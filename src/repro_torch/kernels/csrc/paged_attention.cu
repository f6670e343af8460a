// Paged decode attention over the Wolf-KV block pool.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention/
// kernel.py (paged_attention, body _paged_kernel): one new query token per
// sequence attends over the pages of its block table (-1 = unallocated),
// masked by the sequence's length and by per-slot validity (eviction
// holes), with grouped-query attention and an fp32 online softmax.
//
// The TPU walks a sequential grid (B, Hkv, pages) and DMAs one page per
// step. Here one launch covers the whole batch: a block of 8 warps serves
// one (sequence, KV head, group of up to 8 of its G query heads), and the
// warps split the table's pages among themselves, warp w taking pages w,
// w + 8, ... Each warp streams its pages in chunks of rows through a ring
// of three stages in shared memory: a lane copies 16 bytes of a K row and
// of a V row at a time (cp.async; a 128-dim bf16 row is 16 lanes), two
// chunks ahead of the one it folds in, and reads back only what it copied
// itself, so a warp needs no barrier at all on its stream. A warp keeps
// its own running max, sum and [G, D] accumulator in registers (each lane
// its share of D, summed over the lanes that hold other rows only at the
// end); nothing is shared between warps and there is no barrier per page.
// At the end the warps' partial states meet in shared memory once (one
// barrier) and are merged, each weighted by exp(m_w - m): a warp whose
// pages were all holes ends with m_w = -1e30 and is weighted 0, as the
// Pallas kernel's later alpha would do; a warp with no pages holds l = 0
// and acc = 0.
//
// The arithmetic follows the Pallas kernel: q times d^-1/2 in fp32, scores
// in fp32, the sentinel -1e30 (not -inf) for masked slots, p rounded to
// V's type before P.V, division by max(l, 1e-30). A page whose table entry
// is < 0 or that starts at or beyond the length is skipped, never indexed.
// The merge reorders fp32 sums against the Pallas kernel's page order.
//
// What bounds it: bytes. It reads each allocated page's K and V once per
// KV head (once per group of 8 query heads where G > 8), and little else.
// The design keeps enough of those bytes in flight to cover the card's
// memory latency: at the serving path's shapes (B 32, Hkv 8, G 2) all 256
// blocks are resident together, two to an SM (96 KB of ring each), and
// each of an SM's 16 warps has two 4 KB chunks (8 rows of K and of V) in
// flight beside the one it folds in: ~17 MB over the card.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

// 16 bytes of T as floats, and p rounded to T
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void to_f(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void to_f(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16(x);
  }
};

constexpr int kStages = 3;  // chunks a warp has in its ring

// U, the warp-wide loads (32 lanes x 16 bytes) of K and of V in a chunk,
// for a block that serves gt query heads: fewer where more heads hold
// registers.
__host__ __device__ constexpr int loads_per_chunk(int gt) {
  return gt <= 2 ? 4 : 2;
}

// A chunk's bytes in a warp's ring: U loads of K, then U of V; lane l's
// slices sit at l * 16 in each.
__host__ __device__ constexpr int chunk_bytes(int u) {
  return 2 * u * 32 * 16;
}

// Where a warp is in its stream: page index ip (of the table), its block,
// and the chunk c of the page.
struct Cursor {
  int ip, blk, c;
};

// The kernel's per-launch constants, shared by the helpers below.
struct Args {
  const int32_t* table;  // this sequence's row of the block table
  const int8_t* valid;   // this sequence's [M, P] slot validity
  int length, m, page, n_chunks, rows_per_load, lanes_per_row;
  int64_t slot_stride;  // elements from one slot to the next
};

// The warp's next page after ip that is allocated and starts before the
// length; false if none is left.
__device__ __forceinline__ bool next_page(const Args& a, Cursor& cur) {
  for (int ip = cur.ip + kWarps; ip < a.m; ip += kWarps) {
    const int32_t blk = __ldg(a.table + ip);
    if (blk >= 0 && ip * a.page < a.length) {
      cur.ip = ip;
      cur.blk = blk;
      cur.c = 0;
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ bool advance(const Args& a, Cursor& cur) {
  if (cur.c + 1 < a.n_chunks) {
    ++cur.c;
    return true;
  }
  return next_page(a, cur);
}

// 16 bytes global -> shared, zero-filled where !pred (nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest kStages - 1 groups have landed
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// The first row of the chunk under cur that this lane holds; its others
// follow every rows_per_load rows.
__device__ __forceinline__ int lane_row(const Args& a, const Cursor& cur,
                                        int u_per_chunk, int lane) {
  return cur.c * u_per_chunk * a.rows_per_load + lane / a.lanes_per_row;
}

// Copy this lane's slices of the chunk under cur into a ring stage; rows
// past the page are zero-filled.
template <typename T, int U>
__device__ __forceinline__ void copy_chunk(const Args& a, const Cursor& cur,
                                           const T* k_base, const T* v_base,
                                           int lane, uint32_t stage) {
  const int64_t page_off =
      static_cast<int64_t>(cur.blk) * a.page * a.slot_stride;
  const int row0 = lane_row(a, cur, U, lane);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = row0 + u * a.rows_per_load;
    const bool real = r < a.page;
    const int64_t off = page_off + (real ? r : 0) * a.slot_stride;
    const uint32_t dst = stage + (u * 32 + lane) * 16;
    cp_async16(dst, k_base + off, real);
    cp_async16(dst + U * 32 * 16, v_base + off, real);
  }
}

// Fold the chunk under cur, landed in a ring stage, into the warp's
// running state (m, l, acc).
template <typename T, int GT, int U>
__device__ __forceinline__ void fold_chunk(
    const Args& a, const Cursor& cur, const unsigned char* stage, int lane,
    const float (&q)[GT][Vec<T>::N], float (&m)[GT], float (&l)[GT],
    float (&acc)[GT][Vec<T>::N]) {
  constexpr int N = Vec<T>::N;
  const int row0 = lane_row(a, cur, U, lane);
  uint32_t real = 0, ok = 0;  // bit u: row u of this lane
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = row0 + u * a.rows_per_load;
    if (r < a.page) {
      real |= 1u << u;
      const int pos = cur.ip * a.page + r;
      if (pos < a.length && __ldg(a.valid + pos) != 0) ok |= 1u << u;
    }
  }
  const uint4* k_s = reinterpret_cast<const uint4*>(stage) + lane;
  const uint4* v_s = k_s + U * 32;
  float s[U][GT];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float kf[N];
    Vec<T>::to_f(k_s[u * 32], kf);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) dot += q[g][i] * kf[i];
      // sum over the lanes that hold this row
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        if (off < a.lanes_per_row)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[u][g] = (ok >> u) & 1u ? dot : kNegInf;
    }
  }
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    float mx = m[g];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if ((real >> u) & 1u) mx = fmaxf(mx, s[u][g]);
    // max over the lanes that hold the chunk's other rows
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      if (off >= a.lanes_per_row)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float alpha = expf(m[g] - mx);
    m[g] = mx;
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float e = (real >> u) & 1u ? expf(s[u][g] - mx) : 0.f;
      sum += e;
      s[u][g] = Vec<T>::round(e);  // P.V in V's type
    }
    l[g] = l[g] * alpha + sum;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[g][i] *= alpha;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float vf[N];
    Vec<T>::to_f(v_s[u * 32], vf);
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int i = 0; i < N; ++i) acc[g][i] += s[u][g] * vf[i];
  }
}

// The warps' rings, then their partial states for the merge: acc
// [warps][GT][D], m and l [warps][GT].
size_t smem_bytes(int gt, int d) {
  return static_cast<size_t>(kWarps) * kStages *
             chunk_bytes(loads_per_chunk(gt)) +
         sizeof(float) * kWarps * gt * (d + 2);
}

// GT: query heads a block serves (up to 8 of the G that share a KV head).
template <typename T, int GT>
__global__ void __launch_bounds__(kThreads, GT <= 2 ? 2 : 1)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ tables,
                       const int32_t* __restrict__ lengths,
                       const int8_t* __restrict__ slot_valid,
                       T* __restrict__ out, int hq, int hkv, int d, int page,
                       int m, float scale) {
  constexpr int N = Vec<T>::N;
  constexpr int U = loads_per_chunk(GT);
  constexpr int SB = chunk_bytes(U);
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc_s = reinterpret_cast<float*>(smem + kWarps * kStages * SB);
  float* m_s = acc_s + kWarps * GT * d;  // [warps][GT]
  float* l_s = m_s + kWarps * GT;        // [warps][GT]

  const int g_n = hq / hkv;
  const int n_groups = (g_n + GT - 1) / GT;
  const int hk = blockIdx.x / n_groups;
  const int g0 = (blockIdx.x % n_groups) * GT;  // first head of the group
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  unsigned char* ring = smem + warp * kStages * SB;
  const uint32_t ring_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  Args a;
  a.table = tables + static_cast<int64_t>(b) * m;
  a.valid = slot_valid + static_cast<int64_t>(b) * m * page;
  a.length = lengths[b];
  a.m = m;
  a.page = page;
  a.lanes_per_row = d / N;
  a.rows_per_load = 32 / a.lanes_per_row;
  a.n_chunks = (page + U * a.rows_per_load - 1) / (U * a.rows_per_load);
  a.slot_stride = static_cast<int64_t>(hkv) * d;
  const int col = (lane % a.lanes_per_row) * N;
  const T* k_base = k_pool + static_cast<int64_t>(hk) * d + col;
  const T* v_base = v_pool + static_cast<int64_t>(hk) * d + col;

  // the warp's stream: kStages - 1 chunks are copied ahead of the one
  // folded in; one copy group per chunk (empty past the stream's end)
  Cursor fold{warp - kWarps, 0, 0};
  bool folding = next_page(a, fold);
  Cursor copy = fold;
  bool copying = folding;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (copying) {
      copy_chunk<T, U>(a, copy, k_base, v_base, lane, ring_addr + st * SB);
      copying = advance(a, copy);
    }
    cp_async_commit();
  }

  // this lane's slice of the group's query rows, scaled
  float qf[GT][N], acc[GT][N], m_run[GT], l_run[GT];
  const T* q_b = q + (static_cast<int64_t>(b) * hq + hk * g_n + g0) * d + col;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    float x[N];
    if (g0 + g < g_n) {
      Vec<T>::to_f(__ldg(reinterpret_cast<const uint4*>(q_b + g * d)), x);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      qf[g][i] = x[i] * scale;
      acc[g][i] = 0.f;
    }
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
  }

  for (int st = 0; folding; st = st + 1 == kStages ? 0 : st + 1) {
    // the stage folded last time takes the chunk kStages - 1 ahead
    if (copying) {
      const int free_st = st == 0 ? kStages - 1 : st - 1;
      copy_chunk<T, U>(a, copy, k_base, v_base, lane,
                        ring_addr + free_st * SB);
      copying = advance(a, copy);
    }
    cp_async_commit();
    cp_async_wait_oldest();  // this stage's chunk has landed
    fold_chunk<T, GT, U>(a, fold, ring + st * SB, lane, qf, m_run, l_run,
                         acc);
    folding = advance(a, fold);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // sum the lanes that hold other rows of the same columns
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    if (off < a.lanes_per_row) continue;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      l_run[g] += __shfl_xor_sync(0xffffffffu, l_run[g], off);
#pragma unroll
      for (int i = 0; i < N; ++i)
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
    }
  }
  if (lane < a.lanes_per_row) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        acc_s[(warp * GT + g) * d + col + i] = acc[g][i];
      if (lane == 0) {
        m_s[warp * GT + g] = m_run[g];
        l_s[warp * GT + g] = l_run[g];
      }
    }
  }
  __syncthreads();

  // merge the warps' states: weights exp(m_w - m) (0 for a warp that saw
  // only holes while another saw a live slot)
  for (int e = tid; e < GT * d; e += kThreads) {
    const int g = e / d, j = e % d;
    if (g0 + g >= g_n) continue;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * GT + g]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(m_s[w * GT + g] - mx);
      l += l_s[w * GT + g] * wt;
      o += acc_s[(w * GT + g) * d + j] * wt;
    }
    const int64_t row = static_cast<int64_t>(b) * hq + hk * g_n + g0 + g;
    out[row * d + j] = Vec<T>::from_f(o / fmaxf(l, 1e-30f));
  }
}

template <typename T, int GT>
int launch_g(const void* q, const void* k_pool, const void* v_pool,
             const void* tables, const void* lengths, const void* slot_valid,
             void* out, int b, int hq, int hkv, int d, int page, int m,
             cudaStream_t stream) {
  const size_t smem = smem_bytes(GT, d);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T, GT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)  // two blocks' rings to an SM
    err = cudaFuncSetAttribute(paged_attention_kernel<T, GT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g_n = hq / hkv;
  const dim3 grid(hkv * ((g_n + GT - 1) / GT), b);
  paged_attention_kernel<T, GT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths),
      static_cast<const int8_t*>(slot_valid), static_cast<T*>(out), hq, hkv,
      d, page, m, static_cast<float>(1.0 / sqrt(static_cast<double>(d))));
  return static_cast<int>(cudaGetLastError());
}

// The group size GT: the fewest heads of {1, 2, 4, 8} that hold all G, or
// 8 (and several groups per KV head) where G > 8.
int group_size(int g_n) {
  return g_n <= 1 ? 1 : g_n <= 2 ? 2 : g_n <= 4 ? 4 : 8;
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, const void* slot_valid,
           void* out, int b, int hq, int hkv, int d, int page, int m,
           cudaStream_t s) {
  // a row is D / N lanes of 16 bytes: a power of two up to a warp
  const int lanes = d / Vec<T>::N;
  if (d % Vec<T>::N != 0 || lanes > 32 || (lanes & (lanes - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (group_size(hq / hkv)) {
    case 1:
      return launch_g<T, 1>(q, k_pool, v_pool, tables, lengths, slot_valid,
                            out, b, hq, hkv, d, page, m, s);
    case 2:
      return launch_g<T, 2>(q, k_pool, v_pool, tables, lengths, slot_valid,
                            out, b, hq, hkv, d, page, m, s);
    case 4:
      return launch_g<T, 4>(q, k_pool, v_pool, tables, lengths, slot_valid,
                            out, b, hq, hkv, d, page, m, s);
    default:
      return launch_g<T, 8>(q, k_pool, v_pool, tables, lengths, slot_valid,
                            out, b, hq, hkv, d, page, m, s);
  }
}

}  // namespace

// q [B, Hq, D]; pools [N, P, Hkv, D]; tables [B, M] int32; lengths [B]
// int32; slot_valid [B, M, P] int8; out [B, Hq, D]; q and the pools
// 16-byte aligned; D / (16 bytes of the type) a power of two up to 32.
// dtype: 0 fp32, 1 bf16. The tables come from the host's block manager,
// whose entries are blocks of the pool or -1.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* lengths,
                                      const void* slot_valid, void* out,
                                      int b, int hq, int hkv, int d,
                                      int page, int m, int dtype,
                                      void* stream) {
  if (b == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tables, lengths, slot_valid, out,
                         b, hq, hkv, d, page, m, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths,
                                 slot_valid, out, b, hq, hkv, d, page, m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}


// Flash attention forward: the dense prefill path's attention.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py (flash_attention, body _attn_kernel): attention of q [B, Sq,
// Hq, D] over k, v [B, Skv, Hkv, D] with grouped-query heads (kv head =
// query head / G), a causal mask aligned at the top left (kv_pos <=
// q_pos), an optional sliding window (kv_pos > q_pos - w) and ragged tails,
// with fp32 online-softmax accumulators. The masks and the arithmetic are
// the Pallas kernel's: scores in fp32 times d^-1/2, the sentinel -1e30
// (not -inf), p rounded to V's type before P.V, division by max(l, 1e-30).
// The tail beyond Skv is masked here, not zero-padded, and query rows
// beyond Sq are not written.
//
// The TPU walks a sequential grid (B * Hkv * G, q tiles, kv tiles) and
// keeps m, l and acc in VMEM scratch across the kv axis. Here a block
// serves one 64-row q tile of one or two query heads and loops over 64-row
// kv tiles itself, visiting only the tiles the Pallas tile predicate
// visits (none above the diagonal or wholly outside the window).
//
// What bounds it: operations (4 * Sq * Skv * D * Hq flops, halved when
// causal), above the card's bytes-to-flops line at prefill lengths. Two
// kernels, one per type:
//
// bf16 (flash_bf16_kernel), FlashAttention-2's shape on the tensor cores: 4
// warps a query head, each owning 16 query rows; where G is even a block
// serves two query heads of one KV head (8 warps), which share every K/V tile
// it loads: measured at S = 2048, Hq 16, Hkv 8, that is 5-6% faster than one
// head a block, with 16 warps to an SM instead of 8 (PERF.md). S = Q.K^T and
// O += P.V run as mma.sync m16n8k16 (bf16 in, fp32 accumulators in registers);
// Q's fragments are loaded once (ldmatrix), K's with ldmatrix and V's with
// ldmatrix.trans; P goes from the S accumulators to bf16 A fragments in
// registers. The product Q_bf16.K_bf16 is scaled by d^-1/2 in fp32, as the
// Pallas kernel scales in fp32. K and V tiles (64 x D bf16) come through
// shared memory by cp.async (16 bytes a thread), double-buffered: the next
// tile's copy is in flight while this tile's products run; rows are padded by
// 16 bytes so that ldmatrix's eight row addresses fall on distinct banks. The
// element mask is applied only on tiles that straddle the diagonal, the
// window's edge or the ragged tail; q tiles launch heaviest first (the causal
// triangle's longest rows) so that the SMs stay even.
//
// fp32 (flash_fp32_kernel): CUDA cores, exact fp32 products (TF32 tensor
// cores would break the 1e-5 bound). 256 threads; the K tile is staged in
// shared memory as fp32 and each thread computes a 4 x 4 block of scores
// (rows tr + 16 i, columns tc + 16 j); four threads per row update the
// running max and sum; V replaces K in the same buffer; each thread keeps
// a 4 x (D / 16) block of the output accumulator in registers.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

// -- fp32: CUDA cores -------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows per block
constexpr int kBKV = 64;  // kv rows per tile
constexpr int kSP = kBKV + 1;  // padded score row

template <int D>
constexpr size_t fp32_smem_bytes() {
  // q tile + k/v tile (rows padded to D + 1) + scores + m, l, alpha
  return sizeof(float) * (2 * 64 * (D + 1) + 64 * kSP + 3 * 64);
}

// Stage rows [row0, row0 + 64) of one head of x into dst [64][D + 1] as
// fp32 times scale; rows at or beyond n are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* x,
                                          int row0, int n,
                                          int64_t row_stride, float scale) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < n ? x[row * row_stride + c] * scale : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int sq,
                  int skv, int hq, int hkv, int causal, int window,
                  float scale) {
  constexpr int DP = D + 1;
  constexpr int CPT = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;             // [BQ][DP]
  float* kv_s = q_s + kBQ * DP;  // [BKV][DP]: K, then V, of this tile
  float* s_s = kv_s + kBKV * DP; // [BQ][SP]: scores, then probabilities
  float* m_s = s_s + kBQ * kSP;  // [BQ] running max
  float* l_s = m_s + kBQ;        // [BQ] running sum
  float* a_s = l_s + kBQ;        // [BQ] this tile's rescale factor

  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / hq, h = blockIdx.y % hq;
  const int hk = h / (hq / hkv);
  const int64_t q_stride = static_cast<int64_t>(hq) * D;
  const int64_t kv_stride = static_cast<int64_t>(hkv) * D;
  const float* q_bh = q + static_cast<int64_t>(b) * sq * q_stride + h * D;
  const float* k_bh = k + static_cast<int64_t>(b) * skv * kv_stride + hk * D;
  const float* v_bh = v + static_cast<int64_t>(b) * skv * kv_stride + hk * D;

  load_tile<D>(q_s, q_bh, q0, sq, q_stride, scale);
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // tiles that hold an unmasked entry for some row of this q tile
  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t0 = kv_begin / kBKV * kBKV; t0 < kv_end; t0 += kBKV) {
    __syncthreads();  // the last tile's P.V is done with kv_s and s_s
    load_tile<D>(kv_s, k_bh, t0, skv, kv_stride, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(tr + 16 * i) * DP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_s[(tc + 16 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i, q_pos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j, kv_pos = t0 + c;
        bool ok = kv_pos < skv;
        if (causal) ok = ok && kv_pos <= q_pos;
        if (window > 0) ok = ok && kv_pos > q_pos - window;
        s_s[r * kSP + c] = ok ? s[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // V replaces K; meanwhile four threads per row update its statistics
    load_tile<D>(kv_s, v_bh, t0, skv, kv_stride, 1.f);
    {
      const int r = tid / 4, part = tid % 4;
      float* row = s_s + r * kSP;
      float mx = kNegInf;
      for (int j = part; j < kBKV; j += 4) mx = fmaxf(mx, row[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = part; j < kBKV; j += 4) {
        const float p = expf(row[j] - m_new);
        sum += p;
        row[j] = p;  // P.V in V's type (fp32)
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[tr + 16 * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBKV; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(tr + 16 * i) * kSP + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vv = kv_s[kk * DP + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * vv;
      }
    }
  }
  __syncthreads();

  float* o_bh = o + static_cast<int64_t>(b) * sq * q_stride + h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    if (q0 + r >= sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      o_bh[(q0 + r) * q_stride + tc + 16 * j] = acc[i][j] / l;
  }
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* o, int b,
                int sq, int skv, int hq, int hkv, int causal, int window,
                float scale, cudaStream_t stream) {
  constexpr size_t smem = fp32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  flash_fp32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, skv, hq, hkv,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// -- bf16: tensor cores -----------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kWarps16 = 4;  // 16 query rows each
constexpr int kThreads16 = 32 * kWarps16;
constexpr int kTile = 64;  // q rows per block, kv rows per tile
constexpr float kLog2e = 1.4426950408889634f;

// A tile of 64 rows x D bf16 in shared memory, each row padded by 8
// elements (16 bytes): the 8 row addresses of one ldmatrix then start 16
// bytes apart modulo 128 and hit distinct banks.
template <int D>
struct TileLayout {
  static constexpr int kStride = D + 8;          // elements per row
  static constexpr int kElems = kTile * kStride;  // elements per tile
  // HPB Q tiles, then K and V double-buffered
  static constexpr size_t smem_bytes(int hpb) {
    return sizeof(bf16) * (hpb + 4) * kElems;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled where !pred (nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy rows [row0, row0 + 64) of one head (row stride `stride` elements)
// into a padded tile with NT threads; rows at or beyond n are zero-filled.
template <int D, int NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int row0, int n,
                                                int64_t stride) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert(kTile * kChunks % NT == 0, "whole copies a thread");
#pragma unroll
  for (int n_i = 0; n_i < kTile * kChunks / NT; ++n_i) {
    const int i = threadIdx.x + n_i * NT;
    const int r = i / kChunks, c = i % kChunks;
    const int row = row0 + r;
    const bool ok = row < n;
    const bf16* g = src + static_cast<int64_t>(ok ? row : 0) * stride + c * 8;
    cp_async16(smem_addr(dst + r * TileLayout<D>::kStride + c * 8), g, ok);
  }
}

// HPB: query heads of one KV head a block serves (4 warps each), which
// share every K/V tile the block loads.
template <int D, int HPB>
__global__ void __launch_bounds__(kThreads16 * HPB)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int sq,
                  int skv, int hq, int hkv, int causal, int window,
                  float scale) {
  using L = TileLayout<D>;
  constexpr int NT = kThreads16 * HPB;
  constexpr int KS = D / 16;  // k-steps of Q.K^T; d-tile pairs of P.V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [HPB] tiles
  bf16* k_s = q_s + HPB * L::kElems;  // [2] tiles
  bf16* v_s = k_s + 2 * L::kElems;    // [2] tiles

  const int tid = threadIdx.x, lane = tid % 32;
  const int head = tid / kThreads16, warp = tid / 32 % kWarps16;
  const int gr = lane / 4, tq = lane % 4;  // mma fragment row, column pair
  // heaviest q tiles first: block y = 0 takes the last tile of every head
  const int n_q = (sq + kTile - 1) / kTile;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int b = blockIdx.x / (hq / HPB);
  const int h0 = blockIdx.x % (hq / HPB) * HPB;
  const int hk = h0 / (hq / hkv);
  const int64_t q_stride = static_cast<int64_t>(hq) * D;
  const int64_t kv_stride = static_cast<int64_t>(hkv) * D;
  const bf16* q_b = q + static_cast<int64_t>(b) * sq * q_stride + h0 * D;
  const bf16* k_bh = k + static_cast<int64_t>(b) * skv * kv_stride + hk * D;
  const bf16* v_bh = v + static_cast<int64_t>(b) * skv * kv_stride + hk * D;

  // the kv tiles the Pallas predicate visits for rows [q0, q0 + 64)
  const int kv_end = causal ? min(skv, q0 + kTile) : skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = kv_begin / kTile;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - 1) / kTile - t_first + 1 : 0;

  // Q, then the first K/V tile pair: two copy groups
#pragma unroll
  for (int i = 0; i < HPB; ++i)
    load_tile_async<D, NT>(q_s + i * L::kElems, q_b + i * D, q0, sq,
                           q_stride);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile_async<D, NT>(k_s, k_bh, t_first * kTile, skv, kv_stride);
    load_tile_async<D, NT>(v_s, v_bh, t_first * kTile, skv, kv_stride);
  }
  cp_async_commit();
  cp_async_wait_prev();
  __syncthreads();

  // this warp's 16 query rows as A fragments, loaded once: rows lane % 16,
  // columns 8 * (lane / 16) of each 16 x 16 block
  uint32_t qf[KS][4];
  {
    const bf16* base = q_s + head * L::kElems +
                       (warp * 16 + (lane & 15)) * L::kStride +
                       (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], smem_addr(base + kk * 16));
  }
  float acc[2 * KS][4];  // O: 16 rows x D, d-tiles of 8 columns
  float m_run[2] = {kNegInf, kNegInf};  // rows gr and gr + 8
  float l_run[2] = {0.f, 0.f};          // this thread's share of the sums
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int row_lo = q0 + warp * 16 + gr;  // q position of rows gr, gr + 8
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = (t_first + it) * kTile;
    const bf16* kt = k_s + (it & 1) * L::kElems;
    const bf16* vt = v_s + (it & 1) * L::kElems;
    if (it + 1 < n_tiles) {  // the next tile's copy flies during this one
      const int nb = (it + 1) & 1;
      load_tile_async<D, NT>(k_s + nb * L::kElems, k_bh, t0 + kTile, skv,
                             kv_stride);
      load_tile_async<D, NT>(v_s + nb * L::kElems, v_bh, t0 + kTile, skv,
                             kv_stride);
    }
    cp_async_commit();
    cp_async_wait_prev();  // this tile's pair has landed
    __syncthreads();

    // S = Q.K^T: 16 rows x 64 kv columns, n-tiles of 8
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    {
      // matrices (kv rows n0 + 8 (i / 2), d columns 8 (i % 2)), i = lane / 8
      const bf16* base = kt + ((lane & 7) + ((lane >> 4) << 3)) * L::kStride +
                         ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t kb[4];
          ldsm_x4(kb, smem_addr(base + jp * 16 * L::kStride + kk * 16));
          mma_bf16(s[2 * jp], qf[kk], kb[0], kb[1]);
          mma_bf16(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
        }
      }
    }

    // scale in fp32; mask only where the tile straddles an edge
    const bool edge = t0 + kTile > skv || (causal && t0 + kTile - 1 > q0) ||
                      (window > 0 && t0 <= q0 + kTile - 1 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) {
          const int q_pos = row_lo + (e >> 1) * 8;
          const int kv_pos = t0 + 8 * j + 2 * tq + (e & 1);
          bool ok = kv_pos < skv;
          if (causal) ok = ok && kv_pos <= q_pos;
          if (window > 0) ok = ok && kv_pos > q_pos - window;
          x = ok ? x : kNegInf;
        }
        s[j][e] = x;
      }
    }

    // online softmax; a row's four threads hold its 64 columns
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m_new[0] = fmaxf(m_new[0], fmaxf(s[j][0], s[j][1]));
      m_new[1] = fmaxf(m_new[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2f((m_run[r] - m_new[r]) * kLog2e);
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[j][e] - m_new[e >> 1]) * kLog2e);
        rsum[e >> 1] += p;
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rsum[r];
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P.V, P in bf16 (V's type) straight from the S accumulators
    {
      // matrices (kv rows 8 (i % 2), d columns n0 + 8 (i / 2)), transposed
      const bf16* base =
          vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * L::kStride +
          (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
        };
#pragma unroll
        for (int dp = 0; dp < KS; ++dp) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, smem_addr(base + kk * 16 * L::kStride + dp * 16));
          mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
          mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer pair
  }
  cp_async_wait_all();

  float l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[r] = fmaxf(l, 1e-30f);
  }
  bf16* o_bh =
      o + static_cast<int64_t>(b) * sq * q_stride + (h0 + head) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q_pos = row_lo + 8 * r;
    if (q_pos >= sq) continue;
    bf16* dst = o_bh + static_cast<int64_t>(q_pos) * q_stride + 2 * tq;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          acc[j][2 * r] / l_row[r], acc[j][2 * r + 1] / l_row[r]);
    }
  }
}

template <int D, int HPB>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int sq, int skv, int hq, int hkv, int causal, int window,
                float scale, cudaStream_t stream) {
  const size_t smem = TileLayout<D>::smem_bytes(HPB);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D, HPB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)  // two blocks' tiles to an SM
    err = cudaFuncSetAttribute(flash_bf16_kernel<D, HPB>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq / HPB, (sq + kTile - 1) / kTile);
  flash_bf16_kernel<D, HPB><<<grid, kThreads16 * HPB, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), sq, skv, hq, hkv,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int skv, int hq, int hkv, int dtype, int causal,
           int window, cudaStream_t s) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  if (dtype == 0)
    return launch_fp32<D>(q, k, v, o, b, sq, skv, hq, hkv, causal, window,
                          scale, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  // two query heads a block where G is even (the two share each K/V tile)
  if ((hq / hkv) % 2 == 0)
    return launch_bf16<D, 2>(q, k, v, o, b, sq, skv, hq, hkv, causal, window,
                             scale, s);
  return launch_bf16<D, 1>(q, k, v, o, b, sq, skv, hq, hkv, causal, window,
                           scale, s);
}

}  // namespace

// q, o [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D], each 16-byte aligned; d in
// {32, 64, 128}; dtype: 0 fp32, 1 bf16; window 0 = full attention.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int sq,
                                      int skv, int hq, int hkv, int d,
                                      int dtype, int causal, int window,
                                      void* stream) {
  if (b == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, b, sq, skv, hq, hkv, dtype, causal,
                        window, s);
    case 64:
      return launch<64>(q, k, v, o, b, sq, skv, hq, hkv, dtype, causal,
                        window, s);
    case 128:
      return launch<128>(q, k, v, o, b, sq, skv, hq, hkv, dtype, causal,
                         window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Paged decode attention over the Wolf-KV block pool.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention/
// kernel.py (paged_attention, body _paged_kernel): one new query token per
// sequence attends over the pages of its block table (-1 = unallocated),
// masked by the sequence's length and by per-slot validity (eviction
// holes), with grouped-query attention and an fp32 online softmax.
//
// The TPU walks a sequential grid (B, Hkv, pages) and DMAs one page per
// step. Here one block of threads serves one (sequence, KV head) and loops
// over the table's pages itself: the G = Hq / Hkv query heads that share
// the KV head share every K/V page read. Per page: one warp per (query
// head, slot) takes the dot product over D (lanes on neighbouring
// elements, a shuffle reduction), one warp per query head updates the
// running max and sum, then every thread updates its share of the [G, D]
// accumulator from the page's V. The arithmetic follows the Pallas kernel:
// scores in fp32 times d^-1/2, the sentinel -1e30 (not -inf) for masked
// slots, p rounded to V's type before P.V, division by max(l, 1e-30). A
// page whose table entry is < 0 or that starts at or beyond the length is
// skipped, never indexed.
//
// What bounds it: bytes. It reads each allocated page's K and V once per
// KV head, and little else. This first version is simple: three barriers
// per page and no prefetch, so a long table is latency-bound; splitting the
// pages over more blocks is a later PR's work.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ tables,
                       const int32_t* __restrict__ lengths,
                       const int8_t* __restrict__ slot_valid,
                       T* __restrict__ out, int hq, int hkv, int d, int page,
                       int m, float scale) {
  extern __shared__ float smem[];
  const int g_n = hq / hkv;
  float* q_s = smem;              // [G, D] query rows, scaled
  float* acc_s = q_s + g_n * d;   // [G, D] running P.V
  float* p_s = acc_s + g_n * d;   // [G, P] scores, then probabilities
  float* m_s = p_s + g_n * page;  // [G] running max
  float* l_s = m_s + g_n;         // [G] running sum
  float* a_s = l_s + g_n;         // [G] this page's rescale factor

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_warps = kThreads / 32;
  const int64_t q_off = (static_cast<int64_t>(b) * hq + h * g_n) * d;

  for (int e = tid; e < g_n * d; e += kThreads) {
    q_s[e] = to_f(q[q_off + e]) * scale;
    acc_s[e] = 0.f;
  }
  for (int g = tid; g < g_n; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int length = lengths[b];
  const int64_t slot_stride = static_cast<int64_t>(hkv) * d;
  for (int ip = 0; ip < m; ++ip) {
    const int32_t blk = tables[static_cast<int64_t>(b) * m + ip];
    if (blk < 0 || ip * page >= length) continue;  // the same for the block
    const int64_t base = static_cast<int64_t>(blk) * page * slot_stride +
                         static_cast<int64_t>(h) * d;
    const int8_t* valid = slot_valid + (static_cast<int64_t>(b) * m + ip) * page;

    for (int e = warp; e < g_n * page; e += n_warps) {
      const int g = e / page, slot = e % page;
      const T* k_row = k_pool + base + slot * slot_stride;
      float dot = 0.f;
      for (int j = lane; j < d; j += 32) dot += q_s[g * d + j] * to_f(k_row[j]);
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) {
        const bool ok = ip * page + slot < length && valid[slot] != 0;
        p_s[e] = ok ? dot : kNegInf;
      }
    }
    __syncthreads();

    for (int g = warp; g < g_n; g += n_warps) {
      float mx = kNegInf;
      for (int j = lane; j < page; j += 32) mx = fmaxf(mx, p_s[g * page + j]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < page; j += 32) {
        const float p = expf(p_s[g * page + j] - m_new);
        sum += p;
        p_s[g * page + j] = to_f(from_f<T>(p));  // P.V in V's type
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < g_n * d; e += kThreads) {
      const int g = e / d, j = e % d;
      const T* v_col = v_pool + base + j;
      float pv = 0.f;
      for (int slot = 0; slot < page; ++slot)
        pv += p_s[g * page + slot] * to_f(v_col[slot * slot_stride]);
      acc_s[e] = acc_s[e] * a_s[g] + pv;
    }
    __syncthreads();
  }

  for (int e = tid; e < g_n * d; e += kThreads)
    out[q_off + e] = from_f<T>(acc_s[e] / fmaxf(l_s[e / d], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, const void* slot_valid,
           void* out, int b, int hq, int hkv, int d, int page, int m,
           cudaStream_t stream) {
  const int g_n = hq / hkv;
  const size_t smem = sizeof(float) * (2 * g_n * d + g_n * page + 3 * g_n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(hkv, b);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths),
      static_cast<const int8_t*>(slot_valid), static_cast<T*>(out), hq, hkv,
      d, page, m, static_cast<float>(1.0 / sqrt(static_cast<double>(d))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Hq, D]; pools [N, P, Hkv, D]; tables [B, M] int32; lengths [B]
// int32; slot_valid [B, M, P] int8; out [B, Hq, D]. dtype: 0 fp32, 1 bf16.
// The tables come from the host's block manager, whose entries are blocks
// of the pool or -1.
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

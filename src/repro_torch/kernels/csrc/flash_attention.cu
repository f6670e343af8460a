// Flash attention forward: the dense prefill path's attention.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py (flash_attention, body _attn_kernel): attention of q [B, Sq,
// Hq, D] over k, v [B, Skv, Hkv, D] with grouped-query heads (kv head =
// query head / G), a causal mask aligned at the top left (kv_pos <=
// q_pos), an optional sliding window (kv_pos > q_pos - w) and ragged tails,
// with fp32 online-softmax accumulators. The masks and the arithmetic are
// the Pallas kernel's: scores in fp32 from q * d^-1/2, the sentinel -1e30
// (not -inf), p rounded to V's type before P.V, division by max(l, 1e-30).
// The tail beyond Skv is masked here, not zero-padded, and query rows
// beyond Sq are not written.
//
// The TPU walks a sequential grid (B * Hkv * G, q tiles, kv tiles) and
// keeps m, l and acc in VMEM scratch across the kv axis. Here one block of
// 256 threads serves one (batch, query head, 64-row q tile) and loops over
// 64-row kv tiles itself, skipping whole tiles above the diagonal or
// outside the window, as the Pallas kernel's tile predicate does. Per
// tile: the K tile is staged in shared memory as fp32 and each thread
// computes a 4 x 4 block of scores (rows tr + 16 i, columns tc + 16 j, so a
// warp reads 16 different K rows on 16 different banks); four threads per
// row update the running max and sum; the V tile replaces K in the same
// buffer; each thread keeps a 4 x (D / 16) block of the output accumulator
// in registers.
//
// What bounds it: operations (4 * Sq * Skv * D * Hq flops, halved when
// causal), above the card's bytes-to-flops line at prefill lengths. This
// first version runs on the CUDA cores in fp32 for both types; the tensor
// cores (mma.sync, then wgmma with TMA) are a later PR's work.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows per block
constexpr int kBKV = 64;  // kv rows per tile
constexpr int kSP = kBKV + 1;  // padded score row
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

template <int D>
constexpr size_t smem_bytes() {
  // q tile + k/v tile (rows padded to D + 1) + scores + m, l, alpha
  return sizeof(float) * (2 * 64 * (D + 1) + 64 * kSP + 3 * 64);
}

// Stage rows [row0, row0 + 64) of one head of x into dst [64][D + 1] as
// fp32 times scale; rows at or beyond n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* x, int row0,
                                          int n, int64_t row_stride,
                                          float scale) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] =
        row < n ? to_f(x[row * row_stride + c]) * scale : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq,
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
  const T* q_bh = q + static_cast<int64_t>(b) * sq * q_stride + h * D;
  const T* k_bh = k + static_cast<int64_t>(b) * skv * kv_stride + hk * D;
  const T* v_bh = v + static_cast<int64_t>(b) * skv * kv_stride + hk * D;

  load_tile<T, D>(q_s, q_bh, q0, sq, q_stride, scale);
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
    load_tile<T, D>(kv_s, k_bh, t0, skv, kv_stride, 1.f);
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
    load_tile<T, D>(kv_s, v_bh, t0, skv, kv_stride, 1.f);
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
        row[j] = to_f(from_f<T>(p));  // P.V in V's type
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

  T* o_bh = o + static_cast<int64_t>(b) * sq * q_stride + h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    if (q0 + r >= sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      o_bh[(q0 + r) * q_stride + tc + 16 * j] = from_f<T>(acc[i][j] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int skv, int hq, int hkv, int causal, int window,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, hq, hkv, causal,
      window, static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int sq, int skv, int hq, int hkv, int d, int causal, int window,
             cudaStream_t s) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, sq, skv, hq, hkv, causal, window, s);
    case 64:
      return launch<T, 64>(q, k, v, o, b, sq, skv, hq, hkv, causal, window, s);
    case 128:
      return launch<T, 128>(q, k, v, o, b, sq, skv, hq, hkv, causal, window,
                            s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D]; d in {32, 64, 128}; dtype:
// 0 fp32, 1 bf16; window 0 = full attention.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int sq,
                                      int skv, int hq, int hkv, int d,
                                      int dtype, int causal, int window,
                                      void* stream) {
  if (b == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, b, sq, skv, hq, hkv, d, causal, window,
                           s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, b, sq, skv, hq, hkv, d, causal,
                                   window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

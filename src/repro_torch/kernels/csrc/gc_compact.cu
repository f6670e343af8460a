// KV-pool compaction of the Wolf-KV serving engine (GC migration),
// over every layer of the K and V pools in one call.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gc_compact/kernel.py
// (_compact_kernel in _run, reached through gc_compact, run under jax.vmap
// over layers by src/repro/serving/paged_model.py:apply_moves): copy one
// token slot [Hkv, D] of K and of V from (src_block, src_slot) to
// (dst_block, dst_slot) for each row of a move list. The contract is
// gc_compact_ref: every read happens before any write, so source and
// destination slot sets may interleave across moves.
//
// The host plans the list first (kernels/gc_compact/kernel.py:plan_moves,
// one numpy pass): it drops no-op rows, checks bounds, refuses duplicate
// destinations (they have no order under the contract), and puts first the
// H hazard rows: rows whose source slot is some row's destination. Only
// those need their source read before the copy writes. So:
//
//   H = 0   one launch: every (K or V, layer, row) copied source to
//           destination, no scratch;
//   H > 0   two launches on one stream: the first stages the hazard rows'
//           sources into scratch [2, L, H, slot], the second copies every
//           row, the hazard rows from scratch and the rest from the pool.
//           No row of the second launch reads what it writes: a row whose
//           source is a destination reads scratch.
//
// One warp serves one (kv, layer, row) and copies the slot in 16-byte
// vectors, lanes on neighbouring addresses, each lane issuing all its
// loads (up to kVecs) before any store, so a slot's bytes are in flight at
// once (2 KB in bf16 at internlm2-1.8b width: 4 vectors a lane).
//
// What bounds it: bytes. Each row reads and writes 2 x L slots, plus the
// staged rows' second round trip; the move list is read once. Blocks of 8
// warps, one row each, 2 x L x M warps: thousands of blocks over 132 SMs.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 8;  // 16-byte vectors a lane keeps in flight

// Copy one slot of row_vecs vectors: every load of a pass before any store.
__device__ __forceinline__ void copy_slot(uint4* __restrict__ dst,
                                          const uint4* __restrict__ src,
                                          int row_vecs, int lane) {
  for (int base = 0; base < row_vecs; base += 32 * kVecs) {
    uint4 v[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int j = base + u * 32 + lane;
      if (j < row_vecs) v[u] = src[j];
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int j = base + u * 32 + lane;
      if (j < row_vecs) dst[j] = v[u];
    }
  }
}

// One warp per (kv, layer, row): w = (kv * L + layer) * n_rows + row.
// STAGE: rows [0, n_rows) are the hazard rows, pool -> scratch. Otherwise
// rows [0, m): rows below n_hazard read scratch, the rest the pool.
template <bool STAGE>
__global__ void __launch_bounds__(kThreads)
gc_compact_kernel(uint4* __restrict__ k_pools, uint4* __restrict__ v_pools,
                  const int32_t* __restrict__ rows,
                  uint4* __restrict__ scratch, int n_layers, int n_blocks,
                  int page, int n_rows, int n_hazard, int row_vecs) {
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= 2LL * n_layers * n_rows) return;
  const int i = static_cast<int>(w % n_rows);
  const int layer = static_cast<int>((w / n_rows) % n_layers);
  const int kv = static_cast<int>(w / (static_cast<int64_t>(n_rows) *
                                       n_layers));
  const int32_t* row = rows + 4 * static_cast<int64_t>(i);
  uint4* pools = kv ? v_pools : k_pools;
  const int64_t layer_slots = static_cast<int64_t>(layer) * n_blocks * page;
  uint4* src = pools + (layer_slots + static_cast<int64_t>(row[0]) * page +
                        row[1]) * row_vecs;
  // staged slot of hazard row i: [kv, layer, i]
  uint4* staged = scratch + ((static_cast<int64_t>(kv) * n_layers + layer) *
                                 n_hazard + i) * row_vecs;
  if (STAGE) {
    copy_slot(staged, src, row_vecs, lane);
  } else {
    uint4* dst = pools + (layer_slots + static_cast<int64_t>(row[2]) * page +
                          row[3]) * row_vecs;
    copy_slot(dst, i < n_hazard ? staged : src, row_vecs, lane);
  }
}

unsigned grid_for(int n_layers, int n_rows) {
  const int64_t warps = 2LL * n_layers * n_rows;
  return static_cast<unsigned>((warps + kWarps - 1) / kWarps);
}

}  // namespace

// k_pools, v_pools: [L, N, P, Hkv, D] of any element type, a token slot
// being row_vecs 16-byte vectors; rows: [m, 4] int32 on the device, the
// planned list (live rows only, in bounds, distinct destinations, the
// n_hazard hazard rows first); scratch: 2 * L * n_hazard * row_vecs
// vectors (null when n_hazard is 0). Launches 1 + (n_hazard > 0) kernels.
extern "C" int gc_compact_launch(void* k_pools, void* v_pools,
                                 const void* rows, void* scratch,
                                 int n_layers, int n_blocks, int page, int m,
                                 int n_hazard, int row_vecs, void* stream) {
  if (m < 0 || n_hazard < 0 || n_hazard > m || row_vecs < 1 ||
      (n_hazard > 0 && !scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint4* k = static_cast<uint4*>(k_pools);
  uint4* v = static_cast<uint4*>(v_pools);
  const int32_t* r = static_cast<const int32_t*>(rows);
  uint4* sc = static_cast<uint4*>(scratch);
  if (n_hazard > 0) {
    gc_compact_kernel<true><<<grid_for(n_layers, n_hazard), kThreads, 0, s>>>(
        k, v, r, sc, n_layers, n_blocks, page, n_hazard, n_hazard, row_vecs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gc_compact_kernel<false><<<grid_for(n_layers, m), kThreads, 0, s>>>(
      k, v, r, sc, n_layers, n_blocks, page, m, n_hazard, row_vecs);
  return static_cast<int>(cudaGetLastError());
}

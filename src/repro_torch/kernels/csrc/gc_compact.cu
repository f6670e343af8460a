// KV-pool compaction of the Wolf-KV serving engine (GC migration),
// over every layer of the K and V pools in one call.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gc_compact/kernel.py
// (_compact_kernel in _run, reached through gc_compact, run under jax.vmap
// over layers by src/repro/serving/paged_model.py:apply_moves): copy one
// token slot [Hkv, D] of K and of V from (src_block, src_slot) to
// (dst_block, dst_slot) for each row of a move list; a row with
// src_block < 0 is a no-op. The contract is gc_compact_ref: every read
// happens before any write, so source and destination slot sets may
// interleave across moves.
//
// A move list holds hundreds to thousands of rows, each 2 x L slots of
// Hkv * D elements (4 KB per layer at internlm2-1.8b width in bf16): far
// more than one block's shared memory. So the copy runs in two phases, two
// launches on one stream: the gather copies every live source slot into a
// scratch buffer [2, L, M, slot] in device memory, the scatter copies the
// scratch to the destinations. Stream order puts every read before every
// write. One warp serves one (K or V, layer, move) and copies the slot in
// 16-byte vectors, lanes on neighbouring addresses.
//
// What bounds it: bytes. Each live move reads and writes 2 x L slots
// (the scratch doubles that traffic: a later PR may drop it where the
// move list's sources and destinations are disjoint). The move list is
// built on the host and checked there (kernels/gc_compact/kernel.py:
// check_moves), so no bounds are tested here.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// One warp per (kv, layer, move): w = (kv * L + layer) * M + move.
// to_scratch = true gathers pool -> scratch; false scatters scratch -> pool.
template <bool to_scratch>
__global__ void gc_compact_kernel(uint4* __restrict__ k_pools,
                                  uint4* __restrict__ v_pools,
                                  const int32_t* __restrict__ moves,
                                  uint4* __restrict__ scratch, int n_layers,
                                  int n_blocks, int page, int m,
                                  int row_vecs) {
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= 2LL * n_layers * m) return;
  const int i = static_cast<int>(w % m);
  const int layer = static_cast<int>((w / m) % n_layers);
  const int kv = static_cast<int>(w / (static_cast<int64_t>(m) * n_layers));
  const int32_t* row = moves + 4 * static_cast<int64_t>(i);
  if (row[0] < 0) return;  // no-op row
  const int32_t blk = to_scratch ? row[0] : row[2];
  const int32_t slot = to_scratch ? row[1] : row[3];
  uint4* pools = kv ? v_pools : k_pools;
  uint4* pool_row =
      pools + ((static_cast<int64_t>(layer) * n_blocks + blk) * page + slot) *
                  row_vecs;
  uint4* scratch_row = scratch + w * row_vecs;
  for (int j = lane; j < row_vecs; j += 32) {
    if (to_scratch) {
      scratch_row[j] = pool_row[j];
    } else {
      pool_row[j] = scratch_row[j];
    }
  }
}

}  // namespace

// k_pools, v_pools: [L, N, P, Hkv, D] of any element type, a token slot
// being row_vecs 16-byte vectors; moves: [M, 4] int32 on the device;
// scratch: 2 * L * M * row_vecs vectors.
extern "C" int gc_compact_launch(void* k_pools, void* v_pools,
                                 const void* moves, void* scratch,
                                 int n_layers, int n_blocks, int page, int m,
                                 int row_vecs, void* stream) {
  if (m == 0) return 0;
  const int64_t warps = 2LL * n_layers * m;
  const unsigned grid = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gc_compact_kernel<true><<<grid, kThreads, 0, s>>>(
      static_cast<uint4*>(k_pools), static_cast<uint4*>(v_pools),
      static_cast<const int32_t*>(moves), static_cast<uint4*>(scratch),
      n_layers, n_blocks, page, m, row_vecs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gc_compact_kernel<false><<<grid, kThreads, 0, s>>>(
      static_cast<uint4*>(k_pools), static_cast<uint4*>(v_pools),
      static_cast<const int32_t*>(moves), static_cast<uint4*>(scratch),
      n_layers, n_blocks, page, m, row_vecs);
  return static_cast<int>(cudaGetLastError());
}

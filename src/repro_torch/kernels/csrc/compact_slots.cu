// GC slot compaction of the SSD simulator, batched over drives.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gc_compact/kernel.py
// (_compact_kernel in _run, reached through compact_slots): copy a GC
// victim's slot metadata (slot_lba, valid) from (src_block, src_slot) to
// (dst_block, dst_slot) over a move list of M rows; a row with
// src_block < 0 is a no-op. The TPU runs the move list as a sequential
// grid of DMA'd tiles. Here one block of threads serves one drive: every
// thread first gathers its moves' (lba, valid) into shared memory, the
// block meets at one barrier, and only then does any thread scatter. That
// keeps the contract of compact_slots_ref (all reads before any write), so
// source and destination slot sets may interleave across moves. Threads
// loop over the moves, so M may exceed the block size.
//
// What bounds it: it moves 5 bytes in and 5 bytes out per move (M = B =
// 128 at Table-2 size, 640 bytes per drive) plus 16 bytes of move row, so
// at the simulator's D = 1 its time is the launch. Rows whose source or
// destination lies outside the pools are skipped like no-op rows: the
// move list is built on the device, and the host cannot check it without
// a read.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

__global__ void compact_slots_kernel(int32_t* __restrict__ slot_lba,
                                     uint8_t* __restrict__ valid,
                                     const int32_t* __restrict__ src_block,
                                     const int32_t* __restrict__ src_slot,
                                     const int32_t* __restrict__ dst_block,
                                     const int32_t* __restrict__ dst_slot,
                                     int m, int n_blocks, int b) {
  extern __shared__ unsigned char smem[];
  int32_t* lba_s = reinterpret_cast<int32_t*>(smem);
  uint8_t* valid_s = smem + 4 * static_cast<size_t>(m);

  const int64_t d = blockIdx.x;
  const int64_t slots = static_cast<int64_t>(n_blocks) * b;
  int32_t* lba_d = slot_lba + d * slots;
  uint8_t* valid_d = valid + d * slots;
  const int32_t* sb = src_block + d * m;
  const int32_t* ss = src_slot + d * m;
  const int32_t* db = dst_block + d * m;
  const int32_t* ds = dst_slot + d * m;

  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int32_t blk = sb[i], slot = ss[i];
    if (blk >= 0 && blk < n_blocks && slot >= 0 && slot < b) {
      const int64_t f = static_cast<int64_t>(blk) * b + slot;
      lba_s[i] = lba_d[f];
      valid_s[i] = valid_d[f];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int32_t blk = sb[i], slot = ss[i];
    const int32_t dblk = db[i], dslot = ds[i];
    if (blk >= 0 && blk < n_blocks && slot >= 0 && slot < b &&
        dblk >= 0 && dblk < n_blocks && dslot >= 0 && dslot < b) {
      const int64_t f = static_cast<int64_t>(dblk) * b + dslot;
      lba_d[f] = lba_s[i];
      valid_d[f] = valid_s[i];
    }
  }
}

extern "C" int compact_slots_launch(void* slot_lba, void* valid,
                                    const void* src_block,
                                    const void* src_slot,
                                    const void* dst_block,
                                    const void* dst_slot, int n_drives,
                                    int m, int n_blocks, int b,
                                    void* stream) {
  const int threads = m < 1024 ? ((m + 31) / 32) * 32 : 1024;
  const size_t smem = 5 * static_cast<size_t>(m);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        compact_slots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  compact_slots_kernel<<<n_drives, threads > 0 ? threads : 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(slot_lba), static_cast<uint8_t*>(valid),
      static_cast<const int32_t*>(src_block),
      static_cast<const int32_t*>(src_slot),
      static_cast<const int32_t*>(dst_block),
      static_cast<const int32_t*>(dst_slot), m, n_blocks, b);
  return static_cast<int>(cudaGetLastError());
}

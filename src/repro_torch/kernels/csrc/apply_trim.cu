// TRIM (discard) of the SSD simulator's op stream, batched over drives.
//
// Replaces the Pallas TPU kernel src/repro/kernels/write_path/kernel.py
// (_apply_trim_kernel, reached through apply_trim). The TPU version takes
// one scalar-prefetch row (lba, old_pm, enabled) and aliases the map and
// the valid pool in place; here each drive d has its own row
// rows[d] = (lba, old_pm, ok) and one thread lands it:
//   if ok and old_pm >= 0: valid[d][old_pm] = 0
//   if ok:                 page_map[d][lba] = -1
// A re-trim (old_pm < 0) stores -1 over the -1 already there. slot_lba is
// not touched: a dead slot is told by its valid bit alone, as after an
// overwrite.
//
// What bounds it: nothing in it is arithmetic. It reads a 12-byte row and
// stores at most 5 bytes per drive (about 17 bytes), so at the
// simulator's D = 1 its time is the launch itself; the design does no more
// than one thread per drive and lets a fleet (D > 1) fill warps. Stores
// outside the pools (an index the caller got wrong) are skipped rather
// than written: the rows are built on the device, so the host cannot check
// them without a read.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

__global__ void apply_trim_kernel(const int32_t* __restrict__ rows,
                                  int32_t* __restrict__ page_map,
                                  uint8_t* __restrict__ valid, int n_drives,
                                  int64_t lba_pages, int64_t slots) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= n_drives) return;
  const int32_t* r = rows + 3 * static_cast<int64_t>(d);
  const int32_t lba = r[0], old_pm = r[1], ok = r[2];
  if (!ok) return;
  if (old_pm >= 0 && old_pm < slots) {
    valid[static_cast<int64_t>(d) * slots + old_pm] = 0;
  }
  if (lba >= 0 && lba < lba_pages) {
    page_map[static_cast<int64_t>(d) * lba_pages + lba] = -1;
  }
}

extern "C" int apply_trim_launch(const void* rows, void* page_map,
                                 void* valid, int n_drives,
                                 long long lba_pages, long long slots,
                                 void* stream) {
  const int threads = 128;
  const int blocks = (n_drives + threads - 1) / threads;
  apply_trim_kernel<<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<int32_t*>(page_map),
      static_cast<uint8_t*>(valid), n_drives, lba_pages, slots);
  return static_cast<int>(cudaGetLastError());
}

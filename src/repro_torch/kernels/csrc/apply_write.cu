// Fused fast-path write of the SSD simulator, batched over drives.
//
// Replaces the Pallas TPU kernel src/repro/kernels/write_path/kernel.py
// (_apply_write_kernel, reached through apply_write). The TPU version takes
// one scalar-prefetch row and aliases the three pools in place; here each
// drive d has its own row rows[d] = (lba, old_pm, new_pm, ok) and one
// thread lands it:
//   if ok and old_pm >= 0: valid[d][old_pm] = 0
//   if ok:                 valid[d][new_pm] = 1, slot_lba[d][new_pm] = lba,
//                          page_map[d][lba] = new_pm
// The clear and the set commute: the new slot is always above the
// destination block's fill pointer, so it is never the old one.
//
// What bounds it: nothing in it is arithmetic. It moves 16 bytes of row
// and stores 10 bytes per drive, so at the simulator's D = 1 its time is
// the launch itself; the design does no more than one thread per drive
// and lets a fleet (D > 1) fill warps. Stores outside the pools (an index
// the caller got wrong) are skipped rather than written: the rows are
// built on the device, so the host cannot check them without a read.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

__global__ void apply_write_kernel(const int32_t* __restrict__ rows,
                                   int32_t* __restrict__ page_map,
                                   int32_t* __restrict__ slot_lba,
                                   uint8_t* __restrict__ valid,
                                   int n_drives, int64_t lba_pages,
                                   int64_t slots) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= n_drives) return;
  const int32_t* r = rows + 4 * static_cast<int64_t>(d);
  const int32_t lba = r[0], old_pm = r[1], new_pm = r[2], ok = r[3];
  if (!ok) return;
  const int64_t base = static_cast<int64_t>(d) * slots;
  if (old_pm >= 0 && old_pm < slots) valid[base + old_pm] = 0;
  if (new_pm < 0 || new_pm >= slots || lba < 0 || lba >= lba_pages) return;
  valid[base + new_pm] = 1;
  slot_lba[base + new_pm] = lba;
  page_map[static_cast<int64_t>(d) * lba_pages + lba] = new_pm;
}

extern "C" int apply_write_launch(const void* rows, void* page_map,
                                  void* slot_lba, void* valid, int n_drives,
                                  long long lba_pages, long long slots,
                                  void* stream) {
  const int threads = 128;
  const int blocks = (n_drives + threads - 1) / threads;
  apply_write_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<int32_t*>(page_map),
      static_cast<int32_t*>(slot_lba), static_cast<uint8_t*>(valid),
      n_drives, lba_pages, slots);
  return static_cast<int>(cudaGetLastError());
}

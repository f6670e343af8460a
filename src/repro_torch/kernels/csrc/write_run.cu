// A run of the SSD simulator's fast-path events, landed on the device,
// batched over drives.
//
// Replaces, on the simulator's paths, the Pallas TPU kernels of
// src/repro/kernels/write_path/kernel.py: _apply_write_kernel (reached
// through apply_write, the fast arm of the JAX package's split step) and
// _apply_trim_kernel (apply_trim, the TRIM arm). There the step is the body
// of a lax.scan on the device; the per-row ports (apply_write.cu,
// apply_trim.cu) land one 26-byte update per launch, and each launch is one
// of ~200 small launches and one host read per event. Here one launch walks
// the events j0, j0 + 1, ... of each drive's segment and, per event:
//
//   TRIM   unmap the page, kill its slot and tally it on its block
//          (trim_dead), with the invalidate counts; never stops the run.
//   WRITE  decide first, writing nothing: the old mapping and group, the
//          layout group of a re-mapped page (op streams), the §5.6 target
//          group (FDP's rate band or the bloom pair, then the hotter
//          neighbour by hit rate over grp_live AFTER this write's
//          decrement), and the heavy predicate: no open block with room,
//          fewer than 2 free blocks, a movement surplus, or the §5.1
//          interval closing at this write. A heavy write, or a bloom insert
//          that would rotate the filter pair (a row copy of `bits` bytes,
//          left to the host), STOPS the run before the event, leaving it
//          wholly untouched. Otherwise the write commits exactly
//          as the simulator's fast path does, and the write clock w
//          advances.
//
// HALT   (with faults: the JAX package's _halt_wrap, simulator.py:1693) a
//          drive whose drive_status is no longer OK at the launch lands
//          every event left as a counted no-op: n_halted += 1, nothing
//          else changes, a WRITE still advances the write clock w (the
//          host counts the stream's WRITEs), and the trace goes on flat.
//          The run goes to the segment's end, so a degraded drive never
//          stops for the heavy path and costs the host no read. No event
//          depends on another here: the block's 32 threads share them.
//
// After every trace_every-th completed event the cumulative (n_app, n_mig)
// go to the trace. stop[d] = (first event not completed, w there, why):
// why is kStopEnd (the segment ran out), kStopHeavy, kStopRotation (a
// bloom rotation alone) or kStopIndex (an index the host never hands over).
//
// What bounds it: a run moves a few tens of distinct bytes an event, ~1e-8
// ms an event over 3.35 TB/s: the byte bound is meaningless. The floor is
// the serial chain of dependent loads, about three per WRITE (lbas[j] ->
// page_map[lba] -> group_of[blk] -> the bloom bits), each an L2 hit at
// best (page_map is 2.9 MB and the block arrays 32 KB each at Table-2
// size, inside the 50 MB L2). The design
// takes that chain as given: one block per drive, and one thread walks the
// chain, since each event reads what the last one wrote. Everything per
// group (sizes, live counts, writes, hit-rate inputs, each group's active
// block and its fill, the bloom write counts) sits in shared memory for
// the whole run; a run never changes an active block, because a full one
// stops it. Stores go straight through to device memory and never wait.
// The next event's lba and op are loaded while the current one commits.
// D > 1 fills the card with drives. Float arithmetic is the plain
// PyTorch version's, rounded the same: the hit rate is one correctly
// rounded float32 division (__fdiv_rn), the hashes wrap in uint32.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes; no fast-math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroups = 64;
constexpr int kThreads = 32;
constexpr uint8_t kOpTrim = 1;  // repro_torch.core.workloads.OP_TRIM
constexpr int32_t kStatusOk = 0;  // repro_torch.core.ssd.STATUS_OK
// why a run stopped: write_run/kernel.py's STOP_WHY, in order
enum StopWhy {
  kStopEnd = 0,
  kStopHeavy = 1,
  kStopRotation = 2,
  kStopIndex = 3,
};
enum TdMode { kStatic = 0, kFdp = 1, kBloom = 2 };

// Device pointers, one per tensor, in write_run/kernel.py's ORDER; every
// tensor has a leading drive axis.
struct Ptrs {
  const int64_t* lbas;        // [D, n]
  const uint8_t* ops;         // [D, n], null without an op stream
  const int64_t* start;       // [D, 2]: (j0, w)
  int64_t* stop;              // [D, 3]: (first event not completed, w, why)
  int32_t* page_map;          // [D, LBA]
  int32_t* slot_lba;          // [D, K * B]
  uint8_t* valid;             // [D, K * B]
  int32_t* fill;              // [D, K]
  int32_t* live;              // [D, K]
  const int32_t* group_of;    // [D, K]
  const int32_t* active_blk;  // [D, G]
  int32_t* trim_dead;         // [D, K]
  int32_t* grp_size;          // [D, G]
  int32_t* grp_live;          // [D, G]
  int32_t* grp_writes;        // [D, G]
  const uint8_t* grp_active;  // [D, G]
  const float* grp_p;         // [D, G]
  const int32_t* grp_surplus; // [D, G]
  const int32_t* free_blocks; // [D]
  int32_t* mapped_pages;      // [D]
  int32_t* n_app;             // [D]
  int32_t* n_trim;            // [D]
  const int32_t* n_mig;       // [D]
  uint8_t* bloom_active;      // [D, G, bits]
  const uint8_t* bloom_passive;  // [D, G, bits]
  int32_t* bloom_writes;      // [D, G]
  const int64_t* page_group0; // [D, LBA], null without an op stream
  const float* page_rate;     // [D, LBA]
  const float* fdp_rate;      // [D, G]
  int32_t* app;               // [D, n / trace_every]
  int32_t* mig;               // [D, n / trace_every]
  const int32_t* drive_status;  // [D], null without faults
  int32_t* n_halted;          // [D], null without faults
};
constexpr int kNumPtrs = sizeof(Ptrs) / sizeof(void*);

// Sizes, in the order write_run_cuda (write_run/kernel.py) packs them.
struct Dims {
  int64_t n_events, lba_pages, n_blocks, pages_per_block, n_groups, bits,
      h, trace_every, rotate_min;
};
constexpr int kNumDims = sizeof(Dims) / sizeof(int64_t);

// A degraded drive's events from start[d] to the segment's end, each a
// counted no-op, with the block's 32 threads: they count the WRITEs (the
// write clock advances by them) and fill the trace columns with the
// unchanged (n_app, n_mig).
template <bool TRIM>
__device__ void halt(const Ptrs& p, const Dims& n, int64_t d) {
  const int64_t nev = n.n_events, E = n.trace_every;
  const int64_t j0 = p.start[2 * d];
  const int64_t from = j0 < nev ? j0 : nev;
  long long writes = 0;
  for (int64_t j = from + threadIdx.x; j < nev; j += kThreads) {
    writes += !TRIM || p.ops[d * nev + j] != kOpTrim;
  }
  for (int off = kThreads / 2; off > 0; off /= 2) {
    writes += __shfl_down_sync(0xffffffffu, writes, off);
  }
  const int32_t n_app = p.n_app[d], n_mig = p.n_mig[d];
  // the columns of the events from..nev-1 that close a trace stride
  for (int64_t c = from / E + threadIdx.x; c < nev / E; c += kThreads) {
    p.app[d * (nev / E) + c] = n_app;
    p.mig[d * (nev / E) + c] = n_mig;
  }
  if (threadIdx.x == 0) {
    p.n_halted[d] += static_cast<int32_t>(nev - from);
    p.stop[3 * d] = j0 < nev ? nev : j0;
    p.stop[3 * d + 1] = p.start[2 * d + 1] + writes;
    p.stop[3 * d + 2] = kStopEnd;
  }
}

template <int TD, bool TRIM, bool MOVE>
__global__ void __launch_bounds__(kThreads)
write_run_kernel(const Ptrs p, const Dims n) {
  __shared__ int32_t s_size[kMaxGroups], s_live[kMaxGroups],
      s_writes[kMaxGroups], s_ablk[kMaxGroups], s_afill[kMaxGroups],
      s_bw[kMaxGroups];
  __shared__ float s_p[kMaxGroups], s_fdp[kMaxGroups];
  __shared__ bool s_active[kMaxGroups];

  const int64_t d = blockIdx.x;
  if (p.drive_status && p.drive_status[d] != kStatusOk) {  // the whole block
    halt<TRIM>(p, n, d);
    return;
  }
  const int G = static_cast<int>(n.n_groups);
  const int64_t B = n.pages_per_block, K = n.n_blocks, LBA = n.lba_pages;
  const int64_t slots = K * B;
  int32_t* grp_size = p.grp_size + d * G;
  int32_t* grp_live = p.grp_live + d * G;
  int32_t* grp_writes = p.grp_writes + d * G;
  int32_t* bloom_writes = p.bloom_writes + d * G;
  int32_t* fill = p.fill + d * K;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    s_size[g] = grp_size[g];
    s_live[g] = grp_live[g];
    s_writes[g] = grp_writes[g];
    s_ablk[g] = p.active_blk[d * G + g];
    s_afill[g] = (s_ablk[g] >= 0 && s_ablk[g] < K) ? fill[s_ablk[g]] : 0;
    s_p[g] = p.grp_p[d * G + g];
    s_active[g] = p.grp_active[d * G + g] != 0;
    if (TD == kFdp) s_fdp[g] = p.fdp_rate[d * G + g];
    if (TD == kBloom) s_bw[g] = bloom_writes[g];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int64_t nev = n.n_events, E = n.trace_every, bits = n.bits;
  const int64_t* lbas = p.lbas + d * nev;
  const uint8_t* ops = TRIM ? p.ops + d * nev : nullptr;
  int32_t* page_map = p.page_map + d * LBA;
  int32_t* slot_lba = p.slot_lba + d * slots;
  uint8_t* valid = p.valid + d * slots;
  int32_t* live = p.live + d * K;
  const int32_t* group_of = p.group_of + d * K;
  int32_t* trim_dead = p.trim_dead + d * K;
  uint8_t* bloom_act = p.bloom_active + d * G * bits;
  const uint8_t* bloom_pas = p.bloom_passive + d * G * bits;
  int32_t* app = p.app + d * (nev / E);
  int32_t* mig = p.mig + d * (nev / E);

  // what a run cannot change: the pool, the surpluses, the active groups
  bool pool_heavy = p.free_blocks[d] < 2;
  if (MOVE) {
    int32_t most = INT32_MIN;
    for (int g = 0; g < G; ++g) most = max(most, p.grp_surplus[d * G + g]);
    pool_heavy = pool_heavy || most >= 1;
  }
  int first_active = 0;  // argmax of grp_active: the first active group
  for (int g = G - 1; g >= 0; --g) if (s_active[g]) first_active = g;

  int32_t n_app = p.n_app[d], n_trim = p.n_trim[d];
  int32_t mapped = p.mapped_pages[d];
  const int32_t n_mig = p.n_mig[d];
  int64_t j = p.start[2 * d], w = p.start[2 * d + 1];
  int64_t lba = j < nev ? lbas[j] : 0;
  bool trim = TRIM && j < nev && ops[j] == kOpTrim;
  int why = kStopEnd;

  for (; j < nev; ++j) {
    // the next event's address is known: load it ahead of this one's chain
    const int64_t lba_next = j + 1 < nev ? lbas[j + 1] : 0;
    const bool trim_next = TRIM && j + 1 < nev && ops[j + 1] == kOpTrim;
    // an index the host never hands over (its step raises on it) stops the
    // run rather than being stored through
    if (lba < 0 || lba >= LBA) {
      why = kStopIndex;
      break;
    }

    const int32_t pm = page_map[lba];
    const bool has = pm >= 0;
    const int64_t blk_old = has ? pm / B : 0;
    const int32_t old_g = has ? group_of[blk_old] : 0;
    const bool dec = has && old_g >= 0;  // the old group loses the page
    const int og = old_g < 0 ? 0 : old_g;

    if (trim) {
      if (has) {
        live[blk_old] -= 1;
        valid[pm] = 0;
        trim_dead[blk_old] += 1;
        mapped -= 1;
      }
      if (dec) {
        grp_size[og] = --s_size[og];
        grp_live[og] = --s_live[og];
      }
      page_map[lba] = -1;
      n_trim += 1;
    } else {
      // -- decide, writing nothing ------------------------------------------
      if (has && old_g < 0) {  // a mapped page in an unowned block
        why = kStopIndex;
        break;
      }
      int g = has ? old_g : 0;
      if (TRIM && !has) {  // a re-mapped page lands in its layout group
        const int64_t pg0 = p.page_group0[d * LBA + lba];
        if (pg0 < 0 || pg0 >= G) {
          why = kStopIndex;
          break;
        }
        g = s_active[pg0] ? static_cast<int>(pg0) : first_active;
      }
      const int cur = g;
      bool promote = false, rotate = false;
      int64_t i1 = 0, i2 = 0;
      if (TD == kFdp) {
        promote = p.page_rate[d * LBA + lba] > 2.0f * s_fdp[cur];
      } else if (TD == kBloom) {
        const uint32_t u = static_cast<uint32_t>(lba);
        i1 = cur * bits + (u * 2654435761u) % static_cast<uint32_t>(bits);
        i2 = cur * bits + (u * 40503u + 99991u) % static_cast<uint32_t>(bits);
        promote = bloom_act[i1] && bloom_act[i2] && bloom_pas[i1] &&
                  bloom_pas[i2];
        const int32_t size = s_size[cur] - (dec && og == cur ? 1 : 0);
        rotate = s_bw[cur] + 1 >= max(size, static_cast<int32_t>(n.rotate_min));
      }
      if (TD != kStatic && promote) {
        // the next hotter active group in the stable (-hit rate, index)
        // order, over grp_live after this write's decrement
        auto hit_rate = [&](int i) {
          const int32_t lv = s_live[i] - (dec && og == i ? 1 : 0);
          return s_active[i]
                     ? __fdiv_rn(s_p[i], fmaxf(static_cast<float>(lv), 1.0f))
                     : -1.0f;
        };
        const float hr_g = hit_rate(cur);
        int nb = -1;
        float best = 0.0f;
        for (int i = 0; i < G; ++i) {
          if (!s_active[i]) continue;
          const float hr = hit_rate(i);
          if (!(hr > hr_g || (hr == hr_g && i < cur))) continue;
          if (nb < 0 || hr <= best) {  // the lowest rate, ties to the highest
            best = hr;
            nb = i;
          }
        }
        if (nb >= 0 && s_active[nb]) g = nb;
      }
      const int32_t ab = s_ablk[g];
      const int32_t slot = s_afill[g];
      if (ab < 0 || ab >= K || slot >= B || pool_heavy || (w + 1) % n.h == 0) {
        why = kStopHeavy;
        break;
      }
      if (rotate) {
        why = kStopRotation;
        break;
      }

      // -- commit: the simulator's fast write -------------------------------
      if (has) {
        live[blk_old] -= 1;
        valid[pm] = 0;
        mapped -= 1;
      }
      if (dec) {
        grp_size[og] = --s_size[og];
        grp_live[og] = --s_live[og];
      }
      if (TD == kBloom) {
        bloom_act[i1] = 1;
        bloom_act[i2] = 1;
        bloom_writes[cur] = ++s_bw[cur];
      }
      const int32_t new_pm = static_cast<int32_t>(ab * B + slot);
      valid[new_pm] = 1;
      slot_lba[new_pm] = static_cast<int32_t>(lba);
      page_map[lba] = new_pm;
      fill[ab] = ++s_afill[g];
      live[ab] += 1;
      grp_size[g] = ++s_size[g];
      grp_live[g] = ++s_live[g];
      grp_writes[g] = ++s_writes[g];
      mapped += 1;
      n_app += 1;
      w += 1;
    }
    if ((j + 1) % E == 0) {
      app[(j + 1) / E - 1] = n_app;
      mig[(j + 1) / E - 1] = n_mig;
    }
    lba = lba_next;
    trim = trim_next;
  }
  p.n_app[d] = n_app;
  p.n_trim[d] = n_trim;
  p.mapped_pages[d] = mapped;
  p.stop[3 * d] = j;
  p.stop[3 * d + 1] = w;
  p.stop[3 * d + 2] = why;
}

template <int TD, bool TRIM>
cudaError_t launch_move(bool move, int n_drives, const Ptrs& p, const Dims& n,
                        cudaStream_t stream) {
  if (move) {
    write_run_kernel<TD, TRIM, true><<<n_drives, kThreads, 0, stream>>>(p, n);
  } else {
    write_run_kernel<TD, TRIM, false><<<n_drives, kThreads, 0, stream>>>(p, n);
  }
  return cudaGetLastError();
}

template <int TD>
cudaError_t launch_trim(bool trim, bool move, int n_drives, const Ptrs& p,
                        const Dims& n, cudaStream_t stream) {
  return trim ? launch_move<TD, true>(move, n_drives, p, n, stream)
              : launch_move<TD, false>(move, n_drives, p, n, stream);
}

}  // namespace

// ptrs: kNumPtrs device pointers (host array) in Ptrs' order (drive_status
// and n_halted both null without faults); dims: kNumDims sizes in Dims'
// order. Returns a CUDA error code (0: launched);
// cudaErrorInvalidValue for a count or mode the kernel does not take.
extern "C" int write_run_launch(void* const* ptrs, int n_ptrs,
                                const long long* dims, int n_dims,
                                int n_drives, int td_mode, int with_trim,
                                int movement_ops, void* stream) {
  if (n_ptrs != kNumPtrs || n_dims != kNumDims || n_drives < 1 ||
      td_mode < kStatic || td_mode > kBloom) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Ptrs p;
  void** slots = reinterpret_cast<void**>(&p);
  for (int i = 0; i < kNumPtrs; ++i) slots[i] = ptrs[i];
  Dims n;
  int64_t* sizes = reinterpret_cast<int64_t*>(&n);
  for (int i = 0; i < kNumDims; ++i) sizes[i] = dims[i];
  if (n.n_groups < 1 || n.n_groups > kMaxGroups || n.trace_every < 1 ||
      n.h < 1 || (p.drive_status == nullptr) != (p.n_halted == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (td_mode) {
    case kFdp:
      err = launch_trim<kFdp>(with_trim, movement_ops, n_drives, p, n, s);
      break;
    case kBloom:
      err = launch_trim<kBloom>(with_trim, movement_ops, n_drives, p, n, s);
      break;
    default:
      err = launch_trim<kStatic>(with_trim, movement_ops, n_drives, p, n, s);
  }
  return static_cast<int>(err);
}

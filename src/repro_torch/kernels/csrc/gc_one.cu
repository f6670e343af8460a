// One garbage collection of the SSD simulator (choose the group and the
// victim, decide, and drain), batched over drives, in one launch.
//
// Replaces, on the simulator's paths, the Pallas TPU kernel
// src/repro/kernels/gc_compact/kernel.py (_compact_kernel in _run, reached
// through compact_slots from the static drain) together with the host
// chain around it: the JAX package's _gc_one (src/repro/core/
// simulator.py:1172), which folds `enabled` into one lax.cond around
// victim selection (_select_victim, :740) and the drain
// (_gc_drain_bulk_static, :1009). The port ran that as ~33 PyTorch ops to
// choose, one host read to decide, and ~237 ops plus compact_slots.cu to
// drain. Here one block of threads serves one drive:
//
//   group   by mode, as _step_tail computes it: kModeGc takes the given g
//           and enabled = needs_block & (over_budget | low_pool), read from
//           the state at launch; kModeValve the group of the CLOSED block
//           with the fewest live pages (first index), enabled; kModeMove
//           the group of the largest surplus (first index), enabled when
//           that surplus is >= 1 and the pool holds >= 2 blocks.
//   victim  S = ((α·(B − live) − γ·stamp) − β·erase_count) − τ·trim_dead
//           in float32 over the group's CLOSED blocks, −inf elsewhere,
//           each product and difference rounded on its own as PyTorch
//           rounds them (__fmul_rn, __fsub_rn: no contraction into FMAs);
//           the argmax is the first maximum, index 0 when all are −inf.
//           ok = closed[v] & (γ > 0 | live[v] < B); do = ok & free >= 1 &
//           enabled. out[d] = (victim, g, do).
//   enable  a drive whose enable[d] is 0 is left as it is: out[d] =
//           (-1, -1, 0) and no other store (a fleet's round runs the GCs
//           of the drives that stopped on a heavy write, and no other).
//           A null enable enables every drive.
//   drain   (static detector, when do) exactly _gc_drain_bulk_static:
//           the live slots' ranks from warp ballots, pages into the
//           group's active block and then at most one fresh block (the
//           lowest FREE one), seal and claim bookkeeping, page_map of the
//           moved pages, pages dropped when no block can be claimed, the
//           surpluses of every group, then the victim erased.
//   demote  (FDP and bloom detectors, when do; drain_demote) exactly
//           _gc_drain_bulk, §5.6: each live slot's flag, one thread a
//           slot (bloom: the page in neither of group g's filters, the
//           two hashes uint32 products wrapping at 2^32, mod the filter
//           width; FDP: page_rate[lba] < 0.5 · fdp_rate[g] in float32);
//           then one warp walks the flagged slots in slot order, each to
//           the colder neighbour of g by hit rate over the group sizes as
//           the walk has moved them (hr = grp_p / max(size, 1), IEEE
//           division, −1 for an inactive group; the candidate with the
//           highest hr, ties to the lowest index, else g), g's size −1 and
//           the target's +1. The pages then land as in the static drain,
//           per target group: ranks in slot order from per-group warp
//           ballots, each group's active block first, one fresh block for
//           each group that overflows (the i-th claim in order of its
//           first overflowing slot takes the i-th lowest FREE block, from
//           a block-wide scan of the states, while the pool counter
//           lasts), the rest dropped and counted. The seal/claim
//           bookkeeping runs one thread a target group (their blocks are
//           distinct), then the counters, the erase and the fault hook on
//           thread 0, as in the static drain.
//   faults  (with a fault policy; the JAX package's _erase_fault_retire,
//           simulator.py:654, which its _gc_one applies to the drain's
//           output) the erase just made may fail: one counter-based
//           uniform u, murmur3's fmix32 over (fault_seed, fault_draws) in
//           uint32, fails it iff u < rate and retires the block iff u <
//           rate^(1 + retries), the power taken as lax.integer_pow takes
//           it (square and multiply, each product rounded). rate is
//           fault_rate, or max(fault_rate_worn, fault_rate) once the
//           block's P-E count before the erase reaches endurance_limit. A
//           retire undoes the erase's wear, makes the block RETIRED under
//           g (the drain left it FREE: the pool count gives it back, and
//           no list holds it), draws a spare, and degrades the drive
//           (drive_status, degraded_at = n_app) when no spare was left or
//           the pool is left empty. fault_draws advances once an erase.
//
// A launch without a drain only decides (the reference drain's call: the
// host reads `do` from out and drains page by page). Each drain kind is
// an instantiation of its own (Drain), so the static one carries none of
// the demoting drain's code or shared memory.
//
// What bounds it: the scan. A drive's victim search reads each block's
// state (1 byte), the group of each CLOSED block and, for the group's
// CLOSED blocks, only the counters whose weight is nonzero: 9-21 bytes a
// block, ~0.1 MB at Table-2 size (K = 8,192), ~0.03 µs over HBM. A drain
// moves B slots (5 bytes each) and B map entries. So one launch is a few
// µs of device time, and what the design removes is the host's: the
// launches and the read of the chain it replaces (for a demoting drain,
// ~25 launches a flagged slot and two reads). The demoting walk is
// sequential by definition, one warp-wide reduction a flagged slot over
// the ≤ 64 groups, each lane holding two groups' sizes and hit rates in
// registers: at B = 128 a few µs. One block of 1,024
// threads per drive scans K / 1,024 blocks a thread, reduces (score, index)
// pairs by warp shuffles and then across the warps in shared memory (lower
// index winning ties), and runs the drain's scalar bookkeeping on thread 0
// in _gc_drain_bulk_static's order, so stores to one block alias as there.
// D > 1 fills the card with drives.
//
// Built with nvcc into a shared library with a plain C interface
// (repro_torch/kernels/_build.py) and bound with ctypes; no fast-math.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 64;
constexpr int kMaxPages = kThreads;  // pages per block: one thread a slot
constexpr int8_t kFree = 0, kOpen = 1, kClosed = 2, kRetired = 3;  // ssd.py
constexpr int32_t kStatusOk = 0, kStatusDegraded = 1;               // ssd.py
constexpr int32_t kIntMax = 2147483647;
enum Mode { kModeGc = 0, kModeValve = 1, kModeMove = 2 };  // kernel.MODES
// what a launch does after deciding: nothing, the static drain, or the
// demoting drain (FDP or bloom detector)
enum Drain { kDrainNone = 0, kDrainStatic = 1, kDrainDemote = 2 };

// Device pointers, one per tensor, in gc_one/kernel.py's ORDER; every
// tensor has a leading drive axis.
struct Ptrs {
  int32_t* page_map;        // [D, LBA]
  int32_t* slot_lba;        // [D, K * B]
  uint8_t* valid;           // [D, K * B]
  int32_t* live;            // [D, K]
  int32_t* fill;            // [D, K]
  int32_t* stamp;           // [D, K]
  int8_t* state;            // [D, K]
  int32_t* group_of;        // [D, K]
  int32_t* erase_count;     // [D, K]
  int32_t* trim_dead;       // [D, K]
  int32_t* erase_total;     // [D]
  int32_t* erase_sq_total;  // [D]
  int32_t* active_blk;      // [D, G]
  int32_t* grp_phys;        // [D, G]
  const int32_t* grp_alloc;    // [D, G]
  const uint8_t* grp_active;   // [D, G]
  int32_t* grp_surplus;     // [D, G]
  int32_t* grp_size;        // [D, G]
  int32_t* grp_live;        // [D, G]
  int32_t* free_blocks;     // [D]
  int32_t* mapped_pages;    // [D]
  int32_t* n_mig;           // [D]
  int32_t* n_dropped;       // [D]
  int32_t* n_erase;         // [D]
  int32_t* clock;           // [D]
  const float* gc_w;        // [D, 4]: (α, β, γ, τ)
  const int64_t* g;         // [D], kModeGc only (null otherwise)
  const uint8_t* enable;    // [D], or null: every drive enabled
  int64_t* out;             // [D, 3]: (victim, g, do)
  // the fault hook's state and per-drive policy: all null without faults
  int32_t* retired_blocks;  // [D]
  int32_t* spares_left;     // [D]
  int32_t* grp_retired;     // [D, G]
  int32_t* drive_status;    // [D]
  int32_t* degraded_at;     // [D]
  int32_t* n_erase_fail;    // [D]
  uint32_t* fault_draws;    // [D]
  const int32_t* n_app;     // [D]
  const float* fault_rate;       // [D]
  const float* fault_rate_worn;  // [D]
  const int32_t* endurance_limit;  // [D], INT32_MAX: never worn
  const int64_t* fault_seed;     // [D], in [0, 2**32)
  // a demoting drain's inputs: grp_p, and the bloom pair or the FDP rates
  // by detector; all null on a launch without one
  const float* grp_p;            // [D, G]
  const uint8_t* bloom_active;   // [D, G, bloom_bits]
  const uint8_t* bloom_passive;  // [D, G, bloom_bits]
  const float* page_rate;        // [D, LBA]
  const float* fdp_rate;         // [D, G]
};
constexpr int kNumPtrs = sizeof(Ptrs) / sizeof(void*);

// Sizes, in the order gc_one_cuda (gc_one/kernel.py) packs them.
struct Dims {
  int64_t lba_pages, n_blocks, pages_per_block, n_groups, reserve, retries,
      bloom_bits;
};
constexpr int kNumDims = sizeof(Dims) / sizeof(int64_t);

// (score, index) with the larger score winning, the lower index on ties.
__device__ __forceinline__ bool beats_max(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}
// (value, index) with the smaller value winning, the lower index on ties.
__device__ __forceinline__ bool beats_min(int a, int ia, int b, int ib) {
  return a < b || (a == b && ia < ib);
}

// The block's argmax of (score, index); every thread gets the index.
__device__ int block_argmax(float v, int i, float* s_v, int* s_i) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int off = 16; off > 0; off /= 2) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (beats_max(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (lane == 0) { s_v[warp] = v; s_i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = s_v[lane];
    i = s_i[lane];
    for (int off = 16; off > 0; off /= 2) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (beats_max(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) s_i[0] = i;
  }
  __syncthreads();
  const int best = s_i[0];
  __syncthreads();  // s_v / s_i may be reused
  return best;
}

// The block's argmin of (value, index); every thread gets the index.
__device__ int block_argmin(int v, int i, int* s_v, int* s_i) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int off = 16; off > 0; off /= 2) {
    const int ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (beats_min(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (lane == 0) { s_v[warp] = v; s_i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = s_v[lane];
    i = s_i[lane];
    for (int off = 16; off > 0; off /= 2) {
      const int ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (beats_min(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) s_i[0] = i;
  }
  __syncthreads();
  const int best = s_i[0];
  __syncthreads();
  return best;
}

// The JAX package's _fault_uniform: fmix32 over (seed, n), the top 24
// bits as an exactly representable float32 in [0, 1).
__device__ __forceinline__ float fault_uniform(uint32_t seed, uint32_t n) {
  uint32_t h = seed + n * 2654435761u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return __fmul_rn(__uint2float_rn(h >> 8), 5.9604644775390625e-8f);
}

// x^k for k >= 1 as lax.integer_pow lowers it: square and multiply, the
// accumulator taken as x at the lowest set bit, each product rounded.
__device__ __forceinline__ float integer_pow(float x, int k) {
  float acc = x;
  bool have = false;
  while (k > 0) {
    if (k & 1) {
      acc = have ? __fmul_rn(acc, x) : x;
      have = true;
    }
    k >>= 1;
    if (k > 0) x = __fmul_rn(x, x);
  }
  return acc;
}

// Erase drive d's drained victim v of group g at `clock` (the claims'
// stamps already taken): FREE, unlabelled, empty, stamped, one more P-E
// cycle, its trimmed-slot tally cleared, the clock advanced; then, with a
// fault policy, the hook on the erase just made (it reads the pool count
// the drain left). Thread 0 only; the caller clears the victim's slots.
__device__ __forceinline__ void erase_victim(
    const Ptrs& p, const Dims& n, int64_t d, int v, int g, int32_t clock,
    int G, int8_t* state, int32_t* group_of, int32_t* fill, int32_t* live,
    int32_t* stamp, int32_t* erase_count, int32_t* trim_dead) {
  const int32_t e_old = erase_count[v];
  state[v] = kFree;
  group_of[v] = -1;
  fill[v] = 0;
  live[v] = 0;
  stamp[v] = clock;
  p.clock[d] = clock + 1;
  p.n_erase[d] += 1;
  erase_count[v] = e_old + 1;
  trim_dead[v] = 0;
  p.erase_total[d] += 1;
  p.erase_sq_total[d] += 2 * e_old + 1;
  if (p.fault_draws) {  // the fault hook, on the erase just made
    const bool worn = e_old >= p.endurance_limit[d];
    const float base = p.fault_rate[d];
    const float rate = worn ? fmaxf(p.fault_rate_worn[d], base) : base;
    const uint32_t draw = p.fault_draws[d];
    const float u =
        fault_uniform(static_cast<uint32_t>(p.fault_seed[d]), draw);
    p.fault_draws[d] = draw + 1u;
    if (u < rate) p.n_erase_fail[d] += 1;
    if (u < integer_pow(rate, 1 + static_cast<int>(n.retries))) {
      const int32_t spares0 = p.spares_left[d];
      const int32_t free_after = p.free_blocks[d] - 1;
      state[v] = kRetired;
      group_of[v] = g;
      p.free_blocks[d] = free_after;
      erase_count[v] = e_old;  // a failed erase completes no P-E cycle
      p.erase_total[d] -= 1;
      p.erase_sq_total[d] -= 2 * e_old + 1;
      p.n_erase[d] -= 1;
      p.retired_blocks[d] += 1;
      p.grp_retired[d * G + g] += 1;
      p.spares_left[d] = max(spares0 - 1, 0);
      if (p.drive_status[d] == kStatusOk &&
          (spares0 <= 0 || free_after <= 0)) {
        p.drive_status[d] = kStatusDegraded;
        if (p.degraded_at[d] < 0) p.degraded_at[d] = p.n_app[d];
      }
    }
  }
}

// The demoting drain of drive d's decided victim v of group g (the
// header's "demote"), by the whole block: every thread calls it. free0 is
// the pool count at launch.
__device__ void drain_demote(const Ptrs& p, const Dims& n, int64_t d, int v,
                             int g, int32_t free0) {
  __shared__ unsigned s_flags[kWarps];       // the flagged live slots
  __shared__ uint8_t s_seq[kMaxPages];       // the i-th flagged slot's group
  __shared__ int s_cnt[kMaxGroups][kWarps];  // live slots by target, warp
  __shared__ int s_m[kMaxGroups], s_space[kMaxGroups], s_ab[kMaxGroups];
  __shared__ int s_fill_ab[kMaxGroups], s_pos[kMaxGroups], s_new[kMaxGroups];
  __shared__ int s_free[kMaxGroups];         // the r-th lowest FREE block
  __shared__ int s_scan[kWarps];

  const int G = static_cast<int>(n.n_groups);
  const int K = static_cast<int>(n.n_blocks);
  const int B = static_cast<int>(n.pages_per_block);
  const int64_t LBA = n.lba_pages;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_warps = (B + 31) / 32;  // the warps that hold slots
  const unsigned below = (1u << lane) - 1u;
  int32_t* page_map = p.page_map + d * LBA;
  int32_t* slot_lba = p.slot_lba + d * K * static_cast<int64_t>(B);
  uint8_t* valid = p.valid + d * K * static_cast<int64_t>(B);
  int8_t* state = p.state + d * K;
  int32_t* fill = p.fill + d * K;
  int32_t* live = p.live + d * K;
  int32_t* stamp = p.stamp + d * K;
  int32_t* group_of = p.group_of + d * K;
  int32_t* active_blk = p.active_blk + d * G;
  const int32_t clock0 = p.clock[d];
  const int64_t vrow = static_cast<int64_t>(v) * B;

  // -- each live slot's flag (state the drain leaves unchanged) -----------
  bool is_live = false, flag = false;
  int32_t lba = -1;
  if (tid < B) {
    is_live = valid[vrow + tid] != 0;
    lba = slot_lba[vrow + tid];
  }
  if (is_live) {
    const int64_t page = min(static_cast<int64_t>(max(lba, 0)), LBA - 1);
    if (p.bloom_active) {  // in neither of group g's filters
      const uint32_t u = static_cast<uint32_t>(page);
      const uint64_t bits = static_cast<uint64_t>(n.bloom_bits);
      const int64_t row = (d * G + g) * n.bloom_bits;
      const uint64_t h1 = (u * 2654435761u) % bits;
      const uint64_t h2 = (u * 40503u + 99991u) % bits;
      const bool in_a = p.bloom_active[row + h1] && p.bloom_active[row + h2];
      const bool in_p =
          p.bloom_passive[row + h1] && p.bloom_passive[row + h2];
      flag = !in_a && !in_p;
    } else {  // FDP: the oracle rate below half the group's assumed rate
      flag = p.page_rate[d * LBA + page] < 0.5f * p.fdp_rate[d * G + g];
    }
  }
  const unsigned flags = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) s_flags[warp] = flags;
  const int n_live = __syncthreads_count(is_live);

  // -- the targets: one warp walks the flagged slots in slot order --------
  if (warp == 0) {
    int n_flagged = 0;
    for (int w = 0; w < n_warps; ++w) n_flagged += __popc(s_flags[w]);
    // lane l holds groups l and l + 32: the sizes as the walk has moved
    // them, and their hit rates
    bool act[2];
    int size[2];
    float gp[2], hr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h;
      act[h] = i < G && p.grp_active[d * G + i];
      size[h] = i < G ? p.grp_live[d * G + i] : 0;
      gp[h] = i < G ? p.grp_p[d * G + i] : 0.0f;
      hr[h] = act[h] ? __fdiv_rn(gp[h], fmaxf(__int2float_rn(size[h]), 1.0f))
                     : -1.0f;
    }
    for (int f = 0; f < n_flagged; ++f) {
      const float hr_g = __shfl_sync(0xffffffffu, g < 32 ? hr[0] : hr[1],
                                     g % 32);
      // the colder candidates (colder, or as cold at a higher index): the
      // hottest, the lowest index on ties
      float best = -CUDART_INF_F;
      int bi = kIntMax;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = lane + 32 * h;
        const bool cand =
            act[h] && (hr[h] < hr_g || (hr[h] == hr_g && i > g));
        if (cand && beats_max(hr[h], i, best, bi)) {
          best = hr[h];
          bi = i;
        }
      }
      for (int off = 16; off > 0; off /= 2) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (beats_max(ov, oi, best, bi)) {
          best = ov;
          bi = oi;
        }
      }
      const int t = bi < kIntMax ? bi : g;
      if (lane == 0) s_seq[f] = static_cast<uint8_t>(t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // g gives the page to t
        const int i = lane + 32 * h;
        if (i == g || i == t) {
          size[h] += (i == t) - (i == g);
          hr[h] = act[h] ? __fdiv_rn(gp[h],
                                     fmaxf(__int2float_rn(size[h]), 1.0f))
                         : -1.0f;
        }
      }
    }
  }
  __syncthreads();
  int target = g;
  if (flag) {
    int before = __popc(flags & below);
    for (int w = 0; w < warp; ++w) before += __popc(s_flags[w]);
    target = s_seq[before];
  }

  // -- each live slot's rank within its target group, in slot order -------
  unsigned mine = 0;  // the warp's live slots of this slot's target
  if (warp < n_warps) {
    for (int t = 0; t < G; ++t) {
      const unsigned m = __ballot_sync(0xffffffffu, is_live && target == t);
      if (target == t) mine = m;
      if (lane == 0) s_cnt[t][warp] = __popc(m);
    }
  }
  if (tid < G) {
    s_pos[tid] = kIntMax;
    s_free[tid] = K;
  }
  __syncthreads();
  int rank = __popc(mine & below);
  if (is_live) {
    for (int w = 0; w < warp; ++w) rank += s_cnt[target][w];
  }
  if (tid < G) {  // the group's pages and the room in its active block
    int m = 0;
    for (int w = 0; w < n_warps; ++w) m += s_cnt[tid][w];
    const int32_t ab = active_blk[tid];
    const int fill_ab = ab >= 0 ? fill[min(ab, K - 1)] : B;
    s_m[tid] = m;
    s_ab[tid] = ab;
    s_fill_ab[tid] = fill_ab;
    s_space[tid] = B - min(fill_ab, B);
  }
  __syncthreads();
  // a group's first page that does not fit orders its claim
  if (is_live && rank == s_space[target]) s_pos[target] = tid;
  __syncthreads();
  bool claim_ok = false;
  int claim_rank = 0;
  if (tid < G) {
    for (int u = 0; u < G; ++u) {
      claim_rank += s_m[u] > s_space[u] && s_pos[u] < s_pos[tid];
    }
    claim_ok = s_m[tid] > s_space[tid] && claim_rank < free0;
  }
  // the claims that succeed hold ranks 0 .. n_claimed - 1
  const int n_claimed = __syncthreads_count(claim_ok);

  // -- the n_claimed lowest FREE blocks: a block-wide scan of the states --
  if (n_claimed > 0) {
    const int chunk = (K + kThreads - 1) / kThreads;
    const int lo = min(tid * chunk, K), hi = min(lo + chunk, K);
    int count = 0;
    for (int i = lo; i < hi; ++i) count += state[i] == kFree;
    int incl = count;
    for (int off = 1; off < 32; off *= 2) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) s_scan[warp] = incl;
    __syncthreads();
    int r = incl - count;
    for (int w = 0; w < warp; ++w) r += s_scan[w];
    for (int i = lo; i < hi && r < n_claimed; ++i) {
      if (state[i] == kFree) s_free[r++] = i;
    }
    __syncthreads();
  }

  // -- seal / claim bookkeeping, one thread a group (distinct blocks) -----
  if (tid < G) {
    const int m = s_m[tid], space = s_space[tid], ab = s_ab[tid];
    const int n_old = min(m, space);  // 0 without an active block
    const int n_new = claim_ok ? m - n_old : 0;
    const int nb = claim_ok ? s_free[claim_rank] : -1;
    s_new[tid] = nb;
    if (ab >= 0 && ab < K) {
      if (m > space) state[ab] = kClosed;
      fill[ab] += n_old;
      live[ab] += n_old;
    }
    if (claim_ok) {
      if (nb < K) {
        state[nb] = kOpen;
        group_of[nb] = tid;
        stamp[nb] = clock0 + claim_rank;
        fill[nb] = n_new;
        live[nb] += n_new;
      }
      active_blk[tid] = nb;
    }
    const int moved = n_old + n_new - (tid == g ? n_live : 0);
    p.grp_phys[d * G + tid] += claim_ok;
    p.grp_size[d * G + tid] += moved;
    p.grp_live[d * G + tid] += moved;
  }
  __syncthreads();

  // -- land the pages (every victim slot was read above) ------------------
  bool lands = false;
  if (is_live) {
    const int space = s_space[target], nb = s_new[target];
    const bool in_old = rank < space;
    const int dst_blk = in_old ? s_ab[target] : nb;
    const int dst_slot = in_old ? s_fill_ab[target] + rank : rank - space;
    const int64_t f = static_cast<int64_t>(dst_blk) * B + dst_slot;
    lands = in_old || nb >= 0;
    if (lands && dst_blk < K) {
      slot_lba[f] = lba;
      valid[f] = 1;
    }
    // No block to claim: the page is dropped.
    if (lba >= 0 && lba < LBA) {
      page_map[lba] = lands ? static_cast<int32_t>(f) : -1;
    }
  }
  const int n_ok = __syncthreads_count(lands);

  // -- the counters, then the victim erased -------------------------------
  if (tid == 0) {
    p.free_blocks[d] = free0 - n_claimed + 1;
    p.mapped_pages[d] -= n_live - n_ok;
    p.n_mig[d] += n_ok;
    p.n_dropped[d] += n_live - n_ok;
    int32_t* grp_phys = p.grp_phys + d * G;
    grp_phys[g] -= 1;
    for (int i = 0; i < G; ++i) {
      p.grp_surplus[d * G + i] = p.grp_active[d * G + i]
                                     ? grp_phys[i] - p.grp_alloc[d * G + i]
                                     : -kIntMax;
    }
    erase_victim(p, n, d, v, g, clock0 + n_claimed, G, state, group_of,
                 fill, live, stamp, p.erase_count + d * K,
                 p.trim_dead + d * K);
  }
  __syncthreads();
  if (tid < B) {  // the erased victim's slots
    slot_lba[vrow + tid] = -1;
    valid[vrow + tid] = 0;
  }
}

template <int MODE, int DRAIN>
__global__ void __launch_bounds__(kThreads)
gc_one_kernel(const Ptrs p, const Dims n) {
  __shared__ float s_fv[kWarps];
  __shared__ int s_iv[kWarps], s_ii[kWarps], s_wcount[kWarps];
  __shared__ int s_g, s_enabled;
  __shared__ int32_t s_lba[kMaxPages];
  __shared__ int s_scalars[6];  // space, fill_ab, ab_c, new_c, claim_ok, go

  const int64_t d = blockIdx.x;
  const int tid = threadIdx.x;
  if (p.enable && !p.enable[d]) {  // the whole block leaves together
    if (tid == 0) {
      p.out[3 * d] = -1;
      p.out[3 * d + 1] = -1;
      p.out[3 * d + 2] = 0;
    }
    return;
  }
  const int G = static_cast<int>(n.n_groups);
  const int K = static_cast<int>(n.n_blocks);
  const int B = static_cast<int>(n.pages_per_block);
  const int64_t LBA = n.lba_pages;
  int32_t* page_map = p.page_map + d * LBA;
  int32_t* slot_lba = p.slot_lba + d * K * static_cast<int64_t>(B);
  uint8_t* valid = p.valid + d * K * static_cast<int64_t>(B);
  int32_t* live = p.live + d * K;
  int32_t* fill = p.fill + d * K;
  int32_t* stamp = p.stamp + d * K;
  int8_t* state = p.state + d * K;
  int32_t* group_of = p.group_of + d * K;
  int32_t* erase_count = p.erase_count + d * K;
  int32_t* trim_dead = p.trim_dead + d * K;
  int32_t* active_blk = p.active_blk + d * G;
  int32_t* grp_phys = p.grp_phys + d * G;
  const int32_t* grp_alloc = p.grp_alloc + d * G;
  const uint8_t* grp_active = p.grp_active + d * G;
  int32_t* grp_surplus = p.grp_surplus + d * G;
  int32_t* grp_size = p.grp_size + d * G;
  int32_t* grp_live = p.grp_live + d * G;
  const float alpha = p.gc_w[4 * d], beta = p.gc_w[4 * d + 1];
  const float gamma = p.gc_w[4 * d + 2], tau = p.gc_w[4 * d + 3];
  const int32_t free0 = p.free_blocks[d];

  // -- the group, and whether this GC is enabled ---------------------------
  if (MODE == kModeValve) {
    // the CLOSED block with the fewest live pages anywhere; its group pays
    int best = kIntMax, bi = kIntMax;
    for (int i = tid; i < K; i += kThreads) {
      const int v = state[i] == kClosed ? live[i] : kIntMax;
      if (beats_min(v, i, best, bi)) { best = v; bi = i; }
    }
    const int v0 = block_argmin(best, bi, s_iv, s_ii);
    if (tid == 0) {
      const int32_t gv = max(group_of[v0], 0);
      s_g = gv < G ? gv : -1;
      s_enabled = 1;
    }
  } else if (tid == 0) {
    if (MODE == kModeGc) {
      const int64_t g = p.g[d];
      int enabled = 0;
      if (g >= 0 && g < G) {
        const int32_t blk = active_blk[g];
        const bool needs_block = blk >= 0 ? fill[min(blk, K - 1)] >= B : true;
        const bool over_budget = grp_phys[g] >= grp_alloc[g];
        const bool low_pool = free0 <= n.reserve;
        enabled = needs_block && (over_budget || low_pool);
      }
      s_g = g >= 0 && g < G ? static_cast<int>(g) : -1;  // -1: no group
      s_enabled = enabled;
    } else {  // kModeMove: the first group of the largest surplus
      int gs = 0;
      for (int i = 1; i < G; ++i) {
        if (grp_surplus[i] > grp_surplus[gs]) gs = i;
      }
      s_g = gs;
      s_enabled = grp_surplus[gs] >= 1 && free0 >= 2;
    }
  }
  __syncthreads();
  const int g = s_g;

  // -- the victim: the first best score over the group's CLOSED blocks ----
  float best = -CUDART_INF_F;
  int bi = kIntMax, first_free = K;
  for (int i = tid; i < K; i += kThreads) {
    const int8_t st = state[i];
    if (DRAIN == kDrainStatic && st == kFree && i < first_free) {
      first_free = i;
    }
    float score = -CUDART_INF_F;
    if (st == kClosed && group_of[i] == g) {
      // PyTorch's order, each op rounded: ((α·x − γ·y) − β·z) − τ·w; a
      // zero weight's counter is not read (its product is +0 either way)
      score = __fmul_rn(alpha, __int2float_rn(B - live[i]));
      score = __fsub_rn(score, __fmul_rn(
          gamma, gamma != 0.0f ? __int2float_rn(stamp[i]) : 0.0f));
      score = __fsub_rn(score, __fmul_rn(
          beta, beta != 0.0f ? __int2float_rn(erase_count[i]) : 0.0f));
      score = __fsub_rn(score, __fmul_rn(
          tau, tau != 0.0f ? __int2float_rn(trim_dead[i]) : 0.0f));
    }
    if (beats_max(score, i, best, bi)) { best = score; bi = i; }
  }
  const int v = block_argmax(best, bi, s_fv, s_ii);
  if (DRAIN == kDrainStatic) {  // the lowest FREE block (argmax of FREE)
    first_free = block_argmin(first_free, first_free, s_iv, s_ii);
  }

  if (tid == 0) {
    const bool closed = state[v] == kClosed && group_of[v] == g;
    const bool ok = closed && (gamma > 0.0f || live[v] < B);
    // an active block outside the drive (never made) refuses the drain
    const bool go = g >= 0 && s_enabled && ok && free0 >= 1 &&
                    active_blk[g] < K;
    p.out[3 * d] = v;
    p.out[3 * d + 1] = g;
    p.out[3 * d + 2] = go;
    s_scalars[5] = go;
  }
  if (DRAIN == kDrainNone) return;
  __syncthreads();
  if (!s_scalars[5]) return;
  if constexpr (DRAIN == kDrainDemote) {
    drain_demote(p, n, d, v, g, free0);
    return;
  }

  // -- the drain: the victim's live slots and their ranks ------------------
  const int64_t vrow = static_cast<int64_t>(v) * B;
  const int lane = tid % 32, warp = tid / 32;
  bool is_live = false;
  int32_t lba = -1;
  if (tid < B) {
    is_live = valid[vrow + tid] != 0;
    lba = slot_lba[vrow + tid];
    s_lba[tid] = lba;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, is_live);
  if (lane == 0) s_wcount[warp] = __popc(ballot);
  __syncthreads();
  int base = 0, n_live = 0;
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? s_wcount[w] : 0;
    n_live += s_wcount[w];
  }
  const int rank = base + __popc(ballot & ((1u << lane) - 1u));

  // -- seal / claim bookkeeping, in _gc_drain_bulk_static's order ----------
  if (tid == 0) {
    const int32_t ab = active_blk[g];
    const bool has_ab = ab >= 0;
    const int ab_c = max(ab, 0);
    const int fill_ab = has_ab ? fill[ab_c] : B;
    const int space = B - min(fill_ab, B);
    const bool claim = n_live > space;
    const bool seal = claim && has_ab;
    const int new_blk = first_free < K ? first_free : 0;
    const bool claim_ok = claim && free0 >= 1;
    const int new_c = claim_ok ? new_blk : 0;
    const int n_old = min(n_live, space);
    const int n_new = claim_ok ? n_live - n_old : 0;
    const int n_ok = n_old + n_new;
    int32_t clock = p.clock[d];
    if (seal) state[ab_c] = kClosed;
    if (claim_ok) {
      state[new_c] = kOpen;
      group_of[new_c] = g;
      stamp[new_c] = clock;
      clock += 1;
    }
    if (has_ab) fill[ab_c] += n_old;
    if (claim_ok) fill[new_c] = n_new;
    if (has_ab) live[ab_c] += n_old;
    if (claim_ok) {
      live[new_c] += n_new;
      active_blk[g] = new_blk;
    }
    // +1 physical block if one was claimed, -1 for the erased victim
    if (!claim_ok) grp_phys[g] -= 1;
    for (int i = 0; i < G; ++i) {
      grp_surplus[i] =
          grp_active[i] ? grp_phys[i] - grp_alloc[i] : -kIntMax;
    }
    p.free_blocks[d] = free0 + (claim_ok ? 0 : 1);
    p.mapped_pages[d] -= n_live - n_ok;
    grp_size[g] += n_ok - n_live;
    grp_live[g] += n_ok - n_live;
    p.n_mig[d] += n_ok;
    p.n_dropped[d] += n_live - n_ok;
    erase_victim(p, n, d, v, g, clock, G, state, group_of, fill, live,
                 stamp, erase_count, trim_dead);
    s_scalars[0] = space;
    s_scalars[1] = fill_ab;
    s_scalars[2] = ab_c;
    s_scalars[3] = new_c;
    s_scalars[4] = claim_ok;
  }
  __syncthreads();

  // -- land the pages (every victim slot was read above) -------------------
  if (tid < B && is_live) {
    const int space = s_scalars[0];
    const bool in_old = rank < space;
    const int dst_blk = in_old ? s_scalars[2] : s_scalars[3];
    const int dst_slot = in_old ? s_scalars[1] + rank : rank - space;
    const bool lands = in_old || s_scalars[4];
    const int64_t f = static_cast<int64_t>(dst_blk) * B + dst_slot;
    if (lands) {
      slot_lba[f] = lba;
      valid[f] = 1;
    }
    // a live slot's page is in the drive; the guard keeps a broken one's
    // store inside it. No block to claim: the page is dropped.
    if (lba >= 0 && lba < LBA) page_map[lba] = lands ? static_cast<int32_t>(f) : -1;
  }
  __syncthreads();
  if (tid < B) {  // the erased victim's slots
    slot_lba[vrow + tid] = -1;
    valid[vrow + tid] = 0;
  }
}

template <int MODE>
cudaError_t launch_drain(int drain, int n_drives, const Ptrs& p,
                         const Dims& n, cudaStream_t stream) {
  if (drain == kDrainDemote) {
    gc_one_kernel<MODE, kDrainDemote><<<n_drives, kThreads, 0, stream>>>(
        p, n);
  } else if (drain == kDrainStatic) {
    gc_one_kernel<MODE, kDrainStatic><<<n_drives, kThreads, 0, stream>>>(
        p, n);
  } else {
    gc_one_kernel<MODE, kDrainNone><<<n_drives, kThreads, 0, stream>>>(p, n);
  }
  return cudaGetLastError();
}

}  // namespace

// ptrs: kNumPtrs device pointers (host array) in Ptrs' order (the fault
// hook's all null, or all set; a demoting drain's grp_p and either the
// bloom pair or the FDP rates, all null on any other launch); dims:
// kNumDims sizes in Dims' order; mode: kernel.MODES' index; drain: Drain.
// Returns a CUDA error code (0: launched); cudaErrorInvalidValue for a
// count, size, mode or pointer set the kernel does not take.
extern "C" int gc_one_launch(void* const* ptrs, int n_ptrs,
                             const long long* dims, int n_dims, int n_drives,
                             int mode, int drain, void* stream) {
  if (n_ptrs != kNumPtrs || n_dims != kNumDims || n_drives < 1 ||
      mode < kModeGc || mode > kModeMove) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Ptrs p;
  void** slots = reinterpret_cast<void**>(&p);
  for (int i = 0; i < kNumPtrs; ++i) slots[i] = ptrs[i];
  Dims n;
  int64_t* sizes = reinterpret_cast<int64_t*>(&n);
  for (int i = 0; i < kNumDims; ++i) sizes[i] = dims[i];
  if (n.n_groups < 1 || n.n_groups > kMaxGroups || n.n_blocks < 1 ||
      n.n_blocks > kIntMax || n.pages_per_block < 1 ||
      n.pages_per_block > kMaxPages || (mode == kModeGc && !p.g) ||
      n.retries < 0 || n.retries > 30 || drain < kDrainNone ||
      drain > kDrainDemote) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a demoting drain reads grp_p and one detector's inputs, whole
  const bool bloom = p.bloom_active && p.bloom_passive;
  const bool fdp = p.page_rate && p.fdp_rate;
  const bool any = p.grp_p || p.bloom_active || p.bloom_passive ||
                   p.page_rate || p.fdp_rate;
  const bool demote_ok = p.grp_p && (bloom != fdp) &&
                         (bloom ? !p.page_rate && !p.fdp_rate &&
                                      n.bloom_bits >= 1 &&
                                      n.bloom_bits <= kIntMax
                                : !p.bloom_active && !p.bloom_passive);
  if (drain == kDrainDemote ? !demote_ok : any) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the fault hook's pointers come all together or not at all
  const void* fault[] = {p.retired_blocks, p.spares_left, p.grp_retired,
                         p.drive_status, p.degraded_at, p.n_erase_fail,
                         p.fault_draws, p.n_app, p.fault_rate,
                         p.fault_rate_worn, p.endurance_limit,
                         p.fault_seed};
  for (const void* f : fault) {
    if ((f == nullptr) != (p.fault_draws == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kModeValve:
      return static_cast<int>(launch_drain<kModeValve>(drain, n_drives, p,
                                                       n, s));
    case kModeMove:
      return static_cast<int>(launch_drain<kModeMove>(drain, n_drives, p,
                                                      n, s));
    default:
      return static_cast<int>(launch_drain<kModeGc>(drain, n_drives, p, n,
                                                    s));
  }
}

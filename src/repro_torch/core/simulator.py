"""Event-granularity SSD simulator in PyTorch, for one drive or a batch of
drives run in lock-step.

The counterpart of ``repro.core.simulator``, fault injection included.
One step is one event of an op stream: a WRITE of a page, or (op streams
only) a TRIM of one.

A WRITE:

  1. invalidate the page's old physical slot (counters first; the valid
     bit is cleared with the commit or, on the heavy path, before GC),
  2. pick the target group (§5.6): the page's own under the static
     detector; one group hotter on a promotion by the FDP rate bands or the
     bloom filter pair. A page re-mapped after a TRIM lands in its layout
     group (``page_group0``),
  3. garbage-collect inside the group if it is out of budgeted space (§5.4);
     a drain under the FDP or bloom detector demotes pages one group colder,
  4. append the page to the group's active block,
  5. every h writes: EWMA update frequencies, create or merge groups
     (§5.2, dynamic mode) and re-allocate over-provisioning (§5.1, §5.5),
  6. movement operations (§5.3): at most one compaction GC per step on the
     most block-surplus group.

A write whose group has room in its open block, with the pool above
reserve, no movement surplus and no interval boundary, takes the fast path.
:func:`scan_writes` lands runs of such writes, and every TRIM, on the
device: one ``kernels/write_run`` launch a round lands each drive's run
and stops it before its first heavy write (or one whose bloom insert would
rotate the filter pair); one read of the D stops decides the round, and
the drives that stopped on a heavy write take it through
:func:`_split_write` and :func:`_step_tail` together, masked per drive.
A TRIM frees space and completes no write, so it never stops a run.

The heavy path has one implementation, over a batch: state fields with a
leading drive axis (``SimState.batch`` makes one drive a batch of one),
indices as ``[D]`` tensors, and a ``[D]`` bool mask ``on`` of the drives a
call acts on (None: every drive, and then no select is made). Stores are
gathers and scatters over the drive axis, and a drive outside the mask is
left untouched. Each GC (the group's own, the emergency valve's, a
movement operation's) is one ``kernels/gc_one`` launch for all the drives
the mask enables: it chooses the group and the victim and decides on the
device, as the JAX package's one ``lax.cond`` does, and the bulk drain
runs in the same launch, §5.6 demotion under the FDP and bloom detectors
included, with no host read.

Every other decision that the JAX package expresses as ``lax.cond`` or
``lax.while_loop`` is one read of a ``[D]`` vector, counted in
:data:`host_syncs`, and acts on the drives where it holds; everything
between decisions is enqueued on the device without a read. The
WRITE/TRIM choice and the §5.1 interval boundary are host decisions with
nothing to read: op codes come from numpy, and the write clock ``n_app``
advances by one per WRITE. A round costs one read (where each drive
stopped), and none when no drive has a WRITE left.

Faults (``SimContext.with_faults``; the rates, endurance limit and seed
are per-drive policy): every GC erase may fail, and retire its block into
the spare pool (the JAX package's ``_erase_fault_retire``). The hook runs
inside the ``gc_one`` launch after a bulk drain; after the reference
drain it runs on each drive's view as device ops, with no read.
Retired blocks leave the §5.5 OP budget. A retire that finds the spares
or the pool exhausted degrades the drive; from its next event on every
event is a counted no-op (``n_halted``, the JAX package's ``_halt_wrap``),
which ``write_run`` lands to the segment's end on the device, so a
degraded drive never stops a run and is never in a round's mask.

The reference engine (``SimContext.fast_path=False`` and
``gc_impl="reference"``) is the per-page oracle that the JAX package's own
tests hold its split engine against, kept here for the same use: it is
not a path users pay for. Its step (:func:`_scan_reference`) takes every
event alone, in lock-step over the D drives with no ``write_run`` launch:
a TRIM through one ``apply_trim`` launch, a WRITE through the whole
invalidate, the target group under every detector and the heavy tail.
Its drain (:func:`_gc_drain_reference`) takes a victim's slots one by
one, each page re-targeted on the state as the drain has moved it and
appended through the heavy path's write (one read a page): ``gc_one``
then only decides. Either can be chosen alone, and every pair gives the
same results.

Interval alignment: a drive that stops on the write that completes a §5.1
interval is held (relaunched, it re-stops at once: the run kernel decides
a write before it writes anything) while any drive still has other heavy
writes before its own boundary; then the held drives take their interval
writes in one masked pass. A pure-write batch with one interval length h
thus runs ``n // h`` interval passes, whatever D is.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.allocation import (
    allocate_by_frequency,
    allocate_by_size,
    allocate_closed_form,
    fsum,
)
from repro_torch.core.ssd import (
    CLOSED,
    FREE,
    OPEN,
    STATUS_OK,
    Geometry,
    ManagerConfig,
    SimState,
    bloom_bits,
    surplus_of,
)
from repro_torch.core.workloads import OP_TRIM
from repro_torch.kernels.gc_one.ops import gc_one_
from repro_torch.kernels.gc_one.kernel import FDP_POLICY
from repro_torch.kernels.gc_one.ref import (
    FAULT_POLICY,
    bloom_hashes,
    erase_fault_retire,
)
from repro_torch.kernels.write_path.ops import apply_trim_
from repro_torch.kernels.write_run.kernel import STOP_WHY
from repro_torch.kernels.write_run.ops import write_run_
from repro_torch.utils.spans import span

INT_MAX = 2**31 - 1
# the emergency valve's fixed weight point: pure greedy reclaim
GC_W_GREEDY = (1.0, 0.0, 0.0, 0.0)
# allocation modes that take the §5.5 closed form (fdp_assumed feeds it
# FDP's assumed frequencies instead of the measured ones)
CLOSED_FORM_MODES = ("wolf", "optimal", "fdp_assumed")
GC_IMPLS = ("bulk", "reference")

# device→host reads made for decisions since the count was last set to 0
host_syncs = 0
# the writes that stopped a write_run run, by why (STOP_WHY), since the
# count was last cleared
run_stops = dict.fromkeys(STOP_WHY[1:], 0)
# scan_writes' rounds (one write_run launch each) and its rounds that
# completed §5.1 intervals, since the counts were last set to 0
rounds = 0
interval_batches = 0
# under a torch profiler, each round, heavy tail, GC, interval and read
# is also a span (repro_torch.utils.spans.LAYERS)


@dataclasses.dataclass(frozen=True)
class SimContext:
    """Static context of one run: geometry, policy, and the run's shape.

    For a batch, ``mcfg`` holds what its drives share: the detector,
    movement operations, dynamic groups, the interval length, the group
    slots (``max_groups``, the padded cap) and the paper's constants; what
    may differ per drive (weights, EWMA constant, allocation mode, own
    group cap) is in the policy."""

    geom: Geometry
    mcfg: ManagerConfig
    n_groups: int  # initial groups (may grow in dynamic mode)
    # emit the cumulative (n_app, n_mig) counters after every E-th event
    trace_every: int = 1
    # op-stream mode: the run takes (op, lba) events, and a write that
    # re-maps a trimmed page lands in its layout group (page_group0)
    with_trim: bool = False
    # fault injection: GC erases may fail and retire their blocks, retired
    # capacity leaves the §5.5 budget, and a degraded drive halts. False
    # runs the fault-free step exactly (no launch, no read of its own)
    with_faults: bool = False
    # GC drain: "bulk" (the victim at once, in gc_one's launch) or
    # "reference" (_gc_drain_reference, page by page: the oracle)
    gc_impl: str = "bulk"
    # step engine: True runs the fast events in write_run's runs and only
    # the heavy ones through the tail; False steps every event through the
    # reference step (the oracle). The two give the same results
    fast_path: bool = True

    def __post_init__(self):
        if self.gc_impl not in GC_IMPLS:
            raise ValueError(f"gc_impl {self.gc_impl!r} not in {GC_IMPLS}")
        if not isinstance(self.fast_path, bool):
            raise ValueError(f"fast_path must be a bool, not "
                             f"{self.fast_path!r}")

    @property
    def h(self) -> int:
        return max(16, int(self.geom.lba_pages * self.mcfg.interval_frac))

    @property
    def f_min_pages(self) -> int:
        return self.geom.n_luns * self.geom.pages_per_block


# the policy's per-drive tensors, each with a leading drive axis (the
# fault policy's only with faults)
POLICY_TENSORS = (
    "gc_w", "gc_w_greedy", "h", "ewma_a", "max_groups", "assumed_p",
    "fdp_rate", "page_rate", "page_group0", "use_assumed", "alloc_closed",
    "alloc_freq", *FAULT_POLICY,
)


def policy_from_config(ctx: SimContext, device, *, assumed_p=None,
                       fdp_rate=None, page_rate=None,
                       page_group0=None) -> dict:
    """A drive's policy as the values the step reads, each with a leading
    drive axis of 1 (:func:`stack_policies` joins drives): float weights
    [1, 4], the §5.1 constants, the drive's group cap, FDP's assumption
    arrays [1, G], the oracle's per-page rates [1, LBA] and the layout
    groups [1, LBA] as device tensors (zeros where not given); the
    allocation mode as a host tuple, with its masks. With faults, the
    fault rates, the endurance limit (INT_MAX when there is none) and the
    seed (its low 32 bits) as well."""
    if ctx.mcfg.has_faults and not ctx.with_faults:
        raise ValueError("the configuration can fail erases: its context "
                         "needs with_faults=True")
    g_max, lba = ctx.mcfg.max_groups, ctx.geom.lba_pages
    mode = ctx.mcfg.alloc_mode

    def f32(x, n):
        if x is None:
            return torch.zeros((1, n), dtype=torch.float32, device=device)
        return torch.as_tensor(np.asarray(x, np.float32),
                               device=device).reshape(1, n)

    def one(v, dtype):
        return torch.tensor([v], dtype=dtype, device=device)

    policy = {
        "alloc_mode": (mode,),
        "gc_w": torch.tensor([ctx.mcfg.gc_weights()], dtype=torch.float32,
                             device=device),
        "gc_w_greedy": torch.tensor([GC_W_GREEDY], dtype=torch.float32,
                                    device=device),
        "h": one(ctx.h, torch.int32),
        "ewma_a": one(ctx.mcfg.ewma_a, torch.float32),
        "max_groups": one(ctx.mcfg.max_groups, torch.int32),
        "assumed_p": f32(assumed_p, g_max),
        "fdp_rate": f32(fdp_rate, g_max),
        "page_rate": f32(page_rate, lba),
        "use_assumed": one(mode == "fdp_assumed", torch.bool),
        "alloc_closed": one(mode in CLOSED_FORM_MODES, torch.bool),
        "alloc_freq": one(mode == "freq", torch.bool),
    }
    if ctx.with_faults:
        mcfg = ctx.mcfg
        policy.update(
            fault_rate=one(mcfg.fault_rate, torch.float32),
            fault_rate_worn=one(mcfg.fault_rate_worn, torch.float32),
            endurance_limit=one(mcfg.endurance_pe_limit
                                if mcfg.endurance_pe_limit > 0 else INT_MAX,
                                torch.int32),
            fault_seed=one(mcfg.fault_seed & 0xFFFFFFFF, torch.int64),
        )
    if ctx.with_trim:
        if page_group0 is None:
            raise ValueError("an op-stream run needs page_group0")
        policy["page_group0"] = torch.as_tensor(
            np.asarray(page_group0, np.int64), device=device).reshape(1, lba)
    return policy


def stack_policies(policies) -> dict:
    """The drives' policies (each from :func:`policy_from_config`) as one
    batch's, in order."""
    out = {"alloc_mode": sum((p["alloc_mode"] for p in policies), ())}
    for k in POLICY_TENSORS:
        if k in policies[0]:
            out[k] = torch.cat([p[k] for p in policies])
    return out


# ---------------------------------------------------------------------------
# device indexing and host decisions
# ---------------------------------------------------------------------------
#
# The heavy path indexes a batch's [D, N] fields with a [D] index, one
# element a drive: _gat gathers, _sca and _acc scatter.

_made = {}  # (what, D, device) -> a constant [D] tensor


def _one_each(n: int, device) -> torch.Tensor:
    """An int32 1 for each of n drives, made once per (n, device)."""
    key = ("ones", n, str(device))
    if key not in _made:
        _made[key] = torch.ones(n, dtype=torch.int32, device=device)
    return _made[key]


def _drives(n: int, device) -> torch.Tensor:
    """The drive indices 0..n-1, made once per (n, device)."""
    key = ("rows", n, str(device))
    if key not in _made:
        _made[key] = torch.arange(n, device=device)
    return _made[key]


def _col(i: torch.Tensor) -> torch.Tensor:
    """A [D] index as the [D, 1] int64 column gather and scatter take (the
    dtype tested on the host: a conversion call costs a dispatch even when
    it returns its input)."""
    return (i if i.dtype == torch.int64 else i.long()).unsqueeze(1)


def _vals(v: torch.Tensor, dtype) -> torch.Tensor:
    """[D] values as the [D, 1] column of ``dtype`` a scatter takes."""
    return (v if v.dtype == dtype else v.to(dtype)).unsqueeze(1)


def _gat(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[d, i[d]]`` for each drive d of a [D, N] tensor: [D], a copy."""
    return t.gather(1, _col(i)).squeeze(1)


def _sca(t: torch.Tensor, i: torch.Tensor, v, on=None) -> None:
    """``t[d, i[d]] = v[d]`` in place for the drives ``on`` selects (every
    drive when None). A Python scalar goes to the kernel as an argument:
    a scalar made into a CUDA tensor would be a host→device copy, which
    waits for the stream."""
    idx = _col(i)
    if on is not None:
        v = torch.where(on, v, t.gather(1, idx).squeeze(1))
    if isinstance(v, torch.Tensor):
        t.scatter_(1, idx, _vals(v, t.dtype))
    else:
        t.scatter_(1, idx, v)


def _acc(t: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> None:
    """``t[d, i[d]] += v[d]`` in place (a drive left out adds 0)."""
    t.scatter_add_(1, _col(i), _vals(v, t.dtype))


def _row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Each drive's row ``t[d, i[d]]`` of a [D, N, M] tensor: [D, M]."""
    return t[_drives(t.shape[0], t.device), i.long()]


def _put_row(t: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> None:
    """``t[d, i[d]] = v[d]`` for each drive's row of a [D, N, M] tensor."""
    t.index_put_((_drives(t.shape[0], t.device), i.long()), v.to(t.dtype))


def _ones_on(st: SimState, on) -> torch.Tensor:
    """An int32 1 for each drive ``on`` selects, 0 for the rest."""
    if on is None:
        return _one_each(st.n_drives, st.device)
    return on.to(torch.int32)


def _read(t: torch.Tensor) -> np.ndarray:
    """A decision: one read of a (small) device tensor on the host,
    counted in :data:`host_syncs`."""
    global host_syncs
    host_syncs += 1
    with span("host.sync"):
        return t.cpu().numpy()


def _on(sel: np.ndarray, pred: torch.Tensor):
    """The mask of a decision read as ``sel`` from ``pred``: None when it
    holds on every drive (no select needed), else ``pred`` itself."""
    return None if sel.all() else pred


def _and(pred: torch.Tensor, on) -> torch.Tensor:
    return pred if on is None else pred & on


# ---------------------------------------------------------------------------
# primitive state updates (a batch, masked per drive)
# ---------------------------------------------------------------------------

def _pop_free_block(st: SimState, g, on=None):
    """Claim each selected drive's lowest FREE block for its group g[d]
    (it becomes the group's OPEN active block); masked to a no-op where
    the pool is empty."""
    free_mask = st.state == FREE
    blk = torch.argmax(free_mask.to(torch.int32), dim=1)
    ok = _and(_gat(free_mask, blk), on)
    d = ok.to(torch.int32)
    _acc(st.grp_phys, g, d)
    _sca(st.state, blk, torch.where(ok, OPEN, _gat(st.state, blk)))
    _sca(st.group_of, blk, torch.where(ok, g, _gat(st.group_of, blk)))
    _sca(st.fill, blk, torch.where(ok, 0, _gat(st.fill, blk)))
    # LRU clock: a block's age is its claim time
    _sca(st.stamp, blk, torch.where(ok, st.clock, _gat(st.stamp, blk)))
    st.grp_surplus.copy_(surplus_of(st.grp_active, st.grp_phys, st.grp_alloc))
    st.free_blocks.sub_(d)
    st.clock.add_(d)
    return blk, ok


def _write_page(ctx: SimContext, st: SimState, lba, g, on=None, *,
                migration: bool = False) -> None:
    """Append each selected drive's page ``lba[d]`` to its group g[d]'s
    active block, allocating a fresh block where it is full (one read:
    which drives need a block): the heavy path's application write, or
    with ``migration`` a GC migration, counted in ``n_mig`` where it
    lands. A drive outside ``on`` is left untouched, its map too."""
    b = ctx.geom.pages_per_block
    blk = _gat(st.active_blk, g)
    blk_c = blk.clamp(min=0).long()
    blk_full = torch.where(blk >= 0, _gat(st.fill, blk_c) >= b, True)
    need = _and(blk_full, on)
    sel = _read(need)
    if sel.any():
        m = _on(sel, need)
        seal = _and(blk >= 0, m)
        _sca(st.state, blk_c, torch.where(seal, CLOSED,
                                          _gat(st.state, blk_c)))
        new_blk, ok = _pop_free_block(st, g, m)
        _sca(st.active_blk, g, torch.where(ok, new_blk, blk))
        blk = _gat(st.active_blk, g)
        blk_c = blk.clamp(min=0).long()
    slot = _gat(st.fill, blk_c)
    # overflow guard: an empty pool leaves the block full — the write is
    # dropped and counted (tests assert it never fires)
    ok = (blk >= 0) & (slot < b)
    landed = _and(ok, on)
    one = landed.to(torch.int32)
    flat = blk_c * b + slot.clamp(max=b - 1)
    d = st.n_drives
    slot_lba, valid = st.slot_lba.view(d, -1), st.valid.view(d, -1)
    _sca(slot_lba, flat, torch.where(landed, lba, _gat(slot_lba, flat)))
    _sca(valid, flat, landed | _gat(valid, flat))
    _acc(st.fill, blk_c, one)
    _acc(st.live, blk_c, one)
    _sca(st.page_map, lba, torch.where(ok, blk * b + slot, -1), on)
    _acc(st.grp_size, g, one)
    _acc(st.grp_live, g, one)
    st.mapped_pages.add_(one)
    st.n_dropped.add_(_and(~ok, on).to(torch.int32))
    if migration:
        st.n_mig.add_(one)


def _invalidate_counts(ctx: SimContext, st: SimState, lba, on=None):
    """The counter half of an invalidate, for the selected drives:
    live/grp_size/grp_live/mapped_pages decrements and the old-group
    lookup, without the valid-bit clear (the fused write, the TRIM or
    :func:`_clear_valid` does that). Returns (old_g, old_pm) [D]; old_g is
    0 for an unmapped page, old_pm -1 for it and for a drive left out."""
    b = ctx.geom.pages_per_block
    pm = _gat(st.page_map, lba)
    if on is not None:
        pm = torch.where(on, pm, -1)
    has = pm >= 0
    blk = pm.clamp(min=0).long() // b
    old_g = _gat(st.group_of, blk)
    d_g = torch.where(has & (old_g >= 0), -1, 0)
    og_c = old_g.clamp(min=0)
    _acc(st.live, blk, torch.where(has, -1, 0))
    _acc(st.grp_size, og_c, d_g)
    _acc(st.grp_live, og_c, d_g)
    st.mapped_pages.sub_(has.to(torch.int32))
    return torch.where(has, old_g, 0).long(), pm


def _clear_valid(ctx: SimContext, st: SimState, pm) -> None:
    """Complete a deferred invalidate: clear each old slot's valid bit
    (nothing where ``pm`` is -1)."""
    has = pm >= 0
    flat = pm.clamp(min=0).long()
    valid = st.valid.view(st.n_drives, -1)
    _sca(valid, flat, ~has & _gat(valid, flat))


def _invalidate(ctx: SimContext, st: SimState, lba, on=None):
    """The whole invalidate of each selected drive's page ``lba[d]``: the
    counter half, then the valid-bit clear (the reference step's). Returns
    (old_g, old_pm) as :func:`_invalidate_counts`."""
    old_g, old_pm = _invalidate_counts(ctx, st, lba, on)
    _clear_valid(ctx, st, old_pm)
    return old_g, old_pm


def _trim_page(ctx: SimContext, st: SimState, lba, on=None) -> None:
    """The TRIM of each selected drive's page ``lba[d]``: the invalidate
    counts, one ``apply_trim_`` launch (unmap, clear the valid bit) for
    the batch, the killed slot tallied in its block's ``trim_dead``, and
    ``n_trim``. A re-trim of an unmapped page counts in ``n_trim`` alone.
    A TRIM frees space and completes no write: it has no heavy path."""
    _, old_pm = _invalidate_counts(ctx, st, lba, on)
    one = _ones_on(st, on)
    apply_trim_(torch.stack([lba.to(torch.int32), old_pm, one], 1),
                st.page_map, st.valid)
    has = old_pm >= 0
    _acc(st.trim_dead, old_pm.clamp(min=0).long() // ctx.geom.pages_per_block,
         has.to(torch.int32))
    st.n_trim.add_(one)


# ---------------------------------------------------------------------------
# temperature detection — §5.6 (+ the oracle FDP bands of §6)
# ---------------------------------------------------------------------------

def _hit_rates(st) -> torch.Tensor:
    """Per-page update rate of each group over its mapped pages (grp_live);
    -1 for inactive groups (over the last axis: one drive or a batch)."""
    s = st.grp_live.to(torch.float32).clamp(min=1.0)
    return torch.where(st.grp_active, st.grp_p / s, -1.0)


def _sgv_neighbors(st: SimState):
    """hotter/colder neighbour by current hit-rate order, from a stable
    argsort: the oracle that :func:`_neighbor_hotter` and
    :func:`_neighbor_colder` are held to in the tests (one drive).
    Returns ``neighbor(g, delta)``."""
    hr = _hit_rates(st)
    g_max = hr.shape[0]
    order = torch.argsort(-hr, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(g_max, device=hr.device)
    n_active = int(st.grp_active.sum())

    def neighbor(g, delta):
        return int(order[min(max(int(rank[g]) + delta, 0), n_active - 1)])

    return neighbor


def _neighbor_hotter(hr, active, g):
    """The next hotter active group of g in the stable (-hr, index) order:
    the candidate (hotter, or as hot with a lower index) with the lowest
    hit rate, ties to the highest index; g itself when it is the hottest.
    Over the last axis: hr [G] with a 0-d g, or [D, G] with g [D]."""
    idx = torch.arange(hr.shape[-1], device=hr.device)
    g_ = g.long().unsqueeze(-1)
    hr_g = hr.gather(-1, g_)
    cand = active & ((hr > hr_g) | ((hr == hr_g) & (idx < g_)))
    min_hr = torch.where(cand, hr, torch.inf).amin(-1, keepdim=True)
    nb = torch.where(cand & (hr == min_hr), idx, -1).amax(-1)
    return torch.where(cand.any(-1), nb, g)


def _neighbor_colder(hr, active, g):
    """The next colder active group of g in the stable (-hr, index) order:
    the candidate (colder, or as cold with a higher index) with the highest
    hit rate, ties to the lowest index. With no candidate an active g stays
    put and an inactive g falls to the coldest active group (argsort's
    ``clip(rank + 1, n_active - 1)``; a GC drain's group is always active:
    ``kernels/gc_one``'s ``colder_neighbor``). Over the last axis, as
    :func:`_neighbor_hotter`."""
    g_max = hr.shape[-1]
    idx = torch.arange(g_max, device=hr.device)
    g_ = g.long().unsqueeze(-1)
    hr_g = hr.gather(-1, g_)
    cand = active & ((hr < hr_g) | ((hr == hr_g) & (idx > g_)))
    best_hr = torch.where(cand, hr, -2.0).amax(-1, keepdim=True)
    nb = torch.where(cand & (hr == best_hr), idx, g_max).amin(-1)
    cold_hr = torch.where(active, hr, torch.inf).amin(-1, keepdim=True)
    coldest = torch.where(active & (hr == cold_hr), idx, -1).amax(-1)
    fallback = torch.where(active.gather(-1, g_).squeeze(-1), g, coldest)
    return torch.where(cand.any(-1), nb, fallback)


def _bloom_hashes(ctx: SimContext, lba):
    """The JAX package's two uint32 hashes of ``lba`` (int tensor, any
    shape, non-negative) mod the context's filter width, and the width."""
    bits = bloom_bits(ctx.geom, ctx.mcfg)
    return (*bloom_hashes(lba, bits), bits)


def _bloom_in(ctx: SimContext, filt, lba, g):
    """Whether each drive's ``lba[d]`` is in its group g[d]'s filter of
    the batch's filters ``filt`` [D, G, bits]."""
    h1, h2, bits = _bloom_hashes(ctx, lba)
    flat = filt.view(filt.shape[0], -1)
    return _gat(flat, g * bits + h1) & _gat(flat, g * bits + h2)


def _bloom_update(ctx: SimContext, st: SimState, lba, g, on=None):
    """Insert each selected drive's ``lba[d]`` into its group g[d]'s active
    filter, and rotate the pair where the group's write count reaches its
    size. The rotation is row-masked, not a branch, so the bloom detector
    adds no host read. Returns whether each page was in both filters
    before the insert."""
    h1, h2, bits = _bloom_hashes(ctx, lba)
    d = st.n_drives
    act, pas = st.bloom_active.view(d, -1), st.bloom_passive.view(d, -1)
    i1, i2 = g * bits + h1, g * bits + h2
    in_both = (_gat(act, i1) & _gat(act, i2)
               & _gat(pas, i1) & _gat(pas, i2))
    if on is None:
        _sca(act, i1, True)
        _sca(act, i2, True)
    else:
        _sca(act, i1, on | _gat(act, i1))
        _sca(act, i2, on | _gat(act, i2))
    _acc(st.bloom_writes, g, _ones_on(st, on))
    writes = _gat(st.bloom_writes, g)
    rotate = _and(writes >= _gat(st.grp_size, g).clamp(
        min=ctx.mcfg.bloom_rotate_min_writes), on)
    row = _row(st.bloom_active, g)
    _put_row(st.bloom_passive, g,
             torch.where(rotate[:, None], row, _row(st.bloom_passive, g)))
    _put_row(st.bloom_active, g, row & ~rotate[:, None])
    _sca(st.bloom_writes, g, torch.where(rotate, 0, writes))
    return in_both


def _target_group_app(ctx: SimContext, st: SimState, lba, cur_g, policy,
                      on=None):
    """Target group of each drive's application write of ``lba[d]`` living
    in cur_g[d]: cur_g under the static detector; the next hotter group
    when FDP's oracle rate beats twice the group's assumed rate, or when
    the page is in both bloom filters."""
    td = ctx.mcfg.td_mode
    if td == "static":
        return cur_g
    if td == "fdp":
        r = _gat(policy["page_rate"], lba)
        promote = r > 2.0 * _gat(policy["fdp_rate"], cur_g)
    elif td == "bloom":
        promote = _bloom_update(ctx, st, lba, cur_g, on)
    else:
        raise ValueError(f"unknown td_mode {td!r}")
    nb = _neighbor_hotter(_hit_rates(st), st.grp_active, cur_g)
    return torch.where(promote, nb, cur_g)


def _target_group_gc(ctx: SimContext, st: SimState, lba, cur_g, policy,
                     on=None):
    """Target group of each selected drive's GC migration of ``lba[d]``
    out of cur_g[d] (the reference drain's, page by page): cur_g under the
    static detector, and for a drive left out; the next colder group when
    FDP's oracle rate is below half the group's assumed rate, or when the
    page is in neither bloom filter. It reads the state as it is now."""
    td = ctx.mcfg.td_mode
    if td == "static":
        return cur_g
    if td == "fdp":
        demote = (_gat(policy["page_rate"], lba)
                  < 0.5 * _gat(policy["fdp_rate"], cur_g))
    elif td == "bloom":
        demote = (~_bloom_in(ctx, st.bloom_active, lba, cur_g)
                  & ~_bloom_in(ctx, st.bloom_passive, lba, cur_g))
    else:
        raise ValueError(f"unknown td_mode {td!r}")
    nb = _neighbor_colder(_hit_rates(st), st.grp_active, cur_g)
    return torch.where(_and(demote, on), nb, cur_g)


# ---------------------------------------------------------------------------
# garbage collection (one victim) — §5.4
# ---------------------------------------------------------------------------

def _gc_drain_reference(ctx: SimContext, st: SimState, victim, g, policy,
                        on=None) -> None:
    """Migrate each selected drive's ``victim[d]`` of group g[d] page by
    page, then erase it (the JAX package's ``_gc_drain_reference``, the
    oracle the bulk drains are held to). For each victim slot in order:
    clear its valid bit and its block's live count where it is live, read
    the page's target group from the state as it is now
    (:func:`_target_group_gc`), take the page out of g's counts, and
    append it through :func:`_write_page` as a migration, masked to the
    drives whose slot is live. No read beyond the append's."""
    b = ctx.geom.pages_per_block
    d = st.n_drives
    slot_lba, valid = st.slot_lba.view(d, -1), st.valid.view(d, -1)
    # a drive left out may hold -1 (gc_one's out): any index will do
    victim, g = victim.clamp(min=0), g.clamp(min=0)
    base = victim * b
    for j in range(b):
        flat = base + j
        lba = _gat(slot_lba, flat).clamp(min=0)  # dead slots hold -1
        was = _gat(valid, flat)
        live = _and(was, on)
        _sca(valid, flat, was & ~live)
        minus = -live.to(torch.int32)
        _acc(st.live, victim, minus)
        g_tgt = _target_group_gc(ctx, st, lba, g, policy, live)
        _acc(st.grp_size, g, minus)
        _acc(st.grp_live, g, minus)
        st.mapped_pages.add_(minus)
        _write_page(ctx, st, lba, g_tgt, live, migration=True)
    _erase_victims(st, victim, g, on)


def _erase_victims(st: SimState, victim, g, on=None) -> None:
    """Erase each selected drive's drained ``victim[d]`` of group g[d]:
    FREE, unlabelled, empty, stamped with the clock (which advances), one
    more P-E cycle (Σe² gains (e+1)² − e²), its trimmed-slot tally
    cleared, its group's block back in the pool."""
    one = _ones_on(st, on)
    e_old = _gat(st.erase_count, victim)
    for t, v in ((st.state, FREE), (st.group_of, -1), (st.fill, 0),
                 (st.live, 0), (st.stamp, st.clock), (st.trim_dead, 0)):
        _sca(t, victim, v, on)
    erased = (one > 0)[:, None]
    _put_row(st.slot_lba, victim,
             torch.where(erased, -1, _row(st.slot_lba, victim)))
    _put_row(st.valid, victim, ~erased & _row(st.valid, victim))
    st.clock.add_(one)
    _acc(st.grp_phys, g, -one)
    st.grp_surplus.copy_(surplus_of(st.grp_active, st.grp_phys, st.grp_alloc))
    st.free_blocks.add_(one)
    st.n_erase.add_(one)
    _acc(st.erase_count, victim, one)
    st.erase_total.add_(one)
    st.erase_sq_total.add_((2 * e_old + 1) * one)


_GC_SPANS = {m: f"gc.{m}" for m in ("gc", "valve", "movement")}


def _gc_one(ctx: SimContext, st: SimState, policy, mode: str,
            g=None, on=None) -> None:
    """One GC (§5.4) for each selected drive, in one ``gc_one_`` launch:
    the group by ``mode`` ("gc": g[d], enabled when it needs a block it is
    not entitled to or the pool is at reserve; "valve": where the fewest
    live pages are, greedy weights; "movement": the most block-surplus
    group), the victim, and the decision, all on the device. With the bulk
    drain, the drain runs in the same launch (demoting under the FDP and
    bloom detectors), without a host read, and with faults its erase goes
    through the retire hook there too. With the reference drain the launch
    only decides: after one read of the D decisions, the reference drain
    for every deciding drive at once, then, with faults, the hook drive by
    drive as device ops."""
    with span(_GC_SPANS[mode]):
        gc_w = policy["gc_w_greedy" if mode == "valve" else "gc_w"]
        out = torch.empty((st.n_drives, 3), dtype=torch.int64,
                          device=st.device)
        drain = ctx.gc_impl == "bulk"
        faults = ({k: policy[k] for k in FAULT_POLICY} if ctx.with_faults
                  else None)
        fdp = drain and ctx.mcfg.td_mode == "fdp"
        retries = ctx.mcfg.erase_max_retries
        gc_one_(st.drive_axis, gc_w, None if g is None else g.long(), out,
                on, faults if drain else None,
                {k: policy[k] for k in FDP_POLICY} if fdp else None,
                mode=mode, td_mode=ctx.mcfg.td_mode, drain=drain,
                gc_reserve_blocks=ctx.mcfg.gc_reserve_blocks,
                erase_max_retries=retries)
        if drain:
            return
        do = out[:, 2] != 0
        sel = _read(do)
        if not sel.any():
            return
        _gc_drain_reference(ctx, st, out[:, 0], out[:, 1], policy,
                            _on(sel, do))
        if faults is None:
            return
        for d in np.flatnonzero(sel).tolist():
            erase_fault_retire(st.drive(d), out[d, 0], out[d, 1],
                               {k: v[d] for k, v in faults.items()}, retries)


# ---------------------------------------------------------------------------
# over-provisioning allocation and groups (interval) — §5.1, §5.2, §5.5
# ---------------------------------------------------------------------------

def _select(mask: torch.Tensor, modes, want: bool, a, b):
    """``where(mask, a(), b())`` row by row, with the mask's host copy
    ``modes`` (a bool a drive): only the side some drive takes is made."""
    if all(m == want for m in modes):
        return a()
    if not any(m == want for m in modes):
        return b()
    return torch.where(mask.unsqueeze(-1), a(), b())


def _recompute_alloc(ctx: SimContext, st: SimState, policy, on=None) -> None:
    """§5.5 for the selected drives, each by its own allocation mode."""
    geom, mcfg = ctx.geom, ctx.mcfg
    b = geom.pages_per_block
    active = st.grp_active
    modes = policy["alloc_mode"]
    # EFFECTIVE group sizes (carried grp_live == mapped pages per group):
    # trimmed pages leave s, so their space re-enters the OP budget
    s = torch.where(active, st.grp_live.to(torch.float32), 0.0)
    s = torch.maximum(s, active.to(torch.float32))
    freq = _select(policy["use_assumed"],
                   [m == "fdp_assumed" for m in modes], True,
                   lambda: policy["assumed_p"], lambda: st.grp_p)
    p = torch.where(active, freq, 0.0)
    p = p / torch.clamp(fsum(p), min=1e-9).unsqueeze(-1)
    # usable OP = spare pages beyond logical content, minus the GC reserve
    # and one block per active group
    n_active = active.sum(-1, dtype=torch.int32)
    op_total = (
        float(geom.pba_pages)
        - (mcfg.gc_reserve_blocks + 1 + n_active) * b
        - fsum(s)
    )
    if ctx.with_faults:
        # retired capacity leaves the OP budget (a drive that retired
        # nothing subtracts exactly 0)
        op_total = op_total - st.retired_blocks.to(torch.float32) * b

    def closed():
        return allocate_closed_form(
            s, p, op_total,
            cold_rule=True,
            cold_hit_rate_frac=mcfg.cold_hit_rate_frac,
            cold_op_frac=mcfg.cold_op_frac,
        )

    def by_freq_or_size():
        return _select(policy["alloc_freq"], [m == "freq" for m in modes],
                       True, lambda: allocate_by_frequency(p, op_total),
                       lambda: allocate_by_size(s, op_total))

    op = _select(policy["alloc_closed"],
                 [m in CLOSED_FORM_MODES for m in modes], True, closed,
                 by_freq_or_size)
    alloc_blocks = torch.ceil((s + op) / b).to(torch.int32)
    alloc_blocks = torch.where(active, alloc_blocks.clamp(min=1), 0)
    if on is not None:
        alloc_blocks = torch.where(on[:, None], alloc_blocks, st.grp_alloc)
    st.grp_alloc.copy_(alloc_blocks)
    st.grp_surplus.copy_(surplus_of(active, st.grp_phys, st.grp_alloc))


def _maybe_create_or_merge(ctx: SimContext, st: SimState, policy,
                           on=None) -> None:
    """§5.2 dynamic groups for the selected drives, at most one create and
    one merge per interval each.

    Create: a new group, seeded with half the hottest group's frequency,
    when the drive has a slot under its own group cap, the hottest group
    is at least ``q_create``× hotter per page than the second and holds
    ``f_min_pages``. Merge: the hottest adjacent pair (in hit-rate order)
    whose ratio fell below 1.3, or whose hotter member shrank below
    ``f_min_pages``, becomes one group (blocks relabelled, the hotter
    group's active block sealed). Both wait out a cooldown of
    ``w_intervals``. Sorts are stable, as JAX's; two host reads.
    """
    mcfg = ctx.mcfg
    f_min = ctx.f_min_pages
    hr = _hit_rates(st)
    order = torch.argsort(-hr, dim=1, stable=True)  # hottest first
    hottest, second = order[:, 0], order[:, 1]
    n_active = st.grp_active.sum(1)
    hot_ratio = _gat(hr, hottest) / _gat(hr, second).clamp(min=1e-12)
    create = _and(
        (n_active < policy["max_groups"])
        & (st.cooldown == 0)
        & (n_active >= 2)
        & (hot_ratio >= mcfg.q_create)
        & (_gat(st.grp_size, hottest) >= f_min), on)
    sel = _read(create)
    if sel.any():
        m = _on(sel, create)
        slot = torch.argmin(st.grp_active.to(torch.int32), dim=1)  # first
        _sca(st.grp_active, slot, True, m)                        # inactive
        _sca(st.grp_phys, slot, 0, m)
        _sca(st.grp_p, slot, _gat(st.grp_p, hottest) * 0.5, m)
        _sca(st.grp_size, slot, 0, m)
        _sca(st.grp_live, slot, 0, m)
        st.grp_surplus.copy_(
            surplus_of(st.grp_active, st.grp_phys, st.grp_alloc))
        _sca(st.grp_created, slot, st.interval, m)
        if m is None:
            st.cooldown.fill_(mcfg.w_intervals)
        else:
            st.cooldown.masked_fill_(m, mcfg.w_intervals)

    hr = _hit_rates(st)
    order = torch.argsort(-hr, dim=1, stable=True)
    g_max = hr.shape[1]
    n_active = st.grp_active.sum(1)
    hr_sorted = hr.gather(1, order)
    hr_next = torch.roll(hr_sorted, -1, dims=1)
    valid_pair = (torch.arange(g_max, device=hr.device)
                  + 1 < n_active[:, None])
    ratio = hr_sorted / hr_next.clamp(min=1e-12)
    converged = valid_pair & (ratio < 1.3) & (hr_sorted > 0)
    tiny = (valid_pair & (st.grp_size.gather(1, order) < f_min)
            & (hr_next > 0))
    mergeable = converged | tiny
    pair_i = torch.argmax(mergeable.to(torch.int32), dim=1)
    do_merge = _and(_gat(mergeable, pair_i) & (st.cooldown == 0)
                    & (n_active > 2), on)
    sel = _read(do_merge)
    if sel.any():
        m = _on(sel, do_merge)
        g_from = _gat(order, pair_i)                          # hotter
        g_to = _gat(order, (pair_i + 1).clamp(max=g_max - 1))  # colder
        relabel = st.group_of == g_from[:, None]
        if m is not None:
            relabel = relabel & m[:, None]
        st.group_of.copy_(torch.where(relabel, g_to[:, None], st.group_of))
        ab = _gat(st.active_blk, g_from)    # no longer reachable: seal it
        ab_c = ab.clamp(min=0)
        _sca(st.state, ab_c, torch.where(_and(ab >= 0, m), CLOSED,
                                         _gat(st.state, ab_c)))
        merged = (st.grp_size, st.grp_live, st.grp_phys, st.grp_p,
                  st.grp_writes)
        if ctx.with_faults:  # RETIRED blocks keep their group label
            merged += (st.grp_retired,)
        for arr in merged:
            _sca(arr, g_to, _gat(arr, g_to) + _gat(arr, g_from), m)
            _sca(arr, g_from, 0, m)
        _sca(st.active_blk, g_from, -1, m)
        _sca(st.grp_active, g_from, False, m)
        st.grp_surplus.copy_(
            surplus_of(st.grp_active, st.grp_phys, st.grp_alloc))
        if m is None:
            st.cooldown.fill_(mcfg.w_intervals)
        else:
            st.cooldown.masked_fill_(m, mcfg.w_intervals)


def _fma32(x, y, z):
    """``x * y + z`` on float32 tensors with ONE rounding, as the JAX
    package's compiled EWMA rounds it (XLA:CPU contracts the multiply-add
    into a fused one). The product is exact in float64; the sum is taken in
    float64 rounded to odd (its error from TwoSum, the last bit forced when
    inexact), so the final rounding to float32 is the correct one."""
    prod = x.double() * y.double()
    zz = z.double()
    s = prod + zz
    bb = s - prod
    err = (prod - (s - bb)) + (zz - bb)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even,
                    torch.nextafter(s, torch.where(err > 0, torch.inf,
                                                   -torch.inf)), s)
    return s.to(torch.float32)


def _interval_update(ctx: SimContext, st: SimState, policy, on=None) -> None:
    """§5.1 for the selected drives: the EWMA of each group's update
    frequency (each drive's own constant), the interval clock and
    cooldown, §5.2 groups and the §5.5 allocation."""
    with span("sim.interval"):
        a = policy["ewma_a"].unsqueeze(1)
        u = st.grp_writes.to(torch.float32) / policy["h"].to(
            torch.float32).unsqueeze(1)
        grp_p = torch.where(st.grp_active,
                            _fma32(st.grp_p, 1.0 - a, a * u), 0.0)
        if on is None:
            st.grp_p.copy_(grp_p)
            st.grp_writes.zero_()
            st.interval.add_(1)
            st.cooldown.copy_((st.cooldown - 1).clamp(min=0))
        else:
            st.grp_p.copy_(torch.where(on[:, None], grp_p, st.grp_p))
            st.grp_writes.masked_fill_(on[:, None], 0)
            st.interval.add_(on.to(torch.int32))
            st.cooldown.sub_(((st.cooldown > 0) & on).to(torch.int32))
        if ctx.mcfg.dynamic_groups:
            _maybe_create_or_merge(ctx, st, policy, on)
        _recompute_alloc(ctx, st, policy, on)


# ---------------------------------------------------------------------------
# the step + runner
# ---------------------------------------------------------------------------

def _step_tail(ctx: SimContext, st: SimState, lba, interval: bool, g,
               policy, on=None) -> None:
    """GC → emergency valve → write → movement ops → §5.1 interval update:
    the heavy path of each selected drive, downstream of invalidate +
    target selection. ``interval``: the write completes a §5.1 interval
    on every drive it acts on (True) or on none (False); or a [D] mask of
    the drives whose write completes one."""
    mcfg = ctx.mcfg

    # GC when the group needs a new block it is not entitled to, or the
    # pool is at reserve (the predicate is read on the device)
    _gc_one(ctx, st, policy, "gc", g, on)

    # emergency valve: while the pool is (nearly) empty, greedily reclaim
    # the best victim anywhere (its group pays), a bounded number of times
    for _ in range(mcfg.valve_max_tries):
        low = _and(st.free_blocks < 2, on)
        sel = _read(low)
        if not sel.any():
            break
        _gc_one(ctx, st, policy, "valve", on=_on(sel, low))

    _write_page(ctx, st, lba, g, on)
    one = _ones_on(st, on)
    st.n_app.add_(one)
    _acc(st.grp_writes, g, one)

    # movement operations (§5.3): one compaction GC on the most surplus
    # group, donating the redeemed block to the pool
    if mcfg.movement_ops:
        _gc_one(ctx, st, policy, "movement", on=on)

    if isinstance(interval, torch.Tensor):
        _interval_update(ctx, st, policy, _and(interval, on))
    elif interval:
        _interval_update(ctx, st, policy, on)


def _resolve_group(st: SimState, old_g, had_mapping, lba, page_group0):
    """Residence group of each drive's written page: its old group when it
    was mapped; after a TRIM its layout group, or the first active group
    when §5.2 merged that one away."""
    pg0 = _gat(page_group0, lba)
    first_active = torch.argmax(st.grp_active.to(torch.int32), dim=1)
    pg0 = torch.where(_gat(st.grp_active, pg0), pg0, first_active)
    return torch.where(had_mapping, old_g, pg0)


def _split_write(ctx: SimContext, st: SimState, lba, interval: bool, policy,
                 on=None) -> None:
    """The writes ``lba`` [D] that stopped the selected drives' runs of
    ``write_run_``: the invalidate counts, the target group, then
    :func:`_step_tail` (GC, the valve, the append, movement, the interval
    when ``interval``). A write that stopped a run for a bloom rotation
    alone passes every heavy predicate, and the tail lands it as the run
    would have, with the rotation."""
    with span("sim.heavy_tail"):
        g, old_pm = _invalidate_counts(ctx, st, lba, on)
        if ctx.with_trim:
            g = _resolve_group(st, g, old_pm >= 0, lba,
                               policy["page_group0"])
        if ctx.mcfg.td_mode != "static":
            old_g = g
            g = _target_group_app(ctx, st, lba, old_g, policy, on)
            g = torch.where(_gat(st.grp_active, g), g, old_g)
        _clear_valid(ctx, st, old_pm)
        _step_tail(ctx, st, lba, interval, g, policy, on)


def _reference_write(ctx: SimContext, st: SimState, lba, interval, policy,
                     on=None) -> None:
    """The reference step's WRITE of each selected drive's ``lba[d]`` (the
    JAX package's ``reference_write``): the whole invalidate, the
    residence group (after a TRIM, the layout group), the target group
    under every detector, then :func:`_step_tail` with ``interval`` as it
    takes it."""
    g, old_pm = _invalidate(ctx, st, lba, on)
    if ctx.with_trim:
        g = _resolve_group(st, g, old_pm >= 0, lba, policy["page_group0"])
    old_g = g
    g = _target_group_app(ctx, st, lba, old_g, policy, on)
    g = torch.where(_gat(st.grp_active, g), g, old_g)
    _step_tail(ctx, st, lba, interval, g, policy, on)


def _scan_reference(ctx: SimContext, st: SimState, lbas, w0, policy, ops):
    """:func:`scan_writes` with ``ctx.fast_path=False``: every event of
    the D drives stepped in lock-step through the reference step, with no
    ``write_run`` launch. The WRITE/TRIM choice comes from the op codes
    on the host: the drives that TRIM take :func:`_trim_page`, those that
    write :func:`_reference_write`, each as a masked pass. With faults a
    degraded drive is masked out of both on the device (the JAX package's
    ``_halt_wrap``) and only counts the event in ``n_halted``. A write
    completes a §5.1 interval where the write clock reaches a multiple of
    h (the event index on a pure-write stream, ``n_app`` on an op
    stream: the same value for a drive in service)."""
    e, h = ctx.trace_every, ctx.h
    n_drives, n = lbas.shape
    dev = st.device
    if ops is None:
        is_write = np.ones((n_drives, n), bool)
    else:
        is_write = np.asarray(ops) != OP_TRIM
    # the per-drive masks, on the device once (a mask is never uploaded
    # per event: the copy would wait for the stream), and the events, an
    # event's D values contiguous
    write_dev = torch.as_tensor(np.ascontiguousarray(is_write.T), device=dev)
    lbas = lbas.t().contiguous()
    app = torch.empty((n_drives, n // e), dtype=torch.int32, device=dev)
    mig = torch.empty_like(app)
    w = np.array(w0, np.int64).reshape(n_drives)  # a copy: updated here
    for i in range(n):
        lba = lbas[i]
        writes = is_write[:, i]
        ok = None
        if ctx.with_faults:  # the halt guard
            ok = st.drive_status == STATUS_OK
            st.n_halted.add_((~ok).to(torch.int32))
        if not writes.all():
            _trim_page(ctx, st, lba, _and(~write_dev[i], ok)
                       if writes.any() else ok)
        if writes.any():
            at = ((w + 1) % h == 0)[writes]
            if at.all() or not at.any():
                interval = bool(at.all())
            else:  # a drive in service: n_app is its write clock
                interval = (st.n_app + 1) % h == 0
            on = ok if writes.all() else _and(write_dev[i], ok)
            _reference_write(ctx, st, lba, interval, policy, on)
        w += writes
        if (i + 1) % e == 0:
            app[:, i // e] = st.n_app
            mig[:, i // e] = st.n_mig
    return app, mig


def scan_writes(ctx: SimContext, st: SimState, lbas: torch.Tensor,
                w0, policy, ops=None):
    """Fold the step over the events ``lbas`` (a device tensor) — writes,
    or with ``ops`` (host int array, op stream) writes and TRIMs —
    emitting the cumulative (n_app, n_mig) counters after every
    ``ctx.trace_every``-th event. One drive: ``st`` a drive, ``lbas`` [n],
    ``w0`` its write clock (``n_app``) at the first event, ``ops`` [n];
    returns device tensors (app, mig) of length n // trace_every. A batch:
    ``st`` a batch of D drives, ``lbas`` [D, n], ``w0`` D write clocks,
    ``ops`` [D, n]; returns (app, mig) [D, n // trace_every]. ``policy``
    is the batch's (:func:`stack_policies`), one row a drive. With
    ``ctx.fast_path=False`` every event goes through the reference step
    instead (:func:`_scan_reference`).

    Each round is one ``write_run_`` launch over every drive (each from
    its own next event), one read of where and why each stopped (tallied
    in :data:`run_stops`), and one masked pass of the heavy tail for the
    drives that stopped on a heavy write. A drive stopped on the write
    that completes a §5.1 interval is held while another still has a
    heavy write before its own boundary; then every held drive takes its
    interval write in the same pass. A drive at its end, or held, re-stops
    at once. The write clocks advance by the WRITEs each run completed,
    counted from the op codes on the host.
    """
    global rounds, interval_batches
    if not st.is_batch:
        app, mig = scan_writes(
            ctx, st.batch, lbas[None], [w0], policy,
            None if ops is None else np.asarray(ops)[None])
        return app[0], mig[0]
    e, h = ctx.trace_every, ctx.h
    n_drives, n = lbas.shape
    if n % e:
        raise ValueError(f"trace_every={e} must divide the segment length {n}")
    if not ctx.fast_path:
        return _scan_reference(ctx, st, lbas, w0, policy, ops)
    dev = st.device
    if ops is None:
        is_write, ops_dev = np.ones((n_drives, n), bool), None
    else:
        ops = np.asarray(ops)
        is_write = ops != OP_TRIM
        ops_dev = torch.as_tensor(ops.astype(np.uint8), device=dev)
    # writes_before[d, j]: drive d's WRITEs among its events 0..j-1
    writes_before = np.concatenate(
        [np.zeros((n_drives, 1), np.int64), np.cumsum(is_write, 1)], 1)
    rows = np.arange(n_drives)
    app = torch.empty((n_drives, n // e), dtype=torch.int32, device=dev)
    mig = torch.empty_like(app)
    run_policy = {k: policy[k] for k in (
        "page_rate", "fdp_rate", "page_group0") if k in policy}
    mode = dict(h=h, trace_every=e, td_mode=ctx.mcfg.td_mode,
                movement_ops=ctx.mcfg.movement_ops,
                bloom_rotate_min_writes=ctx.mcfg.bloom_rotate_min_writes,
                with_faults=ctx.with_faults)
    w = np.array(w0, np.int64).reshape(n_drives)  # a copy: updated here
    start = torch.zeros((n_drives, 2), dtype=torch.int64, device=dev)
    if n_drives == 1:
        start[:, 1] = int(w[0])
    else:
        start[:, 1] = torch.as_tensor(w, device=dev)
    stop = torch.empty((n_drives, 3), dtype=torch.int64, device=dev)
    j = np.zeros(n_drives, np.int64)
    writes_total = writes_before[:, n]
    while True:
        with span("sim.round"):
            write_run_(lbas, ops_dev, start, stop, st.drive_axis, run_policy,
                       app, mig, **mode)
            rounds += 1
            writes_j = writes_before[rows, j]
            if (writes_j == writes_total).all():
                break  # TRIMs alone: every run went to its end
            s, w_s, why = _read(stop).T
            w += writes_before[rows, s] - writes_j
            if (w_s != w).any():
                raise RuntimeError(f"write clock: device {w_s}, host {w}")
            heavy = s < n
            if not heavy.any():
                break
            at_boundary = heavy & ((w + 1) % h == 0)
            interval = bool((at_boundary == heavy).all())
            act = at_boundary if interval else heavy ^ at_boundary
            interval_batches += interval
            for k in why[act].tolist():
                run_stops[STOP_WHY[k]] += 1
            if act.all():
                on = None
            else:  # the same mask, made on the device from the stops
                on = stop[:, 0] < n
                at_dev = (stop[:, 1] + 1) % h == 0
                on = on & (at_dev if interval else ~at_dev)
            at = stop[:, 0]
            lba = lbas.gather(1, at.clamp(max=n - 1)[:, None])[:, 0]
            _split_write(ctx, st, lba, interval, policy, on)
            # the stopped events' trace entries, where (s + 1) % e == 0 (their
            # column is then s // e)
            traced = act & ((s + 1) % e == 0)
            if traced.any():
                col = at if e == 1 else torch.div(at, e, rounding_mode="floor")
                m = None
                if not traced.all():
                    col = col.clamp(max=n // e - 1)
                    m = _and((at + 1) % e == 0, on)
                _sca(app, col, st.n_app, m)
                _sca(mig, col, st.n_mig, m)
            j = s + act
            w += act
            # (s + 1, w + 1) where the drive acted
            torch.add(stop[:, :2], 1 if on is None else on[:, None], out=start)
    return app, mig


def run(ctx: SimContext, st: SimState, lbas, *, ops=None, page_group0=None,
        page_rate=None, assumed_p=None, fdp_rate=None, device="cuda"):
    """Run the simulator over a segment of one drive's writes (or, with
    ``ops``, of WRITE/TRIM events) on ``device``: the batched path at D = 1.

    lbas: int array [T]. ops: int array [T] of op codes (an op-stream
    context, ``ctx.with_trim``, needs it and ``page_group0`` [LBA], the
    layout groups re-mapped pages land in). page_rate: float32 [LBA], the
    current phase's true per-page rates (the FDP detector's input);
    assumed_p / fdp_rate: FDP's assumption arrays [G]. The state is moved
    to ``device`` if it is not there and is updated in place; thread the
    returned state forward across segments. Returns (final_state, trace):
    ``app``/``mig`` are numpy arrays of the CUMULATIVE counters ([T] dense,
    or [T // ctx.trace_every] sampled at every trace_every-th event) and
    ``host_syncs`` counts the device→host reads the segment made.
    """
    if (ops is not None) != ctx.with_trim:
        raise ValueError("pass ops= iff the context is an op stream "
                         "(ctx.with_trim)")
    lbas = np.asarray(lbas)
    if lbas.size and not 0 <= lbas.min() <= lbas.max() < ctx.geom.lba_pages:
        raise ValueError(f"lbas outside [0, {ctx.geom.lba_pages})")
    if ops is not None and np.shape(ops) != lbas.shape:
        raise ValueError(f"ops {np.shape(ops)} and lbas {lbas.shape} differ")
    st = st.to(device)
    policy = policy_from_config(
        ctx, st.device, assumed_p=assumed_p, fdp_rate=fdp_rate,
        page_rate=page_rate, page_group0=page_group0,
    )
    lbas = torch.as_tensor(lbas, dtype=torch.int64, device=st.device)
    syncs0 = host_syncs
    app, mig = scan_writes(ctx, st, lbas, int(st.n_app), policy, ops)
    trace = {
        "app": app.cpu().numpy(),
        "mig": mig.cpu().numpy(),
        "host_syncs": host_syncs - syncs0,
    }
    return st, trace

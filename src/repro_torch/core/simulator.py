"""Event-granularity SSD simulator, one drive, in PyTorch.

The counterpart of ``repro.core.simulator`` without faults
(``check_supported`` names what waits). One step is one event of an op
stream: a WRITE of a page, or (op streams only) a TRIM of one.

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
device in one ``kernels/write_run`` launch a run: the kernel decides each
write there and stops before the first heavy one (or one whose bloom insert
would rotate the filter pair), which the host runs through
:func:`_split_write` and :func:`_step_tail`; then the next run starts after
it. A TRIM frees space and completes no write, so it never stops a run.
Each GC of the heavy path (the group's own, the emergency valve's, a
movement operation's) is one ``kernels/gc_one`` launch that chooses the
group and the victim and decides on the device, as the JAX package's one
``lax.cond`` does; under the static detector it drains the victim in the
same launch. A drain that demotes (FDP or bloom detector) runs on the host
after one read of the decision, and moves the victim's slot metadata with
``kernels/gc_compact.compact_slots``.

State lives on one device and is updated in place. Every other decision
that the JAX package expresses as ``lax.cond`` or ``lax.while_loop`` is
Python control flow on one device→host read, counted in
:data:`host_syncs`; everything between decisions is enqueued on the device
without a read. The
WRITE/TRIM choice and the §5.1 interval boundary are host decisions with
nothing to read: op codes come from numpy, and the write clock ``n_app``
advances by one per WRITE. A run costs one read (where it stopped), and
none when it holds no WRITE. Indices that stay on the device are 0-d integer
tensors, read with :func:`_get` and written with :func:`_set` /
:func:`_add`, so no read is a view that a later write would change and no
index silently wraps.
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
    Geometry,
    ManagerConfig,
    SimState,
    bloom_bits,
    surplus_of,
)
from repro_torch.core.workloads import OP_TRIM
from repro_torch.kernels.gc_compact.ops import compact_slots_
from repro_torch.kernels.gc_one.ops import gc_one_
from repro_torch.kernels.write_run.kernel import (
    COUNTERS,
    STATE_FIELDS,
    STOP_WHY,
)
from repro_torch.kernels.write_run.ops import write_run_

INT_MAX = 2**31 - 1
# the emergency valve's fixed weight point: pure greedy reclaim
GC_W_GREEDY = (1.0, 0.0, 0.0, 0.0)
# allocation modes that take the §5.5 closed form (fdp_assumed feeds it
# FDP's assumed frequencies instead of the measured ones)
CLOSED_FORM_MODES = ("wolf", "optimal", "fdp_assumed")

# device→host reads made for decisions since the count was last set to 0
host_syncs = 0
# the writes that stopped a write_run run, by why (STOP_WHY), since the
# count was last cleared
run_stops = dict.fromkeys(STOP_WHY[1:], 0)


def check_supported(mcfg: ManagerConfig) -> None:
    """Raise for a configuration this port cannot run yet."""
    if mcfg.has_faults:
        raise NotImplementedError(
            "not ported yet: fault injection (the erase-fault retire hook, "
            "the halt guard and the retired-capacity term of §5.5; "
            "preset wolf_endurance)"
        )


@dataclasses.dataclass(frozen=True)
class SimContext:
    """Static context of one run: geometry, policy, and the run's shape."""

    geom: Geometry
    mcfg: ManagerConfig
    n_groups: int  # initial groups (may grow in dynamic mode)
    # emit the cumulative (n_app, n_mig) counters after every E-th event
    trace_every: int = 1
    # op-stream mode: the run takes (op, lba) events, and a write that
    # re-maps a trimmed page lands in its layout group (page_group0)
    with_trim: bool = False

    @property
    def h(self) -> int:
        return max(16, int(self.geom.lba_pages * self.mcfg.interval_frac))

    @property
    def f_min_pages(self) -> int:
        return self.geom.n_luns * self.geom.pages_per_block


def policy_from_config(ctx: SimContext, device, *, assumed_p=None,
                       fdp_rate=None, page_rate=None,
                       page_group0=None) -> dict:
    """A ManagerConfig's policy as the values the step reads: float weights,
    FDP's assumption arrays [G], the oracle's per-page rates [LBA] and the
    layout groups [LBA] as device tensors (zeros where not given), the
    modes as host values."""
    check_supported(ctx.mcfg)
    g_max, lba = ctx.mcfg.max_groups, ctx.geom.lba_pages

    def f32(x, n):
        if x is None:
            return torch.zeros(n, dtype=torch.float32, device=device)
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    policy = {
        "alloc_mode": ctx.mcfg.alloc_mode,
        "gc_w": torch.tensor(ctx.mcfg.gc_weights(), dtype=torch.float32,
                             device=device),
        "gc_w_greedy": torch.tensor(GC_W_GREEDY, dtype=torch.float32,
                                    device=device),
        "h": torch.tensor(ctx.h, dtype=torch.int32, device=device),
        "ewma_a": torch.tensor(ctx.mcfg.ewma_a, dtype=torch.float32,
                               device=device),
        "assumed_p": f32(assumed_p, g_max),
        "fdp_rate": f32(fdp_rate, g_max),
        "page_rate": f32(page_rate, lba),
    }
    if ctx.with_trim:
        if page_group0 is None:
            raise ValueError("an op-stream run needs page_group0")
        policy["page_group0"] = torch.as_tensor(
            np.asarray(page_group0, np.int64), device=device)
    return policy


# ---------------------------------------------------------------------------
# device indexing and host decisions
# ---------------------------------------------------------------------------

def _get(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a 0-d index tensor: a copy (never a view), no host read."""
    return t.index_select(0, i.reshape(1)).reshape(t.shape[1:])


def _set(t: torch.Tensor, i: torch.Tensor, v) -> None:
    """``t[i] = v`` in place, for a 0-d index tensor. A Python scalar goes
    to the kernel as an argument: a scalar made into a CUDA tensor would be
    a host→device copy, which waits for the stream."""
    if isinstance(v, torch.Tensor):
        t.index_put_((i.reshape(1),), v.to(t.dtype).expand(1, *t.shape[1:]))
    else:
        t.index_fill_(0, i.reshape(1), v)


def _add(t: torch.Tensor, i: torch.Tensor, v) -> None:
    """``t[i] += v`` in place, for a 0-d index tensor."""
    if isinstance(v, torch.Tensor):
        t.index_add_(0, i.reshape(1), v.to(t.dtype).reshape(1))
    else:
        _set(t, i, _get(t, i) + v)


def _when(pred: torch.Tensor) -> bool:
    """A decision: read a device bool on the host, counted in
    :data:`host_syncs`."""
    global host_syncs
    host_syncs += 1
    return bool(pred)


def _read(t: torch.Tensor) -> np.ndarray:
    """A decision that needs a whole (small) tensor on the host: one read,
    counted in :data:`host_syncs`."""
    global host_syncs
    host_syncs += 1
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# primitive state updates
# ---------------------------------------------------------------------------

def _pop_free_block(st: SimState, g):
    """Claim the lowest FREE block for group g (becomes its OPEN active
    block); masked to a no-op when the pool is empty."""
    free_mask = st.state == FREE
    blk = torch.argmax(free_mask.to(torch.int32))
    ok = _get(free_mask, blk)
    d = ok.to(torch.int32)
    _add(st.grp_phys, g, d)
    _set(st.state, blk, torch.where(ok, OPEN, _get(st.state, blk)))
    _set(st.group_of, blk, torch.where(ok, g, _get(st.group_of, blk)))
    _set(st.fill, blk, torch.where(ok, 0, _get(st.fill, blk)))
    # LRU clock: a block's age is its claim time
    _set(st.stamp, blk, torch.where(ok, st.clock, _get(st.stamp, blk)))
    st.grp_surplus.copy_(surplus_of(st.grp_active, st.grp_phys, st.grp_alloc))
    st.free_blocks.sub_(d)
    st.clock.add_(d)
    return blk, ok


def _write_page(ctx: SimContext, st: SimState, lba, g) -> None:
    """Append application page ``lba`` to group g's active block,
    allocating a fresh block when it is full (the heavy path's write)."""
    b = ctx.geom.pages_per_block
    blk = _get(st.active_blk, g)
    blk_full = torch.where(
        blk >= 0, _get(st.fill, blk.clamp(min=0)) >= b, True
    )
    if _when(blk_full):
        old = blk.clamp(min=0)
        _set(st.state, old, torch.where(blk >= 0, CLOSED, _get(st.state, old)))
        new_blk, ok = _pop_free_block(st, g)
        _set(st.active_blk, g, torch.where(ok, new_blk, blk))
        blk = _get(st.active_blk, g)
    blk_c = blk.clamp(min=0)
    slot = _get(st.fill, blk_c)
    # overflow guard: an empty pool leaves the block full — the write is
    # dropped and counted (tests assert it never fires)
    ok = (blk >= 0) & (slot < b)
    one = ok.to(torch.int32)
    flat = blk_c * b + slot.clamp(max=b - 1)
    slot_lba, valid = st.slot_lba.view(-1), st.valid.view(-1)
    _set(slot_lba, flat, torch.where(ok, lba, _get(slot_lba, flat)))
    _set(valid, flat, ok | _get(valid, flat))
    _add(st.fill, blk_c, one)
    _add(st.live, blk_c, one)
    _set(st.page_map, lba, torch.where(ok, blk * b + slot, -1))
    _add(st.grp_size, g, one)
    _add(st.grp_live, g, one)
    st.mapped_pages.add_(one)
    st.n_dropped.add_(1 - one)


def _invalidate_counts(ctx: SimContext, st: SimState, lba):
    """The counter half of an invalidate: live/grp_size/grp_live/
    mapped_pages decrements and the old-group lookup, without the valid-bit
    clear (the fused write, the TRIM or :func:`_clear_valid` does that).
    Returns (old_g, old_pm); old_g is 0 for an unmapped page."""
    b = ctx.geom.pages_per_block
    pm = _get(st.page_map, lba)
    has = pm >= 0
    blk = pm.clamp(min=0).long() // b
    old_g = _get(st.group_of, blk)
    d_g = torch.where(has & (old_g >= 0), -1, 0)
    og_c = old_g.clamp(min=0).long()
    _add(st.live, blk, torch.where(has, -1, 0))
    _add(st.grp_size, og_c, d_g)
    _add(st.grp_live, og_c, d_g)
    st.mapped_pages.sub_(has.to(torch.int32))
    return torch.where(has, old_g, 0).long(), pm


def _clear_valid(ctx: SimContext, st: SimState, pm) -> None:
    """Complete a deferred invalidate: clear the old slot's valid bit."""
    has = pm >= 0
    flat = pm.clamp(min=0).long()
    valid = st.valid.view(-1)
    _set(valid, flat, ~has & _get(valid, flat))


# ---------------------------------------------------------------------------
# temperature detection — §5.6 (+ the oracle FDP bands of §6)
# ---------------------------------------------------------------------------

def _hit_rates(st: SimState) -> torch.Tensor:
    """Per-page update rate of each group over its mapped pages (grp_live);
    -1 for inactive groups."""
    s = st.grp_live.to(torch.float32).clamp(min=1.0)
    return torch.where(st.grp_active, st.grp_p / s, -1.0)


def _sgv_neighbors(st: SimState):
    """hotter/colder neighbour by current hit-rate order, from a stable
    argsort: the oracle that :func:`_neighbor_hotter` and
    :func:`_neighbor_colder` are held to in the tests. Returns
    ``neighbor(g, delta)``."""
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
    hit rate, ties to the highest index; g itself when it is the hottest."""
    idx = torch.arange(hr.shape[0], device=hr.device)
    hr_g = _get(hr, g)
    cand = active & ((hr > hr_g) | ((hr == hr_g) & (idx < g)))
    min_hr = torch.where(cand, hr, torch.inf).min()
    nb = torch.where(cand & (hr == min_hr), idx, -1).max()
    return torch.where(cand.any(), nb, g)


def _neighbor_colder(hr, active, g, *, g_known_active: bool = False):
    """The next colder active group of g in the stable (-hr, index) order:
    the candidate (colder, or as cold with a higher index) with the highest
    hit rate, ties to the lowest index. With no candidate an active g stays
    put and an inactive g falls to the coldest active group (argsort's
    ``clip(rank + 1, n_active - 1)``). ``g_known_active`` drops that
    fallback (a GC drain's group is always active)."""
    g_max = hr.shape[0]
    idx = torch.arange(g_max, device=hr.device)
    hr_g = _get(hr, g)
    cand = active & ((hr < hr_g) | ((hr == hr_g) & (idx > g)))
    best_hr = torch.where(cand, hr, -2.0).max()
    nb = torch.where(cand & (hr == best_hr), idx, g_max).min()
    if g_known_active:
        fallback = g
    else:
        cold_hr = torch.where(active, hr, torch.inf).min()
        coldest = torch.where(active & (hr == cold_hr), idx, -1).max()
        fallback = torch.where(_get(active, g), g, coldest)
    return torch.where(cand.any(), nb, fallback)


def _bloom_hashes(ctx: SimContext, lba):
    """The JAX package's two uint32 hashes of ``lba`` (int tensor, any
    shape, non-negative), reduced mod the filter width: the products wrap
    at 2**32 there, so they are taken in int64 and masked to 32 bits."""
    bits = bloom_bits(ctx.geom, ctx.mcfg)
    u = lba.long() & 0xFFFFFFFF
    h1 = ((u * 2654435761) & 0xFFFFFFFF) % bits
    h2 = ((u * 40503 + 99991) & 0xFFFFFFFF) % bits
    return h1, h2, bits


def _bloom_query(ctx: SimContext, filt, lba, g):
    """Whether ``lba`` (int tensor, any shape) is in group g's filter of
    the pair ``filt`` [G, bits]."""
    h1, h2, bits = _bloom_hashes(ctx, lba)
    flat = filt.view(-1)
    base = g * bits
    hit1 = flat.index_select(0, (base + h1).reshape(-1))
    hit2 = flat.index_select(0, (base + h2).reshape(-1))
    return (hit1 & hit2).reshape(h1.shape)


def _bloom_update(ctx: SimContext, st: SimState, lba, g):
    """Insert ``lba`` into group g's active filter, and rotate the pair
    when the group's write count reaches its size. The rotation is
    row-masked, not a branch, so the bloom detector adds no host read.
    Returns whether the page was in both filters before the insert."""
    h1, h2, bits = _bloom_hashes(ctx, lba)
    act, pas = st.bloom_active.view(-1), st.bloom_passive.view(-1)
    i1, i2 = g * bits + h1, g * bits + h2
    in_both = (_get(act, i1) & _get(act, i2)
               & _get(pas, i1) & _get(pas, i2))
    _set(act, i1, True)
    _set(act, i2, True)
    _add(st.bloom_writes, g, 1)
    writes = _get(st.bloom_writes, g)
    rotate = writes >= _get(st.grp_size, g).clamp(
        min=ctx.mcfg.bloom_rotate_min_writes)
    row = _get(st.bloom_active, g)
    _set(st.bloom_passive, g,
         torch.where(rotate, row, _get(st.bloom_passive, g)))
    _set(st.bloom_active, g, row & ~rotate)
    _set(st.bloom_writes, g, torch.where(rotate, 0, writes))
    return in_both


def _target_group_app(ctx: SimContext, st: SimState, lba, cur_g, policy):
    """Target group of an application write of ``lba`` living in cur_g:
    cur_g under the static detector; the next hotter group when FDP's
    oracle rate beats twice the group's assumed rate, or when the page is
    in both bloom filters."""
    td = ctx.mcfg.td_mode
    if td == "static":
        return cur_g
    if td == "fdp":
        r = _get(policy["page_rate"], lba)
        promote = r > 2.0 * _get(policy["fdp_rate"], cur_g)
    elif td == "bloom":
        promote = _bloom_update(ctx, st, lba, cur_g)
    else:
        raise ValueError(f"unknown td_mode {td!r}")
    nb = _neighbor_hotter(_hit_rates(st), st.grp_active, cur_g)
    return torch.where(promote, nb, cur_g)


def _demote_flags(ctx: SimContext, st: SimState, lbas, g, policy):
    """The §5.6 GC demotion predicate over a victim's pages ``lbas`` [B]:
    FDP's oracle rate below half the group's assumed rate, or the page in
    neither bloom filter. It reads only what a drain leaves unchanged."""
    if ctx.mcfg.td_mode == "fdp":
        r = policy["page_rate"].index_select(0, lbas)
        return r < 0.5 * _get(policy["fdp_rate"], g)
    in_a = _bloom_query(ctx, st.bloom_active, lbas, g)
    in_p = _bloom_query(ctx, st.bloom_passive, lbas, g)
    return ~in_a & ~in_p


# ---------------------------------------------------------------------------
# garbage collection (one victim) — §5.4
# ---------------------------------------------------------------------------

def _scatter_live(t: torch.Tensor, idx, vals, mask) -> None:
    """``t[idx[mask]] = vals[mask]`` in place without a host read: rows
    outside the mask store again what the first masked row stores (or, if
    no row is masked, the value already there), so duplicate indices all
    agree whichever write lands last."""
    first = torch.argmax(mask.to(torch.int32))
    any_ = mask.any()
    fill_idx = torch.where(any_, _get(idx, first), idx[0])
    fill_val = torch.where(any_, _get(vals, first), _get(t, fill_idx))
    t.index_put_(
        (torch.where(mask, idx, fill_idx),),
        torch.where(mask, vals, fill_val).to(t.dtype),
    )


def _erase_victim(st: SimState, victim, clock) -> None:
    """Erase a drained victim: FREE, empty, stamped with ``clock``, one
    more P-E cycle (Σe² gains (e+1)² − e²), its trimmed-slot tally
    cleared. The group and pool counters are the caller's."""
    e_old = _get(st.erase_count, victim)
    _set(st.state, victim, FREE)
    _set(st.group_of, victim, -1)
    _set(st.fill, victim, 0)
    _set(st.live, victim, 0)
    _set(st.slot_lba, victim, -1)
    _set(st.valid, victim, False)
    _set(st.stamp, victim, clock)
    st.clock.copy_(clock + 1)
    st.n_erase.add_(1)
    _add(st.erase_count, victim, 1)
    _set(st.trim_dead, victim, 0)
    st.erase_total.add_(1)
    st.erase_sq_total.add_(2 * e_old + 1)


def _demotion_targets(st: SimState, flagged: np.ndarray, g) -> torch.Tensor:
    """Target group [B] of each victim slot: one group colder for the
    flagged live slots, g for the rest. The colder neighbour reads hit
    rates over the group sizes as the drain has moved them so far, so the
    flagged slots are taken in slot order; each step runs on the device
    (only which slots are flagged came to the host, in one read)."""
    b = flagged.shape[0]
    targets = g.expand(b).clone()
    sizes = st.grp_live.clone()
    for j in np.flatnonzero(flagged).tolist():
        hr = torch.where(
            st.grp_active, st.grp_p / sizes.to(torch.float32).clamp(min=1.0),
            -1.0,
        )
        nb = _neighbor_colder(hr, st.grp_active, g, g_known_active=True)
        targets[j] = nb
        _add(sizes, g, -1)
        _add(sizes, nb, 1)
    return targets


def _gc_drain_bulk(ctx: SimContext, st: SimState, victim, g, policy) -> None:
    """Migrate every live page of ``victim``, each into its target group
    (§5.6 demotion under the FDP or bloom detector), then erase it (the JAX
    package's ``_gc_drain_bulk``).

    Pages are counted per target group; each group whose pages overflow its
    active block claims ONE fresh block, and the i-th claim (ordered by
    the slot of the group's first page that does not fit) takes the i-th
    lowest FREE block, what the sequential pop hands out. The slot contents
    move through ``compact_slots`` as one move list.
    """
    b = ctx.geom.pages_per_block
    k = ctx.geom.n_blocks
    g_max = st.grp_active.shape[0]
    dev = st.device
    lbas = _get(st.slot_lba, victim)       # [B]; dead slots hold -1
    is_live = _get(st.valid, victim)       # [B]
    lbas_c = lbas.clamp(min=0).long()

    # -- per-slot target groups (one read: which live slots demote) ---------
    flagged = _read(_demote_flags(ctx, st, lbas_c, g, policy) & is_live)
    if flagged.any():
        targets = _demotion_targets(st, flagged, g)
    else:
        targets = g.expand(b).clone()

    # -- pages per target group; fresh-block claims -------------------------
    idx = torch.arange(b, device=dev)
    arange_g = torch.arange(g_max, device=dev)
    onehot_t = torch.where(is_live, targets, g_max)[:, None] == arange_g
    m = onehot_t.sum(0)                    # [G] live pages per target
    ab = st.active_blk.long()
    has_ab = ab >= 0
    ab_c = ab.clamp(min=0)
    fill_ab = torch.where(has_ab, st.fill.index_select(0, ab_c).long(), b)
    space = b - fill_ab.clamp(max=b)       # [G] free slots in active blocks
    claim = m > space
    seal = claim & has_ab
    # within-group rank of each live page, in slot order
    same = ((targets[:, None] == targets[None, :])
            & is_live[None, :] & is_live[:, None])
    rank = (same & (idx[None, :] < idx[:, None])).sum(1)
    space_t = space.index_select(0, targets)
    first_out = is_live & (rank == space_t)    # a group's first overflow
    claim_pos = torch.where(onehot_t & first_out[:, None], idx[:, None],
                            INT_MAX).amin(0)
    claim_rank = (claim[None, :]
                  & (claim_pos[None, :] < claim_pos[:, None])).sum(1)
    # free_by_rank[r]: the r-th lowest FREE block (k when there is none)
    n_free_before = torch.cumsum((st.state == FREE).long(), 0)
    free_by_rank = torch.searchsorted(n_free_before, arange_g + 1)
    claim_ok = claim & (claim_rank < st.free_blocks)
    new_blk = torch.where(
        claim_ok,
        free_by_rank.index_select(0, claim_rank.clamp(max=g_max - 1)), -1,
    )

    # -- per-page destinations ---------------------------------------------
    in_old = rank < space_t
    dst_blk = torch.where(in_old, ab_c.index_select(0, targets),
                          new_blk.index_select(0, targets))
    dst_slot = torch.where(in_old, fill_ab.index_select(0, targets) + rank,
                           rank - space_t)
    ok = is_live & (in_old | claim_ok.index_select(0, targets))
    db = torch.where(ok, dst_blk, k)       # masked rows land nowhere

    # -- seal / claim bookkeeping ([K + 1] scratch: row k takes the rest) ---
    sealed = torch.zeros(k + 1, dtype=torch.bool, device=dev)
    sealed.index_fill_(0, torch.where(seal, ab_c, k), True)
    claimed_by = torch.full((k + 1,), -1, dtype=torch.long, device=dev)
    claim_at = torch.where(claim_ok, new_blk, k)
    claimed_by.index_copy_(0, claim_at, arange_g)
    claim_stamp = torch.zeros(k + 1, dtype=torch.long, device=dev)
    claim_stamp.index_copy_(0, claim_at, st.clock + claim_rank)
    claimed = claimed_by[:k] >= 0
    st.state.copy_(torch.where(
        claimed, OPEN, torch.where(sealed[:k], CLOSED, st.state)))
    st.group_of.copy_(torch.where(claimed, claimed_by[:k], st.group_of))
    st.stamp.copy_(torch.where(claimed, claim_stamp[:k], st.stamp))
    n_claimed = claim_ok.sum()
    clock = st.clock + n_claimed
    st.active_blk.copy_(torch.where(claim_ok, new_blk, ab))

    # -- land the pages -----------------------------------------------------
    landed_k = torch.zeros(k + 1, dtype=torch.int32, device=dev)
    landed_k.index_add_(0, db, ok.to(torch.int32))
    st.fill.copy_(torch.where(claimed, 0, st.fill) + landed_k[:k])
    st.live.add_(landed_k[:k])
    src = torch.where(ok, victim, -1).to(torch.int32)
    compact_slots_(
        st.slot_lba[None], st.valid[None], src[None],
        idx.to(torch.int32)[None], db.to(torch.int32)[None],
        dst_slot.to(torch.int32)[None],
    )
    _scatter_live(
        st.page_map, lbas_c, torch.where(ok, dst_blk * b + dst_slot, -1),
        is_live,
    )
    n_live = is_live.sum()
    n_ok = ok.sum()
    landed_g = torch.zeros(g_max, dtype=torch.int32, device=dev)
    landed_g.index_add_(0, targets, ok.to(torch.int32))
    for grp in (st.grp_size, st.grp_live):
        grp.add_(landed_g)
        _add(grp, g, -n_live)

    # -- erase the victim ---------------------------------------------------
    st.grp_phys.add_(claim_ok.to(torch.int32))
    _add(st.grp_phys, g, -1)
    st.grp_surplus.copy_(surplus_of(st.grp_active, st.grp_phys, st.grp_alloc))
    st.free_blocks.add_(1 - n_claimed)
    st.mapped_pages.sub_(n_live - n_ok)
    st.n_mig.add_(n_ok)
    st.n_dropped.add_(n_live - n_ok)
    _erase_victim(st, victim, clock)


def _gc_one(ctx: SimContext, st: SimState, policy, mode: str,
            g=None) -> None:
    """One GC (§5.4) in one ``gc_one_`` launch: the group by ``mode`` ("gc":
    g, enabled when it needs a block it is not entitled to or the pool is
    at reserve; "valve": where the fewest live pages are, greedy weights;
    "movement": the most block-surplus group), the victim, and the
    decision, all on the device. The static detector's drain runs in the
    same launch, without a host read. A detector that can demote takes the
    general drain here, on one read of the decision."""
    gc_w = policy["gc_w_greedy" if mode == "valve" else "gc_w"]
    out = torch.empty((1, 3), dtype=torch.int64, device=st.device)
    gc_one_(st.drive_axis, gc_w[None], None if g is None else g.reshape(1),
            out, mode=mode, td_mode=ctx.mcfg.td_mode,
            gc_reserve_blocks=ctx.mcfg.gc_reserve_blocks)
    if ctx.mcfg.td_mode != "static" and _when(out[0, 2] != 0):
        _gc_drain_bulk(ctx, st, out[0, 0], out[0, 1], policy)


# ---------------------------------------------------------------------------
# over-provisioning allocation and groups (interval) — §5.1, §5.2, §5.5
# ---------------------------------------------------------------------------

def _recompute_alloc(ctx: SimContext, st: SimState, policy) -> None:
    geom, mcfg = ctx.geom, ctx.mcfg
    b = geom.pages_per_block
    active = st.grp_active
    mode = policy["alloc_mode"]
    # EFFECTIVE group sizes (carried grp_live == mapped pages per group):
    # trimmed pages leave s, so their space re-enters the OP budget
    s = torch.where(active, st.grp_live.to(torch.float32), 0.0)
    s = torch.maximum(s, active.to(torch.float32))
    freq = policy["assumed_p"] if mode == "fdp_assumed" else st.grp_p
    p = torch.where(active, freq, 0.0)
    p = p / torch.clamp(fsum(p), min=1e-9)
    # usable OP = spare pages beyond logical content, minus the GC reserve
    # and one block per active group
    n_active = active.sum(dtype=torch.int32)
    op_total = (
        float(geom.pba_pages)
        - (mcfg.gc_reserve_blocks + 1 + n_active) * b
        - fsum(s)
    )
    if mode in CLOSED_FORM_MODES:
        op = allocate_closed_form(
            s, p, op_total,
            cold_rule=True,
            cold_hit_rate_frac=mcfg.cold_hit_rate_frac,
            cold_op_frac=mcfg.cold_op_frac,
        )
    elif mode == "freq":
        op = allocate_by_frequency(p, op_total)
    else:
        op = allocate_by_size(s, op_total)
    alloc_blocks = torch.ceil((s + op) / b).to(torch.int32)
    alloc_blocks = torch.where(active, alloc_blocks.clamp(min=1), 0)
    st.grp_alloc.copy_(alloc_blocks)
    st.grp_surplus.copy_(surplus_of(active, st.grp_phys, st.grp_alloc))


def _maybe_create_or_merge(ctx: SimContext, st: SimState) -> None:
    """§5.2 dynamic groups, at most one create and one merge per interval.

    Create: a new group, seeded with half the hottest group's frequency,
    when the hottest group is at least ``q_create``× hotter per page than
    the second and holds ``f_min_pages``. Merge: the hottest adjacent pair
    (in hit-rate order) whose ratio fell below 1.3, or whose hotter member
    shrank below ``f_min_pages``, becomes one group (blocks relabelled,
    the hotter group's active block sealed). Both wait out a cooldown of
    ``w_intervals``. Sorts are stable, as JAX's; two host reads.
    """
    mcfg = ctx.mcfg
    f_min = ctx.f_min_pages
    hr = _hit_rates(st)
    order = torch.argsort(-hr, stable=True)  # hottest first
    hottest, second = order[0], order[1]
    n_active = st.grp_active.sum()
    hot_ratio = _get(hr, hottest) / _get(hr, second).clamp(min=1e-12)
    create = (
        (n_active < mcfg.max_groups)
        & (st.cooldown == 0)
        & (n_active >= 2)
        & (hot_ratio >= mcfg.q_create)
        & (_get(st.grp_size, hottest) >= f_min)
    )
    if _when(create):
        slot = torch.argmin(st.grp_active.to(torch.int32))  # first inactive
        _set(st.grp_active, slot, True)
        _set(st.grp_phys, slot, 0)
        _set(st.grp_p, slot, _get(st.grp_p, hottest) * 0.5)
        _set(st.grp_size, slot, 0)
        _set(st.grp_live, slot, 0)
        st.grp_surplus.copy_(
            surplus_of(st.grp_active, st.grp_phys, st.grp_alloc))
        _set(st.grp_created, slot, st.interval)
        st.cooldown.fill_(mcfg.w_intervals)

    hr = _hit_rates(st)
    order = torch.argsort(-hr, stable=True)
    n_active = st.grp_active.sum()
    hr_sorted = hr.index_select(0, order)
    hr_next = torch.roll(hr_sorted, -1)
    valid_pair = torch.arange(hr.shape[0], device=hr.device) + 1 < n_active
    ratio = hr_sorted / hr_next.clamp(min=1e-12)
    converged = valid_pair & (ratio < 1.3) & (hr_sorted > 0)
    tiny = (valid_pair & (st.grp_size.index_select(0, order) < f_min)
            & (hr_next > 0))
    mergeable = converged | tiny
    pair_i = torch.argmax(mergeable.to(torch.int32))
    do_merge = _get(mergeable, pair_i) & (st.cooldown == 0) & (n_active > 2)
    if _when(do_merge):
        g_from = _get(order, pair_i)        # hotter of the pair
        g_to = _get(order, pair_i + 1)      # absorbed into the colder
        st.group_of.copy_(torch.where(st.group_of == g_from, g_to,
                                      st.group_of))
        ab = _get(st.active_blk, g_from)    # no longer reachable: seal it
        ab_c = ab.clamp(min=0).long()
        _set(st.state, ab_c, torch.where(ab >= 0, CLOSED,
                                         _get(st.state, ab_c)))
        for arr in (st.grp_size, st.grp_live, st.grp_phys, st.grp_p,
                    st.grp_writes):
            _add(arr, g_to, _get(arr, g_from))
            _set(arr, g_from, 0)
        _set(st.active_blk, g_from, -1)
        _set(st.grp_active, g_from, False)
        st.grp_surplus.copy_(
            surplus_of(st.grp_active, st.grp_phys, st.grp_alloc))
        st.cooldown.fill_(mcfg.w_intervals)


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


def _interval_update(ctx: SimContext, st: SimState, policy) -> None:
    a = policy["ewma_a"]
    u = st.grp_writes.to(torch.float32) / policy["h"].to(torch.float32)
    st.grp_p.copy_(
        torch.where(st.grp_active, _fma32(st.grp_p, 1.0 - a, a * u), 0.0)
    )
    st.grp_writes.zero_()
    st.interval.add_(1)
    st.cooldown.copy_((st.cooldown - 1).clamp(min=0))
    if ctx.mcfg.dynamic_groups:
        _maybe_create_or_merge(ctx, st)
    _recompute_alloc(ctx, st, policy)


# ---------------------------------------------------------------------------
# the step + runner
# ---------------------------------------------------------------------------

def _step_tail(ctx: SimContext, st: SimState, lba, w: int, g,
               policy) -> None:
    """GC → emergency valve → write → movement ops → §5.1 interval update:
    the heavy path, downstream of invalidate + target selection. ``w`` is
    the write clock (``n_app`` before this write)."""
    mcfg = ctx.mcfg

    # GC when the group needs a new block it is not entitled to, or the
    # pool is at reserve (the predicate is read on the device)
    _gc_one(ctx, st, policy, "gc", g)

    # emergency valve: while the pool is (nearly) empty, greedily reclaim
    # the best victim anywhere (its group pays), a bounded number of times
    tries = 0
    while tries < mcfg.valve_max_tries and _when(st.free_blocks < 2):
        _gc_one(ctx, st, policy, "valve")
        tries += 1

    _write_page(ctx, st, lba, g)
    st.n_app.add_(1)
    _add(st.grp_writes, g, 1)

    # movement operations (§5.3): one compaction GC on the most surplus
    # group, donating the redeemed block to the pool
    if mcfg.movement_ops:
        _gc_one(ctx, st, policy, "movement")

    # interval completion (§5.1): n_app == w + 1 after this write
    if (w + 1) % ctx.h == 0:
        _interval_update(ctx, st, policy)


def _resolve_group(st: SimState, old_g, had_mapping, lba, page_group0):
    """Residence group of a written page: its old group when it was mapped;
    after a TRIM its layout group, or the first active group when §5.2
    merged that one away."""
    pg0 = _get(page_group0, lba)
    first_active = torch.argmax(st.grp_active.to(torch.int32))
    pg0 = torch.where(_get(st.grp_active, pg0), pg0, first_active)
    return torch.where(had_mapping, old_g, pg0)


def _split_write(ctx: SimContext, st: SimState, lba, w: int, policy) -> None:
    """A write that stopped a run of ``write_run_``: the invalidate counts,
    the target group, then :func:`_step_tail` (GC, the valve, the append,
    the interval, movement). ``w`` is the write clock (``n_app`` before
    this write). A write that stopped the run for a bloom rotation alone
    passes every heavy predicate, and the tail lands it as the run would
    have, with the rotation."""
    g, old_pm = _invalidate_counts(ctx, st, lba)
    if ctx.with_trim:
        g = _resolve_group(st, g, old_pm >= 0, lba, policy["page_group0"])
    if ctx.mcfg.td_mode != "static":
        old_g = g
        g = _target_group_app(ctx, st, lba, old_g, policy)
        g = torch.where(_get(st.grp_active, g), g, old_g)
    _clear_valid(ctx, st, old_pm)
    _step_tail(ctx, st, lba, w, g, policy)


def scan_writes(ctx: SimContext, st: SimState, lbas: torch.Tensor,
                w0: int, policy, ops=None):
    """Fold the step over the events ``lbas`` (a device tensor) — writes,
    or with ``ops`` (host int array, op stream) writes and TRIMs —
    emitting the cumulative (n_app, n_mig) counters after every
    ``ctx.trace_every``-th event. ``w0`` is the write clock (``n_app``) at
    the first event. Returns device tensors (app, mig) of length
    len(lbas) // trace_every.

    One ``write_run_`` launch lands events from j until the first write
    that needs the heavy path (or a bloom rotation); one read says where
    and why it stopped (tallied in :data:`run_stops`). That write goes
    through :func:`_split_write`, and the next run starts after it. The
    write clock advances by the WRITEs the run completed, counted from the
    op codes on the host.
    """
    e = ctx.trace_every
    n = int(lbas.shape[0])
    if n % e:
        raise ValueError(f"trace_every={e} must divide the segment length {n}")
    dev = st.device
    if ops is None:
        is_write, ops_dev = np.ones(n, bool), None
    else:
        is_write = np.asarray(ops) != OP_TRIM
        ops_dev = torch.as_tensor(np.asarray(ops, np.uint8), device=dev)[None]
    # writes_before[j]: the WRITEs among events 0..j-1
    writes_before = np.concatenate([[0], np.cumsum(is_write)]).tolist()
    app = torch.empty((1, n // e), dtype=torch.int32, device=dev)
    mig = torch.empty_like(app)
    # one drive: a drive axis of 1 (a counter may come from the JAX package
    # as [1], already a drive axis)
    state = {k: getattr(st, k).view(1) if k in COUNTERS
             else getattr(st, k)[None] for k in STATE_FIELDS}
    run_policy = {k: policy[k][None] for k in (
        "page_rate", "fdp_rate", "page_group0") if k in policy}
    mode = dict(h=ctx.h, trace_every=e, td_mode=ctx.mcfg.td_mode,
                movement_ops=ctx.mcfg.movement_ops,
                bloom_rotate_min_writes=ctx.mcfg.bloom_rotate_min_writes)
    start = torch.zeros((1, 2), dtype=torch.int64, device=dev)
    start[:, 1] = w0
    stop = torch.empty((1, 3), dtype=torch.int64, device=dev)
    j, w = 0, w0
    while j < n:
        write_run_(lbas[None], ops_dev, start, stop, state, run_policy, app,
                   mig, **mode)
        if writes_before[n] == writes_before[j]:
            break  # TRIMs alone: the run went to the end
        s, w_s, why = _read(stop)[0].tolist()
        w += writes_before[s] - writes_before[j]
        if w_s != w:
            raise RuntimeError(f"write clock: device {w_s}, host {w}")
        if s == n:
            break
        run_stops[STOP_WHY[why]] += 1
        _split_write(ctx, st, lbas[s], w, policy)
        w += 1
        if (s + 1) % e == 0:
            app[0, (s + 1) // e - 1] = st.n_app
            mig[0, (s + 1) // e - 1] = st.n_mig
        j = s + 1
        torch.add(stop[:, :2], 1, out=start)  # (s + 1, w + 1)
    return app[0], mig[0]


def run(ctx: SimContext, st: SimState, lbas, *, ops=None, page_group0=None,
        page_rate=None, assumed_p=None, fdp_rate=None, device="cuda"):
    """Run the simulator over a segment of writes (or, with ``ops``, of
    WRITE/TRIM events) on ``device``.

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

"""Event-granularity SSD simulator, one drive, in PyTorch.

The counterpart of ``repro.core.simulator`` for the static detector over
pure-write streams, without faults (``check_supported`` names what else
waits). One step is one application write:

  1. invalidate the page's old physical slot (counters first; the valid
     bit is cleared by the fused write or, on the heavy path, before GC),
  2. the target group is the page's own (static detector, §6 oracle mode),
  3. garbage-collect inside the group if it is out of budgeted space (§5.4),
  4. append the page to the group's active block,
  5. every h writes: EWMA update frequencies and re-allocate
     over-provisioning (§5.1, §5.5),
  6. movement operations (§5.3): at most one compaction GC per step on the
     most block-surplus group.

A write whose group has room in its open block, with the pool above
reserve, no movement surplus and no interval boundary, takes the fast path:
one fused ``kernels/write_path.apply_write`` plus counter updates. The rest
(:func:`_step_tail`) runs only when one of those O(1) predicates trips. A GC
drain moves the victim's slot metadata with ``kernels/gc_compact.
compact_slots``.

State lives on one device and is updated in place. Every decision that the
JAX package expresses as ``lax.cond`` or ``lax.while_loop`` is Python
control flow on one device→host read, counted in :data:`host_syncs`;
everything between decisions is enqueued on the device without a read.
Indices that stay on the device are 0-d integer tensors, read with
:func:`_get` and written with :func:`_set` / :func:`_add`, so no read is a
view that a later write would change and no index silently wraps.
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
    surplus_of,
)
from repro_torch.kernels.gc_compact.ops import compact_slots_
from repro_torch.kernels.write_path.ops import apply_write_

INT_MAX = 2**31 - 1
# the emergency valve's fixed weight point: pure greedy reclaim
GC_W_GREEDY = (1.0, 0.0, 0.0, 0.0)

# device→host reads made for decisions since the count was last set to 0
host_syncs = 0


def check_supported(mcfg: ManagerConfig) -> None:
    """Raise for a configuration this port cannot run yet."""
    missing = []
    if mcfg.td_mode != "static":
        missing.append(f"td_mode={mcfg.td_mode!r} (FDP/bloom detectors)")
    if mcfg.dynamic_groups:
        missing.append("dynamic_groups (§5.2 create/merge)")
    if mcfg.has_faults:
        missing.append("fault injection")
    if mcfg.alloc_mode == "fdp_assumed":
        missing.append("alloc_mode='fdp_assumed'")
    if missing:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(missing)
        )


@dataclasses.dataclass(frozen=True)
class SimContext:
    """Static context of one run: geometry, policy, and the run's shape."""

    geom: Geometry
    mcfg: ManagerConfig
    n_groups: int  # initial groups
    # emit the cumulative (n_app, n_mig) counters after every E-th write
    trace_every: int = 1

    @property
    def h(self) -> int:
        return max(16, int(self.geom.lba_pages * self.mcfg.interval_frac))


def policy_from_config(ctx: SimContext, device) -> dict:
    """A ManagerConfig's policy as the values the step reads: float weights
    as device tensors, the allocation mode as a host string."""
    check_supported(ctx.mcfg)
    return {
        "alloc_mode": ctx.mcfg.alloc_mode,
        "gc_w": torch.tensor(ctx.mcfg.gc_weights(), dtype=torch.float32,
                             device=device),
        "gc_w_greedy": torch.tensor(GC_W_GREEDY, dtype=torch.float32,
                                    device=device),
        "h": torch.tensor(ctx.h, dtype=torch.int32, device=device),
        "ewma_a": torch.tensor(ctx.mcfg.ewma_a, dtype=torch.float32,
                               device=device),
    }


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
    clear (the fused write or :func:`_clear_valid` does that). Returns
    (old_g, old_pm); old_g is 0 for an unmapped page."""
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
# garbage collection (one victim) — §5.4
# ---------------------------------------------------------------------------

def _select_victim(ctx: SimContext, st: SimState, g, gc_w):
    """Multi-objective victim selection, maximised over CLOSED blocks of
    group g:  S(blk) = α·(B − live) − γ·stamp − β·erase_count − τ·trim_dead.

    Every term is an int32 counter cast to float32, summed in the JAX
    package's order, and ``argmax`` returns the first maximum, as there.
    Returns (victim, ok) as device tensors.
    """
    b = ctx.geom.pages_per_block
    closed = (st.state == CLOSED) & (st.group_of == g)
    alpha, beta, gamma, tau = gc_w.unbind()
    score = (
        alpha * (b - st.live).to(torch.float32)
        - gamma * st.stamp.to(torch.float32)
        - beta * st.erase_count.to(torch.float32)
        - tau * st.trim_dead.to(torch.float32)
    )
    victim = torch.argmax(torch.where(closed, score, -torch.inf))
    # a fully-live victim frees nothing: skip it unless the policy is
    # age-driven (γ > 0: LRU must clean stale blocks even when full)
    ok = _get(closed, victim) & ((gamma > 0.0) | (_get(st.live, victim) < b))
    return victim, ok


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


def _gc_drain_bulk_static(ctx: SimContext, st: SimState, victim, g) -> None:
    """Migrate every live page of ``victim`` back into group g, then erase
    it (the JAX package's static-detector drain).

    Live pages fill the group's active block, then at most ONE fresh block:
    the lowest-index FREE block, what the sequential pop hands out. The
    slot contents move through ``compact_slots`` as one move list; the rest
    are masked single-index stores.
    """
    b = ctx.geom.pages_per_block
    k = ctx.geom.n_blocks
    dev = st.device
    lbas = _get(st.slot_lba, victim)       # [B]; dead slots hold -1
    is_live = _get(st.valid, victim)       # [B]
    lbas_c = lbas.clamp(min=0).long()
    live_i = is_live.to(torch.int32)
    n_live = live_i.sum(dtype=torch.int32)
    rank = torch.cumsum(live_i, 0, dtype=torch.int32) - live_i

    ab = _get(st.active_blk, g)
    has_ab = ab >= 0
    ab_c = ab.clamp(min=0).long()
    fill_ab = torch.where(has_ab, _get(st.fill, ab_c), b)
    space = b - fill_ab.clamp(max=b)       # free slots in the active block
    claim = n_live > space
    seal = claim & has_ab

    new_blk = torch.argmax((st.state == FREE).to(torch.int32))
    claim_ok = claim & (st.free_blocks >= 1)
    new_c = torch.where(claim_ok, new_blk, 0)

    # -- per-page destinations ---------------------------------------------
    in_old = rank < space
    dst_blk = torch.where(in_old, ab_c, new_c).to(torch.int32)
    dst_slot = torch.where(in_old, fill_ab + rank, rank - space)
    ok = is_live & (in_old | claim_ok)
    n_old = torch.minimum(n_live, space)
    n_new = torch.where(claim_ok, n_live - n_old, 0)
    n_ok = n_old + n_new

    # -- seal / claim bookkeeping ------------------------------------------
    _set(st.state, ab_c, torch.where(seal, CLOSED, _get(st.state, ab_c)))
    _set(st.state, new_c, torch.where(claim_ok, OPEN, _get(st.state, new_c)))
    _set(st.group_of, new_c,
         torch.where(claim_ok, g, _get(st.group_of, new_c)))
    _set(st.stamp, new_c,
         torch.where(claim_ok, st.clock, _get(st.stamp, new_c)))
    clock = st.clock + claim_ok.to(torch.int32)
    _add(st.fill, ab_c, torch.where(has_ab, n_old, 0))
    _set(st.fill, new_c, torch.where(claim_ok, n_new, _get(st.fill, new_c)))
    _add(st.live, ab_c, torch.where(has_ab, n_old, 0))
    _add(st.live, new_c, torch.where(claim_ok, n_new, 0))
    _set(st.active_blk, g, torch.where(claim_ok, new_blk, ab))

    # -- land the pages -----------------------------------------------------
    idx = torch.arange(b, dtype=torch.int32, device=dev)
    src = torch.where(ok, victim, -1).to(torch.int32)
    db = torch.where(ok, dst_blk, k)       # masked rows land nowhere
    compact_slots_(
        st.slot_lba[None], st.valid[None],
        src[None], idx[None], db[None], dst_slot.to(torch.int32)[None],
    )
    _scatter_live(
        st.page_map, lbas_c, torch.where(ok, dst_blk * b + dst_slot, -1),
        is_live,
    )

    # -- erase the victim ---------------------------------------------------
    # +1 physical block if one was claimed, -1 for the erased victim
    _add(st.grp_phys, g, torch.where(claim_ok, 0, -1))
    e_old = _get(st.erase_count, victim)
    _set(st.state, victim, FREE)
    _set(st.group_of, victim, -1)
    _set(st.fill, victim, 0)
    _set(st.live, victim, 0)
    _set(st.slot_lba, victim, -1)
    _set(st.valid, victim, False)
    _set(st.stamp, victim, clock)
    st.clock.copy_(clock + 1)
    st.grp_surplus.copy_(surplus_of(st.grp_active, st.grp_phys, st.grp_alloc))
    st.free_blocks.add_(1 - claim_ok.to(torch.int32))
    st.mapped_pages.sub_(n_live - n_ok)
    _add(st.grp_size, g, n_ok - n_live)
    _add(st.grp_live, g, n_ok - n_live)
    st.n_mig.add_(n_ok)
    st.n_dropped.add_(n_live - n_ok)
    st.n_erase.add_(1)
    _add(st.erase_count, victim, 1)
    _set(st.trim_dead, victim, 0)
    st.erase_total.add_(1)
    st.erase_sq_total.add_(2 * e_old + 1)


def _gc_one(ctx: SimContext, st: SimState, g, gc_w, enabled=True) -> None:
    """GC one victim of group g if ``enabled`` and a victim qualifies; the
    pool must hold a block for the migrations (callers keep it ≥ 2)."""
    victim, ok = _select_victim(ctx, st, g, gc_w)
    if _when(ok & (st.free_blocks >= 1) & enabled):
        _gc_drain_bulk_static(ctx, st, victim, g)


# ---------------------------------------------------------------------------
# over-provisioning allocation (interval) — §5.5
# ---------------------------------------------------------------------------

def _recompute_alloc(ctx: SimContext, st: SimState, policy) -> None:
    geom, mcfg = ctx.geom, ctx.mcfg
    b = geom.pages_per_block
    active = st.grp_active
    # EFFECTIVE group sizes (carried grp_live == mapped pages per group)
    s = torch.where(active, st.grp_live.to(torch.float32), 0.0)
    s = torch.maximum(s, active.to(torch.float32))
    p = torch.where(active, st.grp_p, 0.0)
    p = p / torch.clamp(fsum(p), min=1e-9)
    # usable OP = spare pages beyond logical content, minus the GC reserve
    # and one block per active group
    n_active = active.sum(dtype=torch.int32)
    op_total = (
        float(geom.pba_pages)
        - (mcfg.gc_reserve_blocks + 1 + n_active) * b
        - fsum(s)
    )
    if policy["alloc_mode"] in ("wolf", "optimal"):
        op = allocate_closed_form(
            s, p, op_total,
            cold_rule=True,
            cold_hit_rate_frac=mcfg.cold_hit_rate_frac,
            cold_op_frac=mcfg.cold_op_frac,
        )
    elif policy["alloc_mode"] == "freq":
        op = allocate_by_frequency(p, op_total)
    else:
        op = allocate_by_size(s, op_total)
    alloc_blocks = torch.ceil((s + op) / b).to(torch.int32)
    alloc_blocks = torch.where(active, alloc_blocks.clamp(min=1), 0)
    st.grp_alloc.copy_(alloc_blocks)
    st.grp_surplus.copy_(surplus_of(active, st.grp_phys, st.grp_alloc))


def _interval_update(ctx: SimContext, st: SimState, policy) -> None:
    a = policy["ewma_a"]
    u = st.grp_writes.to(torch.float32) / policy["h"].to(torch.float32)
    st.grp_p.copy_(
        torch.where(st.grp_active, st.grp_p * (1.0 - a) + a * u, 0.0)
    )
    st.grp_writes.zero_()
    st.interval.add_(1)
    st.cooldown.copy_((st.cooldown - 1).clamp(min=0))
    _recompute_alloc(ctx, st, policy)


# ---------------------------------------------------------------------------
# the step + runner
# ---------------------------------------------------------------------------

def _step_tail(ctx: SimContext, st: SimState, lba, t: int, g, policy) -> None:
    """GC → emergency valve → write → movement ops → §5.1 interval update:
    the heavy path, downstream of invalidate + target selection."""
    mcfg = ctx.mcfg
    b = ctx.geom.pages_per_block

    # GC when the group needs a new block it is not entitled to, or the
    # pool is at reserve
    blk = _get(st.active_blk, g)
    needs_block = torch.where(
        blk >= 0, _get(st.fill, blk.clamp(min=0)) >= b, True
    )
    over_budget = _get(st.grp_phys, g) >= _get(st.grp_alloc, g)
    low_pool = st.free_blocks <= mcfg.gc_reserve_blocks
    _gc_one(ctx, st, g, policy["gc_w"],
            enabled=needs_block & (over_budget | low_pool))

    # emergency valve: while the pool is (nearly) empty, greedily reclaim
    # the best victim anywhere (its group pays), a bounded number of times
    tries = 0
    while tries < mcfg.valve_max_tries and _when(st.free_blocks < 2):
        score = torch.where(st.state == CLOSED, st.live, INT_MAX)
        victim = torch.argmin(score)
        g_v = _get(st.group_of, victim).clamp(min=0).long()
        _gc_one(ctx, st, g_v, policy["gc_w_greedy"])
        tries += 1

    _write_page(ctx, st, lba, g)
    st.n_app.add_(1)
    _add(st.grp_writes, g, 1)

    # movement operations (§5.3): one compaction GC on the most surplus
    # group, donating the redeemed block to the pool
    if mcfg.movement_ops:
        g_s = torch.argmax(st.grp_surplus)
        _gc_one(
            ctx, st, g_s, policy["gc_w"],
            enabled=(_get(st.grp_surplus, g_s) >= 1) & (st.free_blocks >= 2),
        )

    # interval completion (§5.1): t + 1 == n_app after this write
    if (t + 1) % ctx.h == 0:
        _interval_update(ctx, st, policy)


def _split_write(ctx: SimContext, st: SimState, lba, t: int, policy) -> None:
    """One application write: the fast path when every heavy predicate is
    false (exact, not conservative), else :func:`_step_tail`."""
    b = ctx.geom.pages_per_block
    # the static detector targets the page's own group (the static branch
    # of the JAX package's _target_group_app)
    g, old_pm = _invalidate_counts(ctx, st, lba)

    blk = _get(st.active_blk, g)
    blk_c = blk.clamp(min=0).long()
    slot = _get(st.fill, blk_c)
    # heavy-path predicates: no room in the active block, the valve could
    # fire, movement could fire (a fast write changes no surplus), or the
    # interval closes
    may = (blk < 0) | (slot >= b) | (st.free_blocks < 2)
    if ctx.mcfg.movement_ops:
        may = may | (st.grp_surplus.max() >= 1)
    heavy = ((t + 1) % ctx.h == 0) or _when(may)
    if heavy:
        _clear_valid(ctx, st, old_pm)
        _step_tail(ctx, st, lba, t, g, policy)
        return
    # the op row is built on the device: (lba, old_pm, new_pm, ok)
    row = torch.stack([
        lba.to(torch.int32), old_pm, (blk_c * b + slot).to(torch.int32),
        torch.ones((), dtype=torch.int32, device=st.device),
    ])[None]
    apply_write_(row, st.page_map[None], st.slot_lba[None], st.valid[None])
    _add(st.fill, blk_c, 1)
    _add(st.live, blk_c, 1)
    _add(st.grp_size, g, 1)
    _add(st.grp_live, g, 1)
    st.mapped_pages.add_(1)
    st.n_app.add_(1)
    _add(st.grp_writes, g, 1)


def scan_writes(ctx: SimContext, st: SimState, lbas: torch.Tensor,
                t0: int, policy):
    """Fold the write step over ``lbas`` (a device tensor), emitting the
    cumulative (n_app, n_mig) counters after every ``ctx.trace_every``-th
    write. ``t0`` is the global index of the first write. Returns device
    tensors (app, mig) of length len(lbas) // trace_every."""
    e = ctx.trace_every
    n = int(lbas.shape[0])
    if n % e:
        raise ValueError(f"trace_every={e} must divide the segment length {n}")
    app = torch.empty(n // e, dtype=torch.int32, device=st.device)
    mig = torch.empty_like(app)
    for j in range(n):
        _split_write(ctx, st, lbas[j], t0 + j, policy)
        if (j + 1) % e == 0:
            app[(j + 1) // e - 1] = st.n_app
            mig[(j + 1) // e - 1] = st.n_mig
    return app, mig


def run(ctx: SimContext, st: SimState, lbas, *, device="cuda"):
    """Run the simulator over a segment of writes on ``device``.

    lbas: int array [T]. The state is moved to ``device`` if it is not
    there and is updated in place; thread the returned state forward
    across segments. Returns (final_state, trace): ``app``/``mig`` are
    numpy arrays of the CUMULATIVE counters ([T] dense, or
    [T // ctx.trace_every] sampled at every trace_every-th write) and
    ``host_syncs`` counts the device→host reads the segment made.
    """
    st = st.to(device)
    policy = policy_from_config(ctx, st.device)
    lbas = torch.as_tensor(np.asarray(lbas), dtype=torch.int64,
                           device=st.device)
    syncs0 = host_syncs
    app, mig = scan_writes(ctx, st, lbas, int(st.n_app), policy)
    trace = {
        "app": app.cpu().numpy(),
        "mig": mig.cpu().numpy(),
        "host_syncs": host_syncs - syncs0,
    }
    return st, trace

"""Plain PyTorch version of the GC kernel (``kernels/csrc/gc_one.cu``):
the same GC, drive by drive, on the tensors, in place.

Each drive chooses its group by ``mode`` as the simulator's ``_step_tail``
does (the given g, enabled when it needs a block it is not entitled to or
the pool is at reserve; the emergency valve's group of the CLOSED block
with the fewest live pages; the movement operation's group of the largest
surplus), its victim by the weighted score (:func:`select_victim`), and
decides; asked to drain, a decided GC drains the victim (the static
detector's :func:`drain_static`; the FDP and bloom detectors'
:func:`drain_demoting`, inside a ``gc.demote_drain`` span) and, with a
fault policy, the erase goes through the retry-then-retire hook
(:func:`erase_fault_retire`). ``out[d] = (victim, g, do)``. A drive that
``enable`` leaves out is not touched: ``out[d] = (-1, -1, 0)``.

Decisions are Python values read from the tensors, uncounted: on the CPU
the tensors are the host's own. The score is the simulator's float32
formula, op by op, as the kernel rounds it. What it is held to, on the
CPU, is the JAX package's ``_gc_one`` (``tests/test_torch_gc_one.py``).
"""

from __future__ import annotations

import torch

from repro_torch.core.ssd import (
    CLOSED,
    FREE,
    INT32_MAX,
    OPEN,
    RETIRED,
    STATUS_DEGRADED,
    STATUS_OK,
)
from repro_torch.kernels.gc_compact.ops import compact_slots_
from repro_torch.kernels.gc_one.kernel import FAULT_POLICY
from repro_torch.utils.spans import span

_U32 = 0xFFFFFFFF


def select_victim(s, g: int, gc_w):
    """Multi-objective victim selection over CLOSED blocks of group g:
    S(blk) = α·(B − live) − γ·stamp − β·erase_count − τ·trim_dead, every
    term an int32 counter cast to float32 and summed in the JAX package's
    order; ``argmax`` returns the first maximum, as there. ``s`` holds one
    drive's fields. Returns (victim, ok) as Python values: a fully-live
    victim frees nothing and is refused unless the policy is age-driven
    (γ > 0: LRU must clean stale blocks even when full)."""
    b = s["slot_lba"].shape[-1]
    closed = (s["state"] == CLOSED) & (s["group_of"] == g)
    alpha, beta, gamma, tau = gc_w.unbind()
    score = (
        alpha * (b - s["live"]).to(torch.float32)
        - gamma * s["stamp"].to(torch.float32)
        - beta * s["erase_count"].to(torch.float32)
        - tau * s["trim_dead"].to(torch.float32)
    )
    victim = int(torch.argmax(torch.where(closed, score, -torch.inf)))
    ok = bool(closed[victim]) and (
        bool(gamma > 0.0) or int(s["live"][victim]) < b)
    return victim, ok


def decide(s, gc_w, g, *, mode, gc_reserve_blocks):
    """One drive's group (-1 for an index outside the groups), victim and
    decision, as Python values."""
    k, b = s["slot_lba"].shape
    n_groups = s["grp_size"].shape[0]
    free0 = int(s["free_blocks"])
    if mode == "gc":
        enabled = False
        if 0 <= g < n_groups:
            blk = int(s["active_blk"][g])
            needs_block = int(s["fill"][min(blk, k - 1)]) >= b if blk >= 0 \
                else True
            over_budget = int(s["grp_phys"][g]) >= int(s["grp_alloc"][g])
            enabled = needs_block and (
                over_budget or free0 <= gc_reserve_blocks)
        else:
            g = -1
    elif mode == "valve":
        # the best victim anywhere (its group pays)
        score = torch.where(s["state"] == CLOSED, s["live"], INT32_MAX)
        g = max(int(s["group_of"][int(torch.argmin(score))]), 0)
        g = g if g < n_groups else -1
        enabled = True
    else:  # movement: the group of the largest surplus
        g = int(torch.argmax(s["grp_surplus"]))
        enabled = int(s["grp_surplus"][g]) >= 1 and free0 >= 2
    victim, ok = select_victim(s, g, gc_w)
    # an active block outside the drive (never made) refuses the drain
    do = (g >= 0 and enabled and ok and free0 >= 1
          and int(s["active_blk"][g]) < k)
    return victim, g, do


def drain_static(s, victim: int, g: int) -> None:
    """Migrate every live page of ``victim`` back into group g, then erase
    it (the JAX package's ``_gc_drain_bulk_static``), in place on one
    drive's fields ``s``.

    Live pages fill the group's active block, then at most ONE fresh block:
    the lowest-index FREE block, what the sequential pop hands out; pages
    that find no block are dropped and counted. Every victim slot is read
    before any slot is written."""
    slot_lba, valid = s["slot_lba"], s["valid"]
    k, b = slot_lba.shape
    state, group_of, stamp = s["state"], s["group_of"], s["stamp"]
    fill, live, page_map = s["fill"], s["live"], s["page_map"]
    lbas = slot_lba[victim].tolist()       # dead slots hold -1
    flags = valid[victim].tolist()
    n_live = sum(flags)

    ab = int(s["active_blk"][g])
    has_ab = ab >= 0
    ab_c = max(ab, 0)
    fill_ab = int(fill[ab_c]) if has_ab else b
    space = b - min(fill_ab, b)            # free slots in the active block
    claim = n_live > space
    free0 = int(s["free_blocks"])
    claim_ok = claim and free0 >= 1
    new_blk = int(torch.argmax((state == FREE).to(torch.int32)))
    new_c = new_blk if claim_ok else 0
    n_old = min(n_live, space)
    n_new = n_live - n_old if claim_ok else 0
    n_ok = n_old + n_new

    # -- seal / claim bookkeeping ------------------------------------------
    clock = int(s["clock"])
    if claim and has_ab:
        state[ab_c] = CLOSED
    if claim_ok:
        state[new_c] = OPEN
        group_of[new_c] = g
        stamp[new_c] = clock
        clock += 1
    if has_ab:
        fill[ab_c] += n_old
        live[ab_c] += n_old
    if claim_ok:
        fill[new_c] = n_new
        live[new_c] += n_new
        s["active_blk"][g] = new_blk

    # -- land the pages -----------------------------------------------------
    dst, moved, dropped = [], [], []
    rank = 0
    for lba, is_live in zip(lbas, flags):
        if not is_live:
            continue
        if rank < space:
            dst.append(ab_c * b + fill_ab + rank)
            moved.append(lba)
        elif claim_ok:
            dst.append(new_c * b + rank - space)
            moved.append(lba)
        else:
            dropped.append(lba)
        rank += 1
    lba_pages = page_map.shape[0]
    if dst:
        dev = slot_lba.device
        slot_lba.view(-1)[dst] = torch.tensor(moved, dtype=torch.int32,
                                              device=dev)
        valid.view(-1)[dst] = True
        mapped = [(lba, f) for lba, f in zip(moved, dst)
                  if 0 <= lba < lba_pages]  # the kernel's guard
        if mapped:
            page_map[[lba for lba, _ in mapped]] = torch.tensor(
                [f for _, f in mapped], dtype=torch.int32, device=dev)
    dropped = [lba for lba in dropped if 0 <= lba < lba_pages]
    if dropped:
        page_map[dropped] = -1

    # -- the counters, then the victim erased ---------------------------------
    s["grp_phys"][g] += int(claim_ok)
    s["free_blocks"].fill_(free0 - int(claim_ok))
    s["mapped_pages"].sub_(n_live - n_ok)
    s["grp_size"][g] += n_ok - n_live
    s["grp_live"][g] += n_ok - n_live
    s["n_mig"].add_(n_ok)
    s["n_dropped"].add_(n_live - n_ok)
    erase(s, victim, g, clock)


def erase(s, victim: int, g: int, clock: int) -> None:
    """Erase one drive's drained ``victim`` of group g at ``clock`` (the
    claims' stamps already taken), in place on its fields ``s``: g's block
    back in the pool and every group's surplus, then the victim FREE,
    unlabelled, empty, stamped, one more P-E cycle (Σe² gains (e+1)² −
    e²), its trimmed-slot tally cleared, the clock advanced."""
    s["grp_phys"][g] -= 1
    s["grp_surplus"].copy_(torch.where(
        s["grp_active"], s["grp_phys"] - s["grp_alloc"], -INT32_MAX))
    s["free_blocks"].add_(1)
    e_old = int(s["erase_count"][victim])
    s["state"][victim] = FREE
    s["group_of"][victim] = -1
    s["fill"][victim] = 0
    s["live"][victim] = 0
    s["slot_lba"][victim] = -1
    s["valid"][victim] = False
    s["stamp"][victim] = clock
    s["clock"].fill_(clock + 1)
    s["n_erase"].add_(1)
    s["erase_count"][victim] = e_old + 1
    s["trim_dead"][victim] = 0
    s["erase_total"].add_(1)
    s["erase_sq_total"].add_(2 * e_old + 1)


def bloom_hashes(lba, bits: int):
    """The JAX package's two uint32 hashes of ``lba`` (int tensor, any
    shape, non-negative), reduced mod the filter width ``bits``: the
    products wrap at 2**32 there, so they are taken in int64 and masked to
    32 bits."""
    u = lba.long() & _U32
    h1 = ((u * 2654435761) & _U32) % bits
    h2 = ((u * 40503 + 99991) & _U32) % bits
    return h1, h2


def bloom_query(filt, lba, g: int):
    """Whether each page of ``lba`` (int tensor, any shape) is in group
    g's filter of one drive's pair ``filt`` [G, bits]."""
    h1, h2 = bloom_hashes(lba, filt.shape[-1])
    return filt[g, h1] & filt[g, h2]


def demote_flags(s, lbas, g: int, fdp_policy=None):
    """The §5.6 GC demotion predicate over one drive's victim pages
    ``lbas`` [B] (its fields ``s``): under the FDP detector (``fdp_policy``,
    the drive's rates) the oracle rate below half the group's assumed rate,
    else the page in neither of group g's bloom filters. It reads only what
    a drain leaves unchanged."""
    if fdp_policy is not None:
        return (fdp_policy["page_rate"][lbas]
                < 0.5 * fdp_policy["fdp_rate"][g])
    return (~bloom_query(s["bloom_active"], lbas, g)
            & ~bloom_query(s["bloom_passive"], lbas, g))


def colder_neighbor(hr, active, g: int) -> int:
    """The next colder active group of an active g in the stable (-hr,
    index) order of one drive's hit rates ``hr`` [G]: the candidate
    (colder, or as cold with a higher index) with the highest hit rate,
    ties to the lowest index; g itself when it is the coldest."""
    n = hr.shape[0]
    idx = torch.arange(n, device=hr.device)
    cand = active & ((hr < hr[g]) | ((hr == hr[g]) & (idx > g)))
    if not bool(cand.any()):
        return g
    best = torch.where(cand, hr, -2.0).amax()
    return int(torch.where(cand & (hr == best), idx, n).amin())


def demotion_targets(s, flagged, g: int):
    """Target group [B] of each victim slot: one group colder for the
    ``flagged`` live slots, g for the rest. The colder neighbour reads hit
    rates over the group sizes as the drain has moved them so far, so the
    flagged slots are taken in slot order."""
    targets = torch.full(flagged.shape, g, dtype=torch.long,
                         device=flagged.device)
    sizes = s["grp_live"].clone()
    active = s["grp_active"]
    for j in flagged.nonzero().flatten().tolist():
        hr = torch.where(
            active, s["grp_p"] / sizes.to(torch.float32).clamp(min=1.0), -1.0)
        nb = colder_neighbor(hr, active, g)
        targets[j] = nb
        sizes[g] -= 1
        sizes[nb] += 1
    return targets


def drain_demoting(s, victim: int, g: int, fdp_policy=None) -> None:
    """Migrate every live page of ``victim``, each into its target group
    (§5.6 demotion under the FDP or bloom detector), then erase it (the
    JAX package's ``_gc_drain_bulk``), in place on one drive's fields
    ``s``; ``fdp_policy`` holds the drive's FDP rates (None under bloom).

    Pages are counted per target group; each group whose pages overflow its
    active block claims ONE fresh block, and the i-th claim (ordered by
    the slot of the group's first page that does not fit) takes the i-th
    lowest FREE block, what the sequential pop hands out; pages that find
    no block are dropped and counted. The slot contents move through
    ``compact_slots`` as one move list."""
    slot_lba, valid = s["slot_lba"], s["valid"]
    k, b = slot_lba.shape
    g_max = s["grp_active"].shape[0]
    dev = slot_lba.device
    lbas = slot_lba[victim].clone()        # [B]; dead slots hold -1
    is_live = valid[victim].clone()        # [B]
    lbas_c = lbas.clamp(min=0).long()
    targets = demotion_targets(
        s, demote_flags(s, lbas_c, g, fdp_policy) & is_live, g)

    # -- pages per target group; fresh-block claims -------------------------
    idx = torch.arange(b, device=dev)
    arange_g = torch.arange(g_max, device=dev)
    onehot_t = torch.where(is_live, targets, g_max)[:, None] == arange_g
    m = onehot_t.sum(0)                    # [G] live pages per target
    ab = s["active_blk"].long()
    has_ab = ab >= 0
    ab_c = ab.clamp(min=0)
    fill_ab = torch.where(has_ab, s["fill"][ab_c].long(), b)
    space = b - fill_ab.clamp(max=b)       # [G] free slots in active blocks
    claim = m > space
    seal = claim & has_ab
    # within-group rank of each live page, in slot order
    same = ((targets[:, None] == targets[None, :])
            & is_live[None, :] & is_live[:, None])
    rank = (same & (idx[None, :] < idx[:, None])).sum(1)
    space_t = space[targets]
    first_out = is_live & (rank == space_t)    # a group's first overflow
    claim_pos = torch.where(onehot_t & first_out[:, None], idx[:, None],
                            INT32_MAX).amin(0)
    claim_rank = (claim[None, :]
                  & (claim_pos[None, :] < claim_pos[:, None])).sum(1)
    # free_by_rank[r]: the r-th lowest FREE block (k when there is none)
    n_free_before = torch.cumsum((s["state"] == FREE).long(), 0)
    free_by_rank = torch.searchsorted(n_free_before, arange_g + 1)
    claim_ok = claim & (claim_rank < s["free_blocks"])
    new_blk = torch.where(
        claim_ok, free_by_rank[claim_rank.clamp(max=g_max - 1)], -1)

    # -- per-page destinations ---------------------------------------------
    in_old = rank < space_t
    dst_blk = torch.where(in_old, ab_c[targets], new_blk[targets])
    dst_slot = torch.where(in_old, fill_ab[targets] + rank, rank - space_t)
    ok = is_live & (in_old | claim_ok[targets])
    db = torch.where(ok, dst_blk, k)       # masked rows land nowhere

    # -- seal / claim bookkeeping ([K + 1] scratch: row k takes the rest) ---
    sealed = torch.zeros(k + 1, dtype=torch.bool, device=dev)
    sealed.index_fill_(0, torch.where(seal, ab_c, k), True)
    claimed_by = torch.full((k + 1,), -1, dtype=torch.long, device=dev)
    claim_at = torch.where(claim_ok, new_blk, k)
    claimed_by.index_copy_(0, claim_at, arange_g)
    claim_stamp = torch.zeros(k + 1, dtype=torch.long, device=dev)
    claim_stamp.index_copy_(0, claim_at, s["clock"] + claim_rank)
    claimed = claimed_by[:k] >= 0
    s["state"].copy_(torch.where(
        claimed, OPEN, torch.where(sealed[:k], CLOSED, s["state"])))
    s["group_of"].copy_(torch.where(claimed, claimed_by[:k], s["group_of"]))
    s["stamp"].copy_(torch.where(claimed, claim_stamp[:k], s["stamp"]))
    n_claimed = int(claim_ok.sum())
    s["active_blk"].copy_(torch.where(claim_ok, new_blk, ab))

    # -- land the pages -----------------------------------------------------
    landed_k = torch.zeros(k + 1, dtype=torch.int32, device=dev)
    landed_k.index_add_(0, db, ok.to(torch.int32))
    s["fill"].copy_(torch.where(claimed, 0, s["fill"]) + landed_k[:k])
    s["live"].add_(landed_k[:k])
    src = torch.where(ok, victim, -1).to(torch.int32)
    compact_slots_(slot_lba[None], valid[None], src[None],
                   idx.to(torch.int32)[None], db.to(torch.int32)[None],
                   dst_slot.to(torch.int32)[None])
    s["page_map"][lbas_c[is_live]] = torch.where(
        ok, dst_blk * b + dst_slot, -1)[is_live].to(torch.int32)
    n_live, n_ok = int(is_live.sum()), int(ok.sum())
    landed_g = torch.zeros(g_max, dtype=torch.int32, device=dev)
    landed_g.index_add_(0, targets, ok.to(torch.int32))
    for grp in (s["grp_size"], s["grp_live"]):
        grp.add_(landed_g)
        grp[g] -= n_live

    # -- the counters, then the victim erased ---------------------------------
    s["grp_phys"].add_(claim_ok.to(torch.int32))
    s["free_blocks"].sub_(n_claimed)
    s["mapped_pages"].sub_(n_live - n_ok)
    s["n_mig"].add_(n_ok)
    s["n_dropped"].add_(n_live - n_ok)
    erase(s, victim, g, int(s["clock"]) + n_claimed)


def _mul32(x, c: int):
    """``x * c`` modulo 2**32 for x in [0, 2**32) (an int64 tensor or a
    Python int) and a 32-bit constant c: the product is taken in 16-bit
    halves of c, so no intermediate leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def fault_uniform(seed, n):
    """The JAX package's counter-based uniform in [0, 1): murmur3's fmix32
    over (seed, draw index), both in [0, 2**32) as int64 tensors, wrapped
    at 2**32 after every step as uint32 arithmetic wraps. The top 24 hash
    bits make an exactly representable float32."""
    h = (seed + _mul32(n, 2654435761)) & _U32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * 2.0 ** -24


def integer_pow(x, k: int):
    """``x ** k`` for a Python int k >= 1 as ``lax.integer_pow`` lowers it
    (square and multiply, ``acc = x`` at the lowest set bit), one rounded
    float32 product at a time: ``torch.pow`` may round differently."""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def erase_fault_retire(s, victim, g, policy, erase_max_retries: int) -> None:
    """The JAX package's ``_erase_fault_retire``: the retry-then-retire
    fault hook on one drive's fields ``s`` right after a drain erased
    ``victim`` of group ``g`` (0-d int64 tensors), in place, with no host
    read. ``policy`` holds the drive's :data:`FAULT_POLICY` as 0-d tensors.

    One uniform u (seeded by ``fault_seed``, indexed by ``fault_draws``)
    decides: the erase failed iff u < rate, and every one of its
    ``1 + erase_max_retries`` attempts failed (the block retires) iff
    u < rate^(1 + retries). The rate is ``fault_rate`` until the block's
    P-E count before this erase reaches ``endurance_limit``, then the
    larger of it and ``fault_rate_worn``. A retire undoes the erase's wear
    (count, Σe, Σe², ``n_erase``), makes the block RETIRED under group g,
    takes it out of the pool and draws a spare; a retire that finds no
    spare, or leaves the pool empty, degrades the drive at ``n_app``."""
    v, gg = victim.reshape(1), g.reshape(1)

    def get(t, i):
        return t.index_select(0, i).reshape(())

    def put(t, i, val):
        t.index_put_((i,), val.to(t.dtype).reshape(1))

    ec_new = get(s["erase_count"], v)  # the erase's post-bump count
    worn = (ec_new - 1) >= policy["endurance_limit"]
    base = policy["fault_rate"]
    rate = torch.where(worn, torch.maximum(policy["fault_rate_worn"], base),
                       base)
    draws = s["fault_draws"].view(torch.int32).long() & _U32
    u = fault_uniform(policy["fault_seed"], draws)
    failed = u < rate
    retired = u < integer_pow(rate, 1 + erase_max_retries)
    d = retired.to(torch.int32)
    spares0 = s["spares_left"].clone()
    free_after = s["free_blocks"] - d
    degrade = (retired & (s["drive_status"] == STATUS_OK)
               & ((spares0 <= 0) | (free_after <= 0)))
    put(s["state"], v, torch.where(retired, RETIRED, get(s["state"], v)))
    put(s["group_of"], v, torch.where(retired, g, get(s["group_of"], v)))
    s["free_blocks"].copy_(free_after)
    put(s["erase_count"], v, ec_new - d)
    s["erase_total"].sub_(d)
    s["erase_sq_total"].sub_(d * (2 * (ec_new - 1) + 1))
    s["n_erase"].sub_(d)
    s["retired_blocks"].add_(d)
    s["grp_retired"].index_add_(0, gg, d.reshape(1))
    s["spares_left"].copy_(torch.clamp(spares0 - d, min=0))
    s["n_erase_fail"].add_(failed.to(torch.int32))
    s["drive_status"].copy_(torch.where(degrade, STATUS_DEGRADED,
                                        s["drive_status"]))
    s["degraded_at"].copy_(torch.where(degrade & (s["degraded_at"] < 0),
                                       s["n_app"], s["degraded_at"]))
    s["fault_draws"].view(torch.int32).add_(1)  # wraps as uint32 does


def gc_one_ref(state, gc_w, g, out, enable=None, fault_policy=None,
               fdp_policy=None, *, mode, td_mode, drain, gc_reserve_blocks,
               erase_max_retries=0) -> None:
    """In place, the arguments of ``gc_one_cuda`` (see
    ``kernel.check_args``): each enabled drive's GC, one drive after
    another, decided and, with ``drain``, drained (demoting under the FDP
    and bloom detectors, from the drive's ``fdp_policy`` rates under FDP);
    with ``fault_policy`` (the :data:`FAULT_POLICY` tensors [D]) each
    drain's erase goes through :func:`erase_fault_retire`."""
    for d in range(out.shape[0]):
        if enable is not None and not bool(enable[d]):
            out[d] = torch.tensor([-1, -1, 0], device=out.device)
            continue
        s = {k: v[d] for k, v in state.items()}
        victim, grp, do = decide(
            s, gc_w[d], None if g is None else int(g[d]), mode=mode,
            gc_reserve_blocks=gc_reserve_blocks)
        out[d] = torch.tensor([victim, grp, int(do)], device=out.device)
        if not (do and drain):
            continue
        if td_mode == "static":
            drain_static(s, victim, grp)
        else:
            with span("gc.demote_drain"):
                drain_demoting(s, victim, grp, None if fdp_policy is None
                               else {k: v[d] for k, v in fdp_policy.items()})
        if fault_policy is not None:
            erase_fault_retire(
                s, out[d, 0], out[d, 1],
                {k: fault_policy[k][d] for k in FAULT_POLICY},
                erase_max_retries)

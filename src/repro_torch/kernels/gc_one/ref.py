"""Plain PyTorch version of the GC kernel (``kernels/csrc/gc_one.cu``):
the same GC, drive by drive, on the tensors, in place.

Each drive chooses its group by ``mode`` as the simulator's ``_step_tail``
does (the given g, enabled when it needs a block it is not entitled to or
the pool is at reserve; the emergency valve's group of the CLOSED block
with the fewest live pages; the movement operation's group of the largest
surplus), its victim by the weighted score (:func:`select_victim`), and
decides; under the static detector a decided GC drains the victim
(:func:`drain_static`). ``out[d] = (victim, g, do)``. A drive that
``enable`` leaves out is not touched: ``out[d] = (-1, -1, 0)``.

Decisions are Python values read from the tensors, uncounted: on the CPU
the tensors are the host's own. The score is the simulator's float32
formula, op by op, as the kernel rounds it. What it is held to, on the
CPU, is the JAX package's ``_gc_one`` (``tests/test_torch_gc_one.py``).
"""

from __future__ import annotations

import torch

from repro_torch.core.ssd import CLOSED, FREE, INT32_MAX, OPEN


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

    # -- erase the victim ---------------------------------------------------
    # +1 physical block if one was claimed, -1 for the erased victim
    if not claim_ok:
        s["grp_phys"][g] -= 1
    s["grp_surplus"].copy_(torch.where(
        s["grp_active"], s["grp_phys"] - s["grp_alloc"], -INT32_MAX))
    s["free_blocks"].fill_(free0 + (0 if claim_ok else 1))
    s["mapped_pages"].sub_(n_live - n_ok)
    s["grp_size"][g] += n_ok - n_live
    s["grp_live"][g] += n_ok - n_live
    s["n_mig"].add_(n_ok)
    s["n_dropped"].add_(n_live - n_ok)
    e_old = int(s["erase_count"][victim])
    state[victim] = FREE
    group_of[victim] = -1
    fill[victim] = 0
    live[victim] = 0
    slot_lba[victim] = -1
    valid[victim] = False
    stamp[victim] = clock
    s["clock"].fill_(clock + 1)
    s["n_erase"].add_(1)
    s["erase_count"][victim] = e_old + 1
    s["trim_dead"][victim] = 0
    s["erase_total"].add_(1)
    s["erase_sq_total"].add_(2 * e_old + 1)


def gc_one_ref(state, gc_w, g, out, enable=None, *, mode, td_mode,
               gc_reserve_blocks) -> None:
    """In place, the arguments of ``gc_one_cuda`` (see
    ``kernel.check_args``): each enabled drive's GC, one drive after
    another."""
    for d in range(out.shape[0]):
        if enable is not None and not bool(enable[d]):
            out[d] = torch.tensor([-1, -1, 0], device=out.device)
            continue
        s = {k: v[d] for k, v in state.items()}
        victim, grp, do = decide(
            s, gc_w[d], None if g is None else int(g[d]), mode=mode,
            gc_reserve_blocks=gc_reserve_blocks)
        out[d] = torch.tensor([victim, grp, int(do)], device=out.device)
        if do and td_mode == "static":
            drain_static(s, victim, grp)

"""Plain PyTorch version of the run kernel (``kernels/csrc/write_run.cu``):
the same loop, event by event, on the tensors, in place.

Each drive walks its events from ``start[d] = (j0, w)``: a TRIM unmaps
its page, kills the slot and tallies it on its block (``trim_dead``); a
WRITE is decided first, writing nothing (old mapping and group, layout
group on an op stream, §5.6 target group, heavy predicate, bloom
rotation), then either stops the run before it or commits as the
simulator's fast write: one page appended to its group's open block.
``stop[d] = (first event not completed, w there, why)``, why an index
into ``kernel.STOP_WHY``. With faults, a drive already degraded lands
every event left as a halted no-op (``n_halted``; a WRITE still advances
w) and runs to the end. Integers are Python ints; the two float32 decisions
are rounded as the simulator rounds them: the FDP band compares float32
values, and the hit rates are float32 divisions (torch, on the host).
What it is held to, on the CPU, is the simulator's per-event step
(``tests/test_torch_write_run.py``) and the JAX package's run.
"""

from __future__ import annotations

import torch

OP_TRIM = 1  # repro_torch.core.workloads.OP_TRIM
STATUS_OK = 0  # repro_torch.core.ssd.STATUS_OK
END, HEAVY, ROTATION, INDEX = range(4)  # kernel.STOP_WHY


def _hit_rates(grp_p, active, live_after):
    """Per-group hit rates as the simulator's ``_hit_rates`` computes
    them, over the group live counts ``live_after`` (after this write's
    decrement): float32 p / max(live, 1), -1 for an inactive group."""
    lv = torch.tensor(live_after, dtype=torch.int32).to(torch.float32)
    return torch.where(active, grp_p / lv.clamp(min=1.0), -1.0).tolist()


def _neighbor_hotter(hr, active, g):
    """The next hotter active group of g in the stable (-hr, index) order:
    the candidate (hotter, or as hot with a lower index) with the lowest
    hit rate, ties to the highest index; g itself when it is the hottest."""
    nb, best = -1, 0.0
    for i, (r, act) in enumerate(zip(hr, active)):
        if act and (r > hr[g] or (r == hr[g] and i < g)) and (
                nb < 0 or r <= best):
            nb, best = i, r
    return g if nb < 0 else nb


def _halt_drive(d, ops, start, stop, s, app, mig, n, trace_every):
    """A degraded drive's events from ``start[d]`` to the end, each a
    counted no-op (the JAX package's ``_halt_wrap``)."""
    j, w = start[d].tolist()
    n_app, n_mig = int(s["n_app"]), int(s["n_mig"])
    is_write = ([True] * n if ops is None
                else [o != OP_TRIM for o in ops[d].tolist()])
    for jj in range(j, n):
        w += is_write[jj]
        if (jj + 1) % trace_every == 0:
            app[d, (jj + 1) // trace_every - 1] = n_app
            mig[d, (jj + 1) // trace_every - 1] = n_mig
    s["n_halted"].add_(max(n - j, 0))
    stop[d, 0] = max(j, n)
    stop[d, 1] = w
    stop[d, 2] = END


def _run_drive(d, lbas, ops, start, stop, state, policy, app, mig, *, h,
               trace_every, td_mode, movement_ops, bloom_rotate_min_writes,
               with_faults=False):
    s = {k: v[d] for k, v in state.items()}
    if with_faults and int(s["drive_status"]) != STATUS_OK:
        _halt_drive(d, ops, start, stop, s, app, mig, lbas.shape[1],
                    trace_every)
        return
    page_map, group_of = s["page_map"], s["group_of"]
    slot_lba, valid = s["slot_lba"].view(-1), s["valid"].view(-1)
    fill, live, trim_dead = s["fill"], s["live"], s["trim_dead"]
    bloom_act, bloom_pas = s["bloom_active"].view(-1), s["bloom_passive"]
    bloom_pas = bloom_pas.view(-1)
    b = s["slot_lba"].shape[-1]
    n_blocks, lba_pages = fill.shape[0], page_map.shape[0]
    bits = s["bloom_active"].shape[-1]
    # per-group values, held on the host for the run (the kernel's shared
    # memory); every change is stored through to the tensor as well
    active = s["grp_active"].tolist()
    grp_p = s["grp_p"].cpu()
    active_t = s["grp_active"].cpu()
    size, live_g = s["grp_size"].tolist(), s["grp_live"].tolist()
    writes, bw = s["grp_writes"].tolist(), s["bloom_writes"].tolist()
    ablk = s["active_blk"].tolist()
    afill = [int(fill[a]) if 0 <= a < n_blocks else 0 for a in ablk]
    fdp = policy["fdp_rate"][d].tolist()
    page_rate = policy["page_rate"][d]
    pg0_map = policy["page_group0"][d] if ops is not None else None

    pool_heavy = int(s["free_blocks"]) < 2 or (
        movement_ops and int(s["grp_surplus"].max()) >= 1)
    first_active = active.index(True) if True in active else 0
    n_app, n_trim = int(s["n_app"]), int(s["n_trim"])
    mapped, n_mig = int(s["mapped_pages"]), int(s["n_mig"])
    j, w = start[d].tolist()
    events = lbas[d].tolist()
    why = END
    is_trim = ([False] * len(events) if ops is None
               else [o == OP_TRIM for o in ops[d].tolist()])

    def lose(g):  # the old group loses the page
        size[g] -= 1
        live_g[g] -= 1
        s["grp_size"][g] = size[g]
        s["grp_live"][g] = live_g[g]

    while j < len(events):
        lba = events[j]
        if not 0 <= lba < lba_pages:
            why = INDEX
            break
        pm = int(page_map[lba])
        has = pm >= 0
        blk_old = pm // b if has else 0
        old_g = int(group_of[blk_old]) if has else 0
        dec = has and old_g >= 0
        og = max(old_g, 0)
        if is_trim[j]:
            if has:
                live[blk_old] -= 1
                valid[pm] = False
                trim_dead[blk_old] += 1
                mapped -= 1
            if dec:
                lose(og)
            page_map[lba] = -1
            n_trim += 1
        else:
            # -- decide, writing nothing --------------------------------------
            if has and old_g < 0:
                why = INDEX
                break
            g = old_g if has else 0
            if ops is not None and not has:
                pg0 = int(pg0_map[lba])
                if not 0 <= pg0 < len(active):
                    why = INDEX
                    break
                g = pg0 if active[pg0] else first_active
            cur = g
            promote = rotate = False
            if td_mode == "fdp":
                promote = float(page_rate[lba]) > 2.0 * fdp[cur]
            elif td_mode == "bloom":
                u = lba & 0xFFFFFFFF
                i1 = cur * bits + ((u * 2654435761) & 0xFFFFFFFF) % bits
                i2 = cur * bits + ((u * 40503 + 99991) & 0xFFFFFFFF) % bits
                promote = bool(bloom_act[i1] & bloom_act[i2]
                               & bloom_pas[i1] & bloom_pas[i2])
                size_cur = size[cur] - (1 if dec and og == cur else 0)
                rotate = bw[cur] + 1 >= max(size_cur, bloom_rotate_min_writes)
            if td_mode != "static" and promote:
                after = [v - (1 if dec and og == i else 0)
                         for i, v in enumerate(live_g)]
                nb = _neighbor_hotter(_hit_rates(grp_p, active_t, after),
                                      active, cur)
                g = nb if active[nb] else cur
            ab, slot = ablk[g], afill[g]
            if (not 0 <= ab < n_blocks or slot >= b or pool_heavy
                    or (w + 1) % h == 0):
                why = HEAVY
                break
            if rotate:
                why = ROTATION
                break
            # -- commit: the simulator's fast write ---------------------------
            if has:
                live[blk_old] -= 1
                valid[pm] = False
                mapped -= 1
            if dec:
                lose(og)
            if td_mode == "bloom":
                bloom_act[i1] = True
                bloom_act[i2] = True
                bw[cur] += 1
                s["bloom_writes"][cur] = bw[cur]
            new_pm = ab * b + slot
            valid[new_pm] = True
            slot_lba[new_pm] = lba
            page_map[lba] = new_pm
            afill[g] += 1
            fill[ab] = afill[g]
            live[ab] += 1
            size[g] += 1
            live_g[g] += 1
            writes[g] += 1
            s["grp_size"][g] = size[g]
            s["grp_live"][g] = live_g[g]
            s["grp_writes"][g] = writes[g]
            mapped += 1
            n_app += 1
            w += 1
        if (j + 1) % trace_every == 0:
            app[d, (j + 1) // trace_every - 1] = n_app
            mig[d, (j + 1) // trace_every - 1] = n_mig
        j += 1
    s["n_app"].fill_(n_app)
    s["n_trim"].fill_(n_trim)
    s["mapped_pages"].fill_(mapped)
    stop[d, 0] = j
    stop[d, 1] = w
    stop[d, 2] = why


def write_run_ref(lbas, ops, start, stop, state, policy, app, mig, *, h,
                  trace_every, td_mode, movement_ops,
                  bloom_rotate_min_writes, with_faults=False) -> None:
    """In place, the arguments of ``write_run_cuda`` (see
    ``kernel.check_args``): each drive's run, one drive after another."""
    for d in range(lbas.shape[0]):
        _run_drive(d, lbas, ops, start, stop, state, policy, app, mig, h=h,
                   trace_every=trace_every, td_mode=td_mode,
                   movement_ops=movement_ops,
                   bloom_rotate_min_writes=bloom_rotate_min_writes,
                   with_faults=with_faults)

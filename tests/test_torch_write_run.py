"""The run kernel's plain version (``kernels/write_run``) on the CPU.

``write_run_ref`` lands a run of fast-path events in place and stops
before the first write that needs the heavy path (or whose bloom insert
would rotate the filter pair). It is held to the simulator stepped one
event at a time (:func:`_trim_page` and :func:`_step_write` below: the
per-event fast path, one fused ``write_path`` kernel and counter updates
an event, with the simulator's own heavy tail) from mid-run states, in
every detector mode, with and without TRIMs and movement operations, and
to the JAX package's run over the same events. The bar: every
``SimState`` field and the trace exactly equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simulator as ref_simulator
from repro.core import ssd as ref_ssd
from repro.core.ssd import Geometry as RefGeometry
from repro_torch import convert
from repro_torch.core import managers, simulator, workloads
from repro_torch.core.simulator import _gat
from repro_torch.core.ssd import Geometry
from repro_torch.kernels.write_path.ops import apply_write_
from repro_torch.kernels.write_run import kernel as wr_kernel
from repro_torch.kernels.write_run import ops as wr_ops

GEOM = (4, 32, 8, 0.7)
WARM = 400  # events run before the state is taken
N = 120     # events of the segment under test


def _mcfg(td_mode, movement_ops):
    base = managers.wolf_dynamic() if td_mode == "bloom" else managers.wolf()
    return dataclasses.replace(base, td_mode=td_mode,
                               movement_ops=movement_ops)


def _drive(td_mode, with_trim, movement_ops, seed, geom=GEOM, mcfg=None):
    """A drive after WARM events, the next N events (numpy, from ``seed``)
    and what a run over them takes: (ctx, st, policy, lbas, ops)."""
    pg = Geometry(*geom)
    mcfg = mcfg or _mcfg(td_mode, movement_ops)
    phase = workloads.tpcc_churn(pg.lba_pages, WARM + N)
    if not with_trim:
        phase = dataclasses.replace(phase, trim_probs=())
    st, n_groups, assumed_p, fdp_rate, rates, pg0 = managers.build_drive(
        pg, mcfg, [phase], device="cpu")
    ctx = simulator.SimContext(pg, mcfg, n_groups, with_trim=with_trim)
    ops, lbas = phase.sample_ops(np.random.default_rng(seed))
    kw = dict(page_rate=rates[0], assumed_p=assumed_p, fdp_rate=fdp_rate)
    if with_trim:
        kw.update(ops=ops[:WARM], page_group0=pg0)
    st, _ = simulator.run(ctx, st, lbas[:WARM], device="cpu", **kw)
    policy = simulator.policy_from_config(
        ctx, "cpu", assumed_p=assumed_p, fdp_rate=fdp_rate,
        page_rate=rates[0], page_group0=pg0 if with_trim else None)
    return ctx, st, policy, lbas[WARM:], ops[WARM:] if with_trim else None


def _copy(st):
    return dataclasses.replace(st, **{k: v.clone() for k, v in st.items()})


def _run_args(ctx, st, policy, lbas, ops, j, w):
    """write_run_'s arguments for one drive from event j, write clock w."""
    n = len(lbas)
    start = torch.tensor([[j, w]], dtype=torch.int64)
    return dict(
        lbas=torch.as_tensor(lbas, dtype=torch.int64)[None],
        ops=None if ops is None else torch.as_tensor(
            ops.astype(np.uint8))[None],
        start=start, stop=torch.full((1, 3), -1, dtype=torch.int64),
        state={k: getattr(st, k)[None] for k in wr_kernel.STATE_FIELDS},
        policy={k: policy[k] for k in (
            "page_rate", "fdp_rate", "page_group0") if k in policy},
        app=torch.full((1, n), -1, dtype=torch.int32),
        mig=torch.full((1, n), -1, dtype=torch.int32),
    )


def _mode(ctx):
    return dict(h=ctx.h, trace_every=1, td_mode=ctx.mcfg.td_mode,
                movement_ops=ctx.mcfg.movement_ops,
                bloom_rotate_min_writes=ctx.mcfg.bloom_rotate_min_writes)


def _assert_same_state(a, b, where):
    for k, v in a.items():
        assert torch.equal(v, b[k]), f"{where}: {k}"


def _on_to_a_run(ctx, st, policy, lbas, ops, longer_than):
    """Advance ``st`` run by run (each stop event stepped on the host, as
    the simulator does) to the first run of more than ``longer_than``
    events. Returns (j, w, stop) of that run, not landed."""
    j, w = 0, int(st.n_app)
    while True:
        args = _run_args(ctx, _copy(st), policy, lbas, ops, j, w)
        wr_ops.write_run_(**args, **_mode(ctx))
        s, w_s, _ = args["stop"][0].tolist()
        if s - j > longer_than:
            return j, w, s
        args = _run_args(ctx, st, policy, lbas, ops, j, w)
        wr_ops.write_run_(**args, **_mode(ctx))
        simulator._split_write(ctx, st.batch, torch.tensor([lbas[s]]),
                               (w_s + 1) % ctx.h == 0, policy)
        j, w = s + 1, w_s + 1


def _trim_page(ctx, st, lba):
    """The per-event TRIM (the simulator's, on the drive as a batch of
    one): the invalidate counts, then one fused ``apply_trim`` (unmap,
    clear the valid bit), ``trim_dead`` and ``n_trim``; a re-trim of an
    unmapped page changes nothing but ``n_trim``."""
    simulator._trim_page(ctx, st.batch, lba[None])


def _step_write(ctx, st, lba, w, policy):
    """The per-event WRITE: the invalidate counts and the target group,
    then the heavy predicates read on the host. Heavy: the simulator's
    tail. Else the fast path: one fused ``apply_write`` (clear the old
    slot, set the new one, repoint the map) and the counter updates.
    Returns whether it took the heavy path."""
    b = ctx.geom.pages_per_block
    bst, lba1 = st.batch, lba[None]  # the drive as a batch of one
    g, old_pm = simulator._invalidate_counts(ctx, bst, lba1)
    if ctx.with_trim:
        g = simulator._resolve_group(bst, g, old_pm >= 0, lba1,
                                     policy["page_group0"])
    if ctx.mcfg.td_mode != "static":
        old_g = g
        g = simulator._target_group_app(ctx, bst, lba1, old_g, policy)
        g = torch.where(_gat(bst.grp_active, g), g, old_g)
    g, old_pm = g[0], old_pm[0]
    blk = st.active_blk[g]
    blk_c = blk.clamp(min=0).long()
    slot = st.fill[blk_c]
    may = (blk < 0) | (slot >= b) | (st.free_blocks < 2)
    if ctx.mcfg.movement_ops:
        may = may | (st.grp_surplus.max() >= 1)
    if (w + 1) % ctx.h == 0 or bool(may):
        simulator._clear_valid(ctx, bst, old_pm[None])
        simulator._step_tail(ctx, bst, lba1, (w + 1) % ctx.h == 0, g[None],
                             policy)
        return True
    row = torch.stack([lba.to(torch.int32), old_pm,
                       (blk_c * b + slot).to(torch.int32),
                       torch.ones((), dtype=torch.int32)])[None]
    apply_write_(row, st.page_map[None], st.slot_lba[None], st.valid[None])
    for t, i in ((st.fill, blk_c), (st.live, blk_c), (st.grp_size, g),
                 (st.grp_live, g), (st.grp_writes, g)):
        t[i] += 1
    st.mapped_pages.add_(1)
    st.n_app.add_(1)
    return False


def _step(ctx, st, policy, lba, op, w):
    """One event stepped alone; returns whether it took the heavy path
    and whether its bloom insert rotated the filter pair."""
    if op is not None and op == workloads.OP_TRIM:
        _trim_page(ctx, st, torch.tensor(lba))
        return False, False
    bw = st.bloom_writes.clone()
    heavy = _step_write(ctx, st, torch.tensor(lba), w, policy)
    return heavy, bool((st.bloom_writes < bw).any())


@pytest.mark.parametrize("movement_ops", [True, False], ids=["move", "nomove"])
@pytest.mark.parametrize("with_trim", [True, False], ids=["trim", "writes"])
@pytest.mark.parametrize("td_mode", ["static", "fdp", "bloom"])
def test_run_equals_stepping_event_by_event(td_mode, with_trim,
                                            movement_ops):
    """From a mid-run state, runs of write_run_ref over a segment equal
    the per-event step up to each stop; the stop event is left untouched
    and is the first whose heavy predicate (or bloom rotation) trips, as
    the stop's why says; the host then steps it, and the next run starts
    after it."""
    ctx, st, policy, lbas, ops = _drive(td_mode, with_trim, movement_ops,
                                        seed=7)
    run_st, step_st = _copy(st), st
    j, w = 0, int(st.n_app)
    runs = []
    while j < len(lbas):
        args = _run_args(ctx, run_st, policy, lbas, ops, j, w)
        wr_ops.write_run_(**args, **_mode(ctx))
        s, w_s, why = args["stop"][0].tolist()
        for k in range(j, s):
            op = None if ops is None else ops[k]
            assert _step(ctx, step_st, policy, lbas[k], op, w) == (
                False, False), f"event {k} left the fast path"
            w += op is None or op != workloads.OP_TRIM
            assert int(args["app"][0, k]) == int(step_st.n_app)
            assert int(args["mig"][0, k]) == int(step_st.n_mig)
        assert (args["app"][0, s:] == -1).all()  # no trace past the stop
        assert w_s == w
        _assert_same_state(run_st, step_st, f"run from {j} to {s}")
        runs.append(s - j)
        if s == len(lbas):
            assert wr_kernel.STOP_WHY[why] == "end"
            break
        assert ops is None or ops[s] != workloads.OP_TRIM
        heavy, rotated = _step(ctx, step_st, policy, lbas[s], None, w)
        assert heavy or rotated, f"event {s} stopped the run for nothing"
        assert wr_kernel.STOP_WHY[why] == ("heavy" if heavy else "rotation")
        simulator._split_write(ctx, run_st.batch, torch.tensor([lbas[s]]),
                               (w + 1) % ctx.h == 0, policy)
        _assert_same_state(run_st, step_st, f"host step of event {s}")
        j, w = s + 1, w + 1
    assert len(runs) > 3 and max(runs) > 3, runs


def test_run_equals_the_jax_run():
    """The events one run completes (bloom detector, TRIMs, movement
    operations), run through the JAX package's simulator from the same
    state, give the same state and trace."""
    ctx, st, policy, lbas, ops = _drive("bloom", True, True, seed=11)
    j, w, s = _on_to_a_run(ctx, st, policy, lbas, ops, longer_than=3)
    st_np = {k: v.copy() for k, v in convert.state_to_numpy(st).items()}
    args = _run_args(ctx, st, policy, lbas, ops, j, w)
    wr_ops.write_run_(**args, **_mode(ctx))
    assert int(args["stop"][0, 0]) == s
    mcfg = ref_ssd.ManagerConfig(**dataclasses.asdict(ctx.mcfg))
    ref_ctx = ref_simulator.SimContext(
        RefGeometry(*GEOM), mcfg, ctx.n_groups,
        use_bloom=True, can_demote=True, use_dynamic=mcfg.dynamic_groups,
        use_movement=mcfg.movement_ops, with_trim=True)
    ref_st = ref_ssd.SimState(**{k: jnp.asarray(v) for k, v in st_np.items()})
    end, trace = ref_simulator.run(
        ref_ctx, ref_st, lbas[j:s], ops=ops[j:s],
        page_group0=policy["page_group0"][0].numpy(),
        page_rate=policy["page_rate"][0].numpy(),
        fdp_rate=policy["fdp_rate"][0].numpy())
    np.testing.assert_array_equal(args["app"][0, j:s].numpy(),
                                  np.asarray(trace["app"]))
    np.testing.assert_array_equal(args["mig"][0, j:s].numpy(),
                                  np.asarray(trace["mig"]))
    got = convert.state_to_numpy(st)
    for name, want in end.items():
        np.testing.assert_array_equal(got[name], np.asarray(want),
                                      err_msg=name)


def test_batched_run_equals_single_drive_runs():
    """Three drives in one call (D = 3, each its own state and events)
    land exactly what three single-drive calls land."""
    drives = [_drive("bloom", True, True, seed=s) for s in (1, 2, 3)]
    ctx = drives[0][0]
    singles = []
    for c, st, policy, lbas, ops in drives:
        st = _copy(st)
        args = _run_args(c, st, policy, lbas, ops, 0, int(st.n_app))
        wr_ops.write_run_(**args, **_mode(ctx))
        singles.append(args)
    per = [_run_args(c, st, p, lb, o, 0, int(st.n_app))
           for c, st, p, lb, o in drives]
    batched = {k: torch.cat([a[k] for a in per]) for k in (
        "lbas", "ops", "start", "stop", "app", "mig")}
    for group in ("state", "policy"):
        batched[group] = {k: torch.cat([a[group][k] for a in per])
                          for k in per[0][group]}
    wr_ops.write_run_(**batched, **_mode(ctx))
    assert len({int(a["stop"][0, 0]) for a in singles}) > 1
    for d, one in enumerate(singles):
        for k in ("stop", "app", "mig"):
            assert torch.equal(batched[k][d], one[k][0]), k
        for k, v in one["state"].items():
            assert torch.equal(batched["state"][k][d], v[0]), k


def test_segment_of_fast_writes_costs_one_read():
    """A segment whose every write takes the fast path goes to the device
    in one run and costs exactly one host read (where the run stopped);
    it lands what the per-event step lands."""
    geom = (4, 32, 64, 0.5)  # long blocks and intervals: long runs
    mcfg = dataclasses.replace(managers.wolf(), interval_frac=0.03,
                               movement_ops=False)
    ctx, st, policy, lbas, _ = _drive("static", False, False, seed=5,
                                      geom=geom, mcfg=mcfg)
    j, _, s = _on_to_a_run(ctx, st, policy, lbas, None, longer_than=20)
    lbas = lbas[j:s]
    stepped = _copy(st)
    for lba in lbas:
        _step(ctx, stepped, policy, lba, None, int(stepped.n_app))
    before = simulator.host_syncs
    st, trace = simulator.run(ctx, st, lbas, page_rate=policy[
        "page_rate"][0].numpy(), device="cpu")
    assert simulator.host_syncs - before == 1 == trace["host_syncs"]
    _assert_same_state(st, stepped, "fast segment")


def _small_args():
    ctx, st, policy, lbas, ops = _drive("static", True, True, seed=3)
    return ctx, _run_args(ctx, st, policy, lbas, ops, 0, int(st.n_app))


@pytest.mark.parametrize("bad", [
    "dtype", "shape", "contiguity", "no_drive_axis", "missing_field",
    "td_mode", "trace_every", "groups", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    ctx, args = _small_args()
    mode = _mode(ctx)
    state = args["state"]
    if bad == "dtype":
        args["start"] = args["start"].int()
    elif bad == "shape":
        state["fill"] = state["fill"][:, 1:]
    elif bad == "contiguity":
        state["valid"] = state["valid"].transpose(1, 2).contiguous(
            ).transpose(1, 2)
    elif bad == "no_drive_axis":
        args["lbas"] = args["lbas"][0]
    elif bad == "missing_field":
        del state["grp_live"]
    elif bad == "td_mode":
        mode["td_mode"] = "oracle"
    elif bad == "trace_every":
        mode["trace_every"] = 7
    elif bad == "groups":
        for k in ("active_blk", "grp_size", "grp_live", "grp_writes",
                  "grp_surplus", "bloom_writes", "grp_p", "grp_active"):
            state[k] = state[k].repeat(1, 9)
    else:
        args["app"] = args["app"].to("meta")
    before = {k: v.clone() for k, v in state.items()}
    with pytest.raises(ValueError):
        wr_ops.write_run_(**args, **mode)
    for k, v in before.items():  # nothing landed
        assert torch.equal(state[k], v), k


def test_cpu_call_launches_nothing():
    ctx, args = _small_args()
    before = wr_kernel.launches
    wr_ops.write_run_(**args, **_mode(ctx))
    assert int(args["stop"][0, 0]) > 0
    assert wr_kernel.launches == before
    with pytest.raises(ValueError, match="tensors on cpu"):
        wr_kernel.write_run_cuda(**args, **_mode(ctx))
    meta = {**args, "lbas": args["lbas"].to("meta")}
    with pytest.raises(ValueError, match="no kernel for meta"):
        wr_ops.write_run_(**meta, **_mode(ctx))
    assert wr_kernel.launches == before

"""The GC kernel's plain version (``kernels/gc_one``) on the CPU, held to
the JAX package's ``_gc_one``.

``gc_one_`` chooses a GC's group by mode (the heavy write's own group with
its firing predicate; the emergency valve's; a movement operation's), the
victim by the weighted score, decides, and drains the victim (demoting
under the FDP and bloom detectors), all in one call, with no host read. From
states taken mid-run at Geometry(4, 32, 8, 0.7), numpy-made and carried
through ``convert``, every ``SimState`` field must equal the JAX
package's after its ``_gc_one`` with the same group, weights and
predicate, at the weight points of wolf, wolf_lru, wolf_wear and
wolf_trim_aware.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import managers as ref_managers
from repro.core import simulator as ref_simulator
from repro.core import ssd as ref_ssd
from repro.core import workloads as ref_workloads
from repro.core.ssd import Geometry as RefGeometry
from repro_torch import convert
from repro_torch.core import managers, simulator, workloads
from repro_torch.core.ssd import (
    CLOSED,
    FREE,
    OPEN,
    Geometry,
    assert_invariants,
)
from repro_torch.kernels.gc_one import kernel as gc_kernel
from repro_torch.kernels.gc_one import ops as gc_ops
from repro_torch.kernels.gc_one import ref as gc_ref
from repro_torch.kernels.write_run import kernel as wr_kernel
from repro_torch.kernels.write_run import ops as wr_ops

GEOM = (4, 32, 8, 0.7)
WARM = 400  # events run before the states are taken
NEXT = 3000  # events after them, in which the heavy writes are found
STOPS = 60   # heavy writes walked, at most
EACH = 3     # states compared where a GC drains, and where it does not
STATIC = ("wolf", "wolf_lru", "wolf_wear", "wolf_trim_aware")
MODES = ("gc", "valve", "movement")


def _drive(preset, seed, warm=WARM):
    """A drive after ``warm`` tpcc_churn events (numpy, from ``seed``):
    (ctx, st, policy, page_rate, (ops, lbas) of the next NEXT events)."""
    geom = Geometry(*GEOM)
    mcfg = getattr(managers, preset)()
    phase = workloads.tpcc_churn(geom.lba_pages, warm + NEXT)
    st, n_groups, assumed_p, fdp_rate, rates, pg0 = managers.build_drive(
        geom, mcfg, [phase], device="cpu")
    ctx = simulator.SimContext(geom, mcfg, n_groups, with_trim=True)
    ops, lbas = phase.sample_ops(np.random.default_rng(seed))
    st, _ = simulator.run(ctx, st, lbas[:warm], ops=ops[:warm],
                          page_group0=pg0, page_rate=rates[0],
                          assumed_p=assumed_p, fdp_rate=fdp_rate,
                          device="cpu")
    policy = simulator.policy_from_config(
        ctx, "cpu", assumed_p=assumed_p, fdp_rate=fdp_rate,
        page_rate=rates[0], page_group0=pg0)
    return ctx, st, policy, rates[0], (ops[warm:], lbas[warm:])


def _gc_states(preset, seed, heavy=STOPS):
    """The states a drive's next ``heavy`` heavy writes hand to their GCs,
    mid-run: runs of the run kernel's plain version up to each heavy
    write, then the heavy tail stepped as the simulator's _step_tail
    steps it, yielding (ctx, st, policy, page_rate, kind, g) before each
    of its GCs (kind "gc" with the write's group g, "valve", "movement").
    ``st`` is the live state: copy it before changing it."""
    ctx, st, policy, rate, (ops, lbas) = _drive(preset, seed)
    td = ctx.mcfg.td_mode
    mode = dict(h=ctx.h, trace_every=1, td_mode=td,
                movement_ops=ctx.mcfg.movement_ops,
                bloom_rotate_min_writes=ctx.mcfg.bloom_rotate_min_writes)
    state = {k: getattr(st, k).view(1) if k in wr_kernel.COUNTERS
             else getattr(st, k)[None] for k in wr_kernel.STATE_FIELDS}
    run_policy = {k: policy[k] for k in (
        "page_rate", "fdp_rate", "page_group0")}
    n = len(lbas)
    j, w = 0, int(st.n_app)
    for _ in range(heavy):
        stop = torch.zeros((1, 3), dtype=torch.int64)
        wr_ops.write_run_(
            torch.as_tensor(lbas, dtype=torch.int64)[None],
            torch.as_tensor(ops.astype(np.uint8))[None],
            torch.tensor([[j, w]]), stop, state, run_policy,
            torch.zeros((1, n), dtype=torch.int32),
            torch.zeros((1, n), dtype=torch.int32), **mode)
        s, w, _ = stop[0].tolist()
        assert s < n, "the segment ran out before the heavy writes"
        lba = torch.tensor([lbas[s]])
        bst = st.batch  # the drive as a batch of one: views of st
        # the head of _split_write, then _step_tail
        g, old_pm = simulator._invalidate_counts(ctx, bst, lba)
        g = simulator._resolve_group(bst, g, old_pm >= 0, lba,
                                     policy["page_group0"])
        if td != "static":
            old_g = g
            g = simulator._target_group_app(ctx, bst, lba, old_g, policy)
            g = torch.where(simulator._gat(bst.grp_active, g), g, old_g)
        simulator._clear_valid(ctx, bst, old_pm)
        yield ctx, st, policy, rate, "gc", int(g)
        simulator._gc_one(ctx, bst, policy, "gc", g)
        tries = 0
        while tries < ctx.mcfg.valve_max_tries and int(st.free_blocks) < 2:
            yield ctx, st, policy, rate, "valve", None
            simulator._gc_one(ctx, bst, policy, "valve")
            tries += 1
        simulator._write_page(ctx, bst, lba, g)
        st.n_app.add_(1)
        simulator._acc(bst.grp_writes, g, torch.ones(1, dtype=torch.int32))
        if ctx.mcfg.movement_ops:
            yield ctx, st, policy, rate, "movement", None
            simulator._gc_one(ctx, bst, policy, "movement")
        if (w + 1) % ctx.h == 0:
            simulator._interval_update(ctx, bst, policy)
        j, w = s + 1, w + 1


def _copy(st):
    return dataclasses.replace(st, **{k: v.clone() for k, v in st.items()})


def _jax(ctx, st, policy, page_rate):
    """The JAX package's context, state, policy and rate lookup for the
    port's drive ``st``."""
    td = ctx.mcfg.td_mode
    mcfg = ref_ssd.ManagerConfig(**dataclasses.asdict(ctx.mcfg))
    ref_ctx = ref_simulator.SimContext(
        RefGeometry(*GEOM), mcfg, ctx.n_groups, use_bloom=td == "bloom",
        can_demote=td != "static", use_dynamic=mcfg.dynamic_groups,
        use_movement=mcfg.movement_ops, with_trim=True)
    ref_st = ref_ssd.SimState(**{
        k: jnp.asarray(v) for k, v in convert.state_to_numpy(st).items()})
    ref_policy = ref_simulator.policy_from_config(
        ref_ctx, policy["assumed_p"][0].numpy(),
        policy["fdp_rate"][0].numpy())
    rates = jnp.asarray(page_rate)
    return ref_ctx, ref_st, ref_policy, lambda s, lba: rates[lba]


def _jax_gc_one(ctx, st, policy, page_rate, mode, g=None):
    """What the JAX package's _step_tail does for one GC of ``mode``:
    the group, the weights and the predicate, then ``_gc_one``."""
    ref_ctx, s, ref_policy, rate_fn = _jax(ctx, st, policy, page_rate)
    b = ref_ctx.geom.pages_per_block
    gc_w = ref_policy["gc_w"]
    if mode == "gc":
        blk = s.active_blk[g]
        needs_block = jnp.where(blk >= 0, s.fill[jnp.maximum(blk, 0)] >= b,
                                True)
        enabled = needs_block & (
            (s.grp_phys[g] >= s.grp_alloc[g])
            | (s.free_blocks <= ref_ctx.mcfg.gc_reserve_blocks))
    elif mode == "valve":
        victim = jnp.argmin(jnp.where(s.state == CLOSED, s.live,
                                      ref_simulator.INT_MAX))
        g = jnp.maximum(s.group_of[victim], 0)
        gc_w = jnp.asarray(ref_simulator.GC_W_GREEDY, jnp.float32)
        enabled = True
    else:
        g = jnp.argmax(s.grp_surplus)
        enabled = (s.grp_surplus[g] >= 1) & (s.free_blocks >= 2)
    s = ref_simulator._gc_one(ref_ctx, s, g, ref_policy, rate_fn, gc_w,
                              enabled=enabled)
    return {k: np.asarray(v) for k, v in s.items()}


def _assert_equal(st, want, where):
    got = convert.state_to_numpy(st)
    for name, v in want.items():
        np.testing.assert_array_equal(got[name], v, err_msg=f"{where}: {name}")


def _port_gc_one(ctx, st, policy, mode, g=None):
    """The simulator's _gc_one on ``st`` in place; returns the host reads
    it made."""
    before = simulator.host_syncs
    simulator._gc_one(ctx, st.batch, policy, mode,
                      None if g is None else torch.tensor([g]))
    return simulator.host_syncs - before


def _compare(preset, mode):
    """Walk two drives' heavy writes; at the states handed to their GCs,
    compare ``mode``'s GC with the JAX package's (in mode "gc" at the
    write's group and at the last group slot, which no preset here fills:
    a group with no CLOSED block; the valve and a movement operation at
    the state handed to any GC): the first EACH states where the port's
    GC drains and the first EACH where it does not. A GC costs no host
    read under any detector: the demoting drain is the launch's too.
    Returns (drained, refused) over the states compared."""
    seen = {True: 0, False: 0}
    for seed in (1, 2):
        for ctx, st, policy, rate, kind, g in _gc_states(preset, seed):
            if mode == "gc" and kind != "gc":
                continue
            for grp in [g, ctx.mcfg.max_groups - 1] if mode == "gc" else [
                    None]:
                got = _copy(st)
                reads = _port_gc_one(ctx, got, policy, mode, grp)
                drained = int(got.n_erase) > int(st.n_erase)
                assert reads == 0
                if seen[drained] >= EACH:
                    continue
                seen[drained] += 1
                want = _jax_gc_one(ctx, st, policy, rate, mode, grp)
                _assert_equal(got, want, f"{preset} {mode} seed {seed} "
                              f"at a {kind} GC, g {grp}")
            if min(seen.values()) >= EACH:
                return seen[True], seen[False]
    return seen[True], seen[False]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("preset", STATIC)
def test_static_gc_matches_jax(preset, mode):
    """Static detector, every weight point, each mode: the state after one
    gc_one_ equals the JAX package's after _gc_one, with no host read;
    GCs are both decided and refused (the valve's always drains while the
    pool holds a block)."""
    drained, refused = _compare(preset, mode)
    assert drained == EACH and (mode == "valve" or refused == EACH)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("preset", ["fdp", "wolf_dynamic"])
def test_demoting_gc_matches_jax(preset, mode):
    """FDP and bloom detectors: gc_one_ decides and drains (with §5.6
    demotion) in one call, with no host read. Every state field equals
    the JAX package's; in mode "gc" GCs are both decided and refused."""
    drained, refused = _compare(preset, mode)
    # fdp runs no movement operations, so its surpluses stay and a
    # movement GC is always enabled there
    assert drained == EACH and (mode != "gc" or refused == EACH)


def _args(ctx, states, policy, mode, g=None, gc_w=None):
    """gc_one_'s arguments for the drives ``states`` (stacked on a drive
    axis), drained as the simulator drains them."""
    d = len(states)
    td = ctx.mcfg.td_mode
    fields = gc_kernel.STATE_FIELDS + (
        gc_kernel.DEMOTE_FIELDS if td != "static" else ())
    state = {k: torch.stack([getattr(s, k) for s in states]).contiguous()
             for k in fields}
    if gc_w is None:
        gc_w = policy["gc_w_greedy" if mode == "valve" else "gc_w"]
    return dict(
        state=state,
        gc_w=gc_w.expand(d, 4).contiguous(),
        g=None if g is None else torch.as_tensor(g, dtype=torch.int64),
        out=torch.full((d, 3), -9, dtype=torch.int64),
        fdp_policy=({k: policy[k].expand(d, -1).contiguous()
                     for k in gc_kernel.FDP_POLICY} if td == "fdp" else None),
    ), dict(mode=mode, td_mode=td, drain=True,
            gc_reserve_blocks=ctx.mcfg.gc_reserve_blocks)


def _first_decided(preset, seed, mode):
    """A copy of the first state of a drive's heavy writes at which the
    port's GC of ``mode`` drains: (ctx, st, policy, rate, kind, g)."""
    for ctx, st, policy, rate, kind, g in _gc_states(preset, seed):
        if mode == "gc" and kind != "gc":
            continue
        got = _copy(st)
        simulator._gc_one(ctx, got.batch, policy, mode,
                          torch.tensor([g]) if mode == "gc" else None)
        if int(got.n_erase) > int(st.n_erase):
            return ctx, _copy(st), policy, rate, kind, g
    raise AssertionError(f"no {mode} GC drained")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("preset", ["wolf_wear", "wolf_dynamic"])
def test_batched_drives_equal_single_drive_calls(preset, mode):
    """Four drives in one call (each its own state and group) land exactly
    what four single-drive calls land, out included, static and demoting
    drains alike."""
    drives = [_first_decided(preset, seed, mode)
              for seed in (1, 2, 3, 4)]
    ctx, policy = drives[0][0], drives[0][2]
    groups = [d[5] for d in drives] if mode == "gc" else None
    singles = []
    for i, (_, st, _, _, _, _) in enumerate(drives):
        args, kw = _args(ctx, [st], policy, mode,
                         None if groups is None else groups[i:i + 1])
        gc_ops.gc_one_(**args, **kw)
        singles.append(args)
    args, kw = _args(ctx, [d[1] for d in drives], policy, mode, groups)
    gc_ops.gc_one_(**args, **kw)
    assert args["out"][:, 2].all()
    for d, one in enumerate(singles):
        assert torch.equal(args["out"][d], one["out"][0])
        for k, v in one["state"].items():
            assert torch.equal(args["state"][k][d], v[0]), k


def _split_drain(pool):
    """A decided FDP GC in mode "gc" whose victim's live pages split: every
    other one from the second flagged (oracle rate 0), so it demotes to
    g's colder neighbour, the rest kept in g (rate 1e9), so g's claim
    comes first whatever the groups' order; every active block full, so
    both target groups overflow, and the pool counter at ``pool``.
    Returns (ctx, state, policy, rate, g) with the rates in the policy."""
    for seed in (1, 2, 3, 4):
        ctx, st, policy, _, _, g = _first_decided("fdp", seed, "gc")
        hr = simulator._hit_rates(st)
        victim, _, _ = gc_ref.decide(
            {k: v for k, v in st.items()}, policy["gc_w"][0], g, mode="gc",
            gc_reserve_blocks=ctx.mcfg.gc_reserve_blocks)
        pages = st.slot_lba[victim][st.valid[victim]].tolist()
        if len(pages) >= 2 and int(simulator._neighbor_colder(
                hr, st.grp_active, torch.tensor(g))) != g:
            break
    else:
        pytest.fail("no decided GC of two pages whose group has a colder "
                    "neighbour")
    assert float(policy["fdp_rate"][0, g]) > 0
    rate = np.full(ctx.geom.lba_pages, 1e9, np.float32)
    rate[pages[1::2]] = 0.0
    policy = dict(policy, page_rate=torch.from_numpy(rate)[None])
    b = ctx.geom.pages_per_block
    for ab in st.active_blk[st.grp_active].tolist():
        if ab >= 0:
            st.fill[ab] = b
    st.free_blocks.fill_(pool)
    return ctx, st, policy, rate, g


@pytest.mark.parametrize("pool", [64, 1], ids=["two_claims", "pool_out"])
def test_demoting_drain_claims_in_first_overflow_order(pool):
    """A demoting drain whose pages go to two groups, both overflowing
    their active blocks: each claims a fresh block, the first to
    overflow (by slot) the lowest FREE block; with the pool counter at 1
    the second claim finds none, and its pages are dropped and counted.
    Every state field equals the JAX package's after its _gc_one."""
    ctx, st, policy, rate, g = _split_drain(pool)
    got = _copy(st)
    assert _port_gc_one(ctx, got, policy, "gc", g) == 0
    want = _jax_gc_one(ctx, st, policy, rate, "gc", g)
    _assert_equal(got, want, f"split drain, pool {pool}")
    claimed = ((got.state == OPEN) & (st.state == FREE)).nonzero()
    dropped = int(got.n_dropped) - int(st.n_dropped)
    first = int((st.state == FREE).nonzero()[0])  # the lowest FREE block
    assert int(got.active_blk[g]) == first  # g overflowed first
    if pool > 1:
        assert len(claimed) == 2 and dropped == 0
    else:
        assert len(claimed) == 1 and dropped > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("preset", ["wolf_wear", "fdp"])
def test_disabled_drives_are_left_alone(preset, mode):
    """With ``enable`` false on some drives, those drives' state is bit for
    bit what it was and their out is (-1, -1, 0); the enabled drives land
    what a call with every drive enabled lands."""
    drives = [_first_decided(preset, seed, mode) for seed in (1, 2, 3, 4)]
    ctx, policy = drives[0][0], drives[0][2]
    groups = [d[5] for d in drives] if mode == "gc" else None
    states = [d[1] for d in drives]
    every, kw = _args(ctx, states, policy, mode, groups)
    gc_ops.gc_one_(**every, **kw)
    some, _ = _args(ctx, states, policy, mode, groups)
    before = {k: v.clone() for k, v in some["state"].items()}
    enable = torch.tensor([True, False, True, False])
    gc_ops.gc_one_(**some, enable=enable, **kw)
    assert every["out"][:, 2].all()
    for d in range(len(drives)):
        want = every if enable[d] else {"state": before, "out": torch.tensor(
            [[-1, -1, 0]] * len(drives))}
        assert torch.equal(some["out"][d], want["out"][d]), d
        for k, v in some["state"].items():
            assert torch.equal(v[d], want["state"][k][d]), (d, k)


def test_empty_pool_refuses_and_drain_drops_pages():
    """With the pool counter at 0 no GC is decided (the JAX package's
    free_blocks >= 1 guard); the static drain on its own, handed such a
    pool and a victim whose live pages overflow the active block, drops
    the overflow and counts it, as the JAX package's does."""
    ctx, st, policy, rate, _ = _drive("wolf", 1)
    st.free_blocks.fill_(0)
    want = _jax_gc_one(ctx, st, policy, rate, "valve")
    got = _copy(st)
    assert _port_gc_one(ctx, got, policy, "valve") == 0
    _assert_equal(got, want, "empty pool")
    assert int(got.n_erase) == int(st.n_erase)

    b = ctx.geom.pages_per_block
    for g in range(ctx.n_groups):
        ab = int(st.active_blk[g])
        space = b - int(st.fill[ab]) if ab >= 0 else 0
        closed = ((st.state == CLOSED) & (st.group_of == g)
                  & (st.live > space)).nonzero().flatten()
        if len(closed):
            victim = int(closed[0])
            break
    else:
        pytest.fail("no victim that overflows its group's active block")
    ref_ctx, s, _, _ = _jax(ctx, st, policy, rate)
    want = ref_simulator._gc_drain_bulk_static(ref_ctx, s, victim, g)
    gc_ref.drain_static({k: v for k, v in st.items()}, victim, g)
    _assert_equal(st, {k: np.asarray(v) for k, v in want.items()},
                  "drain into an empty pool")
    assert int(st.n_dropped) > 0


@pytest.mark.parametrize("preset", ["wolf_lru", "wolf_wear"])
def test_whole_run_matches_jax(preset):
    """The age-driven and the wear-levelling weight points over a whole
    run (two_modal, 3,000 writes): traces and every state field equal the
    JAX package's run, and the invariants hold."""
    geom = Geometry(*GEOM)
    phases = [workloads.two_modal(geom.lba_pages, 3000)]
    res = managers.simulate(geom, getattr(managers, preset)(), phases,
                            seed=3, device="cpu")
    assert_invariants(res.state)
    assert int(res.state.n_erase) > 0 and int(res.state.n_dropped) == 0
    want = getattr(ref_managers, preset)()
    ref = ref_managers.simulate(
        RefGeometry(*GEOM), want,
        [ref_workloads.two_modal(geom.lba_pages, 3000)], seed=3)
    np.testing.assert_array_equal(res.app, np.asarray(ref.app))
    np.testing.assert_array_equal(res.mig, np.asarray(ref.mig))
    _assert_equal(res.state, {k: np.asarray(v) for k, v in ref.state.items()},
                  preset)


@pytest.mark.parametrize("bad", [
    "dtype", "shape", "missing_field", "mode", "td_mode", "g_in_valve",
    "no_g", "groups", "device", "no_fdp_rates", "fdp_rates_shape",
    "bloom_shape", "no_grp_p"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    preset = {"no_fdp_rates": "fdp", "fdp_rates_shape": "fdp",
              "bloom_shape": "wolf_dynamic",
              "no_grp_p": "wolf_dynamic"}.get(bad, "wolf")
    ctx, st, policy, _, _ = _drive(preset, 1)
    mode = "valve" if bad == "g_in_valve" else "gc"
    args, kw = _args(ctx, [st], policy, mode, [0])
    state = args["state"]
    if bad == "dtype":
        state["stamp"] = state["stamp"].long()
    elif bad == "shape":
        state["live"] = state["live"][:, 1:]
    elif bad == "missing_field":
        del state["clock"]
    elif bad == "mode":
        kw["mode"] = "greedy"
    elif bad == "td_mode":
        kw["td_mode"] = "oracle"
    elif bad == "no_g":
        args["g"] = None
    elif bad == "groups":
        for k in ("active_blk", "grp_phys", "grp_alloc", "grp_surplus",
                  "grp_size", "grp_live", "grp_active"):
            state[k] = state[k].repeat(1, 9)
    elif bad == "device":
        args["out"] = args["out"].to("meta")
    elif bad == "no_fdp_rates":
        args["fdp_policy"] = None
    elif bad == "fdp_rates_shape":
        args["fdp_policy"]["page_rate"] = args["fdp_policy"]["page_rate"][
            :, 1:].contiguous()
    elif bad == "bloom_shape":
        state["bloom_passive"] = state["bloom_passive"][:, 1:].contiguous()
    elif bad == "no_grp_p":
        del state["grp_p"]
    before = {k: v.clone() for k, v in state.items()}
    with pytest.raises(ValueError):
        gc_ops.gc_one_(**args, **kw)
    for k, v in before.items():  # nothing landed
        assert torch.equal(state[k], v), k


def test_cpu_call_launches_nothing():
    ctx, st, policy, _, _ = _drive("wolf", 1)
    args, kw = _args(ctx, [st], policy, "movement")
    before = gc_kernel.launches
    gc_ops.gc_one_(**args, **kw)
    assert int(args["out"][0, 0]) >= 0
    assert gc_kernel.launches == before
    with pytest.raises(ValueError, match="tensors on cpu"):
        gc_kernel.gc_one_cuda(**args, **kw)
    assert gc_kernel.launches == before

"""The port on a CUDA card: the hand-written kernels against their plain
PyTorch versions, card runs of the simulator against CPU runs, and the
serving engine on the card against its CPU run.

Every test here needs a card and skips without one. The file imports
nothing of JAX, so it also runs on a GPU host without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Simulator comparisons are exact (integer pools and integer state;
``grp_p`` too, since card and CPU run the same float32 operations in the
same order; the GC kernel's float32 victim score is rounded op by op as
PyTorch rounds it), and so are the KV compaction's. The attention kernels
sum in another order than their plain versions: within 1e-5 in fp32 and
2e-2 in bf16 (p is rounded to bf16 before P·V, as in the Pallas kernels),
and in bf16 each output row also within 2e-2 of its own largest value,
since attention outputs can lie far below the absolute bound.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import fleet, managers, simulator, workloads
from repro_torch.core.ssd import Geometry, assert_invariants
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.gc_compact import kernel as gc_kernel
from repro_torch.kernels.gc_compact import ops as gc_ops
from repro_torch.kernels.gc_one import kernel as gc_one_kernel
from repro_torch.kernels.gc_one import ref as gc_one_ref
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.paged_attention import ref as paged_ref
from repro_torch.kernels.write_path import kernel as wp_kernel
from repro_torch.kernels.write_path import ops as wp_ops
from repro_torch.kernels.write_run import kernel as wr_kernel
from repro_torch.kernels.write_run import ref as wr_ref
from repro_torch.models import moe
from repro_torch.models.registry import (
    get_config,
    get_model,
    params_class,
    smoke_config,
)
from repro_torch.serving.engine import Request, ServingEngine

K, B, LBA = 24, 8, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _write_rows(rng, d):
    """Pools for d drives and one valid op row per drive: old_pm is the
    page's mapping (-1 on drive 0), the new slot differs from it, and every
    fourth row is disabled."""
    page_map = rng.integers(-1, K * B, (d, LBA)).astype(np.int32)
    slot_lba = rng.integers(-1, LBA, (d, K, B)).astype(np.int32)
    valid = rng.random((d, K, B)) < 0.5
    rows = []
    for i in range(d):
        lba = int(rng.integers(0, LBA))
        if i == 0:
            page_map[i, lba] = -1
        old = int(page_map[i, lba])
        new = int(rng.integers(0, K * B))
        new = (new + 1) % (K * B) if new == old else new
        rows.append([lba, old, new, int(i % 4 != 3)])
    return np.asarray(rows, np.int32), page_map, slot_lba, valid


def _moves(rng, d):
    """Move lists of B rows per drive whose sources and destinations are
    slots of the same two blocks (interleaved); about a fifth are no-ops."""
    src, dst = [], []
    for _ in range(d):
        base = int(rng.integers(0, K - 1)) * B
        src.append(base + rng.permutation(2 * B)[:B])
        dst.append(base + rng.permutation(2 * B)[:B])
    src, dst = np.asarray(src), np.asarray(dst)
    sb = np.where(rng.random((d, B)) < 0.2, -1, src // B)
    return [x.astype(np.int32) for x in (sb, src % B, dst // B, dst % B)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 9])
def test_kernels_match_plain_versions(cuda, d):
    rng = np.random.default_rng(d)
    rows, *pools = (torch.from_numpy(x).to(cuda) for x in _write_rows(rng, d))
    got, want = [p.clone() for p in pools], [p.clone() for p in pools]
    n = wp_kernel.launches
    wp_kernel.apply_write_cuda(rows, *got)
    assert wp_kernel.launches == n + 1
    wp_ops.apply_write_flat(rows, *want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    pools = [torch.from_numpy(x).to(cuda) for x in (
        rng.integers(-1, LBA, (d, K, B)).astype(np.int32),
        rng.random((d, K, B)) < 0.5,
    )]
    moves = [torch.from_numpy(x).to(cuda) for x in _moves(rng, d)]
    got, want = [p.clone() for p in pools], [p.clone() for p in pools]
    n = gc_kernel.launches
    gc_kernel.compact_slots_cuda(*got, *moves)
    assert gc_kernel.launches == n + 1
    gc_ops.compact_slots_flat(*want, *moves)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _trim_rows(rng, d):
    """Pools for d drives and one TRIM row per drive: old_pm is the page's
    mapping (-1 on drive 0: a re-trim), every fourth row is disabled."""
    page_map = rng.integers(-1, K * B, (d, LBA)).astype(np.int32)
    valid = rng.random((d, K, B)) < 0.5
    rows = []
    for i in range(d):
        lba = int(rng.integers(0, LBA))
        if i == 0:
            page_map[i, lba] = -1
        rows.append([lba, int(page_map[i, lba]), int(i % 4 != 3)])
    return np.asarray(rows, np.int32), page_map, valid


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 9])
def test_trim_kernel_matches_plain_version(cuda, d):
    rng = np.random.default_rng(10 + d)
    rows, *pools = (torch.from_numpy(x).to(cuda) for x in _trim_rows(rng, d))
    got, want = [p.clone() for p in pools], [p.clone() for p in pools]
    n = (wp_kernel.launches, wp_kernel.trim_launches)
    wp_kernel.apply_trim_cuda(rows, *got)
    assert (wp_kernel.launches, wp_kernel.trim_launches) == (n[0], n[1] + 1)
    wp_ops.apply_trim_flat(rows, *want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_card_op_stream_run_matches_cpu_run(cuda):
    """wolf_dynamic on tpcc_churn (bloom detector, demoting drains, §5.2
    groups, TRIMs) on the card equals the CPU run, bit for bit. Every
    TRIM and fast write lands through the run kernel, none through the
    per-row kernels, and every GC drains in its gc_one launch, none
    through compact_slots."""
    geom = Geometry(4, 32, 8)
    phases = [workloads.tpcc_churn(geom.lba_pages, 3000)]
    n = (wr_kernel.launches, wp_kernel.launches, wp_kernel.trim_launches,
         gc_kernel.launches, gc_one_kernel.launches,
         gc_one_kernel.demote_launches)
    card = managers.simulate(geom, managers.wolf_dynamic(), phases, seed=3,
                             device="cuda")
    assert wr_kernel.launches > n[0]
    assert (wp_kernel.launches, wp_kernel.trim_launches,
            gc_kernel.launches) == n[1:4]
    gcs = gc_one_kernel.launches - n[4]
    assert gcs > 0 and gc_one_kernel.demote_launches - n[5] == gcs
    host = managers.simulate(geom, managers.wolf_dynamic(), phases, seed=3,
                             device="cpu")
    np.testing.assert_array_equal(card.app, host.app)
    np.testing.assert_array_equal(card.mig, host.mig)
    assert card.host_syncs == host.host_syncs
    for name, v in card.state.items():
        assert torch.equal(v.cpu(), host.state[name]), name
    assert_invariants(card.state)


@pytest.mark.cuda
def test_card_run_matches_cpu_run(cuda):
    """wolf on two_modal: every GC is one gc_one launch that drains on the
    card (none through compact_slots), and the run equals the CPU run."""
    geom = Geometry(4, 32, 8)
    phases = [workloads.two_modal(geom.lba_pages, 3000)]
    n = (wr_kernel.launches, gc_kernel.launches, wp_kernel.launches,
         gc_one_kernel.launches)
    card = managers.simulate(geom, managers.wolf(), phases, seed=3,
                             device="cuda")
    assert wr_kernel.launches > n[0] and gc_one_kernel.launches > n[3]
    assert (gc_kernel.launches, wp_kernel.launches) == n[1:3]
    host = managers.simulate(geom, managers.wolf(), phases, seed=3,
                             device="cpu")
    np.testing.assert_array_equal(card.app, host.app)
    np.testing.assert_array_equal(card.mig, host.mig)
    assert card.host_syncs == host.host_syncs
    for name, v in card.state.items():
        assert torch.equal(v.cpu(), host.state[name]), name
    assert_invariants(card.state)


TABLE2 = Geometry(8, 1024, 128, 0.7)
RUN_PRESETS = {"static": "wolf", "fdp": "fdp", "bloom": "wolf_dynamic"}


@functools.lru_cache(maxsize=None)
def _table2_drive(td_mode, with_trim, warm=3000):
    """A Table-2 drive on the card after ``warm`` events of tpcc_churn
    (its TRIMs dropped without an op stream), under the preset of
    ``td_mode``: (ctx, state, policy, phase)."""
    mcfg = getattr(managers, RUN_PRESETS[td_mode])()
    phase = workloads.tpcc_churn(TABLE2.lba_pages, warm)
    if not with_trim:
        phase = dataclasses.replace(phase, trim_probs=())
    st, n_groups, assumed_p, fdp_rate, rates, pg0 = managers.build_drive(
        TABLE2, mcfg, [phase], device="cuda")
    ctx = simulator.SimContext(TABLE2, mcfg, n_groups, with_trim=with_trim)
    ops, lbas = phase.sample_ops(np.random.default_rng(0))
    kw = dict(page_rate=rates[0], assumed_p=assumed_p, fdp_rate=fdp_rate)
    if with_trim:
        kw.update(ops=ops, page_group0=pg0)
    st, _ = simulator.run(ctx, st, lbas, device="cuda", **kw)
    policy = simulator.policy_from_config(
        ctx, "cuda", assumed_p=assumed_p, fdp_rate=fdp_rate,
        page_rate=rates[0], page_group0=pg0 if with_trim else None)
    return ctx, st, policy, phase


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 64])
@pytest.mark.parametrize("with_trim", [True, False], ids=["trim", "writes"])
@pytest.mark.parametrize("td_mode", ["static", "fdp", "bloom"])
def test_write_run_kernel_matches_plain_version(cuda, td_mode, with_trim, d):
    """From a Table-2 state reached on the card, d drives (each its own
    next 512 events) run through the kernel and, on copies of the same
    inputs on the CPU, through write_run_ref: stop, trace and every state
    field exact (grp_p, which a run only reads, too)."""
    ctx, st, policy, phase = _table2_drive(td_mode, with_trim)
    n = 512
    rows = [dataclasses.replace(phase, n_writes=n).sample_ops(
        np.random.default_rng(1 + i)) for i in range(d)]
    ops = torch.from_numpy(np.stack([o for o, _ in rows]).astype(np.uint8))
    args = dict(
        lbas=torch.from_numpy(np.stack([lb for _, lb in rows]).astype(
            np.int64)),
        ops=ops if with_trim else None,
        start=torch.tensor([[0, int(st.n_app)]] * d),
        stop=torch.full((d, 3), -1),
        state={k: (v.view(1) if k in wr_kernel.COUNTERS else v[None])
               for k, v in ((k, getattr(st, k).cpu())
                            for k in wr_kernel.STATE_FIELDS)},
        policy={k: policy[k].cpu() for k in (
            "page_rate", "fdp_rate", "page_group0") if k in policy},
        app=torch.full((d, n), -1, dtype=torch.int32),
        mig=torch.full((d, n), -1, dtype=torch.int32),
    )
    for group in ("state", "policy"):
        args[group] = {k: v.repeat(d, *[1] * (v.dim() - 1)).contiguous()
                       for k, v in args[group].items()}
    mode = dict(h=ctx.h, trace_every=1, td_mode=td_mode,
                movement_ops=ctx.mcfg.movement_ops,
                bloom_rotate_min_writes=ctx.mcfg.bloom_rotate_min_writes)

    def on(device):
        return {k: None if v is None else (
            {kk: vv.to(device, copy=True) for kk, vv in v.items()}
            if isinstance(v, dict) else v.to(device, copy=True))
            for k, v in args.items()}

    got, want = on(cuda), on("cpu")
    n_launch = wr_kernel.launches
    wr_kernel.write_run_cuda(**got, **mode)
    torch.cuda.synchronize()
    assert wr_kernel.launches == n_launch + 1
    wr_ref.write_run_ref(**want, **mode)
    assert (want["stop"][:, 0] > 0).any()
    for k in ("stop", "app", "mig"):
        assert torch.equal(got[k].cpu(), want[k]), k
    for group in ("state", "policy"):
        for k, v in want[group].items():
            assert torch.equal(got[group][k].cpu(), v), k


def _gc_one_args(td_mode, d, mode, fault_fields=False):
    """gc_one's arguments for d copies of ``_table2_drive(td_mode)``'s
    state on the CPU (with the fault hook's fields when asked), drained:
    group d % groups in mode "gc"; under a demoting detector every odd
    drive has every page flagged (bloom: its filters cleared; FDP: its
    oracle rates 0), so its pages demote, and the even drives keep the
    run's filters and rates. Returns (ctx, args, kw)."""
    ctx, st, policy, _ = _table2_drive(td_mode, td_mode == "bloom")
    fields = gc_one_kernel.STATE_FIELDS + (
        gc_one_kernel.DEMOTE_FIELDS if td_mode != "static" else ()) + (
        gc_one_kernel.FAULT_FIELDS if fault_fields else ())
    state = {k: (v.view(1) if v.dim() == 0 else v[None])
             for k, v in ((k, getattr(st, k).cpu()) for k in fields)}
    state = {k: v.repeat(d, *[1] * (v.dim() - 1)).contiguous()
             for k, v in state.items()}
    fdp_policy = None
    if td_mode == "bloom":
        state["bloom_active"][1::2] = False
        state["bloom_passive"][1::2] = False
    elif td_mode == "fdp":
        fdp_policy = {k: policy[k].cpu().repeat(d, 1)
                      for k in gc_one_kernel.FDP_POLICY}
        fdp_policy["page_rate"][1::2] = 0.0
    gc_w = policy["gc_w_greedy" if mode == "valve" else "gc_w"].cpu()
    args = dict(state=state, gc_w=gc_w.repeat(d, 1),
                g=torch.arange(d) % ctx.n_groups if mode == "gc" else None,
                out=torch.full((d, 3), -9, dtype=torch.int64),
                fdp_policy=fdp_policy)
    kw = dict(mode=mode, td_mode=td_mode, drain=True,
              gc_reserve_blocks=ctx.mcfg.gc_reserve_blocks)
    return ctx, args, kw


def _on(args, device):
    """A copy of gc_one's arguments on ``device``."""
    return {k: None if v is None else (
        {kk: vv.to(device, copy=True) for kk, vv in v.items()}
        if isinstance(v, dict) else v.to(device, copy=True))
        for k, v in args.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("mode", ["gc", "valve", "movement"])
@pytest.mark.parametrize("td_mode", ["static", "fdp", "bloom"])
def test_gc_one_kernel_matches_plain_version(cuda, td_mode, mode, d):
    """From a Table-2 state reached on the card, d drives' GCs through the
    kernel and, on copies of the same inputs on the CPU, through
    gc_one_ref: out and every state field exact. In mode "gc" every drive
    but the last (of several) has its group's open block full and over
    budget, and in mode "movement" its group two blocks over its
    allocation, so GCs are decided and drained (demoting under FDP and
    bloom, every page of the odd drives flagged) and refused."""
    ctx, args, kw = _gc_one_args(td_mode, d, mode)
    state, g, b = args["state"], args["g"], TABLE2.pages_per_block
    for i in range(d - (d > 1)):
        if mode == "gc":
            ab = int(state["active_blk"][i, g[i]])
            state["fill"][i, ab] = b
            state["grp_alloc"][i, g[i]] = 0
        elif mode == "movement":
            gm = i % ctx.n_groups
            state["grp_alloc"][i, gm] = state["grp_phys"][i, gm] - 2
            state["grp_surplus"][i] = torch.where(
                state["grp_active"][i],
                state["grp_phys"][i] - state["grp_alloc"][i], -(2**31 - 1))
    got, want = _on(args, cuda), _on(args, "cpu")
    n_launch = (gc_one_kernel.launches, gc_one_kernel.demote_launches)
    gc_one_kernel.gc_one_cuda(**got, **kw)
    torch.cuda.synchronize()
    assert gc_one_kernel.launches == n_launch[0] + 1
    assert gc_one_kernel.demote_launches == n_launch[1] + (
        td_mode != "static")
    gc_one_ref.gc_one_ref(**want, **kw)
    assert want["out"][:, 2].any()
    assert torch.equal(got["out"].cpu(), want["out"])
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k].cpu(), v), k
    drained = want["state"]["n_erase"] - state["n_erase"]
    assert torch.equal(drained, want["out"][:, 2].int())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("mode", ["gc", "valve", "movement"])
def test_gc_one_kernel_decides_without_draining(cuda, mode, d):
    """Under the static detector with ``drain=False`` (the reference
    drain's call): from a Table-2 state, the kernel and gc_one_ref write
    the same out, GCs are decided, and the state is left untouched."""
    ctx, st, policy, _ = _table2_drive("static", False)
    b = TABLE2.pages_per_block
    state = {k: (v.view(1) if k in gc_one_kernel.COUNTERS else v[None])
             for k, v in ((k, getattr(st, k).cpu())
                          for k in gc_one_kernel.STATE_FIELDS)}
    state = {k: v.repeat(d, *[1] * (v.dim() - 1)).contiguous()
             for k, v in state.items()}
    g = torch.arange(d) % ctx.n_groups
    if mode == "gc":
        for i in range(d):
            state["fill"][i, int(state["active_blk"][i, g[i]])] = b
            state["grp_alloc"][i, g[i]] = 0
    gc_w = policy["gc_w_greedy" if mode == "valve" else "gc_w"].cpu()
    args = dict(state=state, gc_w=gc_w.repeat(d, 1),
                g=g if mode == "gc" else None,
                out=torch.full((d, 3), -9, dtype=torch.int64))
    kw = dict(mode=mode, td_mode="static", drain=False,
              gc_reserve_blocks=ctx.mcfg.gc_reserve_blocks)

    def on(device):
        return {k: None if v is None else (
            {kk: vv.to(device, copy=True) for kk, vv in v.items()}
            if isinstance(v, dict) else v.to(device, copy=True))
            for k, v in args.items()}

    got, want = on(cuda), on("cpu")
    gc_one_kernel.gc_one_cuda(**got, **kw)
    torch.cuda.synchronize()
    gc_one_ref.gc_one_ref(**want, **kw)
    assert torch.equal(got["out"].cpu(), want["out"])
    assert mode == "movement" or bool(want["out"][:, 2].all())
    for k, v in args["state"].items():
        assert torch.equal(got["state"][k].cpu(), v), k
        assert torch.equal(want["state"][k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["reference", "reference_drain"])
@pytest.mark.parametrize("preset,workload", [
    ("wolf", "two_modal"), ("fdp", "swap"),
    ("wolf_trim_aware", "tpcc_churn")])
def test_card_reference_engine_matches_cpu(cuda, preset, workload, engine):
    """The reference engine (every event stepped alone, each GC drained
    page by page; or only the drain, on the split step) at Geometry(4,
    32, 8): the card run equals the CPU run bit for bit, and so does the
    split engine's card run; TRIMs land through apply_trim one launch an
    event, and no run goes through write_run on the reference step."""
    geom = Geometry(4, 32, 8)
    lba = geom.lba_pages
    phases = {"two_modal": [workloads.two_modal(lba, 2000)],
              "swap": list(workloads.swap_phases(lba, 1000)),
              "tpcc_churn": [workloads.tpcc_churn(lba, 2000)]}[workload]
    mcfg = getattr(managers, preset)()
    kw = dict(seed=3, gc_impl="reference",
              fast_path=engine == "reference_drain")
    n = (wr_kernel.launches, wp_kernel.trim_launches)
    card = managers.simulate(geom, mcfg, phases, device="cuda", **kw)
    runs, trims = wr_kernel.launches - n[0], wp_kernel.trim_launches - n[1]
    if engine == "reference":
        assert runs == 0 and trims == int(card.state.n_trim)
    else:
        assert runs > 0 and trims == 0
    host = managers.simulate(geom, mcfg, phases, device="cpu", **kw)
    split = managers.simulate(geom, mcfg, phases, seed=3, device="cuda")
    for other in (host, split):
        np.testing.assert_array_equal(card.app, other.app)
        np.testing.assert_array_equal(card.mig, other.mig)
        for name, v in card.state.items():
            assert torch.equal(v.cpu(), other.state[name].cpu()), name
    assert_invariants(card.state)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["gc", "valve", "movement"])
@pytest.mark.parametrize("td_mode", ["static", "fdp", "bloom"])
def test_gc_one_kernel_with_enable_matches_plain_version(cuda, td_mode,
                                                         mode):
    """Four Table-2 drives with every other one disabled: the kernel and
    gc_one_ref land the same (out and every field), a disabled drive's
    state is untouched and its out (-1, -1, 0)."""
    ctx, args, kw = _gc_one_args(td_mode, 4, mode)
    state, g, b = args["state"], args["g"], TABLE2.pages_per_block
    if mode == "gc":  # open blocks full and over budget: decided
        for i in range(4):
            state["fill"][i, int(state["active_blk"][i, g[i]])] = b
            state["grp_alloc"][i, g[i]] = 0
    args["enable"] = torch.tensor([True, False, True, False])
    got, want = _on(args, cuda), _on(args, "cpu")
    gc_one_kernel.gc_one_cuda(**got, **kw)
    torch.cuda.synchronize()
    gc_one_ref.gc_one_ref(**want, **kw)
    assert torch.equal(got["out"].cpu(), want["out"])
    assert (want["out"][1::2] == torch.tensor([-1, -1, 0])).all()
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k].cpu(), v), k
        assert torch.equal(v[1::2], state[k][1::2]), k


def _fault_policy(d, cuda_rate=(0.0, 0.3, 0.6, 1.0)):
    """A fault policy [d] that retires some erases and keeps others: base
    rates cycling through ``cuda_rate``, every third drive worn out
    (endurance limit 0, worn rate 1.0), seeds spread over uint32."""
    i = torch.arange(d)
    return {
        "fault_rate": torch.tensor(cuda_rate)[i % len(cuda_rate)],
        "fault_rate_worn": torch.ones(d),
        "endurance_limit": torch.where(i % 3 == 0, 0, 2**31 - 1).int(),
        "fault_seed": (i * 2654435761 + 12345) % 2**32,
    }


@pytest.mark.cuda
@pytest.mark.parametrize("retries", [0, 3])
@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("td_mode", ["static", "fdp", "bloom"])
def test_gc_one_kernel_with_faults_matches_plain_version(cuda, td_mode, d,
                                                         retries):
    """The GC with the fault hook (after the static or the demoting
    drain): from a Table-2 state reached on the card, d drives' decided
    GCs (open blocks full and over budget) through the kernel and
    gc_one_ref, with a fault policy that retires some erases, spares 0 on
    every other drive (a retire degrades it) and draw counters near the
    top of uint32: out and every state field exact, and at least one block
    retired."""
    ctx, args, kw = _gc_one_args(td_mode, d, "gc", fault_fields=True)
    state, g, b = args["state"], args["g"], TABLE2.pages_per_block
    i = torch.arange(d)
    state["spares_left"] = torch.where(i % 2 == 0, 0, 3).int()
    state["fault_draws"].view(torch.int32).copy_((-3 - 1000 * i).int())
    for j in range(d):
        state["fill"][j, int(state["active_blk"][j, g[j]])] = b
        state["grp_alloc"][j, g[j]] = 0
    args["fault_policy"] = _fault_policy(d)
    kw["erase_max_retries"] = retries
    got, want = _on(args, cuda), _on(args, "cpu")
    gc_one_kernel.gc_one_cuda(**got, **kw)
    torch.cuda.synchronize()
    gc_one_ref.gc_one_ref(**want, **kw)
    assert want["out"][:, 2].all()
    assert torch.equal(got["out"].cpu(), want["out"])
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k].cpu().view(v.dtype), v), k
    assert (want["state"]["retired_blocks"] > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("with_trim", [True, False], ids=["trim", "writes"])
def test_write_run_kernel_halts_degraded_drives(cuda, with_trim):
    """Six Table-2 drives, every other one degraded, through write_run
    with faults and through write_run_ref: stop, trace and every state
    field exact; a degraded drive runs to the end, halting each event."""
    ctx, st, policy, phase = _table2_drive("static", with_trim)
    d, n = 6, 256
    rows = [dataclasses.replace(phase, n_writes=n).sample_ops(
        np.random.default_rng(7 + i)) for i in range(d)]
    fields = wr_kernel.STATE_FIELDS + wr_kernel.HALT_FIELDS
    state = {k: (v.view(1) if v.dim() == 0 else v[None])
             for k, v in ((k, getattr(st, k).cpu()) for k in fields)}
    state = {k: v.repeat(d, *[1] * (v.dim() - 1)).contiguous()
             for k, v in state.items()}
    state["drive_status"] = (torch.arange(d) % 2).int()
    args = dict(
        lbas=torch.from_numpy(np.stack([lb for _, lb in rows]).astype(
            np.int64)),
        ops=torch.from_numpy(np.stack([o for o, _ in rows]).astype(
            np.uint8)) if with_trim else None,
        start=torch.tensor([[0, int(st.n_app)]] * d),
        stop=torch.full((d, 3), -1), state=state,
        policy={k: policy[k].cpu().repeat(d, 1) for k in (
            "page_rate", "fdp_rate", "page_group0") if k in policy},
        app=torch.full((d, n), -1, dtype=torch.int32),
        mig=torch.full((d, n), -1, dtype=torch.int32),
    )
    mode = dict(h=ctx.h, trace_every=1, td_mode="static",
                movement_ops=ctx.mcfg.movement_ops,
                bloom_rotate_min_writes=ctx.mcfg.bloom_rotate_min_writes,
                with_faults=True)

    def on(device):
        return {k: None if v is None else (
            {kk: vv.to(device, copy=True) for kk, vv in v.items()}
            if isinstance(v, dict) else v.to(device, copy=True))
            for k, v in args.items()}

    got, want = on(cuda), on("cpu")
    wr_kernel.write_run_cuda(**got, **mode)
    torch.cuda.synchronize()
    wr_ref.write_run_ref(**want, **mode)
    for k in ("stop", "app", "mig"):
        assert torch.equal(got[k].cpu(), want[k]), k
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k].cpu(), v), k
    halted = state["drive_status"] == 1
    assert (want["stop"][halted, 0] == n).all()
    assert (want["state"]["n_halted"][halted] == n).all()
    assert (want["state"]["n_halted"][~halted] == 0).all()


def _faulty_specs(n):
    """Faulty drives at Geometry(4, 32, 8) that degrade within n events:
    static, fdp and bloom (the hook after the demoting drain), one on a
    TRIM op stream, beside a fault-free static drive."""
    lba = Geometry(4, 32, 8).lba_pages
    kw = dict(fault_rate=0.1, erase_max_retries=0)
    return [
        fleet.DriveSpec(managers.wolf(**kw), (workloads.two_modal(lba, n),),
                        1),
        fleet.DriveSpec(managers.wolf(erase_max_retries=0),
                        (workloads.two_modal(lba, n),), 2),
        fleet.DriveSpec(managers.fdp(**kw), (workloads.two_modal(lba, n),),
                        3),
        fleet.DriveSpec(managers.wolf_dynamic(**kw),
                        (workloads.tpcc_churn(lba, n),), 4),
    ]


@pytest.mark.cuda
def test_card_faulty_runs_and_fleet_match_cpu(cuda):
    """Faulty drives (retire hook in gc_one after the static and the
    demoting drain, halt guard in write_run) on the card equal their CPU
    runs, alone and as a fleet with a fault-free drive, bit for bit."""
    geom, specs = Geometry(4, 32, 8), _faulty_specs(3000)
    for s in specs[::2]:
        card = managers.simulate(geom, s.mcfg, list(s.phases), seed=s.seed,
                                 device="cuda")
        host = managers.simulate(geom, s.mcfg, list(s.phases), seed=s.seed,
                                 device="cpu")
        np.testing.assert_array_equal(card.app, host.app)
        np.testing.assert_array_equal(card.mig, host.mig)
        assert card.host_syncs == host.host_syncs
        for name, v in card.state.items():
            assert torch.equal(v.cpu(), host.state[name]), (s.label, name)
        assert int(card.state.retired_blocks) > 0
    card = fleet.simulate_fleet(geom, specs, sampler="numpy")
    host = fleet.simulate_fleet(geom, specs, sampler="numpy", device="cpu")
    np.testing.assert_array_equal(card.app, host.app)
    np.testing.assert_array_equal(card.mig, host.mig)
    assert card.exec_meta == host.exec_meta
    for i in range(len(specs)):
        for name, v in card.state(i).items():
            assert torch.equal(v.cpu(), host.state(i)[name]), (i, name)
    assert (card.drive_status() == host.drive_status()).all()
    assert (card.drive_status() != 0).any()


def _mixed_fleet(n):
    """Drives of every sub-batch kind at Geometry(4, 32, 8): static
    closed-form (two seeds, one on a two-phase swap), fdp, single_group,
    bloom with §5.2, and a TRIM op stream."""
    lba = Geometry(4, 32, 8).lba_pages
    return [
        fleet.DriveSpec(managers.wolf(), (workloads.two_modal(lba, n),), 1),
        fleet.DriveSpec(managers.wolf(), tuple(workloads.swap_phases(
            lba, n // 2)), 2),
        fleet.DriveSpec(managers.fdp(), (workloads.two_modal(lba, n),), 3),
        fleet.DriveSpec(managers.single_group(),
                        (workloads.uniform(lba, n),), 4),
        fleet.DriveSpec(managers.wolf_dynamic(),
                        (workloads.tpcc_like(lba, n),), 5),
        fleet.DriveSpec(managers.wolf_dynamic(),
                        (workloads.tpcc_churn(lba, n),), 6),
    ]


@pytest.mark.cuda
def test_card_fleet_matches_cpu_fleet(cuda):
    """A fleet of every sub-batch kind (numpy streams) on the card equals
    the same fleet on the CPU: traces, every state field, and each
    sub-batch's rounds, interval batches and host syncs."""
    geom, specs = Geometry(4, 32, 8), _mixed_fleet(3000)
    n = wr_kernel.launches
    card = fleet.simulate_fleet(geom, specs, sampler="numpy")
    assert wr_kernel.launches - n == sum(m["rounds"] for m in card.exec_meta)
    host = fleet.simulate_fleet(geom, specs, sampler="numpy", device="cpu")
    np.testing.assert_array_equal(card.app, host.app)
    np.testing.assert_array_equal(card.mig, host.mig)
    assert card.exec_meta == host.exec_meta
    for i in range(len(specs)):
        for name, v in card.state(i).items():
            assert torch.equal(v.cpu(), host.state(i)[name]), (i, name)
        assert_invariants(card.state(i))


@pytest.mark.cuda
def test_card_churn_fleet_matches_cpu_fleet(cuda):
    """Four wolf_dynamic drives on tpcc_churn (bloom detector, demoting
    drains) as one fleet on the card equal the same fleet on the CPU, bit
    for bit; every gc_one launch carries the demoting drain, and none
    goes through compact_slots."""
    geom = Geometry(4, 32, 8)
    specs = [fleet.DriveSpec(managers.wolf_dynamic(),
                             (workloads.tpcc_churn(geom.lba_pages, 3000),),
                             seed) for seed in range(4)]
    n = (gc_one_kernel.launches, gc_one_kernel.demote_launches,
         gc_kernel.launches)
    card = fleet.simulate_fleet(geom, specs, sampler="numpy")
    gcs = gc_one_kernel.launches - n[0]
    assert gcs > 0 and gc_one_kernel.demote_launches - n[1] == gcs
    assert gc_kernel.launches == n[2]
    host = fleet.simulate_fleet(geom, specs, sampler="numpy", device="cpu")
    np.testing.assert_array_equal(card.app, host.app)
    np.testing.assert_array_equal(card.mig, host.mig)
    assert card.exec_meta == host.exec_meta
    for i in range(len(specs)):
        for name, v in card.state(i).items():
            assert torch.equal(v.cpu(), host.state(i)[name]), (i, name)
        assert_invariants(card.state(i))
        assert int(card.state(i).n_erase) > 0


@pytest.mark.cuda
def test_card_device_sampler_fleet(cuda):
    """The device sampler on the card: a fleet runs, keeps its invariants
    and drops nothing, and the same seeds run it again identically."""
    geom, specs = Geometry(4, 32, 8), _mixed_fleet(2000)
    a = fleet.simulate_fleet(geom, specs)
    b = fleet.simulate_fleet(geom, specs)
    np.testing.assert_array_equal(a.app, b.app)
    np.testing.assert_array_equal(a.mig, b.mig)
    for i in range(len(specs)):
        assert_invariants(a.state(i))
        assert int(a.state(i).n_dropped) == 0


ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [True, False],
                         ids=["overlapping", "disjoint"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gc_compact_kernel_matches_plain_version(cuda, dtype, overlap):
    """No-op rows, two layers; source and destination sets overlapping
    (the hazard rows staged: two device launches) or disjoint (one)."""
    rng = np.random.default_rng(5)
    n, p, h, d, m = 12, 8, 2, 64, 30
    pools = [torch.from_numpy(rng.normal(size=(2, n, p, h, d)).astype(
        np.float32)).to(cuda, dtype) for _ in range(2)]
    slots = rng.permutation(n * p)
    dst = slots[:m]
    src = rng.choice(slots if overlap else slots[m:], m, replace=False)
    moves = np.stack([src // p, src % p, dst // p, dst % p], 1)
    moves[rng.random(m) < 0.2, 0] = -1
    moves = torch.from_numpy(moves.astype(np.int32))
    assert (gc_kernel.plan_moves(moves, n, p)[1] > 0) == overlap
    got, want = [t.clone() for t in pools], [t.clone() for t in pools]
    n_launch = (gc_kernel.kv_launches, gc_kernel.kv_device_launches)
    gc_kernel.gc_compact_cuda(*got, moves)
    assert gc_kernel.kv_launches == n_launch[0] + 1
    assert gc_kernel.kv_device_launches == n_launch[1] + 1 + overlap
    gc_ops.gc_compact_ref(*want, moves)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gc_compact_kernel_at_16_kv_heads(cuda, dtype):
    """olmoe-1b-7b's pool rows (16 KV heads of 128) over two layers, the
    sources overlapping the destinations."""
    rng = np.random.default_rng(6)
    n, p, h, d, m = 24, 16, 16, 128, 120
    pools = [torch.from_numpy(rng.normal(size=(2, n, p, h, d)).astype(
        np.float32)).to(cuda, dtype) for _ in range(2)]
    slots = rng.permutation(n * p)
    src = rng.choice(slots, m, replace=False)
    moves = np.stack([src // p, src % p, slots[:m] // p, slots[:m] % p], 1)
    moves = torch.from_numpy(moves.astype(np.int32))
    assert gc_kernel.plan_moves(moves, n, p)[1] > 0
    got, want = [t.clone() for t in pools], [t.clone() for t in pools]
    gc_kernel.gc_compact_cuda(*got, moves)
    gc_ops.gc_compact_ref(*want, moves)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _assert_close(got, want, dtype):
    """Within the absolute bound, and in bf16 each row of the head
    dimension within 2e-2 of that row's largest |plain| value."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    assert err.max().item() <= ATTN_TOL[dtype], err.max().item()
    if dtype == torch.bfloat16:
        rel = err.amax(-1) / want.abs().amax(-1).clamp_min(1e-30)
        assert rel.max().item() <= 2e-2, rel.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,d,n,p,m,lengths,holes", [
    (4, 8, 2, 64, 32, 16, 6, None, 0.3),
    (2, 8, 1, 128, 16, 32, 3, None, 0.3),
    (3, 4, 4, 32, 24, 8, 8, None, 0.3),
    # lengths 1, P and M * P
    (3, 8, 2, 64, 32, 16, 6, (1, 16, 96), 0.3),
    # fewer pages than the kernel's 8 warps, G = 1
    (2, 8, 8, 128, 16, 16, 4, None, 0.3),
    # a 64-page table at the serving path's heads
    (2, 16, 8, 128, 160, 16, 64, (1024, 700), 0.2),
    # every slot a hole but the newest (whole warps see only holes), G = 8
    (4, 16, 2, 128, 64, 16, 8, None, 1.0),
    # G = 8 at D = 32
    (2, 8, 1, 32, 24, 8, 8, (64, 33), 0.3),
    # olmoe-1b-7b's heads: G = 1 over 16 KV heads on a 64-page table
    (4, 16, 16, 128, 200, 16, 64, (1024, 700, 17, 256), 0.2),
])
def test_paged_attention_kernel_matches_plain_version(
        cuda, dtype, b, hq, hkv, d, n, p, m, lengths, holes):
    """Random tables (distinct blocks per sequence, -1 past the length),
    lengths in [1, M * P] unless given, a ``holes`` share of slots
    invalid (the newest token always valid)."""
    args = _paged_inputs(cuda, dtype, b, hq, hkv, d, n, p, m, lengths, holes)
    n_launch = paged_kernel.launches
    got = paged_kernel.paged_attention_cuda(*args)
    assert paged_kernel.launches == n_launch + 1
    want = paged_ref.paged_attention_ref(*args)
    _assert_close(got, want, dtype)


def _paged_inputs(cuda, dtype, b, hq, hkv, d, n, p, m, lengths, holes):
    rng = np.random.default_rng(b + d)
    if lengths is None:
        lengths = rng.integers(1, m * p + 1, b)
    lengths = np.asarray(lengths, np.int32)
    tables = np.full((b, m), -1, np.int32)
    valid = (rng.random((b, m, p)) < 1 - holes).astype(np.int8)
    for i in range(b):
        npages = -(-int(lengths[i]) // p)
        tables[i, :npages] = rng.choice(n, npages, replace=False)
        t = int(lengths[i]) - 1
        valid[i, t // p, t % p] = 1  # every row keeps a valid slot
    q, kp, vp = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        cuda, dtype) for s in ((b, hq, d), (n, p, hkv, d), (n, p, hkv, d)))
    rest = [torch.from_numpy(x).to(cuda) for x in (tables, lengths, valid)]
    return q, kp, vp, *rest


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,ok", [
    (torch.bfloat16, 256, True), (torch.bfloat16, 16, True),
    (torch.bfloat16, 96, False), (torch.float32, 256, False),
])
def test_paged_attention_kernel_head_sizes(cuda, dtype, d, ok):
    """The kernel takes any d_head whose row is a power of two of 16-byte
    lanes, up to a warp's 32, and refuses the rest at launch, counting no
    launch."""
    args = _paged_inputs(cuda, dtype, 2, 8, 2, d, 24, 16, 4, None, 0.3)
    n_launch = paged_kernel.launches
    if not ok:
        with pytest.raises(RuntimeError, match="launch failed"):
            paged_kernel.paged_attention_cuda(*args)
        assert paged_kernel.launches == n_launch
        return
    got = paged_kernel.paged_attention_cuda(*args)
    assert paged_kernel.launches == n_launch + 1
    _assert_close(got, paged_ref.paged_attention_ref(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window", [
    (1, 128, 128, 4, 4, 64, True, 0), (2, 160, 160, 8, 2, 32, True, 0),
    (1, 192, 192, 4, 2, 128, True, 48), (2, 64, 160, 2, 2, 128, False, 0),
    # lengths off the 64-row tiles, G = 8
    (1, 200, 200, 8, 1, 128, True, 0),
    # a window narrower than a tile, G = 4, B > 1
    (2, 333, 333, 4, 1, 64, True, 16),
    # non-causal with Sq < Skv, G = 1
    (1, 200, 333, 4, 4, 32, False, 0),
    # a narrow window at G = 8, B > 1; a window across tiles at D = 32
    (2, 333, 333, 16, 2, 128, True, 16),
    (1, 257, 257, 8, 2, 32, True, 70),
    # mixtral-8x22b's heads (G = 6) with a window shorter than the
    # sequence; llava-next-34b's (G = 7): odd groups, one head a block
    (1, 700, 700, 48, 8, 128, True, 512),
    (2, 300, 300, 56, 8, 128, True, 0),
])
def test_flash_attention_kernel_matches_plain_version(
        cuda, dtype, b, sq, skv, hq, hkv, d, causal, window):
    rng = np.random.default_rng(sq + d)
    q, k, v = (torch.from_numpy((rng.normal(size=s) * 0.5).astype(
        np.float32)).to(cuda, dtype) for s in (
            (b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    n_launch = flash_kernel.launches
    got = flash_kernel.flash_attention_cuda(q, k, v, causal=causal,
                                            window=window)
    assert flash_kernel.launches == n_launch + 1
    want = flash_ref.flash_attention_ref(q, k, v, causal=causal,
                                         window=window)
    _assert_close(got, want, dtype)


@pytest.mark.cuda
def test_empty_calls_launch_and_count_nothing(cuda):
    """A wrapper counts a launch only where it launches its kernel."""
    pools = [torch.zeros((2, 4, 8, 2, 32), device=cuda) for _ in range(2)]
    n_launch = (gc_kernel.kv_launches, gc_kernel.kv_device_launches)
    for moves in (torch.zeros((0, 4), dtype=torch.int32),
                  torch.tensor([[-1, 0, 1, 1]], dtype=torch.int32)):
        gc_kernel.gc_compact_cuda(*pools, moves)
    assert (gc_kernel.kv_launches, gc_kernel.kv_device_launches) == n_launch
    q = torch.zeros((0, 4, 32), device=cuda)
    kp = torch.zeros((4, 8, 2, 32), device=cuda)
    rest = [torch.zeros(s, dtype=t, device=cuda) for s, t in (
        ((0, 3), torch.int32), ((0,), torch.int32), ((0, 3, 8), torch.int8))]
    n_launch = paged_kernel.launches
    assert paged_kernel.paged_attention_cuda(q, kp, kp, *rest).shape == (
        0, 4, 32)
    assert paged_kernel.launches == n_launch
    q = torch.zeros((0, 16, 4, 32), device=cuda)
    kv = torch.zeros((0, 16, 2, 32), device=cuda)
    n_launch = flash_kernel.launches
    assert flash_kernel.flash_attention_cuda(q, kv, kv).shape == q.shape
    assert flash_kernel.launches == n_launch


@pytest.mark.cuda
def test_card_engine_matches_cpu_engine(cuda):
    """The serving engine at smoke width in fp32 on the card and on the
    CPU, with a pool tight enough to compact: the same control plane and
    the same generated tokens, through both serving kernels."""
    cfg = smoke_config(get_config("internlm2-1.8b"))
    runs = []
    for device in (cuda, "cpu"):
        eng = ServingEngine(cfg, n_blocks=48, page=8, max_pages_per_seq=16,
                            max_batch=4, device=device)
        if device == "cpu":  # the card engine's weights
            eng.params.load_state_dict(runs[0][2])
        rng = np.random.default_rng(0)
        reqs = [Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, 12).astype(np.int32), max_new=48,
            policy=["append", "h2o:50", "window:16"][rid % 3])
            for rid in range(8)]
        for r in reqs:
            eng.submit(r)
        n_launch = (paged_kernel.launches, gc_kernel.kv_launches)
        summary = eng.run_until_drained(max_steps=400)
        eng.manager.check_invariants()
        launched = (paged_kernel.launches - n_launch[0],
                    gc_kernel.kv_launches - n_launch[1])
        runs.append((summary, [r.out for r in reqs], {
            k: v.cpu() for k, v in eng.params.state_dict().items()},
            launched))
    assert runs[0][0] == runs[1][0] and runs[0][0]["copied"] > 0
    assert runs[0][1] == runs[1][1]
    assert runs[0][3][0] == cfg.n_layers * runs[0][0]["steps"]
    assert runs[0][3][1] > 0 and runs[1][3] == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("path,tokens", [("capacity", 600), ("dense", 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_card_matches_cpu(cuda, dtype, path, tokens):
    """olmoe's routing (64 experts, top-8, tpg 256) at d 256: routed once
    on the CPU, that routing through the capacity path (three groups, 168
    pad rows, capacity factor 1.0 so tokens drop) or the dense path on
    the card and the CPU: the same pairs kept, outputs within 1e-5 (fp32)
    or 2e-2 (bf16), absolute and relative."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), d_model=256,
                              d_ff=128, capacity_factor=1.0, dtype=dtype)
    layer = moe.MoE(cfg, cuda)
    layer.init_(torch.Generator(device=cuda).manual_seed(0))
    layer_cpu = moe.MoE(cfg, "cpu")
    layer_cpu.load_state_dict({k: v.cpu()
                               for k, v in layer.state_dict().items()})
    x_cpu = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, tokens // 2, cfg.d_model)).astype(np.float32)).to(
            getattr(torch, dtype))
    gates, idx = moe._router(layer_cpu, x_cpu.reshape(tokens, -1), cfg)
    args = (x_cpu.to(cuda), gates.to(cuda), idx.to(cuda), cfg)
    if path == "capacity":
        got, keep = moe.capacity_from_routing(layer, *args)
        want, keep_cpu = moe.capacity_from_routing(layer_cpu, x_cpu, gates,
                                                   idx, cfg)
        assert torch.equal(keep.cpu(), keep_cpu) and not keep_cpu.all()
    else:
        got = moe.dense_from_routing(layer, *args)
        want = moe.dense_from_routing(layer_cpu, x_cpu, gates, idx, cfg)
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.cuda
def test_card_moe_engine_control_plane_matches_cpu(cuda):
    """olmoe at smoke width in fp32 through the serving engine on the card
    and on the CPU, the same weights, a pool tight enough to compact: the
    same control plane (steps, counters, every move list) through both
    serving kernels. Tokens are not compared: a routing choice may flip
    between the two devices' fp32 sums."""
    cfg = smoke_config(get_config("olmoe-1b-7b"))
    runs = []
    for device in (cuda, "cpu"):
        eng = ServingEngine(cfg, n_blocks=24, page=8, max_pages_per_seq=16,
                            max_batch=4, device=device)
        if device == "cpu":  # the card engine's weights
            eng.params.load_state_dict(runs[0][2])
        lists, drain = [], eng.manager.drain_moves

        def recorded():
            moves = drain()
            if moves:
                lists.append(list(moves))
            return moves

        eng.manager.drain_moves = recorded
        rng = np.random.default_rng(0)
        for rid in range(8):
            eng.submit(Request(rid=rid, prompt=rng.integers(
                0, cfg.vocab, 12).astype(np.int32), max_new=48,
                policy=["append", "h2o:50", "window:16"][rid % 3]))
        n_launch = (paged_kernel.launches, gc_kernel.kv_launches)
        summary = eng.run_until_drained(max_steps=400)
        eng.manager.check_invariants()
        assert len(eng.manager.free) == 24
        launched = (paged_kernel.launches - n_launch[0],
                    gc_kernel.kv_launches - n_launch[1])
        runs.append(((summary, lists), launched, {
            k: v.cpu() for k, v in eng.params.state_dict().items()}))
    assert runs[0][0] == runs[1][0] and runs[0][0][0]["copied"] > 0
    assert runs[0][1] == (cfg.n_layers * runs[0][0][0]["steps"],
                          len(runs[0][0][1]))
    assert runs[1][1] == (0, 0)


def _leaves(cache):
    """A cache's tensors (dicts, lists, tuples of them) in order."""
    if isinstance(cache, dict):
        return [t for k in sorted(cache) for t in _leaves(cache[k])]
    if isinstance(cache, (list, tuple)):
        return [t for c in cache for t in _leaves(c)]
    return [cache]


def _rel_close(got, want, tol=1e-4):
    """Within ``tol`` of the CPU's tensor, relative to its largest value."""
    scale = max(want.abs().max().item(), 1.0)
    assert (got.cpu() - want).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-125m", "hymba-1.5b",
                                  "whisper-large-v3", "learned-positions"])
def test_family_on_card_matches_cpu(cuda, arch):
    """Each of the last three families at smoke width in fp32 (and a
    transformer with learned positions), the same weights on the card and
    on the CPU: a prefill of 40 tokens (past Hymba's window of 16) and two
    decode steps, logits and every cache tensor within 1e-4. The three
    families' paths launch no hand-written kernel; the dense transformer
    certifies its window, so its card prefill runs the flash kernel once a
    layer."""
    if arch == "learned-positions":
        cfg = dataclasses.replace(smoke_config(get_config("internlm2-1.8b")),
                                  use_rope=False)
    else:
        cfg = smoke_config(get_config(arch))
    api = get_model(cfg)
    card = api.init_params(torch.Generator(device=cuda).manual_seed(0))
    host = params_class(cfg)(cfg, "cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.default_rng(1)
    b, s, n_steps = 2, 40, 2
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s + n_steps)))
    extra = ()
    if cfg.frontend == "audio_frames":
        extra = (torch.from_numpy(rng.normal(size=(b, 20, cfg.d_model))
                                  .astype(np.float32) * 0.5),)
    n_launch = (flash_kernel.launches, paged_kernel.launches)
    runs = []
    for dev, params in ((cuda, card), ("cpu", host)):
        logits, cache = api.prefill(params, tokens[:, :s].to(dev),
                                    *(e.to(dev) for e in extra),
                                    max_len=s + n_steps)
        steps = [logits]
        for i in range(n_steps):
            pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
            logits, cache = api.decode_step(params, cache,
                                            tokens[:, s + i].to(dev), pos)
            steps.append(logits)
        runs.append(steps + _leaves(cache))
    flash = cfg.n_layers if arch == "learned-positions" else 0
    assert (flash_kernel.launches, paged_kernel.launches) == (
        n_launch[0] + flash, n_launch[1])
    assert len(runs[0]) == len(runs[1])
    for got, want in zip(*runs):
        assert got.is_cuda and got.dtype == want.dtype
        _rel_close(got, want)


# -- training: the flash kernel under autograd, a step, a restore -------------------

def _train_state(cfg, device, seed=0):
    from repro_torch.train.train_loop import state_from_params

    params = params_class(cfg)(cfg, "cpu")
    params.init_(torch.Generator().manual_seed(seed))
    return state_from_params(params.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_autograd_matches_plain_gradients(cuda, dtype, tol):
    """flash_attention under autograd at internlm2-1.8b's heads (16 query,
    8 KV, D 128), causal: the forward is the kernel (one launch), the
    gradients of q, k and v those of the plain chunked attention, within
    ``tol`` of each gradient's largest value."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.attention import chunked_attention

    rng = np.random.default_rng(5)
    shapes = ((2, 256, 16, 128), (2, 256, 8, 128), (2, 256, 8, 128))
    base = [torch.from_numpy((rng.normal(size=s) * 0.5).astype(np.float32))
            .to(cuda, dtype) for s in shapes]
    w = torch.from_numpy(rng.normal(size=shapes[0]).astype(np.float32)).to(
        cuda, dtype)
    grads = []
    for fn in (lambda q, k, v: flash_attention(q, k, v, causal=True),
               lambda q, k, v: chunked_attention(q, k, v, 0, causal=True)):
        q, k, v = (t.clone().requires_grad_(True) for t in base)
        n_launch = flash_kernel.launches
        out = fn(q, k, v)
        grads.append((out.detach(), *torch.autograd.grad(
            (out.float() * w.float()).sum(), (q, k, v))))
        launched = flash_kernel.launches - n_launch
    assert launched == 0  # the plain path ran last
    _assert_close(grads[0][0], grads[1][0], dtype)
    for got, want in zip(grads[0][1:], grads[1][1:]):
        assert torch.isfinite(got).all()
        scale = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
def test_flash_kernel_refuses_inputs_under_autograd(cuda):
    """flash_attention_cuda has no backward: with grad mode on it refuses
    inputs that require a gradient, launching nothing; the op carries them
    through its autograd.Function; without grad mode the kernel runs."""
    from repro_torch.kernels.flash_attention.ops import FlashAttention

    q, k, v = (torch.randn(1, 64, 4, 64, device=cuda).requires_grad_(True)
               for _ in range(3))
    n_launch = flash_kernel.launches
    with pytest.raises(RuntimeError, match="require a gradient"):
        flash_kernel.flash_attention_cuda(q, k, v)
    assert flash_kernel.launches == n_launch
    out = FlashAttention.apply(q, k, v, True, 0)
    assert out.requires_grad and flash_kernel.launches == n_launch + 1
    with torch.no_grad():
        flash_kernel.flash_attention_cuda(q, k, v)
    assert flash_kernel.launches == n_launch + 2


@pytest.mark.cuda
def test_train_step_card_matches_cpu(cuda):
    """One step of internlm2 at smoke width in fp32, two microbatches, AdamW
    at lr 1e-3 without warmup (each element with a gradient moves by about
    1e-3), the same weights and batch on the card and on the CPU: the loss
    and the gradient norm within 1e-5 relative, the first moment (the
    clipped gradient times 1 - b1) within 1e-4 of each leaf's largest
    value; the card's params within 1e-5 of the CPU's AdamW applied to the
    card's first moment over 1 - b1 (Adam's first step is about
    lr * sign(g), which rounding can flip where g is near 0, so the update
    is held on the card's own gradients); the card's flash kernel ran once
    a layer a microbatch in the forward and once more in each block's
    recompute."""
    from repro_torch.data.pipeline import DataConfig, TokenStream, to_device
    from repro_torch.train.optimizer import OptimizerConfig, adamw_update
    from repro_torch.train.train_loop import TrainConfig, make_train_step

    cfg = smoke_config(get_config("internlm2-1.8b"))
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0)
    step = make_train_step(get_model(cfg),
                           TrainConfig(opt=opt, n_microbatches=2))
    batch = TokenStream(DataConfig(cfg.vocab, 64, 4)).batch(0)
    out = {}
    for dev in (cuda, "cpu"):
        n_launch = flash_kernel.launches
        state, metrics = step(_train_state(cfg, dev), to_device(batch, dev))
        out[str(dev)] = (state, {k: v.item() for k, v in metrics.items()},
                         flash_kernel.launches - n_launch)
    (card, m_card, n_card), (host, m_host, n_host) = out["cuda"], out["cpu"]
    assert (n_card, n_host) == (cfg.n_layers * 2 * 2, 0)
    for k in ("loss", "grad_norm"):
        assert abs(m_card[k] - m_host[k]) <= 1e-5 * abs(m_host[k])
    moment = {k: m.cpu() for k, m in card["opt"]["m"].items()}
    for k, m in moment.items():
        want = host["opt"]["m"][k]
        assert (m - want).abs().max() <= 1e-4 * want.abs().max(), k
    replay = _train_state(cfg, "cpu")
    start = {k: p.detach().clone()
             for k, p in replay["params"].named_parameters()}
    adamw_update({k: m / (1 - opt.b1) for k, m in moment.items()},
                 replay["opt"], dict(replay["params"].named_parameters()),
                 opt)
    move = 0.0
    for (name, p), (_, p_want) in zip(card["params"].named_parameters(),
                                      replay["params"].named_parameters()):
        assert p.is_cuda
        p = p.detach().cpu()
        assert (p - p_want.detach()).abs().max().item() <= 1e-5, name
        move = max(move, (p - start[name]).abs().max().item())
    assert move >= 1e-4


@pytest.mark.cuda
def test_checkpoint_restores_onto_card(cuda, tmp_path):
    """A bf16 state saved from the CPU and restored with device="cuda":
    every leaf on the card, bit-equal, params still taking gradients."""
    from repro_torch.train import checkpoint as ck

    cfg = dataclasses.replace(smoke_config(get_config("internlm2-1.8b")),
                              dtype="bfloat16")
    state = _train_state(cfg, "cpu", seed=3)
    ck.save_checkpoint(tmp_path, state, 5)
    restored, step = ck.restore_checkpoint(tmp_path, state, device=cuda)
    assert step == 5
    got, want = ck.state_leaves(restored), ck.state_leaves(state)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.is_cuda and a.dtype == b.dtype, k
        assert torch.equal(a.detach().cpu(), b.detach()), k
    assert all(p.requires_grad for p in restored["params"].parameters())

"""The port's TRIM op stream against the JAX package's, on the CPU.

The kernel module first: the port's plain versions of ``apply_trim`` (what
the CPU runs, and what the CUDA kernel is held to on the card) against the
JAX package's 2-D oracle, its flat lowering and its Pallas kernel in
interpret mode, exactly (integer and boolean pools). Then the op stream end
to end: ``managers.simulate`` with TRIM-bearing phases through both
packages from the same seed. The bar: ``app``/``mig`` traces and every
integer ``SimState`` field exactly equal, ``grp_p`` within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import managers as ref_managers
from repro.core import workloads as ref_workloads
from repro.core.ssd import Geometry as RefGeometry
from repro.kernels.write_path import kernel as ref_wp_kernel
from repro.kernels.write_path import ref as ref_wp
from repro_torch import convert
from repro_torch.core import managers, simulator, workloads
from repro_torch.core.ssd import Geometry, assert_invariants
from repro_torch.kernels.write_path import kernel as wp_kernel
from repro_torch.kernels.write_path import ops as wp_ops

K, B, LBA = 24, 8, 128
GEOM = (4, 32, 8, 0.75)
N = 3000
SEED = 9
GRP_P_ATOL = 1e-6


# -- the kernel module --------------------------------------------------------

def _trim_case(seed, *, mapped=True):
    rng = np.random.default_rng(seed)
    valid = rng.random((K, B)) < 0.5
    page_map = rng.integers(-1, K * B, LBA).astype(np.int32)
    lba = int(rng.integers(0, LBA))
    if not mapped:  # a re-trim: the page has no mapping left
        page_map[lba] = -1
    return page_map, valid, (lba, int(page_map[lba]))


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("mapped", [True, False], ids=["mapped", "retrim"])
def test_apply_trim_matches_reference(seed, mapped):
    page_map, valid, scalars = _trim_case(seed, mapped=mapped)
    j = (jnp.asarray(page_map), jnp.asarray(valid),
         *map(jnp.asarray, scalars))
    want = [np.asarray(x) for x in ref_wp.apply_trim_ref(*j)]
    for other in (ref_wp.apply_trim_flat(*j),
                  ref_wp_kernel.apply_trim(*j, interpret=True)):
        for a, b in zip(other, want):
            np.testing.assert_array_equal(np.asarray(a), b)
    t = (torch.from_numpy(page_map), torch.from_numpy(valid))
    for fn in (wp_ops.apply_trim_ref, wp_ops.apply_trim):
        got = fn(*t, *scalars)
        for g, w, inp in zip(got, want, t):
            assert g.dtype == inp.dtype
            np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(t[0].numpy(), page_map)  # functional
    if not mapped:
        np.testing.assert_array_equal(want[1], valid)  # nothing cleared


def test_apply_trim_disabled_row_is_noop():
    """ok = 0 leaves both pools untouched, as the Pallas kernel with
    enabled=False does."""
    page_map, valid, (lba, old_pm) = _trim_case(11)
    want = ref_wp_kernel.apply_trim(
        jnp.asarray(page_map), jnp.asarray(valid), jnp.asarray(lba),
        jnp.asarray(old_pm), enabled=jnp.asarray(False), interpret=True,
    )
    pools = [torch.from_numpy(x.copy())[None] for x in (page_map, valid)]
    row = torch.tensor([[lba, old_pm, 0]], dtype=torch.int32)
    wp_ops.apply_trim_(row, *pools)
    for got, w in zip(pools, want):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(w))
    np.testing.assert_array_equal(pools[0][0].numpy(), page_map)


def test_apply_trim_batched_rows_match_per_drive_reference():
    """D drives in one call == each drive through the 2-D oracle; rows with
    ok = 0 and out-of-range indices are skipped."""
    d = 6
    cases = [_trim_case(100 + i, mapped=i != 1) for i in range(d)]
    rows = []
    for i, (_, _, (lba, old)) in enumerate(cases):
        if i == 3:
            old = K * B + 5  # outside the pool: the clear is skipped
        if i == 4:
            lba = LBA + 2    # outside the map: the unmap is skipped
        rows.append([lba, old, 0 if i == 2 else 1])
    pools = [torch.from_numpy(np.stack([c[j] for c in cases]))
             for j in range(2)]
    wp_ops.apply_trim_(torch.tensor(rows, dtype=torch.int32), *pools)
    for i, (pm, va, (lba, old)) in enumerate(cases):
        if i == 2:
            want = (pm, va)
        elif i == 3:
            want = (np.asarray(ref_wp.apply_trim_ref(
                jnp.asarray(pm), jnp.asarray(va), lba, -1)[0]), va)
        elif i == 4:
            want = (pm, np.asarray(ref_wp.apply_trim_ref(
                jnp.asarray(pm), jnp.asarray(va), 0, old)[1]))
        else:
            want = [np.asarray(x) for x in ref_wp.apply_trim_ref(
                jnp.asarray(pm), jnp.asarray(va), lba, old)]
        for got, w in zip(pools, want):
            np.testing.assert_array_equal(got[i].numpy(), w)


@pytest.mark.parametrize("bad", ["dtype", "row_width", "contiguity",
                                 "no_drive_axis", "drive_count"])
def test_apply_trim_rejects_what_the_kernel_does_not_take(bad):
    rows = torch.zeros((1, 3), dtype=torch.int32)
    page_map = torch.zeros((1, LBA), dtype=torch.int32)
    valid = torch.zeros((1, K, B), dtype=torch.bool)
    if bad == "dtype":
        rows = rows.long()
    elif bad == "row_width":
        rows = torch.zeros((1, 4), dtype=torch.int32)
    elif bad == "contiguity":
        valid = torch.zeros((1, B, K), dtype=torch.bool).transpose(1, 2)
    elif bad == "no_drive_axis":
        page_map, valid = page_map[0], valid[0]
    else:
        valid = torch.zeros((2, K, B), dtype=torch.bool)
    with pytest.raises(ValueError):
        wp_ops.apply_trim_(rows, page_map, valid)


def test_cpu_trim_launches_no_kernel_and_counts_apart():
    before = (wp_kernel.launches, wp_kernel.trim_launches)
    page_map, valid, scalars = _trim_case(0)
    wp_ops.apply_trim(torch.from_numpy(page_map), torch.from_numpy(valid),
                      *scalars)
    assert (wp_kernel.launches, wp_kernel.trim_launches) == before
    with pytest.raises(ValueError, match="tensors on cpu"):
        wp_kernel.apply_trim_cuda(
            torch.zeros((1, 3), dtype=torch.int32),
            torch.zeros((1, LBA), dtype=torch.int32),
            torch.zeros((1, K, B), dtype=torch.bool),
        )


# -- the op stream end to end -------------------------------------------------

CASES = [
    ("single_group", "trimmed_uniform"),
    ("wolf", "tpcc_churn"),
    ("wolf_trim_aware", "tpcc_churn"),
    ("fdp", "trimmed_two_modal"),
]
IDS = [f"{m}-{w}" for m, w in CASES]


def _phases(module, workload, lba):
    if workload == "trimmed_uniform":
        return [module.trimmed(module.uniform(lba, N), 0.5)]
    if workload == "trimmed_two_modal":
        return [module.trimmed(module.two_modal(lba, N), 0.25)]
    return [getattr(module, workload)(lba, N)]


@pytest.fixture(scope="module")
def runs():
    out = {}
    for manager, workload in CASES:
        rg, pg = RefGeometry(*GEOM), Geometry(*GEOM)
        ref = ref_managers.simulate(
            rg, getattr(ref_managers, manager)(),
            _phases(ref_workloads, workload, rg.lba_pages), seed=SEED,
        )
        port = managers.simulate(
            pg, getattr(managers, manager)(),
            _phases(workloads, workload, pg.lba_pages), seed=SEED,
            device="cpu",
        )
        out[(manager, workload)] = (ref, port)
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_op_stream_traces_match_reference(runs, case):
    ref, port = runs[case]
    np.testing.assert_array_equal(port.app, np.asarray(ref.app))
    np.testing.assert_array_equal(port.mig, np.asarray(ref.mig))
    assert port.wa_total == ref.wa_total
    np.testing.assert_array_equal(port.wa_curve(500), ref.wa_curve(500))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_op_stream_state_matches_reference(runs, case):
    ref, port = runs[case]
    got = convert.state_to_numpy(port.state)
    for name, want in ref.state.items():
        want = np.asarray(want)
        assert got[name].dtype == want.dtype, name
        assert got[name].shape == want.shape, name
        if name == "grp_p":
            np.testing.assert_allclose(got[name], want, rtol=0,
                                       atol=GRP_P_ATOL)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_op_stream_trims_and_holds_invariants(runs, case):
    _, port = runs[case]
    assert_invariants(port.state, str(case))
    st = port.state
    assert int(st.n_trim) > 0 and int(st.n_dropped) == 0
    assert int(st.n_app) + int(st.n_trim) == N
    assert int(st.trim_dead.sum()) > 0 or int(st.n_erase) > 0
    # trimmed pages leave the map: fewer mapped pages than logical ones
    assert int(st.mapped_pages) < Geometry(*GEOM).lba_pages


def test_forced_op_stream_equals_the_pure_write_run():
    """ops_stream=True on pure-write phases samples the same events and
    gives the pure-write run exactly."""
    pg = Geometry(*GEOM)
    phases = list(workloads.swap_phases(pg.lba_pages, 1000))
    pure = managers.simulate(pg, managers.wolf(), phases, seed=4,
                             device="cpu")
    ops = managers.simulate(pg, managers.wolf(), phases, seed=4,
                            ops_stream=True, device="cpu")
    np.testing.assert_array_equal(ops.app, pure.app)
    np.testing.assert_array_equal(ops.mig, pure.mig)
    for name, v in pure.state.items():
        assert torch.equal(ops.state[name], v), name
    with pytest.raises(ValueError, match="ops_stream=False"):
        managers.simulate(
            pg, managers.wolf(),
            [workloads.trimmed(workloads.uniform(pg.lba_pages, 8), 0.5)],
            ops_stream=False, device="cpu",
        )


def test_trim_only_segment_reads_nothing_from_the_device():
    """A TRIM has no heavy path and its op code is a host value: a segment
    of TRIMs leaves simulator.host_syncs where it was, and unmaps pages."""
    pg = Geometry(*GEOM)
    mcfg = managers.wolf_dynamic()
    phase = workloads.tpcc_churn(pg.lba_pages, 400)
    st, n_groups, assumed_p, fdp_rate, rates, pg0 = managers.build_drive(
        pg, mcfg, [phase], device="cpu")
    ctx = simulator.SimContext(pg, mcfg, n_groups, with_trim=True)
    lbas = np.random.default_rng(1).integers(0, pg.lba_pages, 400)
    before = simulator.host_syncs
    st, trace = simulator.run(
        ctx, st, lbas, ops=np.full(400, workloads.OP_TRIM, np.int32),
        page_group0=pg0, page_rate=rates[0], assumed_p=assumed_p,
        fdp_rate=fdp_rate, device="cpu",
    )
    assert simulator.host_syncs == before and trace["host_syncs"] == 0
    assert int(st.n_trim) == 400 and int(st.n_app) == 0
    assert int(st.mapped_pages) == pg.lba_pages - len(np.unique(lbas))
    assert_invariants(st, "trim-only")
    with pytest.raises(ValueError, match="ops="):
        simulator.run(ctx, st, lbas, page_group0=pg0, device="cpu")


def test_trim_workloads_match_reference():
    lba = RefGeometry(*GEOM).lba_pages
    pairs = [
        (workloads.tpcc_churn(lba, 50), ref_workloads.tpcc_churn(lba, 50)),
        (workloads.trimmed(workloads.two_modal(lba, 50), (0.1, 0.4)),
         ref_workloads.trimmed(ref_workloads.two_modal(lba, 50), (0.1, 0.4))),
    ]
    pairs += list(zip(workloads.utilization_sweep(lba, 50),
                      ref_workloads.utilization_sweep(lba, 50), strict=True))
    for port, ref in pairs:
        assert (port.sizes, port.probs, port.n_writes, port.trim_probs) == (
            ref.sizes, ref.probs, ref.n_writes, ref.trim_probs)
        for x, y in zip(port.sample_ops(np.random.default_rng(2)),
                        ref.sample_ops(np.random.default_rng(2))):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        workloads.trimmed(workloads.uniform(lba, 10), 1.5)

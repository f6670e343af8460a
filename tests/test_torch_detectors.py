"""The port's temperature detectors (§5.6), GC demotion and §5.2 dynamic
groups against the JAX package's, on the CPU.

The pieces first (the bloom hashes, filter updates and the hotter/colder
neighbour finds, on numpy-made inputs), then ``managers.simulate`` for the
presets that use them. The bar end to end: ``app``/``mig`` traces and every
integer ``SimState`` field exactly equal, and ``grp_p`` within 1e-6 and, in
the dynamic cases, bit for bit: a create or a merge turns on float32
comparisons of ``grp_p`` ratios, so one ulp there could change the groups.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import managers as ref_managers
from repro.core import simulator as ref_simulator
from repro.core import workloads as ref_workloads
from repro.core.ssd import Geometry as RefGeometry
from repro_torch import convert
from repro_torch.core import managers, simulator, workloads
from repro_torch.core.ssd import Geometry, assert_invariants
from repro_torch.kernels.gc_one import ref as gc_ref

GEOM = (4, 32, 8, 0.7)
TABLE2 = (8, 1024, 128, 0.7)
N = 4000
SEED = 5
GRP_P_ATOL = 1e-6


# -- bloom filter pair -------------------------------------------------------

def _lba_sweep(lba_pages):
    """Every 997th LBA of the drive, its last one, and values around and
    beyond 2**24, where a float32 cast would lose bits and the uint32
    products of the hashes wrap many times over."""
    edges = [lba_pages - 1, 2**24 - 1, 2**24, 2**24 + 1, 2**30 + 7,
             2**31 - 1]
    return np.concatenate([np.arange(0, lba_pages, 997), edges]).astype(
        np.int32)


@pytest.mark.parametrize("geom", [GEOM, TABLE2], ids=["small", "table2"])
def test_bloom_hashes_match_reference(geom):
    mcfg = managers.wolf_dynamic()
    ref_ctx = ref_simulator.SimContext(RefGeometry(*geom),
                                       ref_managers.wolf_dynamic(), 3)
    ctx = simulator.SimContext(Geometry(*geom), mcfg, 3)
    lbas = _lba_sweep(Geometry(*geom).lba_pages)
    r1, r2, r_bits = ref_simulator._bloom_hashes(ref_ctx, jnp.asarray(lbas))
    h1, h2, bits = simulator._bloom_hashes(ctx, torch.from_numpy(lbas))
    assert bits == r_bits
    np.testing.assert_array_equal(h1.numpy(), np.asarray(r1))
    np.testing.assert_array_equal(h2.numpy(), np.asarray(r2))
    assert int(h1.max()) < bits and int(h2.min()) >= 0


def test_bloom_updates_and_queries_match_reference():
    """A sequence of inserts (with rotations) into random filters: the
    returned 'in both' bits, the filter pair and the write counts stay
    equal to the JAX package's; queries of both filters agree too."""
    geom = Geometry(*GEOM)
    mcfg = dataclasses.replace(managers.wolf_dynamic(),
                               bloom_rotate_min_writes=8)
    rg = RefGeometry(*GEOM)
    ref_mcfg = dataclasses.replace(ref_managers.wolf_dynamic(),
                                   bloom_rotate_min_writes=8)
    phase = workloads.tpcc_like(geom.lba_pages, 10)
    st = managers.build_drive(geom, mcfg, [phase], device="cpu")[0]
    rng = np.random.default_rng(3)
    st.bloom_active.copy_(torch.from_numpy(rng.random(st.bloom_active.shape)
                                           < 0.3))
    st.bloom_passive.copy_(torch.from_numpy(
        rng.random(st.bloom_passive.shape) < 0.3))
    st.grp_size[:3] = torch.tensor([9, 12, 30], dtype=torch.int32)
    ref_st = ref_managers.build_drive(
        rg, ref_mcfg, [ref_workloads.tpcc_like(rg.lba_pages, 10)])[0]
    ref_st = ref_st.replace(**{k: jnp.asarray(v.numpy())
                               for k, v in st.items()})
    ctx = simulator.SimContext(geom, mcfg, 3)
    ref_ctx = ref_simulator.SimContext(rg, ref_mcfg, 3)
    lbas = rng.integers(0, geom.lba_pages, 60)
    lbas[30:] = lbas[:30]  # re-inserts: pages that are in the filters
    for lba, g in zip(lbas, rng.integers(0, 3, 60)):
        want_q = [bool(ref_simulator._bloom_query(
                      ref_ctx, f, jnp.asarray(lba, jnp.int32), g))
                  for f in (ref_st.bloom_active, ref_st.bloom_passive)]
        got_q = [bool(gc_ref.bloom_query(f, torch.tensor(lba), int(g)))
                 for f in (st.bloom_active, st.bloom_passive)]
        assert got_q == want_q
        ref_st, want = ref_simulator._bloom_update(
            ref_ctx, ref_st, jnp.asarray(lba, jnp.int32), g)
        got = simulator._bloom_update(ctx, st.batch, torch.tensor([lba]),
                                      torch.tensor([g]))
        assert bool(got[0]) == bool(want)
    for name in ("bloom_active", "bloom_passive", "bloom_writes"):
        np.testing.assert_array_equal(st[name].numpy(),
                                      np.asarray(ref_st[name]), err_msg=name)


# -- neighbour finds ---------------------------------------------------------

def _random_stats(seed):
    """Group stats with inactive groups and forced hit-rate ties."""
    rng = np.random.default_rng(seed)
    g_max = int(rng.integers(2, 13))
    active = rng.random(g_max) < 0.75
    active[int(rng.integers(0, g_max))] = True
    grp_p = np.where(active, rng.random(g_max), 0.0).astype(np.float32)
    grp_live = np.where(active, rng.integers(1, 50, g_max), 0).astype(
        np.int32)
    if g_max > 3:  # equal hit rates: same p, same size
        grp_p[2], grp_live[2] = grp_p[0], grp_live[0]
        grp_p[3], grp_live[3] = grp_p[1], grp_live[1]
    return active, grp_p, grp_live


class _Stats:
    """The fields the neighbour finds read, as the JAX package's state."""

    def __init__(self, active, grp_p, grp_live, module):
        self.grp_active = module.asarray(active)
        self.grp_p = module.asarray(grp_p)
        self.grp_live = module.asarray(grp_live)


@pytest.mark.parametrize("seed", range(40))
def test_neighbor_finds_match_argsort_oracle_and_reference(seed):
    active, grp_p, grp_live = _random_stats(seed)
    port = _Stats(active, grp_p, grp_live, torch)
    ref = _Stats(active, grp_p, grp_live, jnp)
    hr = simulator._hit_rates(port)
    ref_hr = ref_simulator._hit_rates(ref)
    np.testing.assert_array_equal(hr.numpy(), np.asarray(ref_hr))
    oracle = simulator._sgv_neighbors(port)
    ref_oracle = ref_simulator._sgv_neighbors(ref)
    act = torch.from_numpy(active)
    for g in range(len(active)):
        gt = torch.tensor(g)
        up = int(simulator._neighbor_hotter(hr, act, gt))
        dn = int(simulator._neighbor_colder(hr, act, gt))
        assert up == int(ref_simulator._neighbor_hotter(ref_hr, ref.grp_active,
                                                        g))
        assert dn == int(ref_simulator._neighbor_colder(ref_hr, ref.grp_active,
                                                        g))
        if active[g]:
            assert (up, dn) == (oracle(g, -1), oracle(g, 1))
            assert (up, dn) == (int(ref_oracle(g, -1)), int(ref_oracle(g, 1)))
            assert gc_ref.colder_neighbor(hr, act, g) == dn


# -- the presets end to end --------------------------------------------------

CASES = [
    ("fdp", "swap_phases"),
    ("wolf_dynamic", "tpcc_like"),
    ("wolf_dynamic", "tpcc_churn"),
]
IDS = [f"{m}-{w}" for m, w in CASES]


def _phases(module, workload, lba):
    if workload == "swap_phases":
        return list(module.swap_phases(lba, N // 2))
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
def test_detector_traces_match_reference(runs, case):
    ref, port = runs[case]
    np.testing.assert_array_equal(port.app, np.asarray(ref.app))
    np.testing.assert_array_equal(port.mig, np.asarray(ref.mig))
    np.testing.assert_array_equal(port.wa_curve(500), ref.wa_curve(500))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_detector_state_matches_reference(runs, case):
    ref, port = runs[case]
    got = convert.state_to_numpy(port.state)
    for name, want in ref.state.items():
        want = np.asarray(want)
        assert got[name].dtype == want.dtype, name
        if name != "grp_p":
            np.testing.assert_array_equal(got[name], want, err_msg=name)
    want_p = np.asarray(ref.state["grp_p"])
    np.testing.assert_allclose(got["grp_p"], want_p, rtol=0, atol=GRP_P_ATOL)
    if case[0] == "wolf_dynamic":  # bit for bit
        np.testing.assert_array_equal(got["grp_p"].view(np.uint32),
                                      want_p.view(np.uint32))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_detector_runs_move_pages_and_groups(runs, case):
    """The detectors did their work: groups were created or merged in the
    dynamic runs, and every run holds its invariants without a drop."""
    _, port = runs[case]
    st = port.state
    assert_invariants(st, str(case))
    assert int(st.n_dropped) == 0 and int(st.n_erase) > 0
    if case[0] == "wolf_dynamic":
        assert int(st.grp_created.max()) > 0  # stamped by a create
        assert int(st.bloom_writes.sum()) > 0


def test_bloom_state_carries_across_from_a_reference_run():
    """A reference wolf_dynamic run on tpcc_churn stopped half way, carried
    across by convert.state_from_numpy (bloom filter pair, trimmed-slot
    tallies and the trim count included), continues in the port exactly as
    the reference continues."""
    rg = RefGeometry(*GEOM)
    mcfg = ref_managers.wolf_dynamic()
    phases = [ref_workloads.tpcc_churn(rg.lba_pages, 1500)]
    rng = np.random.default_rng(SEED)
    st, n_groups, assumed_p, fdp_rate, rates, pg0 = ref_managers.build_drive(
        rg, mcfg, phases)
    ctx = ref_simulator.SimContext(rg, mcfg, n_groups, use_bloom=True,
                                   with_trim=True)
    kw = dict(page_rate=rates[0], assumed_p=assumed_p, fdp_rate=fdp_rate,
              page_group0=pg0)
    ops, lbas = phases[0].sample_ops(rng)
    mid, _ = ref_simulator.run(ctx, st, lbas, ops=ops, **kw)
    mid_np = {k: np.asarray(v) for k, v in mid.items()}
    assert mid_np["n_trim"] > 0 and mid_np["trim_dead"].sum() > 0
    assert mid_np["bloom_active"].any() and mid_np["bloom_passive"].any()
    ops, lbas = phases[0].sample_ops(rng)
    end, ref_trace = ref_simulator.run(ctx, mid, lbas, ops=ops, **kw)

    port_st = convert.state_from_numpy(mid_np, device="cpu")
    back = convert.state_to_numpy(port_st)
    for name, want in mid_np.items():
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    port_ctx = simulator.SimContext(Geometry(*GEOM), managers.wolf_dynamic(),
                                    n_groups, with_trim=True)
    port_end, trace = simulator.run(port_ctx, port_st, lbas, ops=ops,
                                    device="cpu", **kw)
    np.testing.assert_array_equal(trace["app"], np.asarray(ref_trace["app"]))
    np.testing.assert_array_equal(trace["mig"], np.asarray(ref_trace["mig"]))
    got = convert.state_to_numpy(port_end)
    for name, want in end.items():
        np.testing.assert_array_equal(got[name], np.asarray(want),
                                      err_msg=name)

"""repro_torch.core.fleet on the CPU, held to the port's own per-drive
runs and to the JAX package's one-device fleet.

At Geometry(4, 32, 8, 0.7) with 4,000 events a drive and the numpy
sampler, each drive of a port fleet must equal ``managers.simulate`` of
its spec (traces and every state field exactly; group arrays padded to a
sub-batch's cap stay inactive), and the JAX package's
``simulate_fleet(sampler="numpy")`` on the same specs (traces and integer
state exactly, ``grp_p`` within 1e-6). The fleet's analytics match the
JAX ``FleetResult``'s within rtol 1e-5 (float32 bisection and ``log``).
The device sampler is held by distribution and determinism. Fleets of
other shapes (weights, §5.1 constants, group caps, TRIMs, interval
alignment) are in ``test_torch_fleet_sweeps.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import fleet as ref_fleet
from repro.core import managers as ref_managers
from repro.core import workloads as ref_workloads
from repro.core.ssd import Geometry as RefGeometry
from repro_torch.core import fleet, managers, workloads
from repro_torch.core.ssd import Geometry, assert_invariants

GEOM = (4, 32, 8, 0.7)
LBA = Geometry(*GEOM).lba_pages
N = 4000
GRP_P_TOL = 1e-6
RTOL = 1e-5

# (preset, its keywords, phases from a workloads module, seed)
GRID = [
    ("wolf", {}, lambda W: [W.two_modal(LBA, N)], 1),
    ("fdp", {}, lambda W: [W.two_modal(LBA, N)], 2),
    ("single_group", {}, lambda W: [W.uniform(LBA, N)], 3),
    ("wolf_lru", {}, lambda W: [W.tpcc_like(LBA, N)], 4),
    ("wolf", {}, lambda W: list(W.swap_phases(LBA, N // 2)), 5),
    # the bloom sub-batch: its filter width must match the drive's alone
    ("wolf_dynamic", {}, lambda W: [W.tpcc_like(LBA, N)], 6),
]


def specs_of(desc, port=True):
    """The fleet ``desc`` as the port's DriveSpecs or the JAX package's."""
    m, w, spec = ((managers, workloads, fleet.DriveSpec) if port else
                  (ref_managers, ref_workloads, ref_fleet.DriveSpec))
    return [spec(getattr(m, preset)(**kw), tuple(phases(w)), seed=seed)
            for preset, kw, phases, seed in desc]


def run_port(desc, **kw):
    return fleet.simulate_fleet(Geometry(*GEOM), specs_of(desc),
                                sampler="numpy", device="cpu", **kw)


def run_jax(desc):
    return ref_fleet.simulate_fleet(RefGeometry(*GEOM),
                                    specs_of(desc, port=False),
                                    sampler="numpy")


def assert_equals_runs_alone(result, specs, drives=None):
    """Each drive (of ``drives``, default all) equals managers.simulate of
    its spec: traces and every state field; a padded group slot stays
    inactive."""
    for i in range(len(specs)) if drives is None else drives:
        s = specs[i]
        alone = managers.simulate(Geometry(*GEOM), s.mcfg, list(s.phases),
                                  seed=s.seed, device="cpu")
        np.testing.assert_array_equal(result.app[i], alone.app, s.label)
        np.testing.assert_array_equal(result.mig[i], alone.mig, s.label)
        got_st = result.state(i)
        for key, want in alone.state.items():
            got = got_st[key]
            if got.shape != want.shape:
                g = s.mcfg.max_groups
                assert got.shape[0] > g, (s.label, key)
                if key.startswith("bloom_") and key != "bloom_writes":
                    # the width scales with 1/cap: a drive without the
                    # bloom detector leaves both filters all False
                    assert not got.any() and not want.any(), (s.label, key)
                    continue
                if key == "grp_active":
                    assert not got[g:].any(), (s.label, key)
                got = got[:g]
            elif key == "spares_left":
                # init_state keeps a spare block back per group slot
                want = (want - (got_st.grp_active.shape[0]
                                - s.mcfg.max_groups)).clamp(min=0)
            assert torch.equal(got, want), f"{s.label}: {key}"


def assert_equals_jax(result, ref, n_drives):
    """Traces and integer state exactly, grp_p within GRP_P_TOL."""
    for i in range(n_drives):
        np.testing.assert_array_equal(result.app[i], ref.app[i])
        np.testing.assert_array_equal(result.mig[i], ref.mig[i])
        got, want = result.state(i), ref.state(i)
        for key in want.keys():
            g, w = got[key].numpy(), np.asarray(want[key])
            if key == "grp_p":
                np.testing.assert_allclose(g, w, rtol=0, atol=GRP_P_TOL)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{i}: {key}")


@pytest.fixture(scope="module")
def grid():
    """The six-drive grid: the port fleet and the JAX package's."""
    return run_port(GRID), run_jax(GRID)


@pytest.mark.parametrize("drive", range(len(GRID)))
def test_grid_drive_equals_its_run_alone(grid, drive):
    assert_equals_runs_alone(grid[0], specs_of(GRID), [drive])


def test_grid_equals_jax_fleet(grid):
    assert_equals_jax(grid[0], grid[1], len(GRID))
    np.testing.assert_array_equal(grid[0].wa_total, grid[1].wa_total)


def test_grid_sub_batches(grid):
    """Sub-batches follow the step structure: the bloom drive, fdp,
    single_group and the static closed-form drives (wolf, wolf_lru, the
    swap) apart; a pure-write sub-batch with one h completes
    n // h interval batches, whatever its drive count."""
    result = grid[0]
    assert sorted(len(idx) for idx, _ in result.shards) == [1, 1, 1, 3]
    for meta in result.exec_meta:
        assert meta["interval_batches"] == N // meta["h"], meta
        assert meta["rounds"] >= meta["interval_batches"]
    for i in range(len(GRID)):
        assert_invariants(result.state(i), GRID[i][0])


def test_grid_analytics_match_jax(grid):
    got, want = grid
    np.testing.assert_allclose(got.predicted_wa(), want.predicted_wa(),
                               rtol=RTOL)
    np.testing.assert_allclose(got.wear_variance(), want.wear_variance(),
                               rtol=RTOL)
    np.testing.assert_allclose(got.wear_imbalance(), want.wear_imbalance(),
                               rtol=RTOL)
    np.testing.assert_allclose(got.lifetime_dwpd(), want.lifetime_dwpd(),
                               rtol=RTOL)
    np.testing.assert_allclose(got.wa_vs_lifetime(1000),
                               want.wa_vs_lifetime(1000), rtol=RTOL)
    np.testing.assert_allclose(got.model_error(1000), want.model_error(1000),
                               rtol=RTOL)
    np.testing.assert_array_equal(got.trim_fraction(), want.trim_fraction())
    np.testing.assert_array_equal(got.wa_curves(1000), want.wa_curves(1000))


def test_result_views_do_not_alias_across_drives(grid):
    """A drive's state is a view into its sub-batch: writing it changes
    that drive alone."""
    result = grid[0]
    idx, stacked = next((i, s) for i, s in result.shards if len(i) > 1)
    before = stacked.n_app.clone()
    st = result.state(idx[0])
    st.n_app.add_(1)
    assert torch.equal(stacked.n_app - before,
                       torch.tensor([1] + [0] * (len(idx) - 1),
                                    dtype=torch.int32))
    st.n_app.sub_(1)


def test_reference_engine_and_faults_are_refused():
    """Neither is refused any more: the reference drain runs (a fleet of
    it equals the bulk fleet), and so does a faulty fleet (its drive
    equals its run alone); an unknown drain and uneven streams are."""
    specs = specs_of(GRID[:2])
    for fast_path in (True, False):
        ref = run_port(GRID[:2], gc_impl="reference", fast_path=fast_path)
        bulk = run_port(GRID[:2])
        np.testing.assert_array_equal(ref.app, bulk.app)
        np.testing.assert_array_equal(ref.mig, bulk.mig)
        for i in range(len(specs)):
            for key, v in bulk.state(i).items():
                assert torch.equal(ref.state(i)[key], v), (fast_path, key)
    with pytest.raises(ValueError):
        fleet.simulate_fleet(Geometry(*GEOM), specs, gc_impl="per_page",
                             device="cpu")
    # a faulty fleet runs: its drive equals its run alone
    faulty = [fleet.DriveSpec(managers.wolf(fault_rate=0.1), specs[0].phases,
                              seed=specs[0].seed)]
    res = fleet.simulate_fleet(Geometry(*GEOM), faulty, sampler="numpy",
                               device="cpu")
    assert int(res.state(0).retired_blocks) > 0
    assert_equals_runs_alone(res, faulty)
    uneven = [specs[0], fleet.DriveSpec(
        managers.wolf(), (workloads.two_modal(LBA, N + 1),))]
    with pytest.raises(ValueError):
        fleet.simulate_fleet(Geometry(*GEOM), uneven, device="cpu")


# -- the device sampler ------------------------------------------------------

def _chi_square(counts, expected):
    counts = np.asarray(counts, np.float64)
    expected = np.asarray(expected, np.float64)
    keep = expected > 0
    return float(np.sum((counts[keep] - expected[keep]) ** 2
                        / expected[keep]))


def _device_draw(phases, n, seed, with_ops=False):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    out = workloads.sample_phases_device(
        gen, workloads.phase_param_arrays(phases), n, with_ops=with_ops)
    if with_ops:
        return tuple(t.numpy() for t in out)
    return out.numpy()


def test_device_sampler_group_distribution():
    """Per-group event counts: the chi-square of the device stream against
    the phase's probabilities sits inside chi2(df=2)'s 99.9th percentile,
    as numpy's does."""
    lba, n = 20_000, 120_000
    phase = workloads.tpcc_like(lba, n)
    edges = np.concatenate([[0], np.cumsum(phase.sizes)])
    expected = np.asarray(phase.probs) * n
    chi_dev = _chi_square(np.histogram(_device_draw([phase], n, 0),
                                       bins=edges)[0], expected)
    chi_np = _chi_square(np.histogram(phase.sample(np.random.default_rng(0)),
                                      bins=edges)[0], expected)
    assert chi_dev < 13.8 and chi_np < 13.8, (chi_dev, chi_np)


def test_device_sampler_within_group_uniformity():
    lba, n = 8_000, 200_000
    phase = workloads.two_modal(lba, n, p_hot=0.5, frac_hot=0.5)
    lbas = _device_draw([phase], n, 7)
    assert lbas.min() >= 0 and lbas.max() < lba
    hot = lbas[lbas >= phase.sizes[0]] - phase.sizes[0]
    counts, _ = np.histogram(hot, bins=16, range=(0, phase.sizes[1]))
    assert _chi_square(counts, np.full(16, len(hot) / 16)) < 37.7


def test_device_sampler_phase_boundaries():
    lba = 6_000
    ph1, ph2 = workloads.swap_phases(lba, 5_000)
    lbas = _device_draw([ph1, ph2], 10_000, 3)
    half = lba // 2
    assert (lbas[:5_000] >= half).mean() == pytest.approx(0.9, abs=0.02)
    assert (lbas[5_000:] >= half).mean() == pytest.approx(0.1, abs=0.02)


def test_device_sampler_trims_and_determinism():
    """The same seed draws the same stream, another seed another; TRIMs
    come at each group's trim probability."""
    phase = workloads.tpcc_churn(6_000, 60_000)
    ops, lbas = _device_draw([phase], 60_000, 11, with_ops=True)
    again = _device_draw([phase], 60_000, 11, with_ops=True)
    assert np.array_equal(ops, again[0]) and np.array_equal(lbas, again[1])
    other = _device_draw([phase], 60_000, 12, with_ops=True)
    assert not np.array_equal(lbas, other[1])
    group = np.searchsorted(np.cumsum(phase.sizes), lbas, side="right")
    for g, p in enumerate(phase.trim_probs):
        assert ops[group == g].mean() == pytest.approx(p, abs=0.02)


def test_device_sampler_fleet_holds_invariants():
    """A fleet on the device sampler (the default) keeps every drive's
    invariants, drops nothing and conserves live pages; the same seeds
    run it again identically."""
    specs = [fleet.DriveSpec(
        s.mcfg, (dataclasses.replace(s.phases[0], n_writes=1000),),
        seed=s.seed) for s in specs_of(GRID[:3])]
    a = fleet.simulate_fleet(Geometry(*GEOM), specs, device="cpu")
    b = fleet.simulate_fleet(Geometry(*GEOM), specs, device="cpu")
    np.testing.assert_array_equal(a.app, b.app)
    np.testing.assert_array_equal(a.mig, b.mig)
    assert np.all(a.wa_total >= 1.0)
    for i in range(len(specs)):
        st = a.state(i)
        assert_invariants(st)
        assert int(st.n_dropped) == 0
        assert int(st.live.sum()) == LBA


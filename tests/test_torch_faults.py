"""repro_torch's fault injection and bad-block retirement against the JAX
package's, on the CPU: one drive.

The same seed draws the same stream for both packages, and the JAX run is
``managers.simulate(..., faults=True)``. The bar: ``app``/``mig`` traces
and every integer ``SimState`` field exactly equal (``retired_blocks``,
``grp_retired``, ``spares_left``, ``drive_status``, ``degraded_at``,
``n_erase_fail``, ``n_halted`` and ``fault_draws`` among them); ``grp_p``
within 1e-6 absolute. The pieces are held on their own first: the
counter-based uniform bit for bit over a grid of (seed, draw index) up to
the top of uint32, the retire probability ``rate^(1 + retries)`` in
``lax.integer_pow``'s order bit for bit, and the survival analytics
(δ within 1e-6 absolute; WA = 1/(1-δ) and what is built on it within
1e-5 relative, since the two packages' float32 ``log`` differ in the last
bit and 1/(1-δ) magnifies that). The grid is fixed: every case runs on
every run. A TRIM op stream and a wear-out at the JAX package's own test
size (Geometry(8, 64, 16)) are held too. The fleet's faults are in
``test_torch_faults_fleet.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytics as ref_analytics
from repro.core import managers as ref_managers
from repro.core import simulator as ref_simulator
from repro.core import workloads as ref_workloads
from repro.core.ssd import Geometry as RefGeometry
from repro_torch import convert
from repro_torch.core import analytics, managers, workloads
from repro_torch.core.ssd import (
    STATUS_DEGRADED,
    Geometry,
    ManagerConfig,
    assert_invariants,
)
from repro_torch.kernels.gc_one.ref import fault_uniform, integer_pow

GEOM = (4, 32, 8, 0.7)
GEOM_BIG = (8, 64, 16, 0.7)
N = 4000
GRP_P_ATOL = 1e-6
DELTA_ATOL = 1e-6
WA_RTOL = 1e-5


def run_both(preset, kw, workload, *, geom=GEOM, n=N, seed=1):
    """One configuration through both packages, faults on: (JAX result,
    port result)."""
    rg, pg = RefGeometry(*geom), Geometry(*geom)
    ref_cfg = getattr(ref_managers, preset)(**kw)
    mcfg = ManagerConfig(**dataclasses.asdict(ref_cfg))
    ref = ref_managers.simulate(
        rg, ref_cfg, [getattr(ref_workloads, workload)(rg.lba_pages, n)],
        seed=seed, faults=True)
    port = managers.simulate(
        pg, mcfg, [getattr(workloads, workload)(pg.lba_pages, n)],
        seed=seed, faults=True, device="cpu")
    return ref, port


def assert_same(port, ref, label=""):
    """Traces and integer state exactly, grp_p within GRP_P_ATOL."""
    np.testing.assert_array_equal(port.app, np.asarray(ref.app), label)
    np.testing.assert_array_equal(port.mig, np.asarray(ref.mig), label)
    got = convert.state_to_numpy(port.state)
    for name, want in ref.state.items():
        want = np.asarray(want)
        assert got[name].dtype == want.dtype, name
        if name == "grp_p":
            np.testing.assert_allclose(got[name], want, rtol=0,
                                       atol=GRP_P_ATOL)
        else:
            np.testing.assert_array_equal(got[name], want,
                                          err_msg=f"{label}: {name}")


# -- the pieces ---------------------------------------------------------------

SEEDS = [0, 1, 12345, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]
DRAWS = [0, 1, 2, 977, 65535, 65536, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]


def test_fault_uniform_is_bit_exact():
    """The murmur3 fmix32 uniform over (seed, n), in int64 with the wrap
    after every step, equals the JAX package's uint32 one bit for bit,
    at the ends of uint32 too."""
    seeds, draws = np.meshgrid(np.array(SEEDS, np.uint32),
                               np.array(DRAWS, np.uint32), indexing="ij")
    want = np.asarray(ref_simulator._fault_uniform(
        jnp.asarray(seeds), jnp.asarray(draws)))
    got = fault_uniform(torch.as_tensor(seeds.astype(np.int64)),
                        torch.as_tensor(draws.astype(np.int64)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert ((got >= 0) & (got < 1)).all()


@pytest.mark.parametrize("retries", [0, 1, 2, 3, 4, 7])
def test_retire_probability_in_integer_pow_order(retries):
    """rate^(1 + retries) as lax.integer_pow multiplies it (square and
    multiply), bit for bit over float32 rates, and u < that on the 2^-24
    grid as the JAX package decides it."""
    rng = np.random.default_rng(retries)
    rates = np.concatenate([
        rng.random(4000, np.float32), np.float32([0.0, 1.0, 0.5, 0.05,
                                                 0.3, 0.999999])])
    want = np.asarray(jnp.asarray(rates) ** (1 + retries))
    got = integer_pow(torch.as_tensor(rates), 1 + retries).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    u = (np.arange(0, 2**24, 4099, dtype=np.float32) * np.float32(2**-24))
    np.testing.assert_array_equal(
        u[None, :] < got[:64, None], u[None, :] < want[:64, None])


def test_survival_analytics_match_reference():
    """δ from the OP ratio, WA, the retired fraction, the degraded ratio,
    WA with retirement and the survival curve, on a grid."""
    r = np.linspace(0.05, 0.95, 37).astype(np.float32)
    f = np.linspace(0.0, 0.4, 37).astype(np.float32)
    np.testing.assert_allclose(
        analytics.delta_from_op_ratio(r).numpy(),
        np.asarray(ref_analytics.delta_from_op_ratio(r)), rtol=0,
        atol=DELTA_ATOL)
    np.testing.assert_allclose(
        analytics.wa_from_op_ratio(r).numpy(),
        np.asarray(ref_analytics.wa_from_op_ratio(r)), rtol=WA_RTOL)
    np.testing.assert_array_equal(
        analytics.degraded_op_ratio(r, f).numpy(),
        np.asarray(ref_analytics.degraded_op_ratio(r, f)))
    np.testing.assert_allclose(
        analytics.wa_with_retirement(r, f).numpy(),
        np.asarray(ref_analytics.wa_with_retirement(r, f)), rtol=WA_RTOL)
    retired = np.array([0, 1, 7, 100, 1023], np.int32)
    np.testing.assert_array_equal(
        analytics.retired_fraction(retired, 1024).numpy(),
        np.asarray(ref_analytics.retired_fraction(retired, 1024)))
    degraded_at = np.array([-1, 0, 5, 1000, 4000, -1, 3999])
    t = np.array([[0, 5, 6], [999, 1000, 4000]])
    np.testing.assert_array_equal(
        analytics.survival_fraction(degraded_at, t).numpy(),
        np.asarray(ref_analytics.survival_fraction(degraded_at,
                                                   jnp.asarray(t))))


# -- one drive through both packages -----------------------------------------

# (preset, fault_rate, endurance_pe_limit, erase_max_retries, seed): the
# grid wolf/single x rate {0, 0.02, 0.1} x limit {0, 2} x retries
# {0, 1, 3} x two seeds, pruned to ten cases that still cover every value
# of each axis with each preset (a zero rate only with a limit: without
# one the configuration cannot fail)
GRID = [
    ("wolf", 0.02, 0, 0, 1),
    ("wolf", 0.1, 0, 1, 2),
    ("wolf", 0.1, 2, 3, 1),
    ("wolf", 0.0, 2, 0, 2),
    ("wolf", 0.02, 2, 1, 2),
    ("wolf", 0.1, 0, 3, 1),
    ("single_group", 0.1, 0, 0, 1),
    ("single_group", 0.02, 2, 3, 2),
    ("single_group", 0.0, 2, 1, 1),
    ("single_group", 0.1, 2, 0, 2),
]
WORKLOAD = {"wolf": "two_modal", "single_group": "uniform"}


@pytest.mark.parametrize(
    "preset,rate,limit,retries,seed", GRID,
    ids=[f"{p}-r{r}-L{lim}-k{k}-s{s}" for p, r, lim, k, s in GRID])
def test_faulty_drive_matches_reference(preset, rate, limit, retries, seed):
    kw = dict(fault_rate=rate, endurance_pe_limit=limit,
              erase_max_retries=retries, fault_seed=seed * 7919)
    ref, port = run_both(preset, kw, WORKLOAD[preset], seed=seed)
    assert_same(port, ref, preset)
    assert_invariants(port.state, preset)
    st = port.state
    # every erase draws once; a retire undoes its erase
    assert int(st.fault_draws) == int(st.n_erase) + int(st.retired_blocks)
    assert int(st.n_erase_fail) >= int(st.retired_blocks)


def test_wolf_endurance_default_matches_reference():
    """The preset as it comes (P-E limit 40, out of reach here): the layer
    runs, nothing retires, and the run equals the JAX package's."""
    ref, port = run_both("wolf_endurance", {}, "two_modal", seed=3)
    assert_same(port, ref, "wolf_endurance")
    assert managers.wolf_endurance().endurance_pe_limit == 40
    assert int(port.state.retired_blocks) == 0
    assert int(port.state.fault_draws) == int(port.state.n_erase) > 0


# -- TRIM op streams and the pool door ---------------------------------------

# (preset, keywords, phases from a workloads module, seed)
STREAMS = [
    ("wolf_dynamic", {"fault_rate": 0.1, "erase_max_retries": 0},
     lambda W, lba, n: [W.tpcc_churn(lba, n)], 4),
    ("single_group", {"fault_rate": 0.1, "erase_max_retries": 0},
     lambda W, lba, n: [W.trimmed(W.uniform(lba, n), 0.3)], 5),
]


@pytest.mark.parametrize("preset,kw,phases,seed", STREAMS,
                         ids=[s[0] for s in STREAMS])
def test_faulty_op_stream_matches_reference(preset, kw, phases, seed):
    """TRIMs, retirement and the halt guard together (TRIMs of a degraded
    drive are halted too): the op-stream engines agree."""
    rg, pg = RefGeometry(*GEOM), Geometry(*GEOM)
    ref_cfg = getattr(ref_managers, preset)(**kw)
    ref = ref_managers.simulate(rg, ref_cfg,
                                phases(ref_workloads, rg.lba_pages, N),
                                seed=seed, faults=True)
    port = managers.simulate(pg, ManagerConfig(**dataclasses.asdict(
        ref_cfg)), phases(workloads, pg.lba_pages, N), seed=seed,
        device="cpu")
    assert_same(port, ref, preset)
    assert_invariants(port.state, preset)
    st = port.state
    assert int(st.n_trim) > 0 and int(st.retired_blocks) > 0
    assert int(st.drive_status) == STATUS_DEGRADED and int(st.n_halted) > 0


def test_wearout_degrades_through_the_pool_door():
    """Deterministic wear-out at 2 P-E cycles with ample spares, at the
    JAX package's own size: each retire nets the pool no block, so the
    pool empties and the drive degrades with spares left; the retired
    blocks sit at the limit, and every failed erase retired."""
    rg, pg = RefGeometry(*GEOM_BIG), Geometry(*GEOM_BIG)
    ref_cfg = ref_managers.wolf_endurance(endurance_pe_limit=2)
    n = 20_000
    ref = ref_managers.simulate(rg, ref_cfg,
                                [ref_workloads.uniform(rg.lba_pages, n)],
                                seed=3)
    port = managers.simulate(pg, ManagerConfig(**dataclasses.asdict(
        ref_cfg)), [workloads.uniform(pg.lba_pages, n)], seed=3,
        device="cpu")
    assert_same(port, ref, "wearout")
    assert_invariants(port.state, "wearout")
    st = port.state
    retired = st.state == 3
    assert int(retired.sum()) == int(st.retired_blocks) > 0
    assert (st.erase_count[retired] == 2).all()
    assert int(st.n_erase_fail) == int(st.retired_blocks)
    assert int(st.drive_status) == STATUS_DEGRADED
    assert int(st.free_blocks) == 0 and int(st.spares_left) > 0


def test_faults_false_is_refused_for_a_faulty_config():
    pg = Geometry(*GEOM)
    with pytest.raises(ValueError, match="faults=False"):
        managers.simulate(pg, managers.wolf_endurance(),
                          [workloads.uniform(pg.lba_pages, 16)],
                          faults=False, device="cpu")

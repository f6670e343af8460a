"""The reference engine of ``repro_torch.core`` on the CPU: the reference
step (``fast_path=False``: every event stepped alone, in lock-step over a
batch) and the reference drain (``gc_impl="reference"``: a GC victim
migrated page by page), held to the JAX package's reference engine and,
inside the port, to the split engine and the bulk drain.

The same numpy-seeded streams go through both packages at Geometry(4, 32,
8) (and, in ``test_torch_reference_fleet.py``, (8, 64, 16)): the
``app``/``mig`` traces and every integer ``SimState`` field must be
exactly equal, and ``grp_p`` within 1e-6 (float32 EWMA). The cases cover
every detector, the weight points, §5.2 groups, TRIM op streams and faults
(with and without erase retries). A mixed fleet in lock-step, and the
per-page demotion target and one reference drain, are in
``test_torch_reference_fleet.py``, which imports the helpers here.
"""

import numpy as np
import pytest
import torch

from repro.core import managers as ref_managers
from repro.core import workloads as ref_workloads
from repro.core.ssd import Geometry as RefGeometry
from repro_torch import convert
from repro_torch.core import managers, workloads
from repro_torch.core.ssd import Geometry, assert_invariants

SMALL = (4, 32, 8, 0.7)
MEDIUM = (8, 64, 16, 0.7)
N = 800
GRP_P_TOL = 1e-6
ENGINES = [(True, "bulk"), (True, "reference"), (False, "bulk")]

# (preset, keywords, phases from a workloads module at (lba, n), geometry)
CASES = {
    "wolf": ("wolf", {}, lambda W, l, n: [W.two_modal(l, n)], SMALL),
    "single_group": ("single_group", {}, lambda W, l, n: [W.uniform(l, n)],
                     SMALL),
    "wolf_lru": ("wolf_lru", {}, lambda W, l, n: [W.tpcc_like(l, n)],
                 SMALL),
    "wolf_wear": ("wolf_wear", {}, lambda W, l, n: [W.two_modal(l, n)],
                  SMALL),
    "fdp_swap": ("fdp", {}, lambda W, l, n: list(W.swap_phases(l, n // 2)),
                 SMALL),
    "wolf_dynamic": ("wolf_dynamic", {}, lambda W, l, n: [W.tpcc_like(l, n)],
                     SMALL),
    "trim_aware_churn": ("wolf_trim_aware", {},
                         lambda W, l, n: [W.tpcc_churn(l, n)], SMALL),
    "faults": ("wolf", dict(fault_rate=0.1),
               lambda W, l, n: [W.two_modal(l, n)], SMALL),
    "faults_retry": ("wolf", dict(fault_rate=0.1, erase_max_retries=1),
                     lambda W, l, n: [W.two_modal(l, n)], SMALL),
}
# the same at Geometry(8, 64, 16), twice the events
# (tests/test_torch_reference_fleet.py)
MEDIUM_CASES = {
    "wolf_medium": ("wolf", {}, lambda W, l, n: [W.two_modal(l, 2 * n)],
                    MEDIUM),
    "dynamic_churn_medium": ("wolf_dynamic", {},
                             lambda W, l, n: [W.tpcc_churn(l, 2 * n)],
                             MEDIUM),
}


def _assert_same(got, want, where):
    """Traces and integer state exactly, grp_p within GRP_P_TOL; ``want``
    a RunResult of either package."""
    np.testing.assert_array_equal(got.app, np.asarray(want.app), where)
    np.testing.assert_array_equal(got.mig, np.asarray(want.mig), where)
    have = convert.state_to_numpy(got.state)
    for key, v in want.state.items():
        v = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
        if key == "grp_p":
            np.testing.assert_allclose(have[key], v, rtol=0, atol=GRP_P_TOL,
                                       err_msg=f"{where}: {key}")
        else:
            np.testing.assert_array_equal(have[key], v,
                                          err_msg=f"{where}: {key}")


_PORT = {}  # case -> the port's reference-engine run


def _case(case):
    return {**CASES, **MEDIUM_CASES}[case]


def _port(case, fast_path=False, gc_impl="reference"):
    preset, kw, phases, geom = _case(case)
    g = Geometry(*geom)
    run = lambda: managers.simulate(  # noqa: E731
        g, getattr(managers, preset)(**kw), phases(workloads, g.lba_pages, N),
        seed=7, fast_path=fast_path, gc_impl=gc_impl, device="cpu")
    if (fast_path, gc_impl) != (False, "reference"):
        return run()
    if case not in _PORT:
        _PORT[case] = run()
    return _PORT[case]


def assert_matches_jax(case):
    """The port's reference engine against the JAX package's
    (``fast_path=False, gc_impl="reference"``) on the same stream."""
    preset, kw, phases, geom = _case(case)
    lba = Geometry(*geom).lba_pages
    got = _port(case)
    want = ref_managers.simulate(
        RefGeometry(*geom), getattr(ref_managers, preset)(**kw),
        phases(ref_workloads, lba, N), seed=7, fast_path=False,
        gc_impl="reference")
    _assert_same(got, want, case)
    assert_invariants(got.state, case)
    st = got.state
    assert int(st.n_erase) > 0 and int(st.n_dropped) == 0
    if "faults" in case:
        assert int(st.retired_blocks) > 0
    if "churn" in case:
        assert int(st.n_trim) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_reference_engine_matches_jax(case):
    assert_matches_jax(case)


@pytest.mark.parametrize("fast_path,gc_impl", ENGINES)
@pytest.mark.parametrize("case", ["wolf", "fdp_swap", "wolf_dynamic",
                                  "trim_aware_churn", "faults_retry"])
def test_engines_agree_in_port(case, fast_path, gc_impl):
    """Inside the port every (fast_path, gc_impl) pair equals the
    reference engine's run, bit for bit."""
    want = _port(case)
    got = _port(case, fast_path, gc_impl)
    _assert_same(got, want, f"{case} fast_path={fast_path} {gc_impl}")

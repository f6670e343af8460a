"""Port fleets whose sub-batches run the masked heavy tail with more than
one drive on the FDP and bloom detectors, held as in
``test_torch_fleet.py``: each drive equal to its run alone, and the fleet
equal to the JAX package's one-device fleet (traces and integer state
exactly, ``grp_p`` within 1e-6).

  * several seeds each of wolf_dynamic (bloom detector, §5.2 groups) and
    fdp, with and without TRIMs: the demoting drain on a drive of a
    stacked state, the bloom update and FDP promotion on a partial mask,
    and §5.2 create and merge decided per drive;
  * a strided trace (``trace_every=2``) on those sub-batches, against the
    JAX fleet's and the dense trace.

The fleet's other options are in ``test_torch_fleet_options.py``.
"""

import numpy as np
import pytest

from repro.core import fleet as ref_fleet
from repro.core.ssd import Geometry as RefGeometry
from repro_torch.core.ssd import assert_invariants
from test_torch_fleet import (
    GEOM,
    LBA,
    N,
    assert_equals_jax,
    assert_equals_runs_alone,
    run_jax,
    run_port,
    specs_of,
)

DYNAMIC = [
    ("wolf_dynamic", {}, lambda W: [W.tpcc_like(LBA, N)], 0),
    ("wolf_dynamic", {}, lambda W: [W.tpcc_like(LBA, N)], 1),
    ("wolf_dynamic", {}, lambda W: [W.exponential_groups(LBA, N, 5)], 2),
    ("fdp", {}, lambda W: [W.two_modal(LBA, N)], 3),
    ("fdp", {}, lambda W: list(W.swap_phases(LBA, N // 2)), 4),
    ("fdp", {}, lambda W: [W.tpcc_like(LBA, N)], 5),
]
DYNAMIC_TRIMS = [
    ("wolf_dynamic", {}, lambda W: [W.tpcc_churn(LBA, N)], 0),
    ("wolf_dynamic", {}, lambda W: [W.tpcc_churn(LBA, N)], 1),
    ("wolf_dynamic", {}, lambda W: [W.trimmed(W.tpcc_like(LBA, N), 0.1)],
     2),
    ("fdp", {}, lambda W: [W.trimmed(W.tpcc_like(LBA, N), 0.1)], 3),
    ("fdp", {}, lambda W: [W.tpcc_churn(LBA, N)], 4),
]


def _group_counts(result, i):
    return int(result.state(i).grp_active.sum())


@pytest.fixture(scope="module")
def dynamic():
    """The pure-write fleet, run once for the tests that read it."""
    return run_port(DYNAMIC)


@pytest.mark.parametrize("desc", [DYNAMIC, DYNAMIC_TRIMS],
                         ids=["writes", "trims"])
def test_masked_detector_fleet_equals_runs_alone_and_jax(desc, dynamic):
    result = dynamic if desc is DYNAMIC else run_port(desc)
    # one sub-batch for each detector, every one of them several drives
    assert sorted(m["drives"] for m in result.exec_meta) == (
        [3, 3] if desc is DYNAMIC else [2, 3])
    assert_equals_runs_alone(result, specs_of(desc))
    assert_equals_jax(result, run_jax(desc), len(desc))
    for i in range(len(desc)):
        assert_invariants(result.state(i), desc[i][0])
    dyn = [i for i, d in enumerate(desc) if d[0] == "wolf_dynamic"]
    # §5.2 acted, and not on every drive alike: its masks were partial
    created = [int((result.state(i).grp_created > 0).sum()) for i in dyn]
    assert max(created) > 0, created
    assert len({(_group_counts(result, i), c)
                for i, c in zip(dyn, created)}) > 1


def test_strided_trace_equals_jax_and_dense_trace(dynamic):
    """trace_every=2 at D > 1: each drive's trace entries are written by a
    masked scatter where its stopped event closes a stride."""
    result = run_port(DYNAMIC, trace_every=2)
    ref = ref_fleet.simulate_fleet(RefGeometry(*GEOM),
                                   specs_of(DYNAMIC, port=False),
                                   sampler="numpy", trace_every=2)
    assert_equals_jax(result, ref, len(DYNAMIC))
    assert result.app.shape == (len(DYNAMIC), N // 2)
    assert result.trace_every == 2
    np.testing.assert_array_equal(result.app, dynamic.app[:, 1::2])
    np.testing.assert_array_equal(result.mig, dynamic.mig[:, 1::2])

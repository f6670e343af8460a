"""Port fleets that sweep policy, held as in ``test_torch_fleet.py``:
each drive equal to its run alone, and the fleet equal to the JAX
package's one-device fleet (traces and integer state exactly, ``grp_p``
within 1e-6).

  * mixed victim-score weights in one sub-batch (greedy, LRU, wear, an
    explicit β, trim-aware, a mixed point);
  * the §5.1 constants: ``ewma_a`` per drive, and interval lengths that
    split the fleet into one sub-batch per h;
  * interval alignment: a pure-write sub-batch of 8 drives with one h runs
    exactly n // h interval batches.

Mixed group caps and TRIM fleets are in ``test_torch_fleet_mixed.py``.
"""

import numpy as np
import pytest

from repro_torch.core.ssd import assert_invariants
from test_torch_fleet import (
    LBA,
    N,
    assert_equals_jax,
    assert_equals_runs_alone,
    run_jax,
    run_port,
    specs_of,
)

WEIGHTS = [
    ("wolf", {}, lambda W: [W.two_modal(LBA, N, p_hot=0.9, frac_hot=0.2)],
     1),
    ("wolf_lru", {}, lambda W: [W.two_modal(LBA, N, p_hot=0.9,
                                            frac_hot=0.2)], 1),
    ("wolf_wear", {}, lambda W: [W.two_modal(LBA, N, p_hot=0.9,
                                             frac_hot=0.2)], 1),
    ("wolf_wear", {"gc_beta": 1.0},
     lambda W: [W.two_modal(LBA, N, p_hot=0.9, frac_hot=0.2)], 1),
    ("wolf_trim_aware", {},
     lambda W: [W.two_modal(LBA, N, p_hot=0.9, frac_hot=0.2)], 1),
    ("wolf", {"gc_alpha": 1.0, "gc_beta": 0.5, "gc_gamma": 0.25},
     lambda W: [W.two_modal(LBA, N, p_hot=0.9, frac_hot=0.2)], 1),
]
SWEEP = [
    ("wolf", {"ewma_a": 0.1}, lambda W: [W.two_modal(LBA, N)], 0),
    ("wolf", {"ewma_a": 0.6}, lambda W: [W.two_modal(LBA, N)], 0),
    ("wolf", {"interval_frac": 0.05}, lambda W: [W.two_modal(LBA, N)], 0),
    ("wolf", {"interval_frac": 0.1}, lambda W: [W.two_modal(LBA, N)], 0),
]
ALIGN = [
    (preset, {"interval_frac": 0.05}, lambda W: [W.two_modal(LBA, N)], seed)
    for seed, preset in enumerate(["wolf", "wolf_lru", "wolf_wear"] * 3)
][:8]


@pytest.mark.parametrize("desc", [WEIGHTS, SWEEP], ids=["weights", "sweep"])
def test_fleet_equals_runs_alone_and_jax_fleet(desc):
    result = run_port(desc)
    assert_equals_runs_alone(result, specs_of(desc))
    assert_equals_jax(result, run_jax(desc), len(desc))
    for i in range(len(desc)):
        assert_invariants(result.state(i), desc[i][0])
    if desc is WEIGHTS:
        # a pure-write stream leaves τ inert: trim-aware is greedy exactly
        np.testing.assert_array_equal(result.mig[4], result.mig[0])
        assert not np.array_equal(result.mig[2], result.mig[0])
        assert len(result.shards) == 1  # one sub-batch, six weight points
    if desc is SWEEP:
        # one sub-batch per interval length, each policy's own dynamics
        assert sorted(m["h"] for m in result.exec_meta) == [16, 35, 71]
        assert len({int(m) for m in result.mig[:, -1]}) == 4


def test_interval_alignment():
    """Eight pure-write drives with one h: n // h interval batches, each a
    masked pass over the drives held at their boundary, and the fleet
    still equals its drives alone (two checked)."""
    result = run_port(ALIGN)
    (meta,) = result.exec_meta
    assert meta["drives"] == 8 and meta["h"] == 35
    assert meta["interval_batches"] == N // meta["h"]
    assert_equals_runs_alone(result, specs_of(ALIGN), drives=[0, 7])

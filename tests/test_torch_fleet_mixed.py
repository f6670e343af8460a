"""Port fleets that mix group caps and op streams, held as in
``test_torch_fleet.py``: each drive equal to its run alone, and the fleet
equal to the JAX package's one-device fleet (traces and integer state
exactly, ``grp_p`` within 1e-6).

  * mixed group caps: wolf_dynamic (12 slots) beside single_group (1),
    and wolf at 4 slots beside wolf at 8 in one padded sub-batch;
  * TRIM op streams (``trimmed``, ``tpcc_churn``) under four presets.
"""

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

CAPS = [
    ("wolf_dynamic", {}, lambda W: [W.tpcc_like(LBA, N)], 0),
    ("single_group", {}, lambda W: [W.two_modal(LBA, N)], 0),
    ("wolf", {"max_groups": 4}, lambda W: [W.exponential_groups(LBA, N, 3)],
     2),
    ("wolf", {}, lambda W: [W.exponential_groups(LBA, N, 5)], 3),
]
TRIMS = [
    ("wolf", {}, lambda W: [W.trimmed(W.two_modal(LBA, N), 0.2)], 1),
    ("wolf_trim_aware", {}, lambda W: [W.tpcc_churn(LBA, N)], 2),
    ("wolf_dynamic", {}, lambda W: [W.tpcc_churn(LBA, N)], 3),
    ("fdp", {}, lambda W: [W.trimmed(W.tpcc_like(LBA, N), 0.1)], 4),
]


@pytest.mark.parametrize("desc", [CAPS, TRIMS], ids=["caps", "trims"])
def test_fleet_equals_runs_alone_and_jax_fleet(desc):
    result = run_port(desc)
    assert_equals_runs_alone(result, specs_of(desc))
    assert_equals_jax(result, run_jax(desc), len(desc))
    for i in range(len(desc)):
        assert_invariants(result.state(i), desc[i][0])
    if desc is CAPS:
        # the single-group drive stays single-group; the two wolf drives
        # share one sub-batch padded to 8 group slots
        assert int(result.state(1).grp_active.sum()) == 1
        assert result.state(2).grp_active.shape[0] == 8
    else:
        assert (result.trim_fraction() > 0).all()

"""``simulate_fleet``'s options on the CPU, each against the JAX package's
one-device fleet with the same option (traces and integer state exactly,
``grp_p`` within 1e-6, as in ``test_torch_fleet.py``):

  * ``ops_stream=True``: every drive on the op-stream engine, whose run on
    pure-write phases is the write engine's;
  * ``return_lbas=True``: the sampled events, the JAX fleet's own;
  * ``init_p_from_phase=False``: group frequencies start at 0, not at the
    first phase's probabilities.

``trace_every`` is held in ``test_torch_fleet_masked.py``.
"""

import numpy as np
import pytest
import torch

from repro.core import fleet as ref_fleet
from repro.core.ssd import Geometry as RefGeometry
from repro_torch.core import managers
from repro_torch.core.ssd import Geometry
from test_torch_fleet import GEOM, LBA, N, assert_equals_jax, run_port, specs_of

FLEET = [
    ("wolf_dynamic", {}, lambda W: [W.tpcc_like(LBA, N)], 0),
    ("fdp", {}, lambda W: list(W.swap_phases(LBA, N // 2)), 4),
    ("fdp", {}, lambda W: [W.tpcc_like(LBA, N)], 5),
    ("wolf", {}, lambda W: [W.two_modal(LBA, N)], 6),
]
OPTIONS = {
    "ops_stream": (True, FLEET[1:]),
    "return_lbas": (True, [
        ("wolf_dynamic", {}, lambda W: [W.tpcc_churn(LBA, N)], 0),
        ("wolf", {}, lambda W: [W.two_modal(LBA, N)], 1)]),
    "init_p_from_phase": (False, [FLEET[0], FLEET[3]]),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_fleet_option_equals_jax_fleet(option):
    value, desc = OPTIONS[option]
    result = run_port(desc, **{option: value})
    ref = ref_fleet.simulate_fleet(RefGeometry(*GEOM),
                                   specs_of(desc, port=False),
                                   sampler="numpy", **{option: value})
    assert_equals_jax(result, ref, len(desc))
    if option == "return_lbas":
        assert result.lbas.shape == (len(desc), N)
        np.testing.assert_array_equal(result.lbas, np.asarray(ref.lbas))
        return
    default = run_port(desc)
    assert default.lbas is None
    if option == "ops_stream":
        # the same events through the op-stream engine: the same runs
        np.testing.assert_array_equal(result.app, default.app)
        np.testing.assert_array_equal(result.mig, default.mig)
    else:
        # flat initial frequencies change the runs
        assert not np.array_equal(result.mig, default.mig)
        spec = specs_of(desc)[0]
        st = managers.build_drive(Geometry(*GEOM), spec.mcfg,
                                  list(spec.phases), init_p_from_phase=False,
                                  device="cpu")[0]
        assert not st.grp_p.any()
        assert torch.isfinite(result.state(0).grp_p).all()

"""The plain NumPy reference equals the port, event by event and in its
final state, for both managers (wolf; wolf_dynamic on the TPC-C op
stream) at Geometry(8, 64, 16); and its float32 helpers round as a
float32 program does."""

import fractions

import numpy as np
import pytest
import torch
from wabench_small import CELLS, small_cell

from wabench import check as checks
from wabench import harness, reference, streams


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_port(name):
    c = small_cell(name, drives=3, events=4000)
    prog = harness.Program(c["config"], c["traffic"], "cpu")
    res = prog.experiment(2**31 + 7, 0)
    kept = [harness._kept(res, d, streams.drive_seed(2**31 + 7, 0, d))
            for d in range(3)]
    verdict = checks.check(kept, c["config"], c["traffic"], "cpu",
                           workers=1)
    assert verdict["numbers"] == {"stream_mismatch": 0, "trace_mismatch": 0,
                                  "state_mismatch": 0}, verdict["fields"]
    assert verdict["failed"] == 0 and verdict["checked"] == 3
    st = res.state(0)
    assert int(st.n_erase) > 0 and int(st.interval) > 0
    if checks.with_trim(c["traffic"]):
        assert int(st.n_trim) > 0 and int(st.grp_active.sum()) > 3


def test_fma32_rounds_once():
    rng = np.random.default_rng(0)
    x, y, z = (rng.random(64).astype(np.float32) for _ in range(3))
    got = reference.fma32(x, y, z)
    for a, b, c, g in zip(x, y, z, got):
        q = (fractions.Fraction(float(a)) * fractions.Fraction(float(b))
             + fractions.Fraction(float(c)))
        err = abs(fractions.Fraction(float(g)) - q)
        for n in (np.nextafter(g, np.float32(np.inf)),
                  np.nextafter(g, np.float32(-np.inf))):
            assert err <= abs(fractions.Fraction(float(n)) - q)
    two = (x.astype(np.float64) * y + z).astype(np.float32)
    assert (got != (x * y + z)).any() or (got == two).all()


def test_bf16_rounds_to_nearest_even():
    v = np.array([1.0, 1.00390625, 1.01171875, 3.14159265], np.float32)
    got = reference.bf16(v)
    want = torch.tensor(v).to(torch.bfloat16).to(torch.float32).numpy()
    assert (got == want).all()

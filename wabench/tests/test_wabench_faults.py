"""The check catches a broken timed path: a small run of each cell on the
CPU, with the harness's look for a card skipped, is correct as it is and
not correct with each fault a cell can have planted under it; and the
bfloat16 control fails the check. (The cells run on one card, so there is
no exchange between chips to leave out.)"""

import time

import numpy as np
import pytest
from wabench_small import CELLS, small_cell

from repro_torch.core import fleet, simulator
from wabench import control, harness

SEED = 2**31 + 99


def run(name):
    c = small_cell(name, drives=4, events=1500)
    line, _ = harness.run_cell(c, SEED, 0.1, False, "cpu",
                               time.perf_counter(), workers=1)
    return line


def state_unchanged(monkeypatch):
    """Each segment returns the state it was given: no event lands."""
    def scan(ctx, st, lbas, w0, policy, ops=None):
        n = lbas.shape[-1] // ctx.trace_every
        z = np.zeros((lbas.shape[0], n), np.int32)
        return simulator.torch.as_tensor(z), simulator.torch.as_tensor(z)
    monkeypatch.setattr(simulator, "scan_writes", scan)


def half_left_out(monkeypatch):
    """Only the first half of the fleet is simulated; the second half's
    answers are the first half's."""
    real = fleet.simulate_fleet

    def half(geom, specs, **kw):
        h = len(specs) // 2
        return real(geom, specs[:h] + specs[:len(specs) - h], **kw)
    monkeypatch.setattr(fleet, "simulate_fleet", half)


def answer_altered(monkeypatch):
    """The run kernel's first launch counts one migration too many."""
    real = simulator.write_run_

    def altered(lbas, ops, start, stop, state, policy, app, mig, **mode):
        first = bool((start[:, 0] == 0).all())
        real(lbas, ops, start, stop, state, policy, app, mig, **mode)
        if first:
            state["n_mig"].add_(1)
    monkeypatch.setattr(simulator, "write_run_", altered)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = run(name)
    assert line["correct"] and line["failed"] == 0
    assert all(c["value"] == 0 for c in line["checks"].values())
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   answer_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    line = run(name)
    assert not line["correct"] and line["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_fails_the_check(name):
    c = small_cell(name, drives=4, events=3000)
    got = control.control(c, 7, 2, "cpu", workers=1)
    assert got["trace_mismatch"] > 0 and got["state_mismatch"] > 0
    assert got["drives_caught"] == got["drives"]

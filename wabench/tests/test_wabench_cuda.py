"""On the card: the frozen stream copy draws the program's card stream at
the cells' full size, and a small run of each cell is correct. Marked
``cuda``; each test skips where there is no card (decided inside the
test)."""

import time

import pytest
import torch
from wabench_small import CELLS, small_cell
from test_wabench_streams import port_phases

from repro_torch.core import workloads
from wabench import cell as cells
from wabench import check as checks
from wabench import harness, streams

pytestmark = pytest.mark.cuda


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("name", CELLS)
def test_frozen_copy_draws_the_card_stream(name):
    need_card()
    c = cells.load_cell(name)
    lba = checks.lba_pages(c["config"])
    params = streams.param_arrays(c["traffic"]["phases"], lba)
    n = int(params["counts"].sum())
    trim = checks.with_trim(c["traffic"])
    ref = workloads.phase_param_arrays(port_phases(c["traffic"], lba))
    for seed in (5, 2**31 + 5):
        ops, lbas = streams.draw(seed, params, n, trim, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        drawn = workloads.sample_phases_device(gen, ref, n, with_ops=trim)
        if trim:
            assert torch.equal(ops, drawn[0])
            drawn = drawn[1]
        assert torch.equal(lbas, drawn)


@pytest.mark.parametrize("name", CELLS)
def test_small_run_on_the_card_is_correct(name):
    need_card()
    line, _ = harness.run_cell(small_cell(name, drives=4, events=1500), 11,
                               0.1, False, "cuda", time.perf_counter(),
                               workers=2)
    assert line["correct"] and line["device"]["platform"] == "gpu"

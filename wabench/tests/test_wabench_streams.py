"""The benchmark's frozen copy of the sampling recipe draws what the
program's device sampler draws, from the same seed on the same device."""

import numpy as np
import pytest
import torch
from wabench_small import CELLS

from repro_torch.core import workloads
from wabench import cell as cells
from wabench import check as checks
from wabench import streams

SEEDS = (0, 1, 2**31 + 11, 2**62 + 5)


def port_phases(traffic, lba):
    out = []
    for ph in traffic["phases"]:
        sizes, probs, trims = streams.phase_groups(ph, lba)
        out.append(workloads.Phase(
            tuple(sizes), tuple(probs), int(ph["events"]),
            tuple(trims) if any(t > 0 for t in trims) else ()))
    return out


def two_phase_traffic():
    g = [{"frac": 0.5, "weight": 0.1}, {"frac": 0.5, "weight": 0.9}]
    return {"phases": [{"events": 3000, "groups": g},
                       {"events": 2000, "groups": g[::-1]}]}


@pytest.mark.parametrize("name", [*CELLS, "two_phase"])
@pytest.mark.parametrize("seed", SEEDS)
def test_frozen_copy_draws_the_port_sampler_stream(name, seed):
    if name == "two_phase":
        cfg = cells.load_cell(CELLS[0])["config"]
        traffic = two_phase_traffic()
    else:
        c = cells.load_cell(name)
        cfg, traffic = c["config"], dict(c["traffic"])
        traffic["phases"] = [dict(ph, events=5000)
                             for ph in traffic["phases"]]
    lba = checks.lba_pages(cfg)
    params = streams.param_arrays(traffic["phases"], lba)
    n = int(params["counts"].sum())
    trim = checks.with_trim(traffic)
    ops, lbas = streams.draw(seed, params, n, trim, "cpu")
    ref = workloads.phase_param_arrays(port_phases(traffic, lba))
    gen = torch.Generator(device="cpu").manual_seed(seed)
    drawn = workloads.sample_phases_device(gen, ref, n, with_ops=trim)
    if trim:
        assert torch.equal(ops, drawn[0]) and ops.sum() > 0
        drawn = drawn[1]
    assert torch.equal(lbas, drawn)
    assert 0 <= int(lbas.min()) and int(lbas.max()) < lba


def test_drive_seeds_differ_and_fit_a_generator():
    seeds = {streams.drive_seed(s, e, d) for s in (0, 2**31 + 3)
             for e in range(4) for d in range(64)}
    assert len(seeds) == 2 * 4 * 64
    assert all(0 <= s < 2**63 for s in seeds)
    torch.Generator().manual_seed(max(seeds))


def test_phase_groups_take_shares_from_weights():
    sizes, probs, trims = streams.phase_groups(
        {"events": 1, "groups": [{"frac": 0.54, "weight": 0.0108},
                                 {"frac": 0.26, "weight": 0.26,
                                  "trim": 0.05}]}, 1000)
    assert sizes == [675, 325] and sum(sizes) == 1000
    assert np.isclose(sum(probs), 1.0) and trims == [0.0, 0.05]

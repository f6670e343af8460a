"""The fleet's devices (``core.fleet.resolve_devices``,
``simulate_fleet(devices=)``) against the JAX package's semantics
(repro/core/fleet_exec.py:102), and the training launcher's ``--mesh``.

``resolve_devices`` follows the JAX rule as a function of the visible
device count (JAX sees the suite's two virtual CPU devices, the port one
CPU). A fleet split over an explicit device list equals its one-device
run exactly: every trace and every integer state field, and ``grp_p``
bit for bit (the drives are independent lanes, and each slice is the
same code on the same streams). ``launch/train.py --mesh single`` raises,
naming the 256 devices the mesh needs.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import fleet_exec as ref_exec
from repro_torch.core import fleet, managers, workloads
from repro_torch.core.ssd import Geometry
from repro_torch.launch import train


def _rule(devices, n_avail):
    if devices in (None, 1):
        return 1
    if devices == "auto":
        return n_avail
    return max(1, min(int(devices), n_avail))


@pytest.mark.parametrize("devices", [None, 1, 2, 3, 8, "2", "auto", 0])
def test_resolve_devices_follows_the_jax_rule(devices):
    n_jax = len(jax.devices())
    assert ref_exec.resolve_devices(devices) == _rule(devices, n_jax)
    got = fleet.resolve_devices(devices, "cpu")
    assert len(got) == _rule(devices, 1)
    assert all(d == torch.device("cpu") for d in got)


def test_resolve_devices_lists_and_cards():
    assert fleet.resolve_devices(["cpu", "cpu"], "cuda") == [
        torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        fleet.resolve_devices([], "cpu")
    # a CUDA fleet counts the host's cards; none here, so one
    assert fleet.resolve_devices("auto", "cuda") == [torch.device("cuda", 0)]


def test_fleet_over_two_devices_equals_one():
    geom = Geometry(4, 32, 8)
    lba = geom.lba_pages
    specs = [
        fleet.DriveSpec(mk(), (workloads.two_modal(lba, 800),), seed=i)
        for i, mk in enumerate((managers.wolf, managers.fdp,
                                managers.single_group, managers.wolf))
    ]
    one = fleet.simulate_fleet(geom, specs, sampler="numpy", device="cpu")
    two = fleet.simulate_fleet(geom, specs, sampler="numpy", device="cpu",
                               devices=["cpu", "cpu"], return_lbas=True)
    np.testing.assert_array_equal(one.app, two.app)
    np.testing.assert_array_equal(one.mig, two.mig)
    assert one.devices_used == 1 and two.devices_used == 2
    assert sorted({m["slice"] for m in two.exec_meta}) == [0, 1]
    assert two.lbas.shape == (4, 800)
    for i in range(len(specs)):
        a, b = one.state(i), two.state(i)
        for k in a.keys():
            assert torch.equal(a[k], b[k]), (i, k)


def test_train_mesh_needs_its_devices():
    with pytest.raises(ValueError, match="needs 256 devices"):
        train.main(["--smoke", "--device", "cpu", "--mesh", "single",
                    "--steps", "1"])
    with pytest.raises(ValueError, match="needs 512 devices"):
        train.main(["--smoke", "--device", "cpu", "--mesh", "multi",
                    "--steps", "1"])

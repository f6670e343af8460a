"""repro_torch.core.workloads against repro.core.workloads: the same seed
must draw the identical stream (exact equality), since every simulator
equivalence test feeds both packages from it."""

import numpy as np
import pytest

from repro.core import workloads as ref
from repro_torch.core import workloads as port

LBA = 716


def _phases(module, name):
    if name == "uniform":
        return [module.uniform(LBA, 500)]
    if name == "two_modal":
        return [module.two_modal(LBA, 500, p_hot=0.8, frac_hot=0.3)]
    if name == "swap_phases":
        return list(module.swap_phases(LBA, 250))
    if name == "exponential_groups":
        return [module.exponential_groups(LBA, 500, n_groups=5)]
    if name == "pairwise_swap":
        return [module.pairwise_swap(
            module.exponential_groups(LBA, 100, 4), 0, 3, 500)]
    assert name == "tpcc_like"
    return [module.tpcc_like(LBA, 500)]


GENERATORS = ["uniform", "two_modal", "swap_phases", "exponential_groups",
              "pairwise_swap", "tpcc_like"]


@pytest.mark.parametrize("name", GENERATORS)
@pytest.mark.parametrize("seed", [0, 7])
def test_sample_streams_identical(name, seed):
    ref_rng, port_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for a, b in zip(_phases(ref, name), _phases(port, name), strict=True):
        assert (b.sizes, b.probs, b.n_writes) == (a.sizes, a.probs, a.n_writes)
        got, want = b.sample(port_rng), a.sample(ref_rng)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(b.page_group(), a.page_group())
        np.testing.assert_array_equal(b.page_rate(), a.page_rate())


@pytest.mark.parametrize("trim_probs", [(), (0.0, 0.3)])
def test_sample_ops_identical(trim_probs):
    a = ref.Phase((300, 416), (0.2, 0.8), 400, trim_probs)
    b = port.Phase((300, 416), (0.2, 0.8), 400, trim_probs)
    assert a.has_trim == b.has_trim
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    for x, y in zip(a.sample_ops(ra), b.sample_ops(rb)):
        np.testing.assert_array_equal(y, x)
    if b.has_trim:
        with pytest.raises(ValueError):
            b.sample(rb)


@pytest.mark.parametrize("seed", range(4))
def test_split_sizes_identical(seed):
    rng = np.random.default_rng(seed)
    fracs = rng.random(int(rng.integers(1, 7)))
    lba = int(rng.integers(10, 10**6))
    assert port.split_sizes(lba, fracs) == ref.split_sizes(lba, fracs)
    assert sum(port.split_sizes(lba, fracs)) == lba


@pytest.mark.parametrize("name", GENERATORS)
def test_phase_param_arrays_identical(name):
    """The fleet's padded phase parameters equal the JAX package's, padded
    or not."""
    for pad in ({}, {"g_max": 6, "p_max": 3}):
        got = port.phase_param_arrays(_phases(port, name), **pad)
        want = ref.phase_param_arrays(_phases(ref, name), **pad)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)

"""repro_torch.core.analytics against repro.core.analytics on seeded
inputs: the block-decay law (eq. 1, 2), WA and δ both ways, the effective
utilization under TRIM, and Appendix A's Lambert-W form (eq. 9).

Tolerances: the closed forms at rtol 1e-6 (float32, the same operations
in the same order); ``lambertw0`` and ``delta_from_op_ratio_lambertw``
(32 Halley steps through float32 ``exp``) at atol 1e-6, the branch point
-1/e and the values 0 and e included, as ``tests/test_analytics.py`` takes
them, but for δ at utilizations above 0.9 (see
:func:`test_lambertw_forms_match_reference`).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytics as ref
from repro_torch.core import analytics as port

RTOL = 1e-6
ATOL_W = 1e-6


def _f32(rng, lo, hi, n=64):
    return rng.uniform(lo, hi, n).astype(np.float32)


def _close(got, want, **tol):
    got = got.numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **tol)


@pytest.mark.parametrize("seed", range(3))
def test_block_decay_matches_reference(seed):
    """Eq. 1 and 2 at Table-2's B and LBA, and at a small drive's."""
    rng = np.random.default_rng(seed)
    for b, lba in ((128.0, 734_003.0), (8.0, 716.0)):
        g = _f32(rng, 0.5, b)
        x = _f32(rng, 0.0, 5.0 * lba)
        _close(port.block_decay_updates(torch.from_numpy(g), b=b, lba=lba),
               ref.block_decay_updates(jnp.asarray(g), b=b, lba=lba),
               rtol=RTOL)
        _close(port.block_live_pages(torch.from_numpy(x), b=b, lba=lba),
               ref.block_live_pages(jnp.asarray(x), b=b, lba=lba),
               rtol=RTOL)


@pytest.mark.parametrize("seed", range(3))
def test_wa_and_delta_both_ways_match_reference(seed):
    rng = np.random.default_rng(10 + seed)
    wa = _f32(rng, 1.0, 40.0)
    _close(port.delta_from_wa(torch.from_numpy(wa)),
           ref.delta_from_wa(jnp.asarray(wa)), rtol=RTOL)
    _close(port.op_ratio_from_wa(torch.from_numpy(wa)),
           ref.op_ratio_from_wa(jnp.asarray(wa)), rtol=RTOL)


@pytest.mark.parametrize("seed", range(3))
def test_trim_as_over_provisioning_matches_reference(seed):
    """effective_op_ratio on a grid of utilizations × trim fractions
    (broadcast), and the equilibrium WA there (80-step bisection)."""
    rng = np.random.default_rng(20 + seed)
    r = _f32(rng, 0.5, 0.95, 8)[:, None]
    t = _f32(rng, 0.0, 0.6, 8)[None, :]
    _close(port.effective_op_ratio(torch.from_numpy(r), torch.from_numpy(t)),
           ref.effective_op_ratio(jnp.asarray(r), jnp.asarray(t)), rtol=RTOL)
    _close(port.wa_with_trim(torch.from_numpy(r), torch.from_numpy(t)),
           ref.wa_with_trim(jnp.asarray(r), jnp.asarray(t)), rtol=1e-5)


@pytest.mark.parametrize("a", [0.0, float(np.e), -1.0 / float(np.e), -0.3,
                               -0.05, 0.5, 2.0])
def test_lambertw0_matches_reference_at_known_points(a):
    got = port.lambertw0(a)
    _close(got, ref.lambertw0(jnp.asarray(a, jnp.float32)), rtol=0,
           atol=ATOL_W)
    if a == 0.0:
        assert float(got) == 0.0
    if a == float(np.e):
        assert float(got) == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_lambertw_forms_match_reference(seed):
    """W0 over [-0.36, 2] (the range ``tests/test_analytics.py`` checks
    its identity on) and eq. 9's δ over utilizations 0.3-0.9 at atol
    1e-6; δ also equals the bisection's (``delta_from_op_ratio``).

    Above r = 0.9 the argument -z·e^(-z) nears the branch point, where
    W's slope 1 / (e^W (W + 1)) grows without bound, and a last-bit
    difference of float32 ``exp`` (PyTorch's against XLA's) moves δ by
    more than 1e-6: the JAX package's own jitted δ differs from its eager
    δ by 1.3e-6 at r = 0.942. There δ is held at atol 1e-5."""
    rng = np.random.default_rng(30 + seed)
    a = _f32(rng, -0.36, 2.0)
    _close(port.lambertw0(torch.from_numpy(a)), ref.lambertw0(jnp.asarray(a)),
           rtol=0, atol=ATOL_W)
    for lo, hi, atol in ((0.3, 0.9, ATOL_W), (0.9, 0.97, 1e-5)):
        r = _f32(rng, lo, hi)
        got = port.delta_from_op_ratio_lambertw(torch.from_numpy(r))
        _close(got, ref.delta_from_op_ratio_lambertw(jnp.asarray(r)),
               rtol=0, atol=atol)
        np.testing.assert_allclose(
            got.numpy(),
            port.delta_from_op_ratio(torch.from_numpy(r)).numpy(), atol=1e-4)


def test_public_names_match_reference():
    """The port's core package exports every public name of the JAX
    package's, and each module's ``__all__`` lists the same names."""
    import repro.core
    import repro_torch.core
    from repro.core import allocation as ref_alloc
    from repro_torch.core import allocation as port_alloc

    public = {n for n, v in vars(repro.core).items()
              if not n.startswith("_") and not inspect.ismodule(v)}
    assert public and public <= set(dir(repro_torch.core))
    assert set(ref.__all__) == set(port.__all__)
    assert set(ref_alloc.__all__) <= set(port_alloc.__all__)

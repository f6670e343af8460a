"""repro_torch.core.allocation against repro.core.allocation on random
(s, p, OP), ties included.

Tolerance: 1e-6 relative (float32 with the same operation order; the
values in fact agree bit for bit, and the simulator equivalence tests rely
on that where allocations become block counts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import allocation as ref
from repro_torch.core import allocation as port

RTOL = 1e-6


def _inputs(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    s = rng.integers(1, 5000, n).astype(np.float32)
    p = rng.random(n).astype(np.float32)
    if seed % 3 == 0:  # ties: equal sizes and equal frequencies
        s[:] = s[0]
        p[:] = p[0]
    if seed % 4 == 1:  # a cold group that trips the §5.5.3 rule
        p[int(rng.integers(0, n))] = 1e-5
    if seed % 5 == 2:  # inactive groups (s = p = 0), as in the simulator
        s[n // 2:] = 0.0
        p[n // 2:] = 0.0
        s[0] = max(s[0], 1.0)
    op = np.float32(rng.integers(100, 20000))
    return s, p, op


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("seed", range(12))
def test_allocators_match_reference(seed):
    s, p, op = _inputs(seed)
    ts, tp, top = torch.from_numpy(s), torch.from_numpy(p), torch.tensor(op)
    _close(port.allocate_by_size(ts, top),
           ref.allocate_by_size(jnp.asarray(s), jnp.float32(op)))
    if p.sum() > 0:
        _close(port.allocate_by_frequency(tp, top),
               ref.allocate_by_frequency(jnp.asarray(p), jnp.float32(op)))
    for cold_rule in (True, False):
        _close(
            port.allocate_closed_form(ts, tp, top, cold_rule=cold_rule),
            ref.allocate_closed_form(jnp.asarray(s), jnp.asarray(p),
                                     jnp.float32(op), cold_rule=cold_rule),
        )


@pytest.mark.parametrize("n", [1, 2, 5, 8, 12])
def test_fsum_is_the_reference_sum(n):
    """The in-order group-axis sum equals XLA:CPU's jitted reduction."""
    rng = np.random.default_rng(n)
    for _ in range(50):
        x = (rng.random(n) * 10.0 ** rng.integers(-3, 4)).astype(np.float32)
        want = np.float32(jax.jit(jnp.sum)(jnp.asarray(x)))
        assert port.fsum(torch.from_numpy(x)).item() == want

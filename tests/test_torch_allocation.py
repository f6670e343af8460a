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


def _rows(seed, d=5, n=6):
    """d drives' (s, p, OP) with one group count: ties, a cold group and
    inactive groups on some rows, as in _inputs."""
    rng = np.random.default_rng(seed)
    s = rng.integers(1, 5000, (d, n)).astype(np.float32)
    p = rng.random((d, n)).astype(np.float32)
    s[0], p[0] = s[0, 0], p[0, 0]          # ties
    p[1, int(rng.integers(0, n))] = 1e-5    # a cold group
    s[2, n // 2:], p[2, n // 2:] = 0.0, 0.0  # inactive groups
    op = rng.integers(100, 20000, d).astype(np.float32)
    return s, p, op


@pytest.mark.parametrize("seed", range(6))
def test_drive_axis_rows_equal_each_row_and_reference(seed):
    """On [D, G], fsum, the three allocators and total_wa give each row
    bit for bit what that row gives alone, and the JAX package's values."""
    s, p, op = _rows(seed)
    ts, tp = torch.from_numpy(s), torch.from_numpy(p)
    top = torch.from_numpy(op)
    batched = {
        "fsum": port.fsum(ts),
        "size": port.allocate_by_size(ts, top),
        "freq": port.allocate_by_frequency(tp, top),
        "closed": port.allocate_closed_form(ts, tp, top),
        "total_wa": port.total_wa(ts, tp / port.fsum(tp)[:, None],
                                  torch.from_numpy(op[:, None] / 6 + s)),
    }
    for d in range(len(s)):
        rs, rp, rop = ts[d], tp[d], top[d]
        alone = {
            "fsum": port.fsum(rs),
            "size": port.allocate_by_size(rs, rop),
            "freq": port.allocate_by_frequency(rp, rop),
            "closed": port.allocate_closed_form(rs, rp, rop),
            "total_wa": port.total_wa(rs, rp / port.fsum(rp),
                                      torch.from_numpy(op[d] / 6 + s[d])),
        }
        for k, v in alone.items():
            assert torch.equal(batched[k][d], v), (d, k)
        js, jp = jnp.asarray(s[d]), jnp.asarray(p[d])
        _close(batched["size"][d], ref.allocate_by_size(js, op[d]))
        _close(batched["freq"][d], ref.allocate_by_frequency(jp, op[d]))
        _close(batched["closed"][d], ref.allocate_closed_form(js, jp, op[d]))
        want = ref.total_wa(js, jp / jnp.sum(jp),
                            jnp.asarray(op[d] / 6 + s[d]))
        np.testing.assert_allclose(batched["total_wa"][d].numpy(),
                                   np.asarray(want), rtol=1e-5)
        assert port.fsum(rs).item() == np.float32(
            jax.jit(jnp.sum)(js)), d


@pytest.mark.parametrize("seed", range(4))
def test_group_wa_matches_reference(seed):
    """Eq. 4 per group (the 80-step float32 bisection) against the JAX
    package's, over sizes and over-provisionings from tight to loose."""
    rng = np.random.default_rng(seed)
    s = rng.integers(1, 5000, 8).astype(np.float32)
    op = (s * rng.uniform(0.01, 3.0, 8)).astype(np.float32)
    np.testing.assert_allclose(
        port.group_wa(torch.from_numpy(s), torch.from_numpy(op)).numpy(),
        np.asarray(ref.group_wa(jnp.asarray(s), jnp.asarray(op))), rtol=1e-5)


# -- the gradient and the two oracle optima ----------------------------------

def _sweep_inputs(n_groups, draw, q=10, lba_pba=0.7):
    """A split of ``tests/test_allocation.py``'s near-optimality sweep:
    Q chunks of size and of frequency over n groups, LBA 100,000."""
    rng = np.random.default_rng(n_groups * 100 + q)
    lba = 100_000.0
    op_total = np.float32(lba * (1.0 / lba_pba - 1.0))
    for _ in range(draw + 1):
        s_chunks = rng.multinomial(q - n_groups,
                                   np.ones(n_groups) / n_groups) + 1
        p_chunks = rng.multinomial(q - n_groups,
                                   np.ones(n_groups) / n_groups) + 1
    s = (s_chunks / q * lba).astype(np.float32)
    p = (p_chunks / q).astype(np.float32)
    return s, p, op_total


@pytest.mark.parametrize("seed", range(4))
def test_total_wa_gradient_matches_jax_grad(seed):
    """d total_wa / d op by autograd through the implicit derivative of
    δ, against jax.grad of the JAX package's total_wa, over tight to loose
    over-provisioning."""
    rng = np.random.default_rng(40 + seed)
    s = rng.integers(100, 5000, 6).astype(np.float32)
    p = rng.random(6).astype(np.float32)
    p /= p.sum()
    op = (s * rng.uniform(0.05, 2.0, 6)).astype(np.float32)
    x = torch.from_numpy(op).requires_grad_(True)
    (got,) = torch.autograd.grad(
        port.total_wa(torch.from_numpy(s), torch.from_numpy(p), x), x)
    want = jax.grad(lambda o: ref.total_wa(jnp.asarray(s), jnp.asarray(p),
                                           o))(jnp.asarray(op))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    # values do not change: the forward is the bisection
    _close(port.group_delta(torch.from_numpy(s), x).detach(),
           ref.group_delta(jnp.asarray(s), jnp.asarray(op)))


@pytest.mark.parametrize("n_groups,draw,split_tol", [
    (2, 0, 1e-3), (3, 1, 1e-3), (5, 0, 1e-2)])
def test_optimal_allocation_matches_jax(n_groups, draw, split_tol):
    """Exponentiated gradient on the simplex from the closed form: total
    WA at rtol 1e-5 against the JAX package's; float32, summing to OP,
    never worse than the closed form. The split is held at ``split_tol``
    of OP: 1e-3 for two and three groups. The normalized steps oscillate
    about the optimum, and a last-bit difference of the first gradient
    (float32 ``log``) leads the two packages along different iterates
    after ~100 steps; on the five-group split, whose WA is flat along two
    groups of equal size and frequency, the best iterates kept differ by
    0.36% of OP at WAs 2.1e-6 apart (the port's the lower)."""
    s, p, op = _sweep_inputs(n_groups, draw)
    ts, tp = torch.from_numpy(s), torch.from_numpy(p)
    got = port.optimal_allocation(ts, tp, op)
    want = ref.optimal_allocation(jnp.asarray(s), jnp.asarray(p),
                                  jnp.asarray(op))
    assert got.dtype == torch.float32 and got.shape == (n_groups,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=split_tol * op)
    wa = float(port.total_wa(ts, tp, got))
    np.testing.assert_allclose(
        wa, float(ref.total_wa(jnp.asarray(s), jnp.asarray(p), want)),
        rtol=1e-5)
    assert float(got.sum()) == pytest.approx(float(op), rel=1e-5)
    closed = port.allocate_closed_form(ts, tp, op, cold_rule=False)
    assert wa <= float(port.total_wa(ts, tp, closed)) + 1e-6


@pytest.mark.parametrize("n_groups,draw", [(2, 0), (3, 1), (5, 0)])
def test_hillclimb_allocation_matches_jax(n_groups, draw):
    """The block hill climber (blocks of 1,024 pages here) against the
    JAX package's: total WA at rtol 1e-6, within 0.5% of the optimum."""
    s, p, op = _sweep_inputs(n_groups, draw)
    ts, tp = torch.from_numpy(s), torch.from_numpy(p)
    got = port.hillclimb_allocation(ts, tp, op, block_pages=1024)
    want = ref.hillclimb_allocation(jnp.asarray(s), jnp.asarray(p), op,
                                    block_pages=1024)
    assert got.dtype == torch.float32
    wa = float(port.total_wa(ts, tp, got))
    np.testing.assert_allclose(
        wa, float(ref.total_wa(jnp.asarray(s), jnp.asarray(p), want)),
        rtol=1e-6)
    best = float(port.total_wa(ts, tp, port.optimal_allocation(ts, tp, op)))
    assert wa <= best * 1.005

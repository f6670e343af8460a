"""The port's recurrent cells (``models/ssm.py``: Mamba, mLSTM, sLSTM)
against the JAX package's, with their carried states.

Inputs are made from a seed with numpy; each cell's parameters are the
JAX package's ``*_init`` carried across leaf by leaf. Everything runs in
fp32. Outputs and states are held within 1e-5, relative to each tensor's
largest value: the port's log-depth scan and the JAX package's
``associative_scan`` combine in different trees, and the two sides' sums
run in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as ref_ssm
from repro_torch.models import ssm

TOL = 1e-5
D_MODEL, N_STATE, CONV_K = 64, 16, 4
HEADS, D_HEAD = 4, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    """Within ``tol`` of the reference, relative to its largest value."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _load(module, tree):
    for name, t in module.named_parameters():
        src = _t(tree[name])
        assert src.dtype == t.dtype and src.shape == t.shape, name
        t.copy_(src)
    return module


def _x(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 0.5).astype(
        np.float32)


@pytest.fixture(scope="module")
def mamba():
    tree = jax.tree_util.tree_map(np.asarray, ref_ssm.mamba_init(
        jax.random.PRNGKey(0), D_MODEL, D_MODEL, N_STATE, CONV_K,
        jnp.float32))
    m = ssm.Mamba(D_MODEL, D_MODEL, N_STATE, CONV_K, torch.float32, "cpu")
    return tree, _load(m, tree)


@pytest.fixture(scope="module")
def mlstm():
    tree = jax.tree_util.tree_map(np.asarray, ref_ssm.mlstm_init(
        jax.random.PRNGKey(1), D_MODEL, HEADS, D_HEAD, jnp.float32))
    cell = ssm.MLSTMCell(D_MODEL, HEADS, D_HEAD, torch.float32, "cpu")
    return tree, _load(cell, tree)


@pytest.fixture(scope="module")
def slstm():
    tree = jax.tree_util.tree_map(np.asarray, ref_ssm.slstm_init(
        jax.random.PRNGKey(2), D_MODEL, HEADS, D_HEAD, jnp.float32))
    cell = ssm.SLSTMCell(D_MODEL, HEADS, D_HEAD, torch.float32, "cpu")
    return tree, _load(cell, tree)


def test_softplus_is_jax_softplus_past_the_threshold():
    """Within an ulp of ``jax.nn.softplus`` on both sides of 20."""
    x = np.linspace(-40.0, 40.0, 801).astype(np.float32)
    got = ssm.softplus(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)),
                               rtol=2e-7, atol=0)


@pytest.mark.parametrize("s", [7, 100])
def test_mamba_apply_matches(mamba, s):
    tree, m = mamba
    x = _x((2, s, D_MODEL), s)
    _close(ssm.mamba_apply(m, _t(x)), ref_ssm.mamba_apply(tree, x))


@pytest.mark.parametrize("s", [32, 48, 100, 128, 200])
def test_mamba_scan_chunked_matches(mamba, s):
    """The chunk rule (one chunk below 2·64 when 64 does not divide S; a
    padded tail at S = 200) from a non-zero h0: y and the carried h."""
    tree, m = mamba
    x = _x((2, s, D_MODEL), 10 + s)
    gates = ref_ssm._mamba_gates(tree, x)
    got_gates = ssm._mamba_gates(m, _t(x))
    for got, want in zip(got_gates, gates):
        _close(got, want)
    h0 = _x((2, D_MODEL, N_STATE), 99)
    u, _, dt, bmat, cmat, _ = (np.asarray(g) for g in gates)
    want_y, want_h = ref_ssm._mamba_scan_chunked(u, dt, bmat, cmat,
                                                 tree["a_log"], h0, 64)
    got_y, got_h = ssm._mamba_scan_chunked(
        _t(u), _t(dt), _t(bmat), _t(cmat), m.a_log, _t(h0), 64)
    _close(got_y, want_y)
    _close(got_h, want_h)


def test_prefix_scan_matches_the_loop():
    rng = np.random.default_rng(3)
    a = _t(rng.uniform(0.5, 1.0, (3, 37, 5)).astype(np.float32))
    b = _t(rng.normal(size=(3, 37, 5)).astype(np.float32))
    acc_a, acc_b = ssm._prefix_scan(a, b, dim=1)
    h, p = torch.zeros(3, 5), torch.ones(3, 5)
    for t in range(37):
        h, p = a[:, t] * h + b[:, t], p * a[:, t]
        _close(acc_b[:, t], h.numpy())
        _close(acc_a[:, t], p.numpy())


def test_mamba_decode_steps_match(mamba):
    """A prompt's state (h and the pre-conv history) carried through 8
    decode steps: outputs and both state tensors at every step."""
    tree, m = mamba
    x = _x((2, 20, D_MODEL), 4)
    u, _, dt, bmat, cmat, u_raw = ref_ssm._mamba_gates(tree, x)
    h0 = np.zeros((2, D_MODEL, N_STATE), np.float32)
    _, h = ref_ssm._mamba_scan_chunked(u, dt, bmat, cmat, tree["a_log"], h0,
                                       64)
    want_st = {"h": h, "conv": u_raw[:, -(CONV_K - 1):]}
    st = {k: _t(v) for k, v in want_st.items()}
    for i, xt in enumerate(_x((8, 2, D_MODEL), 5)):
        want_y, want_st = ref_ssm.mamba_decode_step(tree, want_st, xt)
        got_y, st = ssm.mamba_decode_step(m, st, _t(xt))
        _close(got_y, want_y)
        for k in ("h", "conv"):
            _close(st[k], want_st[k])


def test_mamba_init_state_matches(mamba):
    tree, m = mamba
    want = ref_ssm.mamba_init_state(tree, 3)
    got = ssm.mamba_init_state(m, 3)
    for k in ("h", "conv"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("s", [1, 33])
def test_mlstm_sequential_matches(mlstm, s):
    tree, cell = mlstm
    x = _x((2, s, D_MODEL), 20 + s)
    _close(ssm.mlstm_sequential(cell, _t(x)),
           ref_ssm.mlstm_sequential(tree, x))


@pytest.mark.parametrize("s,chunk", [(200, 128), (200, 200), (64, 16),
                                     (45, 16)])
def test_mlstm_chunked_matches(mlstm, s, chunk):
    """Outputs and the carried (C, n, m); at S = 200 with chunk 128 the
    56 pad rows move m, as in the JAX package."""
    tree, cell = mlstm
    x = _x((2, s, D_MODEL), 30 + s)
    want_y, want_st = ref_ssm.mlstm_chunked(tree, x, chunk=chunk)
    got_y, got_st = ssm.mlstm_chunked(cell, _t(x), chunk=chunk)
    _close(got_y, want_y)
    for got, want in zip(got_st, want_st):
        _close(got, want)


def test_mlstm_pad_moves_the_carried_stabiliser(mlstm):
    """The pad is the JAX package's and the port keeps it: S = 200 at
    chunk 128 (56 pad rows) and at chunk 200 (none) carry different m;
    the chunked form without a pad agrees with the sequential oracle."""
    tree, cell = mlstm
    x = _t(_x((2, 200, D_MODEL), 7))
    y_pad, (_, _, m_pad) = ssm.mlstm_chunked(cell, x, chunk=128)
    y_one, (_, _, m_one) = ssm.mlstm_chunked(cell, x, chunk=200)
    assert (m_pad - m_one).abs().max() > 1e-3
    _close(y_one, ssm.mlstm_sequential(cell, x).numpy(), 1e-4)
    _close(y_pad, y_one.numpy(), 1e-4)


def test_mlstm_decode_step_matches(mlstm):
    """From the chunked prefill's carried state (the pad's m included),
    four decode steps: outputs and (C, n, m) at each."""
    tree, cell = mlstm
    x = _x((2, 200, D_MODEL), 8)
    _, want_st = ref_ssm.mlstm_chunked(tree, x, chunk=128)
    _, st = ssm.mlstm_chunked(cell, _t(x), chunk=128)
    for xt in _x((4, 2, D_MODEL), 9):
        want_y, want_st = ref_ssm.mlstm_decode_step(tree, want_st, xt)
        got_y, st = ssm.mlstm_decode_step(cell, st, _t(xt))
        _close(got_y, want_y)
        for got, want in zip(st, want_st):
            _close(got, want)


def test_mlstm_decode_from_the_initial_state(mlstm):
    """m = -1e30 at first: exp(-m) is inf inside the denominator's max,
    and the step must still agree (no clamp of the port's own)."""
    tree, cell = mlstm
    want_st = ref_ssm.mlstm_init_state_raw(2, HEADS, D_HEAD)
    st = ssm.mlstm_init_state_raw(2, HEADS, D_HEAD, "cpu")
    for got, want in zip(st, want_st):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for xt in _x((3, 2, D_MODEL), 11):
        want_y, want_st = ref_ssm.mlstm_decode_step(tree, want_st, xt)
        got_y, st = ssm.mlstm_decode_step(cell, st, _t(xt))
        _close(got_y, want_y)
        for got, want in zip(st, want_st):
            _close(got, want)


@pytest.mark.parametrize("s", [1, 40])
def test_slstm_apply_matches(slstm, s):
    tree, cell = slstm
    x = _x((2, s, D_MODEL), 40 + s)
    want_y, want_st = ref_ssm.slstm_apply(tree, x)
    got_y, got_st = ssm.slstm_apply(cell, _t(x))
    _close(got_y, want_y)
    for k in ("h", "c", "n", "m"):
        _close(got_st[k], want_st[k])


def test_slstm_decode_step_matches(slstm):
    """From a prompt's state, four decode steps: outputs and every state
    tensor at each."""
    tree, cell = slstm
    x = _x((2, 25, D_MODEL), 12)
    _, want_st = ref_ssm.slstm_apply(tree, x)
    _, st = ssm.slstm_apply(cell, _t(x))
    for xt in _x((4, 2, D_MODEL), 13):
        want_y, want_st = ref_ssm.slstm_decode_step(tree, want_st, xt)
        got_y, st = ssm.slstm_decode_step(cell, st, _t(xt))
        _close(got_y, want_y)
        for k in ("h", "c", "n", "m"):
            _close(st[k], want_st[k])


def test_slstm_initial_state_matches():
    want = ref_ssm.slstm_init_state(2, HEADS, D_HEAD)
    got = ssm.slstm_init_state(2, HEADS, D_HEAD, "cpu")
    for k in ("h", "c", "n", "m"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))

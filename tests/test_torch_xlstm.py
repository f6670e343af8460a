"""The port's xLSTM LM (xlstm-125m, ``models/xlstm.py``) against the JAX
package's: prefill, decode and the recurrent cache (every mLSTM's (C, n,
m) and every sLSTM's {h, c, n, m}), and the parameter tree across
``convert``.

Inputs are made from a seed with numpy; parameters are the JAX package's
``init_params`` carried across with ``convert.params_from_numpy``. Logits
and every cache leaf are compared in fp32 at smoke width within 1e-4,
relative to each tensor's largest value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as ref_registry
from repro.models import xlstm as ref_xlstm
from repro_torch import convert
from repro_torch.models import registry, xlstm

ARCH = "xlstm-125m"
TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _cache_close(got, want):
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda _: 0, got)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda _: 0,
                                                            want))
    for g, w in zip(_leaves(got), _leaves(want)):
        _close(g, w)


@pytest.fixture(scope="module")
def model():
    cfg = registry.smoke_config(registry.get_config(ARCH))
    ref_cfg = ref_registry.smoke_config(ref_registry.get_config(ARCH))
    ref_params = ref_registry.get_model(ref_cfg).init_params(
        jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return cfg, ref_cfg, ref_params, params


def test_layer_kinds_and_blocks(model):
    cfg, ref_cfg, _, params = model
    full = registry.get_config(ARCH)
    assert xlstm.layer_kinds(full) == ref_xlstm.layer_kinds(
        ref_registry.get_config(ARCH))
    assert xlstm.layer_kinds(full).count("slstm") == 3
    assert xlstm.layer_kinds(cfg) == ref_xlstm.layer_kinds(ref_cfg)
    assert [type(b).__name__ for b in params.blocks] == [
        "MLSTMBlock", "MLSTMBlock", "MLSTMBlock", "SLSTMBlock"]
    assert xlstm.slstm_ffn_width(768) == 1024
    assert xlstm.slstm_ffn_width(cfg.d_model) == cfg.d_model


@pytest.mark.parametrize("s", [40, 130])
def test_prefill_and_decode_match(model, s):
    """Prefill (S = 130 pads the mLSTM to 256 at chunk 128) through both
    registries, then three decode steps: logits and every state leaf at
    each step."""
    cfg, ref_cfg, ref_params, params = model
    ref_api, api = ref_registry.get_model(ref_cfg), registry.get_model(cfg)
    b, n_steps = 2, 3
    tokens = np.random.default_rng(s).integers(
        0, cfg.vocab, (b, s + n_steps)).astype(np.int32)
    want, ref_cache = ref_api.prefill(ref_params, jnp.asarray(tokens[:, :s]),
                                      max_len=s + n_steps)
    got, cache = api.prefill(params, _t(tokens[:, :s]), max_len=s + n_steps)
    _close(got, want)
    _cache_close(cache, ref_cache)
    for i in range(n_steps):
        pos = np.full(b, s + i, np.int32)
        want, ref_cache = ref_api.decode_step(
            ref_params, ref_cache, jnp.asarray(tokens[:, s + i]),
            jnp.asarray(pos))
        got, cache = api.decode_step(params, cache, _t(tokens[:, s + i]),
                                     _t(pos))
        _close(got, want)
        _cache_close(cache, ref_cache)


def test_init_cache_matches(model):
    cfg, ref_cfg, _, _ = model
    want = ref_registry.get_model(ref_cfg).init_cache(3, 64)
    got = registry.get_model(cfg).init_cache(3, 64, "cpu")
    _cache_close(got, want)


def test_decode_from_a_fresh_cache_matches(model):
    """Decode with no prefill, from ``init_cache``: the mLSTM's m = -1e30
    and the sLSTM's n = 1e-6, m = -1e30 as they start."""
    cfg, ref_cfg, ref_params, params = model
    ref_api, api = ref_registry.get_model(ref_cfg), registry.get_model(cfg)
    ref_cache, cache = ref_api.init_cache(2, 8), api.init_cache(2, 8, "cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 2))
    for i in range(2):
        tok = tokens[:, i].astype(np.int32)
        pos = np.full(2, i, np.int32)
        want, ref_cache = ref_api.decode_step(ref_params, ref_cache,
                                              jnp.asarray(tok),
                                              jnp.asarray(pos))
        got, cache = api.decode_step(params, cache, _t(tok), _t(pos))
        _close(got, want)
        _cache_close(cache, ref_cache)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_roundtrip_keeps_every_dtype(dtype):
    """The heterogeneous ``blocks`` list across ``convert`` and back, leaf
    for leaf; under bf16 the mLSTM gates and the whole sLSTM cell but
    its out_proj stay fp32, and the port's own init has the same tree,
    dtypes and shapes (ffn_gate = ffn_up, as the JAX package draws
    them)."""
    ref_cfg = dataclasses.replace(
        ref_registry.smoke_config(ref_registry.get_config(ARCH)), dtype=dtype)
    cfg = dataclasses.replace(registry.smoke_config(registry.get_config(ARCH)),
                              dtype=dtype)
    tree = jax.tree_util.tree_map(np.asarray, ref_registry.get_model(
        ref_cfg).init_params(jax.random.PRNGKey(0)))
    params = convert.params_from_numpy(tree, cfg, "cpu")
    back = convert.params_to_numpy(params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.astype(np.float32),
                                      b.astype(np.float32))
    cell = params.blocks[3].cell
    assert cell.wz.dtype == cell.rz.dtype == torch.float32
    assert cell.out_proj.dtype == getattr(torch, dtype)
    assert params.blocks[0].cell.w_i.dtype == torch.float32
    own = convert.params_to_numpy(xlstm.init_params(
        torch.Generator().manual_seed(0), cfg))
    assert jax.tree_util.tree_structure(own) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(tree)):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
    np.testing.assert_array_equal(own["blocks"][3]["ffn_gate"],
                                  own["blocks"][3]["ffn_up"])
    np.testing.assert_array_equal(tree["blocks"][3]["ffn_gate"],
                                  tree["blocks"][3]["ffn_up"])
    tree["blocks"][3]["cell"]["rz"] = tree["blocks"][3]["cell"]["rz"].astype(
        np.float64)
    with pytest.raises(TypeError, match="rz"):
        convert.params_from_numpy(tree, cfg, "cpu")

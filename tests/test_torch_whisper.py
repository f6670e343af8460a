"""The port's Whisper backbone (whisper-large-v3, ``models/whisper.py``)
against the JAX package's: the encoder over stub frames with sinusoidal
positions, the decoder with learned positions, causal self-attention and
cross-attention, prefill, decode and the cache (self K, V and positions,
cross K and V), and the parameter tree across ``convert``.

Inputs are made from a seed with numpy; parameters are the JAX package's
``init_params`` carried across with ``convert.params_from_numpy``. Logits
and every cache leaf are compared in fp32 at smoke width (2 encoder and 2
decoder layers) within 1e-4, relative to each tensor's largest value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as ref_common
from repro.models import registry as ref_registry
from repro.models import whisper as ref_whisper
from repro_torch import convert
from repro_torch.models import common, registry, whisper
from test_torch_xlstm import _cache_close, _close, _t

ARCH = "whisper-large-v3"


@pytest.fixture(scope="module")
def model():
    cfg = registry.smoke_config(registry.get_config(ARCH))
    ref_cfg = ref_registry.smoke_config(ref_registry.get_config(ARCH))
    ref_params = ref_registry.get_model(ref_cfg).init_params(
        jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return cfg, ref_cfg, ref_params, params


def test_layernorm_matches():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 96)) * 3 + 1).astype(np.float32)
    tree = {"scale": rng.normal(size=96).astype(np.float32),
            "bias": rng.normal(size=96).astype(np.float32)}
    norm = common.layernorm_init(96, "cpu")
    torch.testing.assert_close(norm.scale, torch.ones(96))
    torch.testing.assert_close(norm.bias, torch.zeros(96))
    for name, t in norm.named_parameters():
        t.copy_(_t(tree[name]))
    np.testing.assert_allclose(
        common.layernorm_apply(norm, _t(x), 1e-5).numpy(),
        np.asarray(ref_common.layernorm_apply(tree, x, 1e-5)),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s,d,tol", [(20, 128, 1e-6), (1500, 1280, 2e-4)])
def test_sinusoidal_matches(s, d, tol):
    """The encoder's positions; at whisper's 1,500 frames the float32 sin
    of angles up to 1,499 rad differs by the libraries' range reduction
    (1.2e-4 at most)."""
    np.testing.assert_allclose(whisper._sinusoidal(s, d, "cpu").numpy(),
                               np.asarray(ref_whisper._sinusoidal(s, d)),
                               rtol=0, atol=tol)


def test_encode_and_cross_kv_match(model):
    cfg, ref_cfg, ref_params, params = model
    frames = (np.random.default_rng(1).normal(size=(2, 20, cfg.d_model))
              * 0.5).astype(np.float32)
    want = ref_whisper.encode(ref_params, jnp.asarray(frames), ref_cfg)
    got = whisper.encode(params, _t(frames), cfg)
    _close(got, want)
    for g, w in zip(whisper._cross_kv(params, got),
                    ref_whisper._cross_kv(ref_params["decoder"], want,
                                          ref_cfg)):
        _close(g, w)


@pytest.mark.parametrize("max_len", [None, 43])
def test_prefill_and_decode_match(model, max_len):
    """20 stub frames and 40 tokens (``max_len`` None: the cache is the
    prompt, and decode wraps onto slot 0), then three decode steps: logits
    and every cache leaf at each step."""
    cfg, ref_cfg, ref_params, params = model
    ref_api, api = ref_registry.get_model(ref_cfg), registry.get_model(cfg)
    rng = np.random.default_rng(2)
    b, s_enc, s, n_steps = 2, 20, 40, 3
    tokens = rng.integers(0, cfg.vocab, (b, s + n_steps)).astype(np.int32)
    frames = (rng.normal(size=(b, s_enc, cfg.d_model)) * 0.5).astype(
        np.float32)
    want, ref_cache = ref_api.prefill(ref_params, jnp.asarray(tokens[:, :s]),
                                      jnp.asarray(frames), max_len=max_len)
    got, cache = api.prefill(params, _t(tokens[:, :s]), _t(frames),
                             max_len=max_len)
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
    want = ref_registry.get_model(ref_cfg).init_cache(3, 24)
    got = registry.get_model(cfg).init_cache(3, 24, "cpu")
    _cache_close(got, want)
    assert got["cross_k"].shape[2] == 12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_roundtrip_keeps_every_dtype(dtype):
    """The stacked ``encoder`` and ``decoder``, ``enc_norm``, LayerNorm
    biases and ``pos_embed`` across ``convert`` and back, leaf for leaf,
    and the port's own init with the same tree, dtypes and shapes."""
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
    assert params.pos_embed.dtype == getattr(torch, dtype)
    assert params.pos_embed.shape == (cfg.max_position, cfg.d_model)
    assert params.decoder[0].ln_x.bias.dtype == torch.float32
    own = convert.params_to_numpy(whisper.init_params(
        torch.Generator().manual_seed(0), cfg))
    assert jax.tree_util.tree_structure(own) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(tree)):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
    tree["enc_norm"]["bias"] = tree["enc_norm"]["bias"][:-1]
    with pytest.raises(TypeError, match="enc_norm/bias"):
        convert.params_from_numpy(tree, cfg, "cpu")

"""The port's Hymba (hymba-1.5b, ``models/hymba.py``) against the JAX
package's: attention ∥ Mamba in every layer, sliding windows with global
layers, prefill, decode and the cache (K, V and their positions, the
Mamba state and its pre-conv history), and the parameter tree across
``convert``.

Inputs are made from a seed with numpy; parameters are the JAX package's
``init_params`` carried across with ``convert.params_from_numpy``. Logits
and every cache leaf are compared in fp32 at smoke width (window 16,
global layers 0 and 3) within 1e-4, relative to each tensor's largest
value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as ref_registry
from repro.models import transformer as ref_transformer
from repro_torch import convert
from repro_torch.models import hymba, registry, transformer
from test_torch_xlstm import _cache_close, _close, _t

ARCH = "hymba-1.5b"


@pytest.fixture(scope="module")
def model():
    cfg = registry.smoke_config(registry.get_config(ARCH))
    ref_cfg = ref_registry.smoke_config(ref_registry.get_config(ARCH))
    ref_params = ref_registry.get_model(ref_cfg).init_params(
        jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return cfg, ref_cfg, ref_params, params


@pytest.mark.parametrize("n_layers", [32, 4, 2])
def test_window_schedule_matches(n_layers):
    """Full depth (global 0, 16, 31), the smoke config, and a depth cut
    to 2 layers, where the JAX package's scatter drops the out-of-range
    global layers."""
    cfg = dataclasses.replace(registry.get_config(ARCH), n_layers=n_layers)
    ref_cfg = dataclasses.replace(ref_registry.get_config(ARCH),
                                  n_layers=n_layers)
    np.testing.assert_array_equal(
        transformer.window_schedule(cfg).numpy(),
        np.asarray(ref_transformer.window_schedule(ref_cfg)))
    assert transformer.cache_alloc_len(cfg, 2064) == 2064


@pytest.mark.parametrize("s", [40, 200])
def test_prefill_and_decode_match(model, s):
    """S = 40 and 200 past the window of 16, with decode headroom (S =
    200 runs the Mamba scan as four chunks of 64, the last padded):
    logits and every cache leaf after prefill and after each of three
    decode steps."""
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
    assert cache["k"].shape[2] == s + n_steps
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_roundtrip_keeps_every_dtype(dtype):
    """The stacked ``layers`` with their ``mamba`` subtree across
    ``convert`` and back, leaf for leaf; under bf16 conv_w, dt_proj,
    dt_bias, a_log and d_skip stay fp32, and the port's own init has the
    same tree, dtypes and shapes."""
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
    m = params.layers[1].mamba
    for name in ("conv_w", "dt_proj", "dt_bias", "a_log", "d_skip"):
        assert getattr(m, name).dtype == torch.float32, name
    assert m.in_proj.dtype == getattr(torch, dtype)
    own = convert.params_to_numpy(hymba.init_params(
        torch.Generator().manual_seed(0), cfg))
    assert jax.tree_util.tree_structure(own) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(tree)):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
    # the deterministic leaves are the JAX package's exactly
    for name in ("dt_bias", "a_log", "d_skip"):
        np.testing.assert_allclose(own["layers"]["mamba"][name],
                                   tree["layers"]["mamba"][name], rtol=1e-6)
    tree["layers"]["mamba"]["a_log"] = tree["layers"]["mamba"][
        "a_log"].astype(np.float16)
    with pytest.raises(TypeError, match="a_log"):
        convert.params_from_numpy(tree, cfg, "cpu")

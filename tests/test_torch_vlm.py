"""The port's VLM backbone (llava-next-34b) against the JAX package's: the
stub frontend's precomputed patch embeddings go before the text
(``extra_embeds``), positions run over the whole sequence, and decode
continues after them; ``_seq_split`` sizes them.

Inputs are made from a seed with numpy; parameters are the JAX package's
``init_params`` carried across with ``convert.params_from_numpy``. Logits
are compared in fp32 at smoke width within the dense model tests' 1e-4.
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
from repro_torch.models import common, registry, transformer

TOL = dict(atol=1e-4, rtol=1e-4)  # logits after a stack of layers


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def llava():
    cfg = registry.smoke_config(registry.get_config("llava-next-34b"))
    ref_cfg = ref_registry.smoke_config(
        ref_registry.get_config("llava-next-34b"))
    ref_params = ref_registry.get_model(ref_cfg).init_params(
        jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return cfg, ref_cfg, ref_params, params


@pytest.mark.parametrize("arch", ["llava-next-34b", "internlm2-1.8b",
                                  "olmoe-1b-7b"])
@pytest.mark.parametrize("seq_len", [1, 7, 2048, 4096])
def test_seq_split_matches_jax(arch, seq_len):
    cfg = registry.get_config(arch)
    assert registry._seq_split(cfg, seq_len) == ref_registry._seq_split(
        ref_registry.get_config(arch), seq_len)
    whisper = dataclasses.replace(cfg, frontend="audio_frames",
                                  encoder_seq_ratio=2)
    assert registry._seq_split(whisper, seq_len) == ref_registry._seq_split(
        whisper, seq_len)


def test_prefill_with_extra_embeds_and_decode_match(llava):
    """Two sequences of 8 patch embeddings and 12 text tokens, decode
    headroom for three steps: logits, cache positions and K at each step
    against the JAX package's."""
    cfg, ref_cfg, ref_params, params = llava
    assert cfg.family == "vlm" and cfg.frontend == "vision_patches"
    ref_api, api = ref_registry.get_model(ref_cfg), registry.get_model(cfg)
    rng = np.random.default_rng(21)
    b, s_img, s_text, n_steps = 2, 8, 12, 3
    s = s_img + s_text
    tokens = rng.integers(0, cfg.vocab, (b, s_text + n_steps)).astype(
        np.int32)
    extra = (rng.normal(size=(b, s_img, cfg.d_model)) * 0.5).astype(
        np.float32)
    want, ref_cache = ref_api.prefill(
        ref_params, jnp.asarray(tokens[:, :s_text]),
        extra_embeds=jnp.asarray(extra), max_len=s + n_steps)
    got, cache = api.prefill(params, _t(tokens[:, :s_text]),
                             extra_embeds=_t(extra), max_len=s + n_steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                  np.asarray(ref_cache["kv_pos"]))
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(ref_cache["k"]),
                               **TOL)
    assert cache["k"].shape[2] == s + n_steps
    for i in range(n_steps):
        pos = np.full(b, s + i, np.int32)
        want, ref_cache = ref_api.decode_step(
            ref_params, ref_cache, jnp.asarray(tokens[:, s_text + i]),
            jnp.asarray(pos))
        got, cache = api.decode_step(params, cache,
                                     _t(tokens[:, s_text + i]), _t(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                  np.asarray(ref_cache["kv_pos"]))


def test_forward_hidden_with_extra_embeds_matches(llava):
    """The whole sequence's hidden states: the patch rows first, then the
    text, one position each."""
    cfg, ref_cfg, ref_params, params = llava
    rng = np.random.default_rng(22)
    tokens = rng.integers(0, cfg.vocab, (1, 9)).astype(np.int32)
    extra = rng.normal(size=(1, 5, cfg.d_model)).astype(np.float32)
    want = ref_transformer.forward_hidden(
        ref_params, jnp.asarray(tokens), ref_cfg,
        extra_embeds=jnp.asarray(extra), remat=False)
    got = transformer.forward_hidden(params, _t(tokens), cfg,
                                     extra_embeds=_t(extra))
    assert got.shape == (1, 14, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_equals_extended_prefill(llava):
    """The card's consistency check at smoke width: each decode step's
    logits equal the last-token logits of a pass over the extended
    sequence (a dense stack: no capacity drops)."""
    cfg, _, _, params = llava
    rng = np.random.default_rng(23)
    b, s_img, s_text, n_steps = 2, 6, 10, 4
    tokens = _t(rng.integers(0, cfg.vocab, (b, s_text + n_steps)).astype(
        np.int32))
    extra = _t(rng.normal(size=(b, s_img, cfg.d_model)).astype(np.float32))
    s = s_img + s_text
    _, cache = transformer.prefill(params, tokens[:, :s_text], cfg,
                                   extra_embeds=extra, max_len=s + n_steps)
    x = transformer.forward_hidden(params, tokens, cfg, extra_embeds=extra)
    for i in range(n_steps):
        pos = torch.full((b,), s + i, dtype=torch.int32)
        got, cache = transformer.decode_step(
            params, cache, tokens[:, s_text + i], pos, cfg)
        want = common.logits_last(params.embedding, x[:, s + i])
        torch.testing.assert_close(got, want, **TOL)


def test_extra_embeds_are_cast_to_the_model_dtype():
    cfg = dataclasses.replace(
        registry.smoke_config(registry.get_config("llava-next-34b")),
        dtype="bfloat16")
    params = transformer.init_params(torch.Generator().manual_seed(3), cfg)
    rng = np.random.default_rng(24)
    tokens = _t(rng.integers(0, cfg.vocab, (1, 6)).astype(np.int32))
    extra = _t(rng.normal(size=(1, 4, cfg.d_model)).astype(np.float32))
    x, positions = transformer._input_embeds(params, tokens, extra)
    assert x.dtype == torch.bfloat16 and x.shape == (1, 10, cfg.d_model)
    assert torch.equal(x[:, :4], extra.to(torch.bfloat16))
    assert positions.tolist() == list(range(10))
    got, _ = transformer.prefill(params, tokens, cfg, extra_embeds=extra)
    want, _ = transformer.prefill(params, tokens, cfg,
                                  extra_embeds=extra.to(torch.bfloat16))
    assert torch.equal(got, want)

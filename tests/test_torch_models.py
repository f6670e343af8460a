"""The port's configs, dense decoder and flash attention against the JAX
package's.

Inputs are made from a seed with numpy; parameters are the JAX package's
``init_params`` carried across with ``convert.params_from_numpy``. The JAX
side runs as its own tests run it on the CPU: the model through its XLA
path, the Pallas flash kernel in interpret mode. Logits and attention
outputs are compared in fp32 at smoke width.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.kernels.flash_attention.kernel import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro.models import registry as ref_registry
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention, common, registry, transformer

DENSE = ("internlm2-1.8b", "deepseek-7b", "granite-20b", "deepseek-coder-33b")
# logits: the two sides' fp32 matmuls sum in other orders
TOL = dict(atol=1e-4, rtol=1e-4)
# one attention call in fp32 (the JAX package's own kernel bound)
ATTN_TOL = dict(atol=2e-5, rtol=2e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("arch", DENSE)
def test_configs_equal_field_by_field(arch):
    ref_cfg = ref_registry.get_config(arch)
    cfg = registry.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert dataclasses.asdict(registry.smoke_config(cfg)) == \
        dataclasses.asdict(ref_registry.smoke_config(ref_cfg))
    assert [f.name for f in dataclasses.fields(base.ModelConfig)] == \
        [f.name for f in dataclasses.fields(ref_base.ModelConfig)]
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()}


@pytest.mark.parametrize("arch", ref_registry.ALL_ARCHS)
def test_every_arch_config_and_param_count(arch):
    """All ten archs: every field, the smoke reduction and the parameter
    estimate (full and active-only) equal the JAX package's."""
    assert registry.ALL_ARCHS == ref_registry.ALL_ARCHS
    cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    for c, r in ((cfg, ref_cfg), (registry.smoke_config(cfg),
                                  ref_registry.smoke_config(ref_cfg))):
        assert dataclasses.asdict(c) == dataclasses.asdict(r)
        for active_only in (False, True):
            assert c.param_count(active_only=active_only) == \
                r.param_count(active_only=active_only)
    assert registry.FAMILY_MODULES[cfg.family]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "xlstm-125m", "whisper-large-v3"])
def test_other_families_raise(arch):
    """No family raises any more: each arch resolves to the JAX package's
    config and builds through ``get_model`` into its family's module; and,
    as the JAX package's serving engine does, a transformer builds over
    the config whatever its family (xLSTM's ``mlp_type="none"`` is the
    GELU MLP, learned positions where ``use_rope=False``)."""
    ref_cfg = ref_registry.get_config(arch)
    cfg = registry.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    smoke = registry.smoke_config(cfg)
    params = registry.get_model(smoke).init_params(
        torch.Generator().manual_seed(0))
    assert isinstance(params, registry.params_class(smoke))
    if arch == "olmoe-1b-7b":
        assert params.layers[0].moe.router.dtype == torch.float32
    as_lm = transformer.init_params(torch.Generator().manual_seed(0), smoke)
    ref_tree = ref_registry.get_model(dataclasses.replace(
        ref_registry.smoke_config(ref_cfg), family="dense")).init_params(
            jax.random.PRNGKey(0))
    own = convert.params_to_numpy(as_lm)
    assert jax.tree_util.tree_structure(own) == \
        jax.tree_util.tree_structure(ref_tree)
    assert (as_lm.pos_embed is None) == cfg.use_rope


def test_unported_entry_points_raise():
    """Both entry points that once raised are ported now (the name is kept
    from when they raised): ``loss_fn`` gives a finite fp32 scalar near ln
    V at initialisation, and a batch without labels is refused (its
    values are held to the JAX package's in test_torch_train.py); learned
    absolute positions are ported (``pos_embed``)."""
    cfg = registry.smoke_config(registry.get_config("internlm2-1.8b"))
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    labels = torch.randint(0, cfg.vocab, (4, 32),
                           generator=torch.Generator().manual_seed(1))
    loss = transformer.loss_fn(params, {"tokens": labels, "labels": labels},
                               cfg)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(loss.item() - np.log(cfg.vocab)) < 1.0
    with pytest.raises(KeyError, match="labels"):
        transformer.loss_fn(params, {"tokens": tokens}, cfg)
    learned = transformer.init_params(torch.Generator().manual_seed(0),
                                      dataclasses.replace(cfg, use_rope=False))
    assert learned.pos_embed.shape == (cfg.max_position, cfg.d_model)
    assert abs(learned.pos_embed.std().item() - 0.02) < 0.001


@pytest.fixture(scope="module")
def learned():
    """internlm2-1.8b at smoke width with learned absolute positions."""
    cfg = dataclasses.replace(
        registry.smoke_config(registry.get_config("internlm2-1.8b")),
        use_rope=False)
    ref_cfg = dataclasses.replace(
        ref_registry.smoke_config(ref_registry.get_config("internlm2-1.8b")),
        use_rope=False)
    ref_params = ref_registry.get_model(ref_cfg).init_params(
        jax.random.PRNGKey(5))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return cfg, ref_cfg, ref_params, params


@pytest.mark.parametrize("max_len", [None, 16])
def test_learned_positions_prefill_and_decode_match(learned, max_len):
    """``use_rope=False``: pos_embed added at the prompt's positions and
    at each decode position; logits and K within 1e-4 of the JAX
    package's (``max_len`` None: decode wraps onto slot 0)."""
    cfg, ref_cfg, ref_params, params = learned
    ref_api, api = ref_registry.get_model(ref_cfg), registry.get_model(cfg)
    b, s, n_steps = 2, 13, 3
    tokens = np.random.default_rng(8).integers(
        0, cfg.vocab, (b, s + n_steps)).astype(np.int32)
    want, ref_cache = ref_api.prefill(ref_params, jnp.asarray(tokens[:, :s]),
                                      max_len=max_len)
    got, cache = api.prefill(params, _t(tokens[:, :s]), max_len=max_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i in range(n_steps):
        pos = np.full(b, s + i, np.int32)
        want, ref_cache = ref_api.decode_step(
            ref_params, ref_cache, jnp.asarray(tokens[:, s + i]),
            jnp.asarray(pos))
        got, cache = api.decode_step(params, cache, _t(tokens[:, s + i]),
                                     _t(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(cache["k"].numpy(),
                                   np.asarray(ref_cache["k"]), **TOL)
    np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                  np.asarray(ref_cache["kv_pos"]))


def test_learned_positions_paged_decode_matches(learned):
    """The paged model adds no learned positions (the JAX package's adds
    none either): paged_prefill and two paged_decode_steps on the same
    manager decisions, logits and pools within 1e-4."""
    from repro.serving import paged_model as ref_pm
    from repro_torch.kvcache.manager import WolfKVManager
    from repro_torch.serving import paged_model
    from test_torch_serving import _decode_inputs, _reserve

    cfg, ref_cfg, ref_params, params = learned
    b, s, page, n_blocks, max_pages = 2, 20, 8, 48, 6
    tokens = np.random.default_rng(9).integers(
        0, cfg.vocab, (b, s + 2)).astype(np.int32)
    mgr = WolfKVManager(n_blocks, page, 1, adaptive=False)
    wb, ws = _reserve(mgr, b, s)
    want, ref_pools = ref_pm.paged_prefill(
        ref_params, ref_cfg, ref_pm.init_pools(ref_cfg, n_blocks, page),
        jnp.asarray(tokens[:, :s]), jnp.asarray(wb), jnp.asarray(ws))
    got, pools = paged_model.paged_prefill(
        params, cfg, paged_model.init_pools(cfg, n_blocks, page, "cpu"),
        _t(tokens[:, :s]), _t(wb), _t(ws))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i in range(2):
        tables, valid, lengths, wb1, ws1 = _decode_inputs(
            mgr, range(b), max_pages)
        pos = np.full(b, s + i, np.int32)
        want, ref_pools = ref_pm.paged_decode_step(
            ref_params, ref_cfg, ref_pools, *map(jnp.asarray, (
                tables, valid, lengths, wb1, ws1, tokens[:, s + i], pos)))
        got, pools = paged_model.paged_decode_step(
            params, cfg, pools, *map(_t, (
                tables, valid, lengths, wb1, ws1, tokens[:, s + i], pos)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(pools[name].numpy(),
                                   np.asarray(ref_pools[name]), **TOL)


def test_init_statistics():
    """dense_init: truncated at ±2σ with σ = fan_in^-½; embed_init: 0.02."""
    cfg = registry.smoke_config(registry.get_config("internlm2-1.8b"))
    params = transformer.init_params(torch.Generator().manual_seed(1), cfg)
    w = params.layers[0].mlp.wi_gate
    sigma = cfg.d_model ** -0.5
    assert w.abs().max() <= 2 * sigma + 1e-7
    # the ±2σ truncated normal keeps 0.88σ of spread
    assert abs(w.std().item() / sigma - 0.880) < 0.02
    e = params.embedding.embed
    assert abs(e.std().item() - 0.02) < 0.001
    assert torch.equal(params.final_norm.scale, torch.ones(cfg.d_model))
    assert not any(p.requires_grad for p in params.parameters())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_learned_positions_params_roundtrip(dtype):
    """A ``use_rope=False`` transformer's tree (``pos_embed`` beside the
    layers) across ``convert`` and back, leaf for leaf, dtypes kept."""
    cfg = dataclasses.replace(
        registry.smoke_config(registry.get_config("granite-20b")),
        dtype=dtype, use_rope=False)
    tree = jax.tree_util.tree_map(
        np.asarray, ref_registry.get_model(cfg).init_params(
            jax.random.PRNGKey(0)))
    assert "pos_embed" in tree
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_roundtrip_and_dtype_check(dtype):
    cfg = dataclasses.replace(
        registry.smoke_config(registry.get_config("granite-20b")),
        dtype=dtype)
    tree = jax.tree_util.tree_map(
        np.asarray, ref_registry.get_model(cfg).init_params(
            jax.random.PRNGKey(0)))
    params = convert.params_from_numpy(tree, cfg, "cpu")
    back = convert.params_to_numpy(params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.astype(np.float32),
                                      b.astype(np.float32))
    assert params.layers[0].attn.wq.dtype == getattr(torch, dtype)
    tree["layers"]["attn"]["wq"] = tree["layers"]["attn"]["wq"].astype(
        np.float64)
    with pytest.raises(TypeError, match="wq"):
        convert.params_from_numpy(tree, cfg, "cpu")


def test_norm_rope_mlp_match_reference():
    cfg = registry.smoke_config(registry.get_config("granite-20b"))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    scale = rng.normal(size=cfg.d_model).astype(np.float32)
    norm = common.rmsnorm_init(cfg.d_model, "cpu")
    norm.scale.copy_(_t(scale))
    np.testing.assert_allclose(
        common.rmsnorm_apply(norm, _t(x), 1e-5).numpy(),
        np.asarray(ref_common.rmsnorm_apply({"scale": scale}, x, 1e-5)),
        **ATTN_TOL)
    h = rng.normal(size=(2, 5, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        common.apply_rope(_t(h), _t(pos), 10_000.0).numpy(),
        np.asarray(ref_common.apply_rope(h, pos, 10_000.0)), **TOL)
    for mlp_type in ("gelu", "swiglu"):
        c = dataclasses.replace(cfg, mlp_type=mlp_type)
        tree = jax.tree_util.tree_map(
            np.asarray, ref_common.mlp_init(jax.random.PRNGKey(3), c))
        mlp = common.MLP(c, "cpu")
        for name, t in mlp.named_parameters():
            t.copy_(_t(tree[name]))
        np.testing.assert_allclose(
            common.mlp_apply(mlp, _t(x)).numpy(),
            np.asarray(ref_common.mlp_apply(tree, x, c)), **TOL)


def test_mlp_of_type_none_is_gelu_and_takes_no_width():
    """Every type but "swiglu" is the GELU MLP, as the JAX package's
    ``mlp_init`` has it; xlstm-125m's own config (``mlp_type="none"``,
    d_ff = 0) builds empty matrices and adds nothing (the JAX package's
    init divides by the zero fan-in there and raises)."""
    cfg = registry.get_config("xlstm-125m")
    mlp = common.mlp_init(cfg, torch.Generator().manual_seed(0))
    assert mlp.wi.shape == (cfg.d_model, 0) and mlp.wo.shape == (0, cfg.d_model)
    x = torch.randn(2, 3, cfg.d_model).to(torch.bfloat16)
    assert torch.equal(common.mlp_apply(mlp, x), torch.zeros_like(x))
    with pytest.raises(ZeroDivisionError):
        ref_common.mlp_init(jax.random.PRNGKey(0), ref_registry.get_config(
            "xlstm-125m"))
    smoke = registry.smoke_config(cfg)
    tree = jax.tree_util.tree_map(np.asarray, ref_common.mlp_init(
        jax.random.PRNGKey(3), ref_registry.smoke_config(
            ref_registry.get_config("xlstm-125m"))))
    assert set(tree) == {"wi", "wo"}
    mlp = common.MLP(smoke, "cpu")
    for name, t in mlp.named_parameters():
        t.copy_(_t(tree[name]))
    x = np.random.default_rng(4).normal(size=(2, 5, smoke.d_model)).astype(
        np.float32)
    np.testing.assert_allclose(
        common.mlp_apply(mlp, _t(x)).numpy(),
        np.asarray(ref_common.mlp_apply(tree, x, smoke)), **TOL)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-7b", "granite-20b"])
def test_prefill_and_decode_logits_match(arch):
    """G = 2 (internlm2), MHA (deepseek-7b), MQA with GELU (granite)."""
    cfg = registry.smoke_config(registry.get_config(arch))
    ref_api = ref_registry.get_model(cfg)
    ref_params = ref_api.init_params(jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    api = registry.get_model(cfg)
    b, s, n_steps = 2, 13, 3
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab, (b, s + n_steps)).astype(np.int32)

    want, ref_cache = ref_api.prefill(ref_params, jnp.asarray(tokens[:, :s]),
                                      max_len=s + n_steps)
    got, cache = api.prefill(params, _t(tokens[:, :s]), max_len=s + n_steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                  np.asarray(ref_cache["kv_pos"]))
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(ref_cache["k"]),
                               **TOL)
    for i in range(n_steps):
        pos = np.full(b, s + i, np.int32)
        want, ref_cache = ref_api.decode_step(
            ref_params, ref_cache, jnp.asarray(tokens[:, s + i]),
            jnp.asarray(pos))
        got, cache = api.decode_step(params, cache, _t(tokens[:, s + i]),
                                     _t(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                  np.asarray(ref_cache["kv_pos"]))


def test_sliding_window_ring_buffer_matches():
    """A sliding-window-everywhere variant: prefill keeps the last window
    in ring-slot order, decode wraps around it."""
    cfg = dataclasses.replace(
        registry.smoke_config(registry.get_config("internlm2-1.8b")),
        sliding_window=8)
    ref_cfg = dataclasses.replace(
        ref_registry.smoke_config(ref_registry.get_config("internlm2-1.8b")),
        sliding_window=8)
    ref_api = ref_registry.get_model(ref_cfg)
    ref_params = ref_api.init_params(jax.random.PRNGKey(1))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    tokens = np.random.default_rng(8).integers(
        0, cfg.vocab, (1, 15)).astype(np.int32)
    want, ref_cache = ref_api.prefill(ref_params, jnp.asarray(tokens[:, :13]))
    got, cache = transformer.prefill(params, _t(tokens[:, :13]), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                  np.asarray(ref_cache["kv_pos"]))
    for i in (13, 14):
        pos = np.asarray([i], np.int32)
        want, ref_cache = ref_api.decode_step(
            ref_params, ref_cache, jnp.asarray(tokens[:, i]), jnp.asarray(pos))
        got, cache = transformer.decode_step(params, cache, _t(tokens[:, i]),
                                             _t(pos), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


FLASH_CASES = [
    # b, sq, skv, hq, hkv, d, causal, window
    (1, 128, 128, 4, 4, 64, True, 0),     # MHA causal
    (2, 160, 160, 8, 2, 32, True, 0),     # GQA, d 32, ragged tail
    (2, 128, 128, 4, 1, 128, True, 0),    # MQA, d 128
    (1, 192, 192, 4, 2, 64, True, 48),    # sliding window
    (2, 64, 160, 2, 2, 128, False, 0),    # cross (Sq != Skv), not causal
    (1, 100, 100, 4, 4, 32, True, 0),     # ragged tail
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window", FLASH_CASES)
def test_flash_attention_plain_matches_reference_and_kernel(
        b, sq, skv, hq, hkv, d, causal, window):
    rng = np.random.default_rng(sq + d + window)
    q = (rng.normal(size=(b, sq, hq, d)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(b, skv, hkv, d)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(b, skv, hkv, d)) * 0.5).astype(np.float32)
    got = flash_ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                    window=window).numpy()
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want), **ATTN_TOL)
    kern = ref_flash(q, k, v, causal=causal, window=window, block_q=64,
                     block_kv=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **ATTN_TOL)
    if causal:  # the plain chunked path (CPU) over several KV chunks
        chunked = attention.chunked_attention(
            _t(q), _t(k), _t(v), window, kv_chunk=48, window_static=window)
        np.testing.assert_allclose(chunked.numpy(), np.asarray(want),
                                   **ATTN_TOL)


def test_flash_attention_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((1, 8, 4, 48))
    with pytest.raises(ValueError, match="d_head 48"):
        flash_ops.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 4, 64), dtype=torch.float16)
    with pytest.raises(ValueError, match="float16"):
        flash_ops.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 3, 64))
    k = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="3 query / 2 kv"):
        flash_kernel.check_args(q, k, k)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_and_chunked_attention_match(window):
    rng = np.random.default_rng(window)
    b, s, hq, hkv, d = 3, 20, 4, 2, 32
    q = rng.normal(size=(b, 1, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    kv_pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    kv_pos[1, [2, 7, 11]] = -1
    pos = np.asarray([19, 15, 9], np.int32)
    got = attention.decode_attention(_t(q), _t(k), _t(v), _t(kv_pos),
                                     _t(pos), window)
    want = ref_attention.decode_attention(q, k, v, kv_pos, pos,
                                          jnp.int32(window))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    qs = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    got = attention.chunked_attention(_t(qs), _t(k), _t(v), window,
                                      kv_chunk=8)
    want = ref_attention.chunked_attention(qs, k, v, jnp.int32(window),
                                           kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)

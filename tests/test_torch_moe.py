"""The port's mixture-of-experts family against the JAX package's: the
configs, the MoE layer's capacity and dense paths, whole olmoe and mixtral
models, olmoe on the Wolf-KV paged path and in the serving engine, and the
parameter round trip.

Inputs are made from a seed with numpy; parameters are the JAX package's
``init_params`` / ``moe_init`` carried across. The JAX capacity and dense
functions are called directly: the tests never flip its ``MOE_IMPL``
global. Tolerances: 1e-5 for one MoE layer in fp32 (the two sides' fp32
matmuls sum in other orders), 2e-2 absolute and relative in bf16 (a
bf16 output rounds to 2^-8 of its value, and the SwiGLU rounds three
times before the combine), and the dense model tests' 1e-4 for logits
after a stack of layers.
"""

import dataclasses
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro.models import registry as ref_registry
from repro.serving import engine as ref_engine
from repro.serving import paged_model as ref_pm
from repro_torch import convert
from repro_torch.kvcache.manager import WolfKVManager
from repro_torch.launch import serve
from repro_torch.models import moe, registry, transformer
from repro_torch.serving import engine, paged_model
from test_torch_serving import _decode_inputs, _recording, _reserve

MOE_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
           "bfloat16": dict(atol=2e-2, rtol=2e-2)}
TOL = dict(atol=1e-4, rtol=1e-4)  # logits after a stack of layers


def _t(x):
    return torch.from_numpy(np.array(x))


def _leaf(arr) -> torch.Tensor:
    """A JAX leaf as a tensor of its own dtype (bf16 crosses as 16 bits)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _configs(arch, **over):
    """The JAX package's config and the port's, with the same overrides."""
    return (dataclasses.replace(ref_registry.get_config(arch), **over),
            dataclasses.replace(registry.get_config(arch), **over))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x22b",
                                  "llava-next-34b"])
def test_configs_equal_field_by_field(arch):
    ref_cfg, cfg = ref_registry.get_config(arch), registry.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert dataclasses.asdict(registry.smoke_config(cfg)) == \
        dataclasses.asdict(ref_registry.smoke_config(ref_cfg))
    assert registry.get_model(cfg).cfg is cfg


def _keep_oracle(idx, cfg, tpg):
    """The capacity decision in plain Python: per group, every token's
    first choice before any token's second, each expert taking ``cap``
    (token, choice) pairs; pad rows route to expert 0 for every choice."""
    t_total, k = idx.shape
    pad = (-t_total) % tpg
    idx = np.concatenate([idx, np.zeros((pad, k), idx.dtype)])
    cap = max(1, int(tpg * k / cfg.n_experts * cfg.capacity_factor))
    keep = np.zeros(idx.shape, bool)
    for lo in range(0, len(idx), tpg):
        load = np.zeros(cfg.n_experts, int)
        for j in range(k):
            for t in range(lo, lo + tpg):
                keep[t, j] = load[idx[t, j]] < cap
                load[idx[t, j]] += 1
    return keep[:t_total]


MOE_CASES = [
    # arch, dtype, tokens, capacity factor: olmoe's own routing at d 128
    # (top-8 of 64, tpg 256) and mixtral's (top-2 of 8, tpg 1024)
    ("olmoe-1b-7b", "float32", 256, 0.5),
    ("olmoe-1b-7b", "bfloat16", 256, 1.0),
    ("olmoe-1b-7b", "float32", 600, 1.0),    # 3 groups, 168 pad rows
    ("olmoe-1b-7b", "bfloat16", 600, 0.5),
    ("mixtral-8x22b", "float32", 2048, 0.5),  # 2 groups
    ("mixtral-8x22b", "float32", 1200, 1.0),  # 848 pad rows
    ("mixtral-8x22b", "bfloat16", 1200, 1.0),
]


@pytest.mark.parametrize("arch,dtype,tokens,cf", MOE_CASES)
def test_capacity_path_matches_jax(arch, dtype, tokens, cf):
    """The same routing, the same tokens dropped, and the layer's output
    within the dtype's bound; some tokens are dropped in every case."""
    ref_cfg, cfg = _configs(arch, d_model=128, d_ff=64, dtype=dtype,
                            capacity_factor=cf)
    tree = ref_moe.moe_init(jax.random.PRNGKey(tokens), ref_cfg)
    layer = moe.MoE(cfg, "cpu")
    for name, t in layer.named_parameters():
        t.copy_(_leaf(tree[name]))
    assert layer.router.dtype == torch.float32
    x = np.random.default_rng(tokens).normal(
        size=(2, tokens // 2, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(ref_cfg.dtype)
    xt = _t(x).to(getattr(torch, dtype))

    gates, idx = moe._router(layer, xt.reshape(-1, cfg.d_model), cfg)
    ref_gates, ref_idx = ref_moe._router(tree, xj.reshape(-1, cfg.d_model),
                                         ref_cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(ref_gates),
                               **MOE_TOL["float32"])
    got, keep = moe.capacity_from_routing(layer, xt, gates, idx, cfg)
    tpg = moe.tokens_per_group(cfg, tokens)
    np.testing.assert_array_equal(keep.numpy(),
                                  _keep_oracle(idx.numpy(), cfg, tpg))
    assert 0 < int((~keep).sum()) < keep.numel()
    want = jax.jit(ref_moe.moe_apply_capacity, static_argnums=2)(
        tree, xj, ref_cfg)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **MOE_TOL[dtype])
    assert torch.equal(moe.moe_apply(layer, xt, cfg), got)


def test_padding_takes_expert_zero_slots():
    """Pad rows route to expert 0 for all k choices. At top-2 of 8 with
    T = 1,200 (tpg 1,024, capacity 320), the second group holds 176 real
    rows and 848 pad rows: the pads' first choices fill expert 0 before
    any real second choice, so the 154 real second choices of expert 0
    there drop (176 would fit without the pads)."""
    _, cfg = _configs("mixtral-8x22b", d_model=128, d_ff=64,
                      dtype="float32")
    assert moe.capacity(cfg, 1024) == 320
    idx = np.zeros((1200, 2), np.int64)
    idx[:, 0] = np.arange(1200) % 8
    idx[np.arange(1200) % 8 == 0, 1] = 1
    layer = moe.MoE(cfg, "cpu")
    layer.init_(torch.Generator().manual_seed(0))
    x = torch.randn((1, 1200, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    gates = torch.full((1200, 2), 0.5)
    _, keep = moe.capacity_from_routing(layer, x, gates, _t(idx), cfg)
    np.testing.assert_array_equal(keep.numpy(), _keep_oracle(idx, cfg, 1024))
    g1 = slice(1024, 1200)
    assert keep[g1, 0].all()
    assert not keep[g1, 1][_t(idx[g1, 1] == 0)].any()
    assert keep[g1, 1][_t(idx[g1, 1] == 1)].all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_path_and_switch_match_jax(dtype):
    """moe_apply_dense at S = 1 (every decode step), and moe_apply's
    switch: one token a sequence takes the dense path, longer ones the
    capacity path unless ``impl="dense"``."""
    ref_cfg, cfg = _configs("olmoe-1b-7b", d_model=128, d_ff=64,
                            dtype=dtype, capacity_factor=0.5)
    tree = ref_moe.moe_init(jax.random.PRNGKey(5), ref_cfg)
    layer = moe.MoE(cfg, "cpu")
    for name, t in layer.named_parameters():
        t.copy_(_leaf(tree[name]))
    x = np.random.default_rng(5).normal(size=(6, 40, cfg.d_model)).astype(
        np.float32)
    xj = jnp.asarray(x).astype(ref_cfg.dtype)
    xt = _t(x).to(getattr(torch, dtype))
    ref_dense = jax.jit(ref_moe.moe_apply_dense, static_argnums=2)
    for sl in (slice(0, 1), slice(None)):  # S = 1, then S = 40
        got = moe.moe_apply_dense(layer, xt[:, sl], cfg)
        want = ref_dense(tree, xj[:, sl], ref_cfg)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **MOE_TOL[dtype])
        assert torch.equal(moe.moe_apply(layer, xt[:, sl], cfg, impl="dense"),
                           got)
    assert torch.equal(moe.moe_apply(layer, xt[:, :1], cfg),
                       moe.moe_apply_dense(layer, xt[:, :1], cfg))
    capacity = moe.moe_apply(layer, xt, cfg)
    assert torch.equal(capacity, moe.moe_apply_capacity(layer, xt, cfg))
    assert not torch.equal(capacity, got)  # cf 0.5 drops
    with pytest.raises(ValueError, match="impl"):
        moe.moe_apply(layer, xt, cfg, impl="gshard")


def test_router_breaks_ties_toward_the_lower_expert():
    _, cfg = _configs("olmoe-1b-7b", d_model=4, n_experts=8, top_k=3,
                      dtype="float32")
    layer = moe.MoE(cfg, "cpu")
    layer.router.zero_()
    layer.router[0, [1, 5, 6]] = 1.0
    x = torch.tensor([[1.0, 0, 0, 0], [0, 0, 0, 0]])
    gates, idx = moe._router(layer, x, cfg)
    assert idx.tolist() == [[1, 5, 6], [0, 1, 2]]
    assert torch.allclose(gates, torch.full((2, 3), 1 / 3))


def _models(arch):
    cfg = registry.smoke_config(registry.get_config(arch))
    ref_cfg = ref_registry.smoke_config(ref_registry.get_config(arch))
    ref_params = ref_registry.get_model(ref_cfg).init_params(
        jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return cfg, ref_cfg, ref_params, params


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x22b"])
def test_prefill_and_decode_logits_match(arch):
    """Smoke width (8 experts, top-2): the prefill's capacity path and
    the decode steps' dense path; mixtral's window 16 drives the ring
    cache (a 20-token prompt, decode past the ring's wrap)."""
    cfg, ref_cfg, ref_params, params = _models(arch)
    assert isinstance(params.layers[0].moe, moe.MoE)
    assert not hasattr(params.layers[0], "mlp")
    ref_api, api = ref_registry.get_model(ref_cfg), registry.get_model(cfg)
    b, s, n_steps = 2, 20, 3
    tokens = np.random.default_rng(11).integers(
        0, cfg.vocab, (b, s + n_steps)).astype(np.int32)
    want, ref_cache = ref_api.prefill(ref_params, jnp.asarray(tokens[:, :s]),
                                      max_len=s + n_steps)
    got, cache = api.prefill(params, _t(tokens[:, :s]), max_len=s + n_steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                  np.asarray(ref_cache["kv_pos"]))
    assert cache["k"].shape[2] == (16 if cfg.sliding_window else s + n_steps)
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


@pytest.fixture(scope="module")
def olmoe():
    return _models("olmoe-1b-7b")


def test_paged_model_matches_jax(olmoe):
    """olmoe's paged_prefill, a compaction and paged_decode_step on the
    same manager decisions as the JAX package's paged model."""
    cfg, ref_cfg, ref_params, params = olmoe
    b, s, page, n_blocks, max_pages = 2, 20, 8, 48, 6
    tokens = np.random.default_rng(3).integers(
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
    for ci in (2, 3, 5, 9, 10, 11, 17):
        mgr.evict_token(1, ci)
    assert mgr.gc_group(0) > 0
    moves = mgr.drain_moves()
    ref_pools = ref_pm.apply_moves(ref_pools, moves)
    pools = paged_model.apply_moves(pools, moves)
    for name in ("k", "v"):
        np.testing.assert_allclose(pools[name].numpy(),
                                   np.asarray(ref_pools[name]), **TOL)
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


def _engine_run(eng, mod, vocab, n_requests, max_new, token_seed=0):
    lists = _recording(eng.manager)
    rng = np.random.default_rng(token_seed)
    reqs = [mod.Request(rid=rid, prompt=rng.integers(0, vocab, 12).astype(
        np.int32), max_new=max_new, policy=["append", "h2o:50",
                                            "window:16"][rid % 3])
            for rid in range(n_requests)]
    for r in reqs:
        eng.submit(r)
    summary = eng.run_until_drained(max_steps=400)
    eng.manager.check_invariants()
    return summary, lists, [r.out for r in reqs], len(eng.manager.free)


# a pool tight enough that the h2o churn compacts within 4 requests
ENGINE = dict(n_blocks=24, page=8, max_pages_per_seq=16, max_batch=4)


def test_engine_matches_jax_engine(olmoe):
    """olmoe through both engines with a pool tight enough to compact
    (three move lists): the same move lists, counters and generated
    tokens, every block free at the end."""
    cfg, ref_cfg, _, params = olmoe
    eng = engine.ServingEngine(cfg, device="cpu", **ENGINE)
    eng.params = params  # the JAX engine's weights (PRNGKey(0))
    want = _engine_run(ref_engine.ServingEngine(ref_cfg, **ENGINE),
                       ref_engine, cfg.vocab, 4, 48)
    got = _engine_run(eng, engine, cfg.vocab, 4, 48)
    assert got == want
    assert len(got[1]) == 3 and got[3] == ENGINE["n_blocks"]


def test_engine_control_plane_does_not_depend_on_the_model():
    """The manager never sees the model: a dense and an MoE engine, fed
    other prompt tokens, take the same steps and make the same copies and
    move lists (so a card run of one arch can be held to another arch's
    CPU run of the same request set)."""
    runs = []
    for arch, token_seed in (("internlm2-1.8b", 0), ("olmoe-1b-7b", 1)):
        cfg = registry.smoke_config(registry.get_config(arch))
        eng = engine.ServingEngine(cfg, device="cpu", **ENGINE)
        summary, lists, outs, free = _engine_run(
            eng, engine, cfg.vocab, 8, 48, token_seed)
        runs.append((summary, lists, free))
        assert outs[0] and len(outs[0]) == 48
    assert runs[0] == runs[1] and runs[0][0]["copied"] > 0


def test_params_roundtrip_bf16_with_fp32_router():
    cfg = dataclasses.replace(
        registry.smoke_config(registry.get_config("olmoe-1b-7b")),
        dtype="bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, ref_registry.get_model(
        cfg).init_params(jax.random.PRNGKey(0)))
    assert set(tree["layers"]["moe"]) == {"router", "wi_gate", "wi_up", "wo"}
    params = convert.params_from_numpy(tree, cfg, "cpu")
    block = params.layers[1]
    assert block.moe.router.dtype == torch.float32
    assert block.moe.wi_gate.dtype == torch.bfloat16
    assert block.moe.wi_gate.shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert block.moe.wo.shape == (cfg.n_experts, cfg.d_ff, cfg.d_model)
    back = convert.params_to_numpy(params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.astype(np.float32),
                                      b.astype(np.float32))
    # dtypes are checked, never cast: a bf16 router is refused
    tree["layers"]["moe"]["router"] = tree["layers"]["moe"]["router"].astype(
        tree["layers"]["moe"]["wo"].dtype)
    with pytest.raises(TypeError, match="router"):
        convert.params_from_numpy(tree, cfg, "cpu")


def test_init_statistics():
    """The router's fan-in is d (axis 0), the experts' axis 1; every
    leaf truncated at ±2σ; the router in fp32 under a bf16 model."""
    cfg = dataclasses.replace(
        registry.smoke_config(registry.get_config("olmoe-1b-7b")),
        d_ff=96, dtype="bfloat16")
    params = transformer.init_params(torch.Generator().manual_seed(2), cfg)
    layer = params.layers[0].moe
    assert layer.router.dtype == torch.float32
    for t, fan_in in ((layer.router, cfg.d_model), (layer.wi_gate,
                      cfg.d_model), (layer.wo, cfg.d_ff)):
        sigma = fan_in ** -0.5
        w = t.float()
        assert w.abs().max() <= 2 * sigma * (1 + 2 ** -7)
        assert abs(w.std().item() / sigma - 0.880) < 0.03


def test_launcher_serves_the_moe_and_vlm_archs():
    """``--arch`` takes the new archs; the drained line is the control
    plane's, so it equals the dense arch's (held to the JAX launcher in
    tests/test_torch_serving.py)."""
    argv = ["--requests", "4", "--max-new", "6", "--prompt-len", "8",
            "--blocks", "96", "--page", "8", "--device", "cpu"]
    lines = []
    for arch in ("internlm2-1.8b", "olmoe-1b-7b", "mixtral-8x22b",
                 "llava-next-34b"):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert serve.main(argv + ["--arch", arch]) == 0
        lines.append(buf.getvalue().strip().splitlines()[-1])
    assert lines[0].startswith("drained: steps=")
    assert lines == [lines[0]] * 4

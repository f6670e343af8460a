"""The port's Wolf-KV serving path against the JAX package's: the plain
versions of paged attention and KV compaction, the paged decoder, the
serving engine and its launcher.

Inputs are made from a seed with numpy; model parameters are the JAX
package's ``init_params`` carried across with ``convert.params_from_numpy``.
The JAX side runs as its own tests run it on the CPU (Pallas kernels in
interpret mode). Attention and logits are compared in fp32 within the JAX
package's own bounds; compaction and the control plane exactly.
"""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gc_compact.kernel import gc_compact as ref_gc_kernel
from repro.kernels.gc_compact.ref import gc_compact_ref as ref_gc_ref
from repro.kernels.paged_attention.kernel import (
    paged_attention as ref_paged_kernel,
)
from repro.kernels.paged_attention.ref import paged_attention_ref as ref_paged
from repro.launch import serve as ref_serve
from repro.models import registry as ref_registry
from repro.serving import engine as ref_engine
from repro.serving import paged_model as ref_pm
from repro_torch import convert
from repro_torch.kernels.gc_compact import ops as gc_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kvcache.manager import WolfKVManager
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.serving import engine, paged_model

ATTN_TOL = dict(atol=2e-5, rtol=2e-5)  # one attention call in fp32
TOL = dict(atol=1e-4, rtol=1e-4)       # logits after a stack of layers
DENSE_TOL = dict(atol=2e-3, rtol=2e-3)  # paged vs dense (test_wolf_kv.py)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def model():
    """internlm2-1.8b at smoke width: the JAX params and the port's copy."""
    cfg = registry.smoke_config(registry.get_config("internlm2-1.8b"))
    ref_cfg = ref_registry.smoke_config(
        ref_registry.get_config("internlm2-1.8b"))
    ref_params = ref_registry.get_model(ref_cfg).init_params(
        jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return cfg, ref_cfg, ref_params, params


def _paged_case(b, hq, hkv, d, n, p, m, seed, holes):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, hq, d)) * 0.5).astype(np.float32)
    kp = (rng.normal(size=(n, p, hkv, d)) * 0.5).astype(np.float32)
    vp = (rng.normal(size=(n, p, hkv, d)) * 0.5).astype(np.float32)
    lengths = rng.integers(1, m * p + 1, b).astype(np.int32)
    tables = np.full((b, m), -1, np.int32)
    for i in range(b):
        npages = -(-int(lengths[i]) // p)
        tables[i, :npages] = rng.choice(n, npages, replace=False)
    valid = np.ones((b, m, p), np.int8)
    if holes:
        valid = (rng.random((b, m, p)) < 0.7).astype(np.int8)
        for i in range(b):  # the newest token is always valid
            t = int(lengths[i]) - 1
            valid[i, t // p, t % p] = 1
            # an unallocated page inside the length (a freed page)
            if t // p >= 2:
                tables[i, 0] = -1
    return q, kp, vp, tables, lengths, valid


@pytest.mark.parametrize("holes", [False, True], ids=["dense", "holes"])
@pytest.mark.parametrize("b,hq,hkv,d,n,p,m", [
    (2, 4, 4, 64, 16, 16, 4),   # MHA
    (4, 8, 2, 64, 32, 16, 6),   # GQA
    (2, 8, 1, 128, 16, 32, 3),  # MQA, d 128
    (3, 4, 2, 32, 24, 8, 8),    # long table, d 32
])
def test_paged_attention_plain_matches_reference_and_kernel(
        b, hq, hkv, d, n, p, m, holes):
    q, kp, vp, tables, lengths, valid = _paged_case(
        b, hq, hkv, d, n, p, m, seed=b * m + d, holes=holes)
    got = paged_ops.paged_attention(*map(_t, (q, kp, vp, tables, lengths,
                                              valid))).numpy()
    want = ref_paged(q, kp, vp, tables, lengths, valid)
    np.testing.assert_allclose(got, np.asarray(want), **ATTN_TOL)
    kern = ref_paged_kernel(q, kp, vp, tables, lengths, valid,
                            interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **ATTN_TOL)


@pytest.mark.parametrize("seed", range(4))
def test_gc_compact_plain_matches_reference_and_kernel(seed):
    """Overlapping source and destination sets; exact equality. No real
    move targets slot (0, 0): the JAX oracle writes a no-op row there."""
    rng = np.random.default_rng(seed)
    n, p, h, d = 12, 8, 2, 64
    m = int(rng.integers(8, 40))
    kp = rng.normal(size=(n, p, h, d)).astype(np.float32)
    vp = rng.normal(size=(n, p, h, d)).astype(np.float32)
    src = rng.choice(n * p, m, replace=False)
    dst = 1 + rng.choice(n * p - 1, m, replace=False)
    assert len(set(src) & set(dst)) > 0
    sb = np.where(rng.random(m) < 0.2, -1, src // p).astype(np.int32)
    moves = [sb, (src % p).astype(np.int32), (dst // p).astype(np.int32),
             (dst % p).astype(np.int32)]
    got_k, got_v = _t(kp)[None], _t(vp)[None]  # one layer
    gc_ops.gc_compact_(got_k, got_v, torch.from_numpy(np.stack(moves, 1)))
    j = [jnp.asarray(x) for x in (kp, vp, *moves)]
    for want_k, want_v in (ref_gc_ref(*j), ref_gc_kernel(*j, interpret=True)):
        np.testing.assert_array_equal(got_k[0].numpy(), np.asarray(want_k))
        np.testing.assert_array_equal(got_v[0].numpy(), np.asarray(want_v))


def test_gc_compact_refuses_moves_outside_the_pool():
    pools = torch.zeros((2, 4, 8, 2, 32)), torch.zeros((2, 4, 8, 2, 32))
    for row in ([0, 0, 4, 0], [0, 8, 1, 0], [1, -2, 1, 0]):
        with pytest.raises(IndexError, match="outside a pool"):
            gc_ops.gc_compact_(*pools, torch.tensor([row], dtype=torch.int32))
    with pytest.raises(ValueError, match="host int32"):
        gc_ops.gc_compact_(*pools, torch.zeros((1, 4), dtype=torch.int64))
    # a no-op row is not checked
    gc_ops.gc_compact_(*pools, torch.tensor([[-1, 99, 99, 99]],
                                            dtype=torch.int32))


def _reserve(mgr, n_seqs, n_tokens):
    wb = np.zeros((n_seqs, n_tokens), np.int32)
    ws = np.zeros((n_seqs, n_tokens), np.int32)
    for i in range(n_seqs):
        mgr.add_sequence(i, 0)
        for t in range(n_tokens):
            wb[i, t], ws[i, t] = mgr.append_token(i)
    return wb, ws


def _decode_inputs(mgr, seqs, max_pages):
    wb = np.zeros(len(seqs), np.int32)
    ws = np.zeros(len(seqs), np.int32)
    for j, sid in enumerate(seqs):
        wb[j], ws[j] = mgr.append_token(sid)
    tables = np.stack([mgr.block_table(s, max_pages) for s in seqs])
    valid = np.stack([mgr.slot_valid(s, max_pages) for s in seqs])
    lengths = np.asarray([mgr.cache_len(s) for s in seqs], np.int32)
    return tables, valid.astype(np.int8), lengths, wb, ws


def test_paged_model_matches_jax(model):
    """paged_prefill, paged_decode_step and apply_moves on the same manager
    decisions: logits within 1e-4, pools moved identically."""
    cfg, ref_cfg, ref_params, params = model
    b, s, page, n_blocks, max_pages = 2, 20, 8, 48, 6
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab, (b, s + 2)).astype(np.int32)
    mgr = WolfKVManager(n_blocks, page, 1, adaptive=False)
    wb, ws = _reserve(mgr, b, s)
    ref_pools = ref_pm.init_pools(ref_cfg, n_blocks, page)
    pools = paged_model.init_pools(cfg, n_blocks, page, "cpu")
    want, ref_pools = ref_pm.paged_prefill(
        ref_params, ref_cfg, ref_pools, jnp.asarray(tokens[:, :s]),
        jnp.asarray(wb), jnp.asarray(ws))
    got, pools = paged_model.paged_prefill(
        params, cfg, pools, _t(tokens[:, :s]), _t(wb), _t(ws))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(pools[name].numpy(),
                                   np.asarray(ref_pools[name]), **TOL)

    for ci in (2, 3, 5, 9, 10, 11, 17):  # scattered holes in sequence 1
        mgr.evict_token(1, ci)
    assert mgr.gc_group(0) > 0
    moves = mgr.drain_moves()
    ref_pools = ref_pm.apply_moves(ref_pools, moves)
    same = {k: _t(v) for k, v in ref_pm.apply_moves(
        {k: jnp.asarray(v.numpy()) for k, v in pools.items()},
        moves).items()}
    pools = paged_model.apply_moves(pools, moves)
    for name in ("k", "v"):  # the same pools, moved by both: exact
        np.testing.assert_array_equal(pools[name].numpy(),
                                      same[name].numpy())

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


def test_paged_decode_matches_dense(model):
    """The port's paged path against its own dense path (the counterpart of
    test_wolf_kv.py::test_decode_matches_dense)."""
    cfg, _, _, params = model
    api = registry.get_model(cfg)
    b, s_prompt, n_steps = 2, 12, 3
    page, n_blocks, max_pages = 8, 64, 8
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, (b, s_prompt + n_steps)).astype(np.int32)
    want, cache = api.prefill(params, _t(tokens[:, :s_prompt]),
                              max_len=s_prompt + n_steps)
    mgr = WolfKVManager(n_blocks, page, 1)
    wb, ws = _reserve(mgr, b, s_prompt)
    got, pools = paged_model.paged_prefill(
        params, cfg, paged_model.init_pools(cfg, n_blocks, page, "cpu"),
        _t(tokens[:, :s_prompt]), _t(wb), _t(ws))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **DENSE_TOL)
    for i in range(n_steps):
        pos = _t(np.full(b, s_prompt + i, np.int32))
        want, cache = api.decode_step(params, cache,
                                      _t(tokens[:, s_prompt + i]), pos)
        tables, valid, lengths, wb1, ws1 = _decode_inputs(
            mgr, range(b), max_pages)
        got, pools = paged_model.paged_decode_step(
            params, cfg, pools, *map(_t, (tables, valid, lengths, wb1, ws1,
                                          tokens[:, s_prompt + i])), pos)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **DENSE_TOL)


def test_compaction_preserves_logits(model):
    """Evict, compact (gc_compact moves the pool), decode: equal to a dense
    run with the evicted positions masked (the counterpart of
    test_wolf_kv.py::test_compaction_preserves_logits)."""
    cfg, _, _, params = model
    api = registry.get_model(cfg)
    page, n_blocks, max_pages, s_prompt = 8, 64, 8, 24
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab, (1, s_prompt + 1)).astype(np.int32)
    mgr = WolfKVManager(n_blocks, page, 1, adaptive=False)
    wb, ws = _reserve(mgr, 1, s_prompt)
    _, pools = paged_model.paged_prefill(
        params, cfg, paged_model.init_pools(cfg, n_blocks, page, "cpu"),
        _t(tokens[:, :s_prompt]), _t(wb), _t(ws))
    evicted = [3, 4, 5, 6, 7, 11, 13]
    for ci in evicted:
        mgr.evict_token(0, ci)
    assert mgr.gc_group(0) > 0
    pools = paged_model.apply_moves(pools, mgr.drain_moves())
    mgr.check_invariants()
    pos = _t(np.asarray([s_prompt], np.int32))
    tables, valid, lengths, wb1, ws1 = _decode_inputs(mgr, [0], max_pages)
    got, _ = paged_model.paged_decode_step(
        params, cfg, pools, *map(_t, (tables, valid, lengths, wb1, ws1,
                                      tokens[:, s_prompt])), pos)
    _, cache = api.prefill(params, _t(tokens[:, :s_prompt]),
                           max_len=s_prompt + 1)
    cache["kv_pos"][:, evicted] = -1
    want, _ = api.decode_step(params, cache, _t(tokens[:, s_prompt]), pos)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **DENSE_TOL)


def _recording(mgr):
    """Record every non-empty move list the manager hands out."""
    lists = []
    drain = mgr.drain_moves

    def recorded():
        moves = drain()
        if moves:
            lists.append(list(moves))
        return moves

    mgr.drain_moves = recorded
    return lists


@pytest.mark.parametrize("n_blocks,n_requests,max_new", [
    (128, 6, 20),  # test_wolf_kv.py::TestEngine's setup (never compacts)
    (48, 8, 48),   # a pool tight enough that h2o churn compacts
], ids=["test_wolf_kv", "tight"])
def test_engine_matches_jax_engine(model, n_blocks, n_requests, max_new):
    """The same requests through both engines: the same move lists,
    counters and generated tokens, and every block free at the end."""
    cfg, ref_cfg, ref_params, params = model
    kw = dict(n_blocks=n_blocks, page=8, max_pages_per_seq=16, max_batch=4)
    ref_eng = ref_engine.ServingEngine(ref_cfg, **kw)
    eng = engine.ServingEngine(cfg, device="cpu", **kw)
    eng.params = params  # the JAX engine's weights (PRNGKey(0))
    runs = []
    for e, mod in ((ref_eng, ref_engine), (eng, engine)):
        lists = _recording(e.manager)
        rng = np.random.default_rng(0)
        reqs = []
        for rid in range(n_requests):
            reqs.append(mod.Request(
                rid=rid, prompt=rng.integers(0, cfg.vocab, 12).astype(
                    np.int32),
                max_new=max_new,
                policy=["append", "h2o:50", "window:16"][rid % 3]))
            e.submit(reqs[-1])
        summary = e.run_until_drained(max_steps=400)
        e.manager.check_invariants()
        runs.append((summary, lists, [r.out for r in reqs],
                     len(e.manager.free)))
    assert runs[1] == runs[0]
    summary, lists, _, free = runs[1]
    assert free == n_blocks
    assert (summary["copied"] > 0) == (n_blocks == 48)
    assert sum(map(len, lists)) == summary["copied"]


def test_engine_step_reports_its_move_lists_and_logits(model):
    """Each step returns the batch's logits and the non-empty move lists
    it applied, admissions included: together, every list the manager
    handed out, in order."""
    cfg, _, _, params = model
    eng = engine.ServingEngine(cfg, n_blocks=48, page=8, max_pages_per_seq=16,
                               max_batch=4, device="cpu")
    eng.params = params
    recorded = _recording(eng.manager)
    rng = np.random.default_rng(0)
    for rid in range(8):
        eng.submit(engine.Request(
            rid=rid, prompt=rng.integers(0, cfg.vocab, 12).astype(np.int32),
            max_new=48, policy=["append", "h2o:50", "window:16"][rid % 3]))
    reported = []
    while eng.running or eng.queue:
        batch = len(eng.running)
        admitted = eng.admit()
        info = eng.step()  # its own admission finds no room
        assert info["logits"].shape == (batch + admitted, cfg.vocab)
        assert bool(torch.isfinite(info["logits"]).all())
        reported.extend(info["move_lists"])
    assert reported == recorded and len(recorded) > 0


def test_launcher_drains_on_cpu():
    """The default arch, then the three families served as the JAX
    engine serves them (a transformer over the config): the same
    ``drained:`` line from both launchers."""
    runs = [["--requests", "4", "--max-new", "6", "--prompt-len", "8",
             "--blocks", "96", "--page", "8"]]
    runs += [["--arch", arch, "--requests", "3", "--max-new", "4"]
             for arch in ("xlstm-125m", "hymba-1.5b", "whisper-large-v3")]
    for argv in runs:
        outs = []
        for main, extra in ((ref_serve.main, []), (serve.main,
                                                   ["--device", "cpu"])):
            buf = io.StringIO()
            with redirect_stdout(buf):
                assert main(argv + extra) == 0
            outs.append(buf.getvalue().strip().splitlines()[-1])
        assert outs[1].startswith("drained: steps=")
        assert outs[1] == outs[0]

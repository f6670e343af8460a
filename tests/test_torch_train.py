"""The port's training substrate against the JAX package's: the learning
rate schedule, AdamW (``train/optimizer.py``), the chunked cross-entropy,
internlm2's loss and gradients, the microbatched step
(``train/train_loop.py``) and the token stream (``data/pipeline.py``).

Inputs are made from a seed with numpy; model parameters are the JAX
package's ``init_params`` carried across with ``convert.params_from_numpy``,
which also puts the JAX gradients in the port's layout (the per-arch
files draw theirs with ``numpy_params``). Bounds: the
schedule within 1e-7 of the peak rate; AdamW's m, v, master and params and the
gradient norm within 1e-6 (relative to each leaf's largest value); the loss
within 1e-5 relative and every gradient within 1e-4 of its leaf's largest
value; params after three steps within 1e-5. The JAX package sums the
gradient norm over its leaves in sorted-key order and over layer-stacked
leaves, the port leaf by leaf in parameter order: the two differ in the
last bits only (``test_adamw_update_matches``).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as RefShape
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import TokenStream as RefTokenStream
from repro.models import common as ref_common
from repro.models import registry as ref_registry
from repro.train import optimizer as ref_opt
from repro.train import train_loop as ref_loop
from repro_torch import convert
from repro_torch.data.pipeline import DataConfig, TokenStream, to_device
from repro_torch.models import common
from repro_torch.models import registry
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop

ARCH = "internlm2-1.8b"
BATCH, SEQ = 4, 32


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol):
    """Within ``tol`` of the larger of 1 and want's largest magnitude."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _leaf_close(got, want, tol):
    """Within ``tol`` of want's own largest magnitude (gradients)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale + 1e-30)


def _port_tree(tree, cfg):
    """A JAX params-shaped tree as the port's {name: tensor}."""
    module = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), cfg, "cpu")
    return dict(module.named_parameters())


def numpy_params(ref_api, seed):
    """The JAX package's parameter tree with values drawn from ``seed`` with
    numpy: each leaf's shape and dtype from ``jax.eval_shape`` of its
    ``init_params`` (no init is compiled), each value near what that init
    gives the leaf: norm scales and Mamba's skip D about 1, biases about
    0, xLSTM's forget-gate bias about 3, Mamba's ``a_log`` and ``dt_bias``
    over the init's ranges, every other leaf normal with std
    d_model^-1/2."""
    rng = np.random.default_rng(seed)
    std = ref_api.cfg.d_model ** -0.5

    def draw(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        noise = rng.normal(size=shape)
        if name in ("scale", "d_skip"):
            v = 1 + 0.1 * noise
        elif name == "f_bias":
            v = 3 + 0.1 * noise
        elif name == "a_log":
            v = np.log(rng.uniform(1, 16, shape))
        elif name == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
            v = dt + np.log(-np.expm1(-dt))
        elif name.endswith("bias"):
            v = 0.1 * noise
        else:
            v = std * noise
        return jnp.asarray(v, leaf.dtype)

    shapes = jax.eval_shape(ref_api.init_params, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def model():
    cfg = registry.smoke_config(registry.get_config(ARCH))
    ref_cfg = ref_registry.smoke_config(ref_registry.get_config(ARCH))
    ref_api = ref_registry.get_model(ref_cfg)
    ref_params = jax.jit(ref_api.init_params)(jax.random.PRNGKey(0))
    return cfg, ref_cfg, registry.get_model(cfg), ref_api, ref_params


def _batch(cfg, step=0, batch=BATCH, seq=SEQ):
    return TokenStream(DataConfig(cfg.vocab, seq, batch, seed=3)).batch(step)


# -- optimizer ------------------------------------------------------------------

def test_lr_schedule_matches():
    cfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    ref_cfg = ref_opt.OptimizerConfig(lr=1e-3, warmup_steps=10,
                                      total_steps=100)
    for s in range(121):
        got = float(opt.lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
        want = float(ref_opt.lr_schedule(ref_cfg, jnp.asarray(s, jnp.int32)))
        assert abs(got - want) <= 1e-7 * cfg.lr, (s, got, want)


def test_adamw_update_matches():
    """One step from a state two steps in, on a random tree with an fp32
    and a bf16 leaf: m, v, master, the re-cast params, the gradient norm
    and the rate."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (33,), "c": (4, 3, 2)}
    dtypes = {"a": np.float32, "b": ml_dtypes.bfloat16, "c": np.float32}
    params = {k: rng.normal(size=s).astype(np.float32).astype(dtypes[k])
              for k, s in shapes.items()}
    grads = {k: (rng.normal(size=s) * 3).astype(np.float32)
             for k, s in shapes.items()}
    state = {f: {k: rng.normal(size=s).astype(np.float32) * sc
                 for k, s in shapes.items()}
             for f, sc in (("m", 0.1), ("v", 0.0), ("master", 1.0))}
    state["v"] = {k: np.abs(rng.normal(size=s)).astype(np.float32) * 0.01
                  for k, s in shapes.items()}
    cfg = opt.OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=50,
                              grad_clip=1.0)
    ref_cfg = ref_opt.OptimizerConfig(lr=1e-2, warmup_steps=2,
                                      total_steps=50, grad_clip=1.0)

    ref_state = {f: {k: jnp.asarray(v) for k, v in d.items()}
                 for f, d in state.items()}
    ref_state["count"] = jnp.asarray(2, jnp.int32)
    ref_p, ref_new, ref_metrics = ref_opt.adamw_update(
        {k: jnp.asarray(v) for k, v in grads.items()}, ref_state,
        {k: jnp.asarray(v) for k, v in params.items()}, ref_cfg)

    def t(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())

    p = {k: t(v) for k, v in params.items()}
    st = {f: {k: t(v) for k, v in d.items()} for f, d in state.items()}
    st["count"] = torch.tensor(2, dtype=torch.int32)
    metrics = opt.adamw_update({k: t(v) for k, v in grads.items()}, st, p,
                               cfg)
    assert int(st["count"]) == int(ref_new["count"]) == 3
    for k in shapes:
        for f in ("m", "v", "master"):
            _close(st[f][k].numpy(), ref_new[f][k], 1e-6)
        assert p[k].dtype == (torch.bfloat16 if k == "b" else torch.float32)
        _close(_np(p[k]), np.asarray(ref_p[k], np.float32), 1e-6)
    gn, ref_gn = float(metrics["grad_norm"]), float(ref_metrics["grad_norm"])
    assert gn > cfg.grad_clip  # reported before clipping, and clipped
    assert abs(gn - ref_gn) <= 1e-6 * ref_gn
    assert float(metrics["lr"]) == pytest.approx(float(ref_metrics["lr"]),
                                                 rel=1e-7)


def test_adamw_reduces_quadratic():
    """The JAX package's case: AdamW drives w to 0 on |w|^2."""
    params = {"w": torch.tensor([3.0, -2.0, 5.0])}
    state = opt.adamw_init(params)
    cfg = opt.OptimizerConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                              total_steps=200)
    for _ in range(150):
        opt.adamw_update({"w": 2 * params["w"]}, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.1


def test_grad_clip_reports_norm_before_clipping():
    """The JAX package's case: a 1e6 gradient is clipped to norm 1 but
    reported whole."""
    params = {"w": torch.zeros(3)}
    state = opt.adamw_init(params)
    cfg = opt.OptimizerConfig(lr=1.0, grad_clip=1.0, warmup_steps=0,
                              weight_decay=0.0)
    metrics = opt.adamw_update({"w": torch.tensor([1e6, 0.0, 0.0])}, state,
                               params, cfg)
    assert float(metrics["grad_norm"]) > 1e5
    assert float(state["m"]["w"][0]) == pytest.approx(0.1, rel=1e-6)


# -- loss and gradients -------------------------------------------------------------

def test_chunked_xent_loss_matches(model):
    """S = 600: a full chunk of 512 and a padded one, with -1 labels in
    both; the loss and its gradients in x and the unembedding."""
    cfg, ref_cfg, _, _, ref_params = model
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 600, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (2, 600)).astype(np.int32)
    labels[rng.random((2, 600)) < 0.2] = -1
    emb_tree = jax.tree_util.tree_map(np.asarray, ref_params["embedding"])

    def ref_loss(emb, x):
        return ref_common.chunked_xent_loss(emb, x, jnp.asarray(labels),
                                            ref_cfg)

    ref_l, (ref_ge, ref_gx) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        emb_tree, jnp.asarray(x))
    emb = common.Embedding(cfg, "cpu")
    with torch.no_grad():
        emb.embed.copy_(torch.from_numpy(emb_tree["embed"].copy()))
        emb.unembed.copy_(torch.from_numpy(emb_tree["unembed"].copy()))
    emb.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = common.chunked_xent_loss(emb, xt, torch.from_numpy(labels))
    gx, gu = torch.autograd.grad(loss, [xt, emb.unembed])
    assert abs(loss.item() - float(ref_l)) <= 1e-5 * abs(float(ref_l))
    _leaf_close(gx.numpy(), ref_gx, 1e-4)
    _leaf_close(gu.numpy(), ref_ge["unembed"], 1e-4)


def test_internlm2_loss_and_grads_match(model):
    """internlm2 at smoke_config: loss within 1e-5 relative, every gradient
    leaf within 1e-4 of its largest value, against jax.value_and_grad."""
    cfg, _, api, ref_api, ref_params = model
    batch = _batch(cfg)
    ref_l, ref_g = jax.jit(jax.value_and_grad(ref_api.loss_fn))(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    state = train_loop.state_from_params(convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu"))
    loss, grads = train_loop.value_and_grad(api, state["params"],
                                            to_device(batch, "cpu"))
    assert abs(float(loss) - float(ref_l)) <= 1e-5 * abs(float(ref_l))
    want = _port_tree(ref_g, cfg)
    assert list(grads) == list(want)
    for k, g in grads.items():
        assert torch.isfinite(g).all(), k
        _leaf_close(g.numpy(), _np(want[k]), 1e-4)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_three_steps_match_jax(model, n_micro):
    """Three AdamW steps through make_train_step, microbatched or not,
    against the JAX package's: each step's loss and gradient norm within
    1e-5 relative, then params within 1e-5 and the first moment within
    1e-4 of each leaf's largest value. Adam divides by sqrt(v), so an
    element whose gradient lies near the rounding noise moves by a share
    of the rate in one framework and not the other: at lr 1e-3 one element
    of 65,536 differs by 3.2e-5, at 3e-4 by 9.7e-6; at 1e-4, here, the
    bound has three times that room."""
    cfg, _, api, ref_api, ref_params = model
    ocfg = dict(lr=1e-4, warmup_steps=0, total_steps=20)
    tcfg = train_loop.TrainConfig(opt=opt.OptimizerConfig(**ocfg),
                                  n_microbatches=n_micro)
    ref_tcfg = ref_loop.TrainConfig(opt=ref_opt.OptimizerConfig(**ocfg),
                                    n_microbatches=n_micro)
    ref_step = jax.jit(ref_loop.make_train_step(ref_api, ref_tcfg))
    ref_state = {"params": ref_params, "opt": ref_opt.adamw_init(ref_params),
                 "step": jnp.zeros((), jnp.int32)}
    step = train_loop.make_train_step(api, tcfg)
    state = train_loop.state_from_params(convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu"))
    for i in range(3):
        batch = _batch(cfg, step=i)
        ref_state, ref_m = ref_step(
            ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, to_device(batch, "cpu"))
        assert abs(float(m["loss"]) - float(ref_m["loss"])) <= \
            1e-5 * float(ref_m["loss"])
        assert abs(float(m["grad_norm"]) - float(ref_m["grad_norm"])) <= \
            1e-5 * float(ref_m["grad_norm"])
    assert int(state["step"]) == int(ref_state["step"]) == 3
    want = _port_tree(ref_state["params"], cfg)
    moment = _port_tree(ref_state["opt"]["m"], cfg)
    for k, p in state["params"].named_parameters():
        _close(_np(p), _np(want[k]), 1e-5)
        _leaf_close(state["opt"]["m"][k].numpy(), _np(moment[k]), 1e-4)


def test_microbatching_matches_full_batch(model):
    """The JAX package's case on the port: one step at 1 and at 4
    microbatches (fp32 accumulation) gives near-identical params."""
    cfg, _, api, _, ref_params = model
    batch = to_device(_batch(cfg), "cpu")
    states = []
    for n in (1, 4):
        state = train_loop.state_from_params(convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu"))
        step = train_loop.make_train_step(
            api, train_loop.TrainConfig(n_microbatches=n))
        states.append(step(state, batch)[0])
    for (k, a), (_, b) in zip(states[0]["params"].named_parameters(),
                              states[1]["params"].named_parameters()):
        assert (a - b).abs().max().item() < 5e-5, k


def test_bf16_accumulator_runs(model):
    """accum_dtype="bfloat16": the microbatch sum in bf16, the step
    finite and close to the fp32 one."""
    cfg, _, api, _, ref_params = model
    batch = to_device(_batch(cfg), "cpu")
    out = {}
    for acc in ("float32", "bfloat16"):
        state = train_loop.state_from_params(convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu"))
        step = train_loop.make_train_step(api, train_loop.TrainConfig(
            n_microbatches=2, accum_dtype=acc))
        out[acc] = step(state, batch)[1]
    assert torch.isfinite(out["bfloat16"]["grad_norm"])
    assert float(out["bfloat16"]["grad_norm"]) == pytest.approx(
        float(out["float32"]["grad_norm"]), rel=1e-2)


@pytest.mark.parametrize("window", [0, 5])
def test_flash_attention_autograd_on_cpu(window):
    """Under autograd flash_attention is its autograd.Function: on the CPU
    the forward is the plain einsum version, the gradients those of the
    plain chunked attention (fp32, within 1e-5 of each gradient's largest
    value)."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.attention import chunked_attention

    rng = np.random.default_rng(window)
    base = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((2, 24, 4, 32), (2, 24, 2, 32), (2, 24, 2, 32))]
    w = torch.from_numpy(rng.normal(size=(2, 24, 4, 32)).astype(np.float32))
    got = []
    for fn in (lambda q, k, v: flash_attention(q, k, v, window=window),
               lambda q, k, v: chunked_attention(q, k, v, window, kv_chunk=8)):
        q, k, v = (t.clone().requires_grad_(True) for t in base)
        out = fn(q, k, v)
        got.append((out.detach(),
                    *torch.autograd.grad((out * w).sum(), (q, k, v))))
    for a, b in zip(*got):
        _leaf_close(a.numpy(), b.numpy(), 1e-5)
    q, k, v = (t.clone().requires_grad_(True) for t in base)
    with pytest.raises(RuntimeError, match="require a gradient"):
        flash_kernel.flash_attention_cuda(q, k, v)


def test_init_state_turns_gradients_on(model):
    cfg, _, api, _, _ = model
    state = train_loop.init_state(api, torch.Generator().manual_seed(0))
    params = dict(state["params"].named_parameters())
    assert all(p.requires_grad for p in params.values())
    assert list(state["opt"]["m"]) == list(params)
    assert int(state["step"]) == 0 and int(state["opt"]["count"]) == 0
    served = api.init_params(torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in served.parameters())


def test_train_batch_specs_match(model):
    """Every arch's train_batch_specs has the JAX package's shapes (the
    vision arch's patches out of S, the audio arch's frames on top)."""
    shape = registry.ShapeConfig("t", seq_len=64, global_batch=2,
                                 kind="train")
    for arch in registry.ALL_ARCHS:
        cfg = registry.smoke_config(registry.get_config(arch))
        ref_cfg = ref_registry.smoke_config(ref_registry.get_config(arch))
        specs = registry.get_model(cfg).train_batch_specs(shape)
        ref_specs = ref_registry.get_model(ref_cfg).train_batch_specs(
            RefShape("t", seq_len=64, global_batch=2, kind="train"))
        assert sorted(specs) == sorted(ref_specs), arch
        for k, (shp, dtype) in specs.items():
            assert shp == ref_specs[k].shape, (arch, k)
            assert str(dtype).removeprefix("torch.") == str(
                ref_specs[k].dtype), (arch, k)
        batch = registry.get_model(cfg).make_train_batch(
            shape, torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in batch.items()} == {
            k: s for k, (s, _) in specs.items()}


# -- data ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_token_stream_bit_equal(num_shards):
    for shard in range(num_shards):
        kw = dict(vocab=97, seq_len=16, global_batch=8, seed=5,
                  num_shards=num_shards, shard_id=shard)
        ours, ref = TokenStream(DataConfig(**kw)), RefTokenStream(
            RefDataConfig(**kw))
        for step in (0, 1, 7, 1000):
            a, b = ours.batch(step), ref.batch(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])

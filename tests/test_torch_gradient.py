"""The port's gradient codec (``repro_torch.sharding.gradient``) against the
JAX package's (``repro.sharding.gradient``).

The int8 codec draws its noise per leaf; the JAX noise (``jax.random.
uniform`` on ``jax.random.split(rng, n)`` in flatten order, i.e. sorted
names) is handed to the port's ``_quant_int8``. Bounds: the scales
bit-equal; an int8 payload element may differ only where ``x / scale +
noise`` sits at a rounding tie (within 1e-4 of a half), and then by 1.
bf16 and ``none`` bit-equal. Five error-feedback steps: the residuals
equal but where a payload element took the other side of a tie (then by
that step's scale). The compressed mean over two participants (two gloo
processes joined through a file store) against ``compressed_psum`` under
``jit(shard_map)`` over the suite's two virtual CPU devices: within 1e-6
relative to the largest value.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.sharding import gradient as ref
from repro_torch.sharding import gradient as G

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
SHAPES = {"b.bias": (37,), "a.w": (16, 24), "c.wq": (8, 3, 5)}
TIE = 1e-4  # how close to a half counts as a tie


def _grads(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _jax_noise(rng, tree):
    """The JAX codec's noise per leaf, in its flatten order."""
    names = sorted(tree)
    keys = jax.random.split(rng, len(names))
    return {k: np.array(jax.random.uniform(
        key, tree[k].shape, minval=-0.5, maxval=0.5))
        for k, key in zip(names, keys)}


def _check_payload(q_got, q_want, x, scale, noise):
    """Equal, or off by 1 where x / scale + noise is at a tie."""
    q_got, q_want = np.asarray(q_got), np.asarray(q_want)
    diff = q_got.astype(np.int32) - q_want.astype(np.int32)
    bad = diff != 0
    if bad.any():
        t = x[bad] / np.float32(scale) + noise[bad]
        frac = np.abs(t - np.floor(t) - 0.5)
        assert (np.abs(diff[bad]) == 1).all() and (frac < TIE).all(), (
            diff[bad], frac)
    return bad


def test_int8_payloads_and_scales_match():
    grads = _grads(0)
    rng = jax.random.PRNGKey(3)
    q_ref, s_ref = ref.compress_tree(
        {k: jnp.asarray(v) for k, v in grads.items()}, rng, mode="int8")
    noise = _jax_noise(rng, grads)
    for k, x in grads.items():
        q, s = G._quant_int8(torch.from_numpy(x), torch.from_numpy(noise[k]))
        assert q.dtype == torch.int8
        assert s.item() == float(s_ref[k])
        _check_payload(q.numpy(), q_ref[k], x, s.item(), noise[k])
    # the port's own codec: one draw a leaf in sorted-name order, the
    # payloads within the int8 range and the round trip within a step
    payload, scales = G.compress_tree(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        torch.Generator().manual_seed(0))
    assert list(payload) == sorted(grads)
    back = G.decompress_tree(payload, scales,
                             {k: torch.from_numpy(v) for k, v in grads.items()})
    for k, x in grads.items():
        assert payload[k].abs().max().item() <= 127
        assert np.abs(back[k].numpy() - x).max() <= scales[k].item()


@pytest.mark.parametrize("mode", ["bf16", "none"])
def test_bf16_and_none_bit_equal(mode):
    grads = _grads(1)
    like = {k: jnp.asarray(v) for k, v in grads.items()}
    p_ref, m_ref = ref.compress_tree(like, jax.random.PRNGKey(0), mode=mode)
    p, m = G.compress_tree({k: torch.from_numpy(v) for k, v in grads.items()},
                           None, mode=mode)
    assert m is None and m_ref is None
    for k in grads:
        want = np.asarray(p_ref[k])
        got = p[k]
        if mode == "bf16":
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
        else:
            assert np.array_equal(got.numpy(), want)
    back_ref = ref.decompress_tree(p_ref, m_ref, like)
    back = G.decompress_tree(p, m, {k: torch.from_numpy(v)
                                    for k, v in grads.items()})
    for k in grads:
        assert np.array_equal(back[k].numpy(), np.asarray(back_ref[k]))


def test_five_error_feedback_steps_match(monkeypatch):
    residual_ref = ref.init_residual({k: jnp.zeros(s, jnp.float32)
                                      for k, s in SHAPES.items()})
    residual = G.init_residual({k: torch.zeros(s) for k, s in SHAPES.items()})
    key = jax.random.PRNGKey(7)
    for step in range(5):
        grads = _grads(10 + step, scale=0.1)
        rng = jax.random.fold_in(key, step)
        eff = {k: grads[k] + np.asarray(residual_ref[k]) for k in grads}
        queue = [torch.from_numpy(n) for _, n in
                 sorted(_jax_noise(rng, eff).items())]
        monkeypatch.setattr(G, "_noise", lambda x, gen: queue.pop(0))
        out_ref, residual_ref_new = ref.error_feedback_step(
            {k: jnp.asarray(v) for k, v in grads.items()}, residual_ref, rng)
        out, residual = G.error_feedback_step(
            {k: torch.from_numpy(v) for k, v in grads.items()}, residual,
            torch.Generator())
        assert not queue
        for k in grads:
            scale = np.float32(np.abs(eff[k]).max() / np.float32(127.0))
            got, want = residual[k].numpy(), np.asarray(residual_ref_new[k])
            off = got != want
            assert np.allclose(np.abs(got[off] - want[off]), scale,
                               rtol=1e-5), k
            assert off.mean() < 0.01
            np.testing.assert_array_equal(
                out[k].numpy() + got, np.asarray(out_ref[k]) + want)
        # carry the reference's residual on, so a tie does not compound
        residual_ref = residual_ref_new
        residual = {k: torch.from_numpy(np.array(v))
                    for k, v in residual_ref.items()}


def test_none_mode_passes_through():
    grads = {k: torch.from_numpy(v) for k, v in _grads(2).items()}
    res = G.init_residual(grads)
    out, res2 = G.error_feedback_step(grads, res, None, mode="none")
    assert out is grads and res2 is res
    with pytest.raises(ValueError):
        G.compress_tree(grads, None, mode="fp8")


def test_one_participant_is_a_mean_of_one():
    x = torch.from_numpy(_grads(4)["a.w"])
    noise = torch.from_numpy(_jax_noise(jax.random.PRNGKey(1), {"a.w": x})["a.w"])
    got = G._compressed_mean(x, noise)
    q, s = G._quant_int8(x, noise)
    assert torch.equal(got, q.float() * s)
    assert torch.equal(G._compressed_mean(x, None, mode="none"), x)


WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.sharding import gradient as G

rank, store, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2,
                        rank=rank)
data = np.load(inp)
res = {}
for mode in ("int8", "none"):
    x = torch.from_numpy(data[f"x{rank}"])
    noise = torch.from_numpy(data[f"n{rank}"])
    res[mode] = G._compressed_mean(x, noise, mode=mode).numpy()
dist.destroy_process_group()
np.savez(out, **res)
"""


def test_two_participants_match_compressed_psum(tmp_path):
    rng = np.random.default_rng(5)
    xs = [(rng.standard_normal((6, 40)) * s).astype(np.float32)
          for s in (1.0, 3.0)]
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    noises = [np.array(jax.random.uniform(k, xs[0].shape, minval=-0.5,
                                            maxval=0.5)) for k in keys]
    mesh = jax.make_mesh((2,), ("d",),
                         axis_types=(jax.sharding.AxisType.Explicit,))
    want = {}
    with jax.set_mesh(mesh):
        for mode in ("int8", "none"):
            f = jax.jit(jax.shard_map(
                lambda x, k, mode=mode: ref.compressed_psum(
                    x[0], "d", k[0], mode=mode)[None],
                in_specs=(P("d"), P("d")), out_specs=P("d")))
            out = np.asarray(f(jnp.asarray(np.stack(xs)), keys))
            np.testing.assert_array_equal(out[0], out[1])
            want[mode] = out[0]
    inp = tmp_path / "inputs.npz"
    np.savez(inp, x0=xs[0], x1=xs[1], n0=noises[0], n1=noises[1])
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(tmp_path / "store"),
         str(inp), str(tmp_path / f"out{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    for r in range(2):
        got = np.load(tmp_path / f"out{r}.npz")
        for mode in ("int8", "none"):
            scale = np.abs(want[mode]).max()
            np.testing.assert_allclose(got[mode], want[mode], rtol=0,
                                       atol=1e-6 * scale,
                                       err_msg=json.dumps([r, mode]))

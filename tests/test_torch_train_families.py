"""Every arch's ``loss_fn`` and its gradients, the port against the JAX
package, at ``smoke_config`` in fp32: here the seven transformer archs
(dense, MoE, VLM); ``test_torch_train_recurrent.py`` holds xLSTM, Hymba
and Whisper with ``check_arch`` from this file (two files, so each takes
~30 s alone and the two run side by side under ``--dist loadfile``).

Parameters are drawn from a seed with numpy in the JAX package's tree
(``test_torch_train.numpy_params``) and carried across with
``convert.params_from_numpy`` (which also puts the JAX gradients in the
port's layout); batches are made from a seed with numpy in the shapes of
``train_batch_specs`` (the VLM's patch and Whisper's frame embeddings
included). Bounds: the loss within 1e-5 relative, every gradient leaf
within 1e-4 of its largest value, and every gradient finite (as
``tests/test_arch_smoke.py`` asks of the JAX package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as ref_registry
from repro_torch import convert
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import registry
from repro_torch.train import train_loop
from test_torch_train import _leaf_close, _np, _port_tree, numpy_params

SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=2, kind="train")


def _numpy_batch(api, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dtype) in sorted(api.train_batch_specs(SHAPE).items()):
        if dtype == torch.int32:
            out[name] = rng.integers(0, api.cfg.vocab, shape).astype(np.int32)
        else:
            out[name] = (rng.normal(size=shape) * 0.02).astype(np.float32)
    return out


TRANSFORMER_ARCHS = tuple(
    a for a in registry.ALL_ARCHS
    if registry.get_config(a).family in ("dense", "moe", "vlm"))


def check_arch(arch):
    cfg = registry.smoke_config(registry.get_config(arch))
    ref_cfg = ref_registry.smoke_config(ref_registry.get_config(arch))
    ref_api = ref_registry.get_model(ref_cfg)
    ref_params = numpy_params(ref_api, seed=0)
    api = registry.get_model(cfg)
    batch = _numpy_batch(api, seed=7)

    ref_l, ref_g = jax.jit(jax.value_and_grad(ref_api.loss_fn))(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    state = train_loop.state_from_params(convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu"))
    loss, grads = train_loop.value_and_grad(
        api, state["params"], {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert abs(float(loss) - float(ref_l)) <= 1e-5 * abs(float(ref_l))
    want = _port_tree(ref_g, cfg)
    assert list(grads) == list(want)
    for k, g in grads.items():
        assert torch.isfinite(g).all(), (arch, k)
        _leaf_close(g.numpy(), _np(want[k]), 1e-4)


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_loss_and_grads_match(arch):
    check_arch(arch)

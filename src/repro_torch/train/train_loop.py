"""The training step: gradient accumulation over microbatches, per-layer
remat, mixed precision (the counterpart of ``repro.train.train_loop``).

``make_train_step(api, tcfg)`` builds ``train_step(state, batch) ->
(state, metrics)``. The state is {"params": the model's ``nn.Module``,
"opt": AdamW's state keyed by parameter name, "step": int32}; the step
updates it in place and returns it. Its metrics are tensors on the
state's device: nothing is read to the host, the caller decides when to.

  * microbatches: a loop in place of the JAX package's ``lax.scan``, the
    gradients summed in ``accum_dtype`` (float32 or bfloat16) and divided
    by their number, the loss likewise in fp32;
  * per-layer remat is inside each model's ``forward_hidden``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.registry import ModelApi
from repro_torch.train.optimizer import (
    OptimizerConfig,
    adamw_init,
    adamw_update,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptimizerConfig = OptimizerConfig()
    n_microbatches: int = 1
    accum_dtype: str = "float32"


def init_state(api: ModelApi, generator: torch.Generator) -> dict:
    """Random params from ``generator`` (on its device), each with its
    gradient on, and a fresh AdamW state."""
    return state_from_params(api.init_params(generator))


def state_from_params(params: torch.nn.Module) -> dict:
    """A fresh training state around ``params`` (their gradient turned
    on)."""
    params.requires_grad_(True)
    p0 = next(params.parameters())
    return {"params": params,
            "opt": adamw_init(dict(params.named_parameters())),
            "step": torch.zeros((), dtype=torch.int32, device=p0.device)}


def train_state_specs(api: ModelApi) -> dict:
    """The train state on the meta device: the params (built empty, in
    their dtypes), AdamW's fp32 m, v and master, its count, and the step;
    shapes and dtypes with nothing behind them, for the dry-run."""
    from repro_torch.models.registry import params_class

    return state_from_params(params_class(api.cfg)(api.cfg, "meta"))


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by microbatches {n}")
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def value_and_grad(api: ModelApi, params: torch.nn.Module, batch: dict):
    """(loss, {name: gradient}) of ``api.loss_fn``; a parameter the loss
    does not reach gets zeros, as ``jax.grad`` gives it."""
    named = dict(params.named_parameters())
    loss = api.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(named.items(), grads)}


def make_train_step(api: ModelApi, tcfg: TrainConfig) -> Callable:
    acc_dt = getattr(torch, tcfg.accum_dtype)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        if tcfg.n_microbatches <= 1:
            loss, grads = value_and_grad(api, params, batch)
        else:
            loss, grads = None, None
            for mb in _split_microbatches(batch, tcfg.n_microbatches):
                l, g = value_and_grad(api, params, mb)
                if grads is None:
                    loss = l
                    grads = {k: v.to(acc_dt, copy=True) for k, v in g.items()}
                else:
                    loss = loss + l
                    for k, v in g.items():
                        grads[k] += v.to(acc_dt)
                del g
            loss = loss / tcfg.n_microbatches
            grads = {k: v / tcfg.n_microbatches for k, v in grads.items()}
        metrics = adamw_update(grads, state["opt"],
                               dict(params.named_parameters()), tcfg.opt)
        state["step"] = state["step"] + 1
        return state, dict(metrics, loss=loss)

    return train_step

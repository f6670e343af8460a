"""Automatic parameter and state placement, FSDP + TP (the counterpart of
``repro.sharding.auto``).

Placement does not change numerics, so instead of a hand table per arch
each tensor is placed greedily:

  1. shard the largest dim divisible by |model| over ``model``  (TP/EP)
  2. shard the largest remaining dim divisible by |data| over ``data`` (FSDP)
  3. leave everything else replicated

Trees here are what the port keeps: a module's ``named_parameters``,
dicts of tensors keyed by name (the optimizer state, a cache, a batch),
nested dicts of those (the train state), or ``{name: (shape, dtype)}``
specs. Every function returns a flat ``{dotted name: NamedSharding}``.

The JAX package stacks a family's layers on a leading axis ("layers",
"encoder", "decoder") and skips that axis; the port keeps one module a
layer (``layers.3.attn.wq``), so a port layer's spec is the JAX spec
without its leading None. xLSTM's "blocks" is a list in both packages,
and its leaves skip their leading dim in both, as the JAX rule does for
every leaf under a stacked key.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from repro_torch.launch.mesh import Mesh
from repro_torch.sharding.rules import NamedSharding, spec_entry

STACKED_KEYS = ("layers", "encoder", "decoder", "blocks")
PER_LAYER_KEYS = ("layers", "encoder", "decoder")  # the JAX package stacks these


def _is_spec(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[1], torch.dtype))


def flatten(tree: Any, prefix: str = "") -> dict:
    """{dotted name: leaf} of a module, nested dicts, lists and tuples of
    tensors or specs, or one leaf (a list's entries are named by index)."""
    if isinstance(tree, nn.Module):
        return {prefix + k: p for k, p in tree.named_parameters()}
    if isinstance(tree, dict) or (isinstance(tree, (list, tuple))
                                  and not _is_spec(tree)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(flatten(v, f"{prefix}{k}."))
        return out
    return {prefix.rstrip("."): tree}


def leaf_shape(leaf) -> tuple[int, ...]:
    return tuple(leaf[0]) if _is_spec(leaf) else tuple(leaf.shape)


def leaf_itemsize(leaf) -> int:
    dtype = leaf[1] if _is_spec(leaf) else leaf.dtype
    return torch.empty((), dtype=dtype, device="meta").element_size()


# Semantic TP preferences: shard the dim that MATCHES the activation
# sharding (heads for attention, experts/ff for MoE/MLP), so contractions
# stay local instead of re-gathering the whole weight per layer.

def _preferred_tp_dim(key: str, rank: int) -> int | None:
    if key in ("wq", "wk", "wv"):
        return rank - 2  # [d, H, dh] → heads
    if key == "wo":
        return 0  # attn [H, dh, d] / mlp [f, d] → H / f (moe [E,f,d]: E→greedy)
    if key in ("wi_gate", "wi_up", "wi"):
        return rank - 1  # [.., d, f] → f
    return None


def _spec_for_shape(
    shape: tuple[int, ...],
    mesh: Mesh,
    *,
    skip_leading: bool = False,
    axes: tuple[str, ...] = ("model", "data"),
    preferred_model_dim: int | None = None,
) -> tuple:
    axes_avail = [a for a in axes if a in mesh.axis_names]
    parts: list[Any] = [None] * len(shape)
    start = 1 if (skip_leading and len(shape) > 1) else 0
    order = sorted(range(start, len(shape)), key=lambda i: shape[i],
                   reverse=True)
    if preferred_model_dim is not None:
        pd = preferred_model_dim + start
        if pd < len(shape):
            order = [pd] + [i for i in order if i != pd]
    for mesh_axis in axes_avail:
        size = mesh.shape[mesh_axis]
        for i in order:
            if parts[i] is None and shape[i] % size == 0 and shape[i] >= size:
                parts[i] = mesh_axis
                break
        # only the model axis gets the semantic preference
        if preferred_model_dim is not None and mesh_axis == "model":
            order = sorted(range(start, len(shape)), key=lambda i: shape[i],
                           reverse=True)
    return tuple(parts)


def _leaf_spec(name: str, shape: tuple[int, ...], mesh: Mesh,
               mode: str) -> tuple:
    if len(shape) == 0:
        return ()
    parts = name.split(".")
    keys = [p for p in parts if not p.isdigit()]
    if any(k in ("pos_embed", "embed") for k in keys):
        # row-gathered tables: shard only the row dim (vocab / position),
        # replicated when the rows do not divide
        size = mesh.shape.get("model", 1)
        axis = "model" if (shape[0] % size == 0 and size > 1) else None
        return (axis, *([None] * (len(shape) - 1)))
    per_layer = any(a in PER_LAYER_KEYS and b.isdigit()
                    for a, b in zip(parts, parts[1:]))
    if per_layer:  # the JAX leaf has a leading layer axis, skipped
        shape = (1, *shape)
    stacked = any(k in STACKED_KEYS for k in keys)
    rank = len(shape) - (1 if stacked and len(shape) > 1 else 0)
    spec = _spec_for_shape(
        shape, mesh, skip_leading=stacked,
        axes=("model",) if mode == "tp" else ("model", "data"),
        preferred_model_dim=_preferred_tp_dim(keys[-1], rank),
    )
    return spec[1:] if per_layer else spec


def auto_shardings(tree: Any, mesh: Mesh, *,
                   mode: str = "auto") -> dict[str, NamedSharding]:
    """{name: NamedSharding} of every leaf of ``tree``.

    mode="auto": FSDP(data) + TP(model) hybrid, for training, where
    per-microbatch weight gathers amortize across the batch.
    mode="tp": TP(model) only, for decode and serving, where weights
    stream once a token and an FSDP gather would move the whole model
    every step.
    """
    if mode not in ("auto", "tp"):
        raise ValueError(f"unknown placement mode {mode!r}")
    return {name: NamedSharding(mesh, _leaf_spec(name, leaf_shape(leaf),
                                                 mesh, mode))
            for name, leaf in flatten(tree).items()}


def _batch_axes(mesh: Mesh) -> tuple[tuple[str, ...], int]:
    bd = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return bd, math.prod(mesh.shape[a] for a in bd) if bd else 1


def batch_shardings(tree: Any, mesh: Mesh) -> dict[str, NamedSharding]:
    """A data batch: dim 0 over (pod, data) where it divides."""
    bd, size = _batch_axes(mesh)
    out = {}
    for name, leaf in flatten(tree).items():
        shape = leaf_shape(leaf)
        spec = (spec_entry(bd),) if (shape and shape[0] % max(size, 1) == 0
                                     and size > 1) else ()
        out[name] = NamedSharding(mesh, spec)
    return out


def cache_shardings(tree: Any, mesh: Mesh, *,
                    seq_axis: str = "model") -> dict[str, NamedSharding]:
    """A KV cache's placement (the models' ``init_cache`` layouts):

      rank-5 [L, B, S, H, D] → batch over (pod, data), S over ``seq_axis``
      rank-4 [L, B, *, *]    → batch over (pod, data)          (ssm states)
      rank-2/3 [B, ...]      → batch over (pod, data)
    replicated where a size does not divide.
    """
    bd, bsize = _batch_axes(mesh)
    ssize = mesh.shape[seq_axis] if seq_axis in mesh.axis_names else 1
    out = {}
    for name, leaf in flatten(tree).items():
        shape = leaf_shape(leaf)
        if len(shape) >= 2 and shape[0] == 0:
            out[name] = NamedSharding(mesh, ())
            continue
        parts: list[Any] = [None] * len(shape)
        if len(shape) == 5:  # [L, B, S, H, D]
            if bd and shape[1] % bsize == 0:
                parts[1] = spec_entry(bd)
            if ssize > 1 and shape[2] % ssize == 0:
                parts[2] = seq_axis
        elif len(shape) >= 2 and bd:
            for i in (1, 0):  # the first dim that matches a batch size
                if i < len(shape) and shape[i] % bsize == 0 \
                        and shape[i] >= bsize:
                    parts[i] = spec_entry(bd)
                    break
        out[name] = NamedSharding(mesh, tuple(parts))
    return out


def shards(spec: tuple, mesh: Mesh) -> list[int]:
    """How many ways each dimension is split under ``spec``."""
    out = []
    for axis in spec:
        names = () if axis is None else (
            axis if isinstance(axis, tuple) else (axis,))
        out.append(math.prod(mesh.shape[a] for a in names))
    return out


def per_device_bytes(specs: dict, shapes: dict, mesh: Mesh) -> int:
    """Bytes one device holds of the leaves ``shapes`` ({name: tensor or
    (shape, dtype)}) placed by ``specs`` ({name: NamedSharding or spec}):
    each dimension split ceil-wise over its mesh axes (a size that does
    not divide is padded, as XLA pads it)."""
    total = 0
    for name, leaf in flatten(shapes).items():
        spec = specs[name]
        spec = spec.spec if isinstance(spec, NamedSharding) else spec
        shape = leaf_shape(leaf)
        ways = shards(spec, mesh) + [1] * (len(shape) - len(spec))
        total += math.prod(-(-d // w) for d, w in zip(shape, ways)) \
            * leaf_itemsize(leaf)
    return total

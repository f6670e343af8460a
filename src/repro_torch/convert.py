"""Carry drive state between the JAX package and this one.

A simulator's weights are its state: ``state_from_numpy`` builds this
package's :class:`~repro_torch.core.ssd.SimState` from the JAX package's
state turned into numpy (``{k: np.asarray(v) for k, v in st.items()}``), so
a run started there continues here; ``state_to_numpy`` goes the other way.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ssd import SIM_STATE_DTYPES, SimState


def state_from_numpy(d: dict, device="cuda") -> SimState:
    """A SimState on ``device`` from a dict of numpy arrays, one per field,
    each in its field's dtype (checked, never cast)."""
    missing = set(SIM_STATE_DTYPES) - set(d)
    if missing:
        raise KeyError(f"state fields missing: {sorted(missing)}")
    fields = {}
    for name, dtype in SIM_STATE_DTYPES.items():
        arr = np.ascontiguousarray(d[name])
        t = torch.from_numpy(arr.copy())
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arr.dtype} is not {dtype}")
        fields[name] = t.to(device)
    return SimState(**fields)


def state_to_numpy(st: SimState) -> dict:
    """Every field of ``st`` as a numpy array on the host."""
    return {k: v.cpu().numpy() for k, v in st.items()}



# -- model parameters ------------------------------------------------------------
#
# The JAX package's ``init_params`` tree, as numpy: {"embedding": {"embed",
# "unembed"}, "layers": {...} with every leaf stacked on a leading L axis,
# "final_norm": {"scale"}}. A layer holds "mlp" or, in an MoE model, "moe"
# ({"router" [d, E] fp32 in any model, "wi_gate", "wi_up" [E, d, f], "wo"
# [E, f, d]}). The port's modules keep its leaf names, layouts and dtypes.
# numpy has no bfloat16 of its own: a bfloat16 leaf is the JAX package's
# (ml_dtypes) and crosses as its 16 bits.


def params_from_numpy(tree: dict, cfg, device="cuda"):
    """A :class:`~repro_torch.models.transformer.Transformer` on ``device``
    holding the JAX package's parameter tree, each leaf in the port's dtype
    for it (checked, never cast)."""
    from repro_torch.models.transformer import Transformer

    params = Transformer(cfg, device)
    for name, t in _param_leaves(params):
        node = tree
        for key in (name[:1] + name[2:]) if name[0] == "layers" else name:
            node = node[key]
        arr = np.ascontiguousarray(node[name[1]] if name[0] == "layers"
                                   else node)
        if arr.dtype.name == "bfloat16":
            src = torch.from_numpy(arr.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            src = torch.from_numpy(arr.copy())
        if src.dtype != t.dtype or src.shape != t.shape:
            raise TypeError(f"{'/'.join(map(str, name))}: {arr.dtype} "
                            f"{arr.shape} is not {t.dtype} {tuple(t.shape)}")
        t.copy_(src)
    return params


def params_to_numpy(params) -> dict:
    """The JAX package's parameter tree (numpy leaves, layers stacked)."""
    tree: dict = {}
    per_layer: dict = {}
    for name, t in _param_leaves(params):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            arr = t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        else:
            arr = t.numpy()
        if name[0] == "layers":
            per_layer.setdefault(name[:1] + name[2:], []).append(arr)
        else:
            _set(tree, name, arr)
    for name, arrs in per_layer.items():  # in layer order
        _set(tree, name, np.stack(arrs))
    return tree


def _param_leaves(params):
    """(path, tensor) for every parameter; a layer's path has the layer
    index second, e.g. ("layers", 3, "attn", "wq")."""
    for path, t in params.named_parameters():
        keys = path.split(".")
        if keys[0] == "layers":
            keys[1] = int(keys[1])
        yield tuple(keys), t


def _set(tree: dict, name: tuple, value) -> None:
    for key in name[:-1]:
        tree = tree.setdefault(key, {})
    tree[name[-1]] = value

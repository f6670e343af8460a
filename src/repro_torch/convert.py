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
# The JAX package's ``init_params`` tree, as numpy. Each family's tree:
#
# * transformer (dense, moe, vlm): {"embedding": {"embed", "unembed"},
#   "layers": {...} with every leaf stacked on a leading L axis,
#   "final_norm": {"scale"}, and with ``use_rope=False`` "pos_embed"}. A
#   layer holds "mlp" or, in an MoE model, "moe" ({"router" [d, E] fp32
#   in any model, "wi_gate", "wi_up" [E, d, f], "wo" [E, f, d]});
# * xlstm (ssm): "blocks" is a plain list of per-block dicts, mLSTM and
#   sLSTM blocks of different leaves, not stacked;
# * hymba (hybrid): "layers" stacked, each with a "mamba" subtree whose
#   conv_w, dt_proj, dt_bias, a_log and d_skip are fp32 in any model;
# * whisper (audio): "encoder" and "decoder" stacked, "enc_norm" and every
#   norm a LayerNorm ({"scale", "bias"}), "pos_embed".
#
# The port's modules keep the leaf names, layouts and dtypes (the
# recurrences' fp32 leaves under a bf16 model included). numpy has no
# bfloat16 of its own: a bfloat16 leaf is the JAX package's (ml_dtypes)
# and crosses as its 16 bits.

STACKED = ("layers", "encoder", "decoder")  # leaves stacked on a layer axis
LISTED = ("blocks",)  # a list of per-block trees


def params_from_numpy(tree: dict, cfg, device="cuda"):
    """The port's parameter module for ``cfg``'s family (``registry.
    params_class``) on ``device``, holding the JAX package's parameter
    tree, each leaf in the port's dtype for it (checked, never cast)."""
    from repro_torch.models.registry import params_class

    params = params_class(cfg)(cfg, device)
    for name, t in _param_leaves(params):
        node = tree
        if name[0] in STACKED:
            for key in name[:1] + name[2:]:
                node = node[key]
            node = node[name[1]]
        else:
            for key in name:
                node = node[key]
        arr = np.ascontiguousarray(node)
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
    """The JAX package's parameter tree (numpy leaves; "layers",
    "encoder" and "decoder" stacked, "blocks" a list)."""
    tree: dict = {}
    stacked: dict = {}
    for name, t in _param_leaves(params):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            arr = t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        else:
            arr = t.numpy()
        if name[0] in STACKED:
            stacked.setdefault(name[:1] + name[2:], []).append(arr)
        elif name[0] in LISTED:
            blocks = tree.setdefault(name[0], [])
            if len(blocks) == name[1]:
                blocks.append({})
            _set(blocks[name[1]], name[2:], arr)
        else:
            _set(tree, name, arr)
    for name, arrs in stacked.items():  # in layer order
        _set(tree, name, np.stack(arrs))
    return tree


def _param_leaves(params):
    """(path, tensor) for every parameter; a path under a layer list has
    the layer index second, e.g. ("layers", 3, "attn", "wq")."""
    for path, t in params.named_parameters():
        keys = path.split(".")
        if keys[0] in STACKED + LISTED:
            keys[1] = int(keys[1])
        yield tuple(keys), t


def _set(tree: dict, name: tuple, value) -> None:
    for key in name[:-1]:
        tree = tree.setdefault(key, {})
    tree[name[-1]] = value

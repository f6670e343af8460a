"""Logical-axis sharding rules (MaxText-style) and a context that applies
them (the counterpart of ``repro.sharding.rules``).

A rules table maps logical axis names to mesh axes. A spec is a tuple
with one entry a dimension: a mesh axis name, a tuple of two or more
names, or None (replicated), as a ``PartitionSpec``'s canonical entries
are. Outside a rules context the default table applies and no mesh is
active.

Mesh axes (see launch/mesh.py):
    pod    across pods (multi-pod DP)
    data   FSDP / batch
    model  TP / EP / SP

One process here holds one card, so ``logical_constraint`` has nothing to
constrain: it checks the rank and returns the tensor. The port's models
do not call it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence

from repro_torch.launch.mesh import Mesh

Spec = tuple

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicated)
DEFAULT_RULES: dict[str, object] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "seq_kv": "model",        # KV-sequence sharding for decode (SP/flash-decoding)
    "heads": "model",
    "kv_heads": "model",
    "d_model": None,
    "d_ff": "model",
    "vocab": "model",
    # parameters (FSDP over data, TP over model)
    "p_d_model": "data",
    "p_heads": "model",
    "p_kv_heads": "model",
    "p_d_ff": "model",
    "p_vocab": "model",
    "p_experts": None,        # overridden to "model" when divisible (EP)
    "layers": None,
    # never sharded
    "d_head": None,
    "state": None,
    "window": None,
}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""

    mesh: Mesh
    spec: Spec


class _RulesContext(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: dict[str, object] = {}


_CTX = _RulesContext()


@contextlib.contextmanager
def use_sharding_rules(mesh: Mesh, rules: Optional[dict] = None, /,
                       **overrides):
    """Make ``mesh`` and the rules (the defaults, then ``rules``, then
    ``overrides``) active in this thread."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    merged.update(overrides)
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, merged
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def spec_entry(axes: tuple[str, ...]):
    """One dimension's entry for mesh axes: None for none, the name for
    one, the tuple for several (a ``PartitionSpec`` entry's canonical
    form)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _resolve(names: Sequence[Optional[str]], mesh: Optional[Mesh]) -> Spec:
    """Map logical names to mesh axes under the active rules, dropping
    axes the mesh lacks (e.g. "pod" on the single-pod mesh) and axes an
    earlier dimension already took."""
    rules = _CTX.rules or DEFAULT_RULES
    parts, used = [], set()
    for name in names:
        axis = rules.get(name) if name is not None else None
        if axis is not None and mesh is not None:
            if isinstance(axis, (tuple, list)):
                axis = spec_entry(tuple(
                    a for a in axis if a in mesh.axis_names and a not in used))
            elif axis not in mesh.axis_names or axis in used:
                axis = None
        elif isinstance(axis, (tuple, list)):
            axis = spec_entry(tuple(axis))
        if axis is not None:
            used.update(axis if isinstance(axis, tuple) else (axis,))
        parts.append(axis)
    return tuple(parts)


def resolve_spec(names: Sequence[Optional[str]]) -> Spec:
    """Logical axis names -> a spec under the active rules and mesh."""
    return _resolve(names, _CTX.mesh)


def logical_constraint(x, *names: Optional[str]):
    """Check that ``names`` has one entry a dimension of ``x`` and return
    ``x``: one card holds the whole tensor."""
    if len(names) != x.dim():
        raise ValueError(f"rank mismatch: {names} vs {tuple(x.shape)}")
    return x


def named_sharding(mesh: Mesh, *names: Optional[str]) -> NamedSharding:
    """A NamedSharding on ``mesh`` for logical ``names``."""
    return NamedSharding(mesh, _resolve(names, mesh))

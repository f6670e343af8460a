"""Atomic checkpoints of a training state (the counterpart of
``repro.train.checkpoint``, in its layout).

Layout:  <dir>/step_<N>/
             manifest.json         every leaf's shape and dtype, and the step
             shard_<host>.npz      the leaves' values

A state is a tree of dicts whose leaves are tensors, and whose
``nn.Module`` nodes (the params) stand for their named parameters. Keys
are the paths joined by "/" ("params/layers.0.attn.wq", "opt/m/…",
"step"). numpy has no bfloat16: a bf16 leaf is stored as its uint16 bits,
with "bfloat16" in the manifest, and viewed back on restore, so the round
trip is exact.

Atomicity: written to ``<dir>/.tmp_step_N``, then ``os.rename``d (atomic
on POSIX), so a crash mid-save never corrupts the latest complete
checkpoint. The last ``keep`` are kept.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Any, Optional

import numpy as np
import torch
from torch import nn


def state_leaves(tree: Any,
                 prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) for every leaf of a state, a module's parameters
    under their names."""
    if isinstance(tree, nn.Module):
        return [(prefix + k, p) for k, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items()
                for leaf in state_leaves(v, f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def _steps(directory: pathlib.Path) -> list[tuple[int, pathlib.Path]]:
    return sorted((int(p.name.split("_")[1]), p)
                  for p in directory.glob("step_*")
                  if p.name.split("_")[1].isdigit())


def save_checkpoint(directory: str | os.PathLike, state: Any, step: int, *,
                    host_id: int = 0, keep: int = 2) -> pathlib.Path:
    """Write ``state`` as ``<directory>/step_<step>`` and keep the last
    ``keep`` checkpoints."""
    directory = pathlib.Path(directory)
    tmp = directory / f".tmp_step_{step}"
    final = directory / f"step_{step}"
    tmp.mkdir(parents=True, exist_ok=True)
    leaves = state_leaves(state)
    manifest = {
        "step": step,
        "leaves": {key: {"shape": list(t.shape),
                         "dtype": str(t.dtype).removeprefix("torch.")}
                   for key, t in leaves},
    }
    np.savez(tmp / f"shard_{host_id}.npz",
             **{key.replace("/", "__"): _to_numpy(t) for key, t in leaves})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    for _, old in _steps(directory)[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    return final


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = _steps(directory)
    return steps[-1][0] if steps else None


def restore_checkpoint(directory: str | os.PathLike, target: Any, *,
                       step: Optional[int] = None,
                       device=None) -> tuple[Any, int]:
    """A new state of ``target``'s structure from ``<directory>/step_<step>``
    (the latest by default), and the step. Each leaf takes its target's
    dtype and lands on ``device`` (default: its target's device); a module
    is rebuilt as ``type(module)(module.cfg, device)`` (the port's model
    classes), each parameter taking its target's ``requires_grad``."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    ckpt = directory / f"step_{step}"
    manifest = json.loads((ckpt / "manifest.json").read_text())["leaves"]
    data: dict[str, np.ndarray] = {}
    for shard_file in sorted(ckpt.glob("shard_*.npz")):
        with np.load(shard_file) as z:
            data.update({k: z[k] for k in z.files})

    def leaf(key: str, like: torch.Tensor, dev) -> torch.Tensor:
        t = torch.from_numpy(data[key.replace("/", "__")])
        if manifest[key]["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device=dev, dtype=like.dtype)

    def build(tree: Any, prefix: str) -> Any:
        if isinstance(tree, nn.Module):
            p0 = next(tree.parameters())
            module = type(tree)(tree.cfg, device or p0.device)
            with torch.no_grad():
                for (k, p), (_, like) in zip(module.named_parameters(),
                                             tree.named_parameters()):
                    p.copy_(leaf(prefix + k, like, p.device))
                    p.requires_grad_(like.requires_grad)
            return module
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in tree.items()}
        return leaf(prefix.rstrip("/"), tree, device or tree.device)

    return build(target, ""), step

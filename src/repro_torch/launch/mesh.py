"""Meshes (the counterpart of ``repro.launch.mesh``).

A :class:`Mesh` here is a description: axis names and sizes, no devices.
The production meshes are what the JAX package compiles its dry-run cells
for (256 chips a pod, two pods); the sharding rules
(``sharding/rules.py``, ``sharding/auto.py``) place tensors on them, and
``launch/dryrun.py`` reports each device's share. One process here drives
one card, so no mesh is ever bound to devices; a launcher that would need
one says how many devices it lacks (``launch/train.py --mesh``).

The fleet's "mesh" is the list of cards its drives are split over
(``drive_mesh``, from ``core.fleet.resolve_devices``).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in number")

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: size}, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 = 256 chips a pod; 2 pods = 512 chips when multi_pod."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """Any mesh (tests use small ones)."""
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


def drive_mesh(devices=None, device="cuda") -> list:
    """The fleet's 1-D mesh: the cards its drives are split over, one
    contiguous slice of drives a card (``core.fleet.resolve_devices``)."""
    from repro_torch.core.fleet import resolve_devices

    return resolve_devices(devices, device)


def mesh_devices(mesh: Mesh) -> int:
    return mesh.size

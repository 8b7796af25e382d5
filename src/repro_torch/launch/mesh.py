"""Meshes of the launch layer (counterpart of ``repro.launch.mesh``).

Single pod: (data=16, model=16) — 256 chips. Multi-pod: (pod=2, data=16,
model=16) — 512 chips; "pod" is the slow axis (data parallel across pods).

The port has no ``torch.distributed`` mesh yet (ROADMAP queue 1 item 14):
a ``Mesh`` is its axis sizes and names, and the one device its programs
run on — the card (``make_mesh((1, 1), ...)``), the CPU when asked for,
or ``meta`` (shapes only: nothing is allocated or computed, which is how
the roofline counts a program). The production meshes are abstract
(``device`` None): their sizes drive the spec rules and the per-chip
arithmetic, and no program runs on them. A program on a mesh of more
than one device runs only on ``meta``, as a count of the whole program;
anywhere else it raises (``check_runnable``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import device as _dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: Optional[torch.device] = None      # None: abstract

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract (16, 16) or (2, 16, 16) mesh of the spec and size
    arithmetic."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: _dev.DeviceLike = None) -> Mesh:
    """A mesh whose programs run on ``device`` (the card unless asked
    otherwise): ``make_mesh((1, 1), ("data", "model"))`` is the one-card
    mesh."""
    return Mesh(tuple(shape), tuple(axes), _dev.resolve(device))


def shape_only(mesh: Mesh) -> Mesh:
    """The same axes on the ``meta`` device: a program built on it counts
    its work and allocates nothing."""
    return dataclasses.replace(mesh, device=torch.device("meta"))


def check_runnable(mesh: Mesh) -> torch.device:
    """The device a program on ``mesh`` runs on; raises for an abstract
    mesh and for more than one device off ``meta``."""
    if mesh.device is None:
        raise ValueError("an abstract mesh holds sizes for the spec rules; "
                         "build the program on make_mesh(...) to run it")
    if mesh.size > 1 and mesh.device.type != "meta":
        raise NotImplementedError(
            f"a program over {mesh.size} devices needs a torch.distributed "
            "mesh — see ROADMAP queue 1 item 14 (a multi-GPU mesh)")
    return mesh.device


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The batch-sharding axes of a mesh — ('pod', 'data') when multi-pod."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh: Mesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def device_count(mesh: Mesh) -> int:
    return mesh.size

"""Meshes of the launch layer (counterpart of ``repro.launch.mesh``).

Single pod: (data=16, model=16) — 256 chips. Multi-pod: (pod=2, data=16,
model=16) — 512 chips; "pod" is the slow axis (data parallel across pods).

A ``Mesh`` is its axis sizes and names and the one device the calling
process runs its programs on — the card (``make_mesh((1, 1), ...)``),
the CPU when asked for, or ``meta`` (shapes only: nothing is allocated
or computed, which is how the roofline counts a program). The production
meshes are abstract (``device`` None): their sizes drive the spec rules
and the per-chip arithmetic, and no program runs on them.

Inside a ``torch.distributed`` world whose size is the mesh's (one
process a rank, started by ``launch/ranks.py``), ``make_mesh`` gives the
calling rank's mesh: its coordinates (rank r sits at r's row-major
coordinates over the axes) and, for each axis of more than one rank, an
``AxisShard`` — its coordinate on the axis and the process group of its
axis line, the groups that ``models/collectives.py`` reduces and gathers
over. A tuple of axes names a plane: the ranks that share every other
coordinate, indexed row-major over the tuple's axes in mesh order (as a
spec entry ``("pod", "data")`` reads it), with a group of its own
(``axis_shard(("pod", "data"))``: the data axes of a multi-pod mesh,
over which the batch is split and the gradients are summed). A program
on such a mesh holds and computes the rank's shards
(``launch/sharding.py``, ``launch/steps.py``). Outside a world a mesh of
more than one device runs only on ``meta``, as a count of the whole
program; anywhere else it raises (``check_runnable``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as tdist

from repro_torch import device as _dev
from repro_torch.models.collectives import AxisShard


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: Optional[torch.device] = None      # None: abstract
    # in a world: the calling rank's coordinates, and per axis its
    # AxisShard (None for an axis of one rank); () outside a world
    coords: Tuple[int, ...] = ()
    shards: Tuple[Optional[AxisShard], ...] = ()
    # in a world: (axes, AxisShard) of each plane of two or more axes of
    # more than one rank, the axes in mesh order
    planes: Tuple[Tuple[Tuple[str, ...], AxisShard], ...] = ()

    @property
    def in_world(self) -> bool:
        """Whether this is a rank's mesh in a ``torch.distributed`` world
        of more than one rank."""
        return bool(self.coords) and self.size > 1

    def axis_shard(self, axis: Union[str, Tuple[str, ...]]
                   ) -> Optional[AxisShard]:
        """The calling rank's place on ``axis`` — a name, or a tuple of
        names in mesh order (the plane of those axes; its axes of one
        rank drop out) —, or None (no axis of more than one rank among
        them, or a mesh outside a world)."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        if not self.shards:
            return None
        unknown = [a for a in names if a not in self.axis_names]
        if unknown and isinstance(axis, str):
            return None
        if unknown:
            raise ValueError(f"no axes {unknown} in {self.axis_names}")
        order = [self.axis_names.index(a) for a in names]
        if order != sorted(order):
            raise ValueError(f"axes {names} out of the mesh's order "
                             f"{self.axis_names}")
        live = tuple(a for a in names if self.shape[a] > 1)
        if not live:
            return None
        if len(live) == 1:
            return self.shards[self.axis_names.index(live[0])]
        return dict(self.planes)[live]

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


_LINES: Dict[Tuple, Tuple] = {}


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: _dev.DeviceLike = None) -> Mesh:
    """A mesh whose programs run on ``device`` (the card unless asked
    otherwise): ``make_mesh((1, 1), ("data", "model"))`` is the one-card
    mesh. Inside a ``torch.distributed`` world of ``prod(shape)`` ranks
    it is the calling rank's mesh, with its coordinates and its axis
    lines' groups; every rank must call it with the same shape, since
    each axis line's and plane's group is created by all of them (once a
    process, then reused). A world of another size raises."""
    shape, axes = tuple(shape), tuple(axes)
    dev = _dev.resolve(device)
    n = math.prod(shape)
    if n == 1 or not (tdist.is_available() and tdist.is_initialized()):
        return Mesh(shape, axes, dev)
    if tdist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh in a world of "
                         f"{tdist.get_world_size()} ranks")
    key = (shape, axes, id(tdist.group.WORLD))
    if key not in _LINES:
        _LINES[key] = _rank_lines(shape, axes, tdist.get_rank())
    coords, shards, planes = _LINES[key]
    return Mesh(shape, axes, dev, coords, shards, planes)


def _rank_lines(shape, axes, rank: int):
    """The coordinates of ``rank``, its AxisShard per axis and per plane:
    every line of every axis of more than one rank, and every plane of two
    or more such axes, gets a group (each process creates them all, in
    one order), and the rank keeps its own."""
    coords = _unravel(rank, shape)
    live = [a for a, size in enumerate(shape) if size > 1]
    shards: list = [None] * len(shape)
    planes = []
    for n in range(1, len(live) + 1):
        for dims in itertools.combinations(live, n):
            mine = _plane_group(shape, coords, dims)
            if n == 1:
                shards[dims[0]] = mine
            else:
                planes.append((tuple(axes[a] for a in dims), mine))
    return coords, tuple(shards), tuple(planes)


def _plane_group(shape, coords, dims) -> AxisShard:
    """Groups for every plane over the mesh dims ``dims`` (each the ranks
    that share the other coordinates, row-major over ``dims``); returns
    the calling rank's, whose coordinates are ``coords``."""
    sizes = [shape[a] for a in dims]
    others = [range(s) if i not in dims else (None,)
              for i, s in enumerate(shape)]
    mine = None
    for rest in itertools.product(*others):
        members = []
        for inner in itertools.product(*(range(s) for s in sizes)):
            c = list(rest)
            for a, i in zip(dims, inner):
                c[a] = i
            members.append(_ravel(c, shape))
        group = tdist.new_group(ranks=members)
        if all(rest[i] == coords[i] for i in range(len(shape))
               if i not in dims):
            index = _ravel([coords[a] for a in dims], sizes)
            mine = AxisShard(index, len(members), group, tuple(members))
    return mine


def _unravel(rank: int, shape) -> Tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _ravel(coords, shape) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


def shape_only(mesh: Mesh) -> Mesh:
    """The same axes on the ``meta`` device: a program built on it counts
    its work and allocates nothing."""
    return dataclasses.replace(mesh, device=torch.device("meta"))


def check_runnable(mesh: Mesh) -> torch.device:
    """The device a program on ``mesh`` runs on; raises for an abstract
    mesh and, off ``meta``, for a mesh of more than one device outside a
    world (the caller must be one of its ranks: ``launch/ranks.py``)."""
    if mesh.device is None:
        raise ValueError("an abstract mesh holds sizes for the spec rules; "
                         "build the program on make_mesh(...) to run it")
    if mesh.size > 1 and mesh.device.type != "meta" and not mesh.in_world:
        raise NotImplementedError(
            f"a program over {mesh.size} devices runs in a world of as "
            "many ranks (launch/ranks.py), each calling make_mesh, or on "
            "meta as a count")
    return mesh.device


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The batch-sharding axes of a mesh — ('pod', 'data') when multi-pod."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh: Mesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def device_count(mesh: Mesh) -> int:
    return mesh.size

"""Collectives that the launch layer's sharding specs force on a model
axis of more than one rank (the reference's are XLA's, inserted by its
partitioner from ``repro.launch.sharding``'s specs, and the explicit
``psum`` of its shard_map MoE):

  * ``psum``       — the partial outputs of a row-parallel product (the
                     attention's ``wo`` over the rank's heads, the MLP's
                     ``w_down`` over its d_ff slice, the expert-TP MoE,
                     the RG-LRU's ``w_out`` over its channels, a
                     vocab-sharded embedding lookup) summed over the axis;
  * ``all_gather`` — the rank's slices along one dim, concatenated in axis
                     order (K/V's head_dim columns before qk-norm and
                     RoPE, decode's query heads, MLA decode's q and
                     ``w_ukv`` heads, the RG-LRU's conv output on the
                     width, the vocab-sharded logits);
  * ``exchange``   — a block from every rank to every other (the handoff's
                     head_dim → capacity reshard of K/V and of rings,
                     float8 e4m3 shards included, decode's partials of
                     each rank's heads).

They are plain functions over an ``AxisShard`` — the calling rank's
coordinate on the axis, the axis' size, its ``torch.distributed`` group
and that group's global ranks in axis order — and use only
``all_reduce`` and ``broadcast``, the two collectives that the gloo
backend takes on CUDA tensors (it stages them through the host); NCCL
takes them too, so one code path serves both backends (``launch/ranks.py``
picks the backend). ``all_gather`` and ``exchange`` are therefore
written as one ``broadcast`` a source rank (an exchange: one a (source,
destination) pair, which ranks outside the pair receive and drop), each
tensor sent as its bytes (a ``uint8`` view), so every dtype — float8
included — crosses bit for bit. ``psum`` sums in the tensor's own dtype,
as the reference's ``psum`` does (bfloat16 included: gloo adds bfloat16
and rounds to nearest even; with two ranks one addition, rounded once).
With no axis (``shard`` None: a model axis of one rank, the one-card
mesh) each is the identity, so one program serves both.

Every call adds its host-clock seconds, its bytes (of the local tensor)
and one call to ``STATS`` under its name; ``reset_stats`` zeroes them.
The timing is on the host clock around a blocking call: gloo returns once
the data have crossed (its CUDA path waits for the staging copies), so
the seconds include the device→host and host→device copies.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as tdist


@dataclasses.dataclass(frozen=True)
class AxisShard:
    """The calling rank's place on one mesh axis of more than one rank."""
    index: int                 # coordinate on the axis
    size: int                  # ranks on the axis
    group: Any                 # the axis line's process group
    ranks: Tuple[int, ...]     # the line's global ranks, in axis order

    def part(self, n: int) -> Tuple[int, int]:
        """[start, stop) of this rank's equal share of ``n`` (n divisible
        by the axis size)."""
        if n % self.size:
            raise ValueError(f"{n} does not split over {self.size} ranks")
        k = n // self.size
        return self.index * k, (self.index + 1) * k


STATS: Dict[str, Dict[str, float]] = {
    name: {"calls": 0, "seconds": 0.0, "bytes": 0}
    for name in ("psum", "all_gather", "exchange")}


def reset_stats() -> None:
    for rec in STATS.values():
        rec.update(calls=0, seconds=0.0, bytes=0)


def stats() -> Dict[str, Dict[str, float]]:
    """A copy of ``STATS``."""
    return {k: dict(v) for k, v in STATS.items()}


def _note(name: str, t0: float, nbytes: int) -> None:
    rec = STATS[name]
    rec["calls"] += 1
    rec["seconds"] += time.perf_counter() - t0
    rec["bytes"] += nbytes


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat ``uint8`` view."""
    return t.reshape(-1).view(torch.uint8)


def psum(x: torch.Tensor, shard: Optional[AxisShard]) -> torch.Tensor:
    """The sum of ``x`` over the axis (``jax.lax.psum``): every rank gets
    the same bits. Reduces in place when ``x`` is contiguous."""
    if shard is None:
        return x
    t0 = time.perf_counter()
    x = x.contiguous()
    tdist.all_reduce(x, op=tdist.ReduceOp.SUM, group=shard.group)
    _note("psum", t0, x.numel() * x.element_size())
    return x


def all_gather(x: torch.Tensor, dim: int,
               shard: Optional[AxisShard]) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in
    axis order: one broadcast from each rank."""
    if shard is None:
        return x
    t0 = time.perf_counter()
    x = x.contiguous()
    parts = []
    for i, src in enumerate(shard.ranks):
        buf = x if i == shard.index else torch.empty_like(x)
        tdist.broadcast(_bytes(buf), src=src, group=shard.group)
        parts.append(buf)
    out = torch.cat(parts, dim=dim)
    _note("all_gather", t0, x.numel() * x.element_size())
    return out


def exchange(blocks: List[torch.Tensor], shard: Optional[AxisShard]
             ) -> List[torch.Tensor]:
    """All-to-all of equal blocks: ``blocks[j]`` goes to axis member j
    (``blocks[index]`` stays); returns ``got`` with ``got[i]`` the block
    member i sent here. Every block on every rank has one shape and
    dtype. One broadcast a (source, destination) pair."""
    if shard is None:
        return list(blocks)
    t0 = time.perf_counter()
    me = shard.index
    got: List[torch.Tensor] = [None] * shard.size
    got[me] = blocks[me]
    sent = 0
    for i, src in enumerate(shard.ranks):
        for j in range(shard.size):
            if j == i:
                continue
            if me == i:
                buf = blocks[j].contiguous()
                sent += buf.numel() * buf.element_size()
            else:
                buf = torch.empty_like(blocks[me],
                                       memory_format=torch.contiguous_format)
            tdist.broadcast(_bytes(buf), src=src, group=shard.group)
            if me == j:
                got[i] = buf
    _note("exchange", t0, sent)
    return got

"""Gradient compression for a cross-pod reduction — PyTorch port of
``repro.training.compression``.

Two-level reduction: a full-precision all-reduce over the fast inner
group, then a compressed one over the slow outer group. The reference's
``shard_map`` axis names become ``torch.distributed`` process groups, or
a mesh's axis lines (an ``AxisShard`` of ``launch.mesh``: on a (pod,
data, model) mesh the pod line is the outer group and the data line the
inner); ``group=None`` is the default group:

  compressed_psum(x, group, wire)  — int8 absmax-quantized all-reduce
  hierarchical_psum(x, inner, outer, wire)
                                   — all-reduce(inner) → wire-compressed
                                     all-reduce(outer)

Error feedback (residual carrying) is provided for iterated use so the
quantization error does not bias the optimizer in the long run. Rounding
is half to even, as ``jnp.round``'s (``torch.round`` rounds so too).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8. Returns (q, scale)."""
    absmax = torch.max(torch.abs(x.float()))
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=getattr(group, "group", group))
    return out


def compressed_psum(x: torch.Tensor, group=None,
                    wire: str = "int8") -> torch.Tensor:
    """Sum of ``x`` over ``group``'s ranks through a compressed wire format.

    int8: each rank quantizes; the sum runs on the dequantized float32
    (the wire cost is the int8 payload + one scale — what an allgather of
    quantized shards would move). bf16: cast, sum, cast back."""
    if wire == "none":
        return _all_reduce(x, group)
    if wire == "bf16":
        return _all_reduce(x.to(torch.bfloat16), group).to(x.dtype)
    if wire == "int8":
        q, scale = quantize_int8(x)
        return _all_reduce(dequantize_int8(q, scale), group).to(x.dtype)
    raise ValueError(f"unknown wire {wire!r}")


def hierarchical_psum(x: torch.Tensor, inner_group, outer_group,
                      wire: str = "bf16") -> torch.Tensor:
    """All-reduce over the fast inner group in ``x``'s dtype, then a
    compressed all-reduce over the slow outer (cross-pod) group."""
    return compressed_psum(_all_reduce(x, inner_group), outer_group, wire)


def error_feedback_compress(x: torch.Tensor, residual: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """EF21-style: compress(x + residual), carry the new residual.

    Returns (q, scale, new_residual)."""
    target = x.float() + residual
    q, scale = quantize_int8(target)
    return q, scale, target - dequantize_int8(q, scale)

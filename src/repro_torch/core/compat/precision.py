"""Precision alignment component (paper §III-B) — PyTorch port of
``repro.core.compat.precision``.

P and D vendors may not share a native KV dtype: the wire carries a cast
(``raw``) or an int8 quantization with per-(token, head) absmax scales.
numpy has no bfloat16 here, so a bf16 wire slab is stored as uint16 bits
in host memory; every cast happens in torch (round to nearest even, as
ml_dtypes does), so the bytes equal the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import torch_dtype

# host (numpy) storage of each wire payload dtype
_NP_STORAGE = {"float32": np.dtype(np.float32), "bfloat16": np.dtype(np.uint16),
               "float16": np.dtype(np.float16), "int8": np.dtype(np.int8)}


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """On-the-wire representation of canonical KV (S, kv, hd)."""
    kind: str = "raw"          # "raw" (cast) | "int8" (quantized)
    dtype: str = "bfloat16"    # wire dtype for kind == "raw"

    def bytes_per_element(self) -> float:
        if self.kind == "int8":
            return 1.0 + 4.0 / 64  # scales amortized (one fp32 per 64 elems min)
        return torch_dtype(self.dtype).itemsize


def payload_name(wire: WireFormat) -> str:
    """dtype name of the wire payload slab."""
    if wire.kind == "int8":
        return "int8"
    if wire.kind == "raw":
        return wire.dtype
    raise ValueError(f"unknown wire kind {wire.kind!r}")


def storage_dtype(name: str) -> np.dtype:
    """numpy storage dtype of a wire slab of dtype ``name`` (bf16 as
    uint16 bits)."""
    return _NP_STORAGE[name]


def host_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    """A numpy wire view (storage dtype) as a torch tensor of dtype
    ``name``, sharing memory."""
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 over the last axis, in float32:
    scale = max(absmax, 1e-8) / 127, q = clip(round(x / scale))."""
    x = x.float()
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def encode_wire(kv_canon: torch.Tensor, wire: WireFormat
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """canonical (S, kv, hd) → (payload, scales|None)."""
    if wire.kind == "raw":
        return kv_canon.to(torch_dtype(wire.dtype)), None
    if wire.kind == "int8":
        return quantize_int8(kv_canon)
    raise ValueError(f"unknown wire kind {wire.kind!r}")


def decode_wire(payload: torch.Tensor, scales: Optional[torch.Tensor],
                wire: WireFormat, target_dtype: torch.dtype) -> torch.Tensor:
    """(payload, scales) → canonical KV in the D instance's dtype."""
    if wire.kind == "raw":
        return payload.to(target_dtype)
    if wire.kind == "int8":
        return (payload.float() * scales).to(target_dtype)
    raise ValueError(f"unknown wire kind {wire.kind!r}")


def encode_wire_into(src: torch.Tensor, wire: WireFormat, out: torch.Tensor,
                     scales_out: Optional[torch.Tensor] = None) -> None:
    """Single-pass encode of canonical KV (on any device) straight into a
    host buffer view: ``out`` has the wire's torch dtype; for the int8 wire
    ``scales_out`` is the float32 scale view with a trailing axis of 1."""
    if wire.kind == "raw":
        out.copy_(src)
        return
    if wire.kind == "int8":
        q, scale = quantize_int8(src)
        out.copy_(q)
        scales_out.copy_(scale.reshape(scales_out.shape))
        return
    raise ValueError(f"unknown wire kind {wire.kind!r}")


def cast_error_bound(src_dtype, wire: WireFormat) -> float:
    """Worst-case relative error introduced at the boundary."""
    if wire.kind == "int8":
        return 1.0 / 127.0
    eps = {"float32": 2 ** -24, "bfloat16": 2 ** -8, "float16": 2 ** -11}
    return float(eps.get(wire.dtype, 2 ** -8))

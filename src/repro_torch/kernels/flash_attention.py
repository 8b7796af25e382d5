"""Wrapper for the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Counterpart of ``repro.kernels.flash_attention`` (the Pallas TPU kernel).
The kernel adds what chunked prefill needs: ``q_offset`` (the absolute
position of query row 0, so a chunk at c0 masks causally against a cache
that holds positions 0..) and ``kv_len`` (keys at or past it are masked).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

LAUNCHES = {"flash_attention": 0}      # kernel launches, by kernel name
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load().rt_flash_attention
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                      + [ctypes.c_longlong] * 12
                      + [ctypes.c_float] + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])
        _fn = f
    return _fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,Sq,d); k, v: (B,KV,Skv,d), CUDA tensors of one dtype (f32
    or bf16) whose last axis is contiguous; any (batch, head, seq) strides.
    Returns (B,H,Sq,d), laid out in memory as (B,Sq,H,d)."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    kv_len = skv if kv_len is None else int(kv_len)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on {q.device} "
                             f"(CUDA), got {t.device}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} dtype {t.dtype}; "
                            "takes float32 or bfloat16, all alike")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be 4-D with a "
                             "contiguous last axis")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if h % kvh or d > MAX_HEAD_DIM or not 0 <= kv_len <= skv or q_offset < 0:
        raise ValueError(f"flash_attention: unsupported h={h} kv={kvh} d={d} "
                         f"kv_len={kv_len} q_offset={q_offset}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), DTYPES[q.dtype],
        b, h, kvh, sq, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2),
        scale, int(causal), int(window), int(q_offset), kv_len, stream)
    _build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o

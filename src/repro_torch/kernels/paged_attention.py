"""Wrapper for the CUDA paged decode-attention kernel
(``csrc/paged_attention.cu``).

Counterpart of ``repro.kernels.paged_attention`` (the Pallas TPU kernel,
which takes only nbhd pools). This kernel reads nbhd, nhbd and nhdb pools
through their strides, so a D vendor's native layout needs no permute.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.serving.paged_cache import _FROM_CANON

LAUNCHES = {"paged_attention": 0}      # kernel launches, by kernel name
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP_DIM = 16 * 128          # query heads per KV head x head_dim
SMEM_LIMIT = 227 * 1024

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load().rt_paged_attention
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                      + [ctypes.c_longlong] * 8
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        _fn = f
    return _fn


def pool_strides(pool: torch.Tensor, layout: str):
    """(block, token, head, dim) element strides of a (N, *page) pool."""
    perm = _FROM_CANON[layout]            # page axis a holds canonical perm[a]
    axis = {c: a + 1 for a, c in enumerate(perm)}
    return (pool.stride(0), pool.stride(axis[0]), pool.stride(axis[1]),
            pool.stride(axis[2]))


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    seq_lens: torch.Tensor, *, layout: str = "nbhd",
                    scale: Optional[float] = None,
                    window: int = 0) -> torch.Tensor:
    """q: (B,H,d) with a contiguous last axis; pools (N, *page) in
    ``layout``; block_table (B, max_pages) and seq_lens (B,) int32, all
    CUDA tensors on one device. seq_lens count the current token.
    Returns (B,H,d)."""
    b, h, d = q.shape
    perm = _FROM_CANON[layout]
    page = k_pool.shape[1:]
    canon = [0, 0, 0]
    for a, c in enumerate(perm):
        canon[c] = page[a]
    bs, kvh, pd = canon
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("seq_lens", seq_lens)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"paged_attention: {name} must be on {q.device} "
                             f"(CUDA), got {t.device}")
    if q.dtype not in DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError("paged_attention: q and pools must share float32 or "
                        f"bfloat16, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block_table and seq_lens are int32")
    if (k_pool.dim() != 4 or v_pool.shape != k_pool.shape or pd != d
            or q.stride(-1) != 1 or not block_table.is_contiguous()
            or not seq_lens.is_contiguous() or block_table.shape[0] != b
            or seq_lens.shape != (b,)):
        raise ValueError(f"paged_attention: shapes q{tuple(q.shape)} "
                         f"pool{tuple(k_pool.shape)} ({layout}) "
                         f"table{tuple(block_table.shape)}")
    strides = pool_strides(k_pool, layout)
    if pool_strides(v_pool, layout) != strides:
        raise ValueError("paged_attention: k and v pools differ in strides")
    grp = h // kvh if kvh else 0
    smem = 4 * (grp * d + 2 * bs * (d + 1) + grp * bs + 3 * grp)
    if kvh == 0 or h % kvh or grp * d > MAX_GROUP_DIM or smem > SMEM_LIMIT:
        raise ValueError(f"paged_attention: unsupported h={h} kv={kvh} d={d} "
                         f"block_size={bs}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), seq_lens.data_ptr(), o.data_ptr(),
        DTYPES[q.dtype], b, h, kvh, d, bs, block_table.shape[1],
        q.stride(0), q.stride(1), *strides, o.stride(0), o.stride(1),
        scale, int(window), stream)
    _build.check(err, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return o

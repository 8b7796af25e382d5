"""Wrapper for the CUDA overlay re-page kernel (``csrc/kv_repack.cu``).

Counterpart of ``repro.kernels.kv_repack.scatter_pages_overlay``. The
port's kernel takes a leading layer axis, so one launch re-pages every
layer of a block group. ``gather_pages``, ``scatter_pages`` and ``repack``
are not on the serving path and are not ported yet (ROADMAP queue 2).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.serving.paged_cache import _FROM_CANON, KVPageSpec

LAUNCHES = 0            # kernel launches made by this wrapper
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load().rt_scatter_pages_overlay
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                      + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                      + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 2
                      + [ctypes.c_void_p])
        _fn = f
    return _fn


def scatter_pages_overlay(spec: KVPageSpec, pool: torch.Tensor,
                          block_ids: torch.Tensor, canon: torch.Tensor, *,
                          front: int, seq_len: int) -> torch.Tensor:
    """pool: (L, N, *page) contiguous, in ``spec.layout`` and dtype;
    block_ids: (nb,) int32; canon float32 or bfloat16, any strides, either
    whole pages (L, nb, bs, kv, hd) whose flat rows ``[front, front +
    seq_len)`` hold the stream, or the stream's rows alone (L, seq_len, kv,
    hd), landing at flat row ``front``. Writes those rows into the pool
    pages in place, cast to the pool dtype; every other row keeps its
    contents. Returns ``pool``."""
    global LAUNCHES
    n_layers, nb, bs = canon.shape[0], block_ids.shape[0], spec.block_size
    for name, t in (("pool", pool), ("canon", canon),
                    ("block_ids", block_ids)):
        if not t.is_cuda or t.device != pool.device:
            raise ValueError(f"scatter_pages_overlay: {name} must be on "
                             f"{pool.device} (CUDA), got {t.device}")
    if pool.dtype not in DTYPES or canon.dtype not in DTYPES:
        raise TypeError("scatter_pages_overlay: pool/canon dtype "
                        f"{pool.dtype}/{canon.dtype}; takes float32/bfloat16")
    if block_ids.dtype != torch.int32 or not block_ids.is_contiguous():
        raise TypeError("scatter_pages_overlay: block_ids are contiguous int32")
    page = spec.page_shape()
    rows = (spec.kv_heads, spec.head_dim)
    stream_rows = canon.dim() == 4       # row r of canon is flat row front+r
    want = (seq_len,) + rows if stream_rows else (nb, bs) + rows
    if (not pool.is_contiguous() or pool.dim() != 5
            or tuple(pool.shape[2:]) != page or pool.shape[0] != n_layers
            or tuple(canon.shape[1:]) != want or block_ids.dim() != 1):
        raise ValueError(f"scatter_pages_overlay: pool{tuple(pool.shape)} "
                         f"canon{tuple(canon.shape)} ids{tuple(block_ids.shape)}"
                         f" front={front} seq_len={seq_len} do not match "
                         f"{spec}")
    if not (0 <= front and front + seq_len <= nb * bs):
        raise ValueError(f"scatter_pages_overlay: rows [{front}, "
                         f"{front + seq_len}) outside {nb} pages of {bs}")
    if stream_rows:
        row_strides = canon.stride()[1:]
        page_stride, canon_off = bs * canon.stride(1), -front * canon.stride(1)
    else:
        row_strides = canon.stride()[2:]
        page_stride, canon_off = canon.stride(1), 0
    perm = _FROM_CANON[spec.layout]
    c_strides = [row_strides[perm[a]] for a in range(3)]
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    err = _kernel()(
        pool.data_ptr(), canon.data_ptr(), block_ids.data_ptr(),
        DTYPES[pool.dtype], DTYPES[canon.dtype], n_layers, nb, bs,
        pool.stride(0), pool.stride(1), page[0], page[1], page[2],
        perm.index(0), *c_strides, canon.stride(0), page_stride, canon_off,
        int(front), int(seq_len), stream)
    _build.check(err, "scatter_pages_overlay")
    LAUNCHES += 1
    return pool

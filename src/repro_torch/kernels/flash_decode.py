"""Wrapper for the CUDA decode-attention kernel over dense position-tagged
caches (``csrc/flash_decode.cu``).

Counterpart of ``repro.kernels.flash_attention`` on the caches that decode
reads: a ring buffer (a sliding layer's window-sized cache, slot =
position % capacity) or a full-capacity cache, K/V in float32, bfloat16
or float8 e4m3. The reference computes that step in jnp
(``repro.models.layers.attention_decode``: ``cache_attention_mask`` +
``sdpa``); the port's flash kernel reads a cache only where slot ==
position, in bfloat16 or float32. Its plain version is
``ref.cache_attention_ref``.

The kernel cuts the cache's slots into tiles of ``TILE`` and the tiles
across blocks with the paged kernel's ``split_plan`` and, with more than
one split, merges the splits' float32 partials in a second launch of the
same call; ``launch_plan`` holds every other choice the host makes
(padded head dim, the head split, stage row pitch, shared memory), so the
CPU tests can check them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import (BLOCK_GROUP_DIM,
                                                 BLOCKS_PER_SM, MAX_GRID_Y,
                                                 MAX_HEAD_DIM,
                                                 MIN_PAGES_PER_SPLIT,
                                                 SMEM_LIMIT, WARPS, sm_count,
                                                 split_plan,
                                                 stage_copy_bytes)

LAUNCHES = {"flash_decode": 0}         # wrapper calls that launched
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
# (q, K/V) pairs the kernel takes: float8 K/V under a bfloat16 query
PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.bfloat16, torch.float8_e4m3fn)}
TILE = 32                              # slots a stage holds
STAGES = 3                             # the kernel's cp.async ring
MAX_GRID_Z = 65535                     # sequences x query rows
# the ring at the widest stage (float32 rows of MAX_HEAD_DIM) and the warps'
# merge buffer at the widest block fit, so every shape gets the 3 stages
assert STAGES * (2 * TILE * MAX_HEAD_DIM * 4 + 4 * TILE) <= SMEM_LIMIT
assert 4 * WARPS * (2 * BLOCK_GROUP_DIM // 64 + BLOCK_GROUP_DIM) <= SMEM_LIMIT

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load().rt_flash_decode
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 14
                      + [ctypes.c_longlong] * 10
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p])
        _fn = f
    return _fn


def check_dtypes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise TypeError for a (q, K/V) dtype pair the kernel does not take."""
    if k.dtype != v.dtype or (q.dtype, k.dtype) not in PAIRS:
        raise TypeError(f"flash_decode: q {q.dtype} with K/V {k.dtype}/"
                        f"{v.dtype}; the kernel takes float32/float32, "
                        "bfloat16/bfloat16 or bfloat16/float8_e4m3fn")


def launch_plan(h: int, kvh: int, d: int, kv_elem: int) -> Dict[str, int]:
    """Head dim padded to the lanes' layout (64, 128 or 256), the head
    split (blocks per KV head's group: the fewest that divide it into equal
    shares of at most BLOCK_GROUP_DIM query heads x padded head dim), stage
    row pitch (elements, a multiple of 16 bytes) and dynamic shared memory
    of one launch; raises ValueError for a shape the kernel does not
    take."""
    if kvh <= 0 or h % kvh or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_decode: unsupported h={h} kv={kvh} d={d}")
    grp = h // kvh
    hd = next(n for n in (64, 128, MAX_HEAD_DIM) if d <= n)
    hs = next(s for s in range(-(-grp * hd // BLOCK_GROUP_DIM), grp + 1)
              if grp % s == 0)
    if kvh * hs > MAX_GRID_Y:
        raise ValueError(f"flash_decode: {kvh} KV heads x head split {hs} "
                         f"> {MAX_GRID_Y} blocks on the grid's y axis")
    grp //= hs
    unit = 16 // kv_elem
    pitch = -(-d // unit) * unit
    stage = 2 * TILE * pitch * kv_elem + 4 * TILE
    merge = 4 * WARPS * (2 * grp + grp * hd)
    return {"head_dim": hd, "head_split": hs, "pitch": pitch,
            "smem": max(STAGES * stage, merge)}


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor, *, q_offset: int, window: int = 0,
                 scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,d); k, v: (B,cap,KV,d) with the head dim unit-stride and
    rows 4-byte aligned; pos: (B,cap) int32 with unit-stride slots; all
    CUDA tensors on one device. Query row i sits at ``q_offset + i``.
    Returns (B,Sq,H,d) in q's dtype."""
    b, sq, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_decode: {name} must be on {q.device} "
                             f"(CUDA), got {t.device}")
    check_dtypes(q, k, v)
    if pos.dtype != torch.int32:
        raise TypeError(f"flash_decode: pos is int32, got {pos.dtype}")
    if (k.dim() != 4 or v.shape != k.shape or k.shape[0] != b
            or k.shape[3] != d or pos.shape != k.shape[:2]):
        raise ValueError(f"flash_decode: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"pos{tuple(pos.shape)}")
    if q.stride(-1) != 1 or pos.stride(-1) != 1 or k.stride() != v.stride():
        raise ValueError("flash_decode: q's head dim and pos's slots must be "
                         "unit-stride, and k and v share strides")
    # bytes per cp.async of a K/V row, from the caches' (batch, slot,
    # head) strides and alignment as the paged kernel's pages
    cb = stage_copy_bytes(k, v, k.stride(), d)
    if cb == 0:
        raise ValueError("flash_decode: K/V rows must be unit-stride and "
                         "4-byte aligned (base pointers, strides and the "
                         f"row), got strides {k.stride()}")
    cap, kvh = k.shape[1], k.shape[2]
    if b * sq > MAX_GRID_Z or not 0 <= q_offset <= 2 ** 31 - 1 - sq:
        raise ValueError(f"flash_decode: {b} x {sq} query rows at q_offset "
                         f"{q_offset}")
    plan = launch_plan(h, kvh, d, k.element_size())
    n_tiles = -(-cap // TILE)
    n_splits, tps = split_plan(n_tiles, b * sq, kvh * plan["head_split"],
                               sm_count(q.device), BLOCKS_PER_SM,
                               MIN_PAGES_PER_SPLIT)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    part_acc = part_ml = None
    if n_splits > 1:
        part_acc = torch.empty((b * sq, n_splits, h, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b * sq, n_splits, h, 2), dtype=torch.float32,
                              device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), o.data_ptr(),
        part_acc.data_ptr() if part_acc is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        Q_DTYPES[q.dtype], KV_DTYPES[k.dtype], b, sq, h, kvh,
        plan["head_split"], d, cap, TILE, n_splits, tps, plan["pitch"], cb, q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2), pos.stride(0), o.stride(0),
        o.stride(1), o.stride(2), scale, int(window), int(q_offset), stream)
    _build.check(err, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return o

"""Wrapper for the CUDA decode-attention kernel over dense position-tagged
caches (``csrc/flash_decode.cu``).

Counterpart of ``repro.kernels.flash_attention`` on the caches that decode
reads: a ring buffer (a sliding layer's window-sized cache, slot =
position % capacity) or a full-capacity cache, K/V in float32, bfloat16
or float8 e4m3, V as wide as K or narrower (dv <= dk: MLA's latent
expanded to K of 192 and V of 128). The reference computes that step in jnp
(``repro.models.layers.attention_decode``: ``cache_attention_mask`` +
``sdpa``). The port sends here every one-row decode over a dense cache and
every chunk over a ring or a float8 cache (``models.layers``). Its plain
version is ``ref.cache_attention_ref``.

A bfloat16 q (over bfloat16 or float8 K/V) runs the tensor-core kernel:
tiles of ``16 x`` slot groups a block, the KV group's query heads as the
rows of an ``mma.sync`` product, a ring of 2-4 stages (as many as keep
``REG_BLOCKS`` blocks an SM). A float32 q and
K/V run the scalar kernel (tiles of ``TILE_F32`` slots, 3 stages, a
group wider than ``BLOCK_GROUP_DIM`` flattened elements shared by several
blocks). The cache's slot tiles are cut across blocks by ``split_plan``
and, with more than one split, the splits' float32 partials are merged in
a second launch of the same call. ``launch_plan`` holds every other choice
the host makes (padded head dim, tile, head split, staged row pitches,
stages, shared memory), so the CPU tests can check them.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import (BLOCK_GROUP_DIM,
                                                 MAX_GRID_Y, MAX_HEAD_DIM,
                                                 SMEM_LIMIT, WARPS, sm_count,
                                                 stage_copy_bytes)

# wrapper calls that launched: the merged call, the call that stops at
# the partials, and the combine of partials from several calls
LAUNCHES = {"flash_decode": 0, "flash_decode_partial": 0,
            "decode_combine": 0}
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
# (q, K/V) pairs the kernel takes: float8 K/V under a bfloat16 query
PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.bfloat16, torch.float8_e4m3fn)}
TILE_F32 = 32                          # the scalar kernel's slots a stage
STAGES_F32 = 3                         # and its cp.async ring
MMA_ROWS = 16                          # query heads an mma A tile holds
MAX_STAGES = 4                         # the tensor-core kernel's ring, at most
SM_SMEM = 228 * 1024                   # an SM's shared memory
BLOCK_RESERVED = 1024                  # the runtime's share of it a block
# blocks an SM holds by registers: the tensor-core kernel's launch bounds
# (Mma::MINB: 3 up to head dim 128, 2 at 256) and the scalar kernel's
# (up to 254 registers a thread)
REG_BLOCKS = {64: 3, 128: 3, 256: 2}
REG_BLOCKS_F32 = 2
WAVES = 2                              # blocks >= WAVES x SMs, cache allowing
SETUP_TILES = 2                        # a block's set-up, in tiles streamed
MAX_GRID_X = 65535                     # splits
MAX_GRID_Z = 65535                     # sequences x query rows
# the scalar kernel's ring at the widest stage (float32 rows of
# MAX_HEAD_DIM) and its warps' merge buffer at the widest share fit
assert STAGES_F32 * (2 * TILE_F32 * MAX_HEAD_DIM * 4 + 4 * TILE_F32) \
    <= SMEM_LIMIT
assert 4 * WARPS * (2 * BLOCK_GROUP_DIM // 64 + BLOCK_GROUP_DIM) <= SMEM_LIMIT

_fn = None
_combine_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load().rt_flash_decode
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 17
                      + [ctypes.c_longlong] * 13
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p])
        _fn = f
    return _fn


def _combine_kernel():
    global _combine_fn
    if _combine_fn is None:
        f = _build.load().rt_decode_combine
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                      + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
        _combine_fn = f
    return _combine_fn


def check_dtypes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise TypeError for a (q, K/V) dtype pair the kernel does not take."""
    if k.dtype != v.dtype or (q.dtype, k.dtype) not in PAIRS:
        raise TypeError(f"flash_decode: q {q.dtype} with K/V {k.dtype}/"
                        f"{v.dtype}; the kernel takes float32/float32, "
                        "bfloat16/bfloat16 or bfloat16/float8_e4m3fn")


def _padded(d: int) -> int:
    return next(n for n in (64, 128, MAX_HEAD_DIM) if d <= n)


@functools.lru_cache(maxsize=256)
def launch_plan(h: int, kvh: int, d: int, kv_elem: int,
                dv: Optional[int] = None) -> Dict[str, int]:
    """One launch's plan for q (.., h, d) over K (.., kvh, d) and V (..,
    kvh, dv) (dv <= d; None: d) of ``kv_elem`` bytes an element (4: the
    float32 scalar kernel; 2 or 1: the tensor-core kernel under a bfloat16
    q): K's and V's head dims padded to 64, 128 or 256, slots a tile, the
    head split (blocks sharing a KV head's group; 1 on the tensor-core
    kernel, whose 16-row head tiles loop inside the block: ``m_tiles``),
    staged K and V row pitches (elements), ring stages, dynamic shared
    memory, and the blocks an SM holds (by registers and shared memory).
    Raises ValueError for a shape the kernel does not take."""
    dv = d if dv is None else dv
    if kvh <= 0 or h % kvh or not 0 < dv <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_decode: unsupported h={h} kv={kvh} d={d} "
                         f"dv={dv}")
    grp = h // kvh
    hd, hdv = _padded(d), _padded(dv)
    if kv_elem == 4:
        hs = next(s for s in range(-(-grp * hd // BLOCK_GROUP_DIM), grp + 1)
                  if grp % s == 0)
        tile, stages, m_tiles = TILE_F32, STAGES_F32, 1
        pitch_k = pitch_v = -(-d // 4) * 4
        merge = 4 * WARPS * (2 * (grp // hs) + grp // hs * hd)
    else:
        # two warps share a slot group (and split V's head dim) at 256
        hs, m_tiles = 1, -(-grp // MMA_ROWS)
        slot_groups = 2 if hdv == MAX_HEAD_DIM else WARPS
        tile = MMA_ROWS * slot_groups
        # bank-conflict-free fragment loads: K rows 16 bytes past a
        # multiple of 32; V rows an odd multiple of 16 bytes (bf16,
        # ldmatrix) or 32 past a multiple of 128 (e4m3, 4 rows a load)
        pitch_k = hd + 16 // kv_elem
        pitch_v = hdv + 8 if kv_elem == 2 else hdv + 32
        merge = 4 * slot_groups * MMA_ROWS * (2 + hdv)
    if kvh * hs > MAX_GRID_Y:
        raise ValueError(f"flash_decode: {kvh} KV heads x head split {hs} "
                         f"> {MAX_GRID_Y} blocks on the grid's y axis")
    stage = tile * (pitch_k + pitch_v) * kv_elem + 4 * tile
    blocks = REG_BLOCKS_F32 if kv_elem == 4 else REG_BLOCKS[hd]
    if kv_elem != 4:          # the most stages that keep `blocks` an SM
        stages = max(2, min(MAX_STAGES, ring_budget(hd) // stage))
    smem = max(stages * stage, merge)
    return {"head_dim": hd, "head_dim_v": hdv, "tile": tile,
            "head_split": hs,
            "m_tiles": m_tiles, "pitch_k": pitch_k, "pitch_v": pitch_v,
            "stages": stages, "smem": smem,
            "resident": max(1, min(blocks,
                                   SM_SMEM // (smem + BLOCK_RESERVED)))}


def ring_budget(head_dim: int) -> int:
    """Shared memory a tensor-core block's ring may take so that as many
    blocks share an SM as its registers allow."""
    return SM_SMEM // REG_BLOCKS[head_dim] - BLOCK_RESERVED


@functools.lru_cache(maxsize=1024)
def split_plan(n_tiles: int, pairs: int, n_sm: int = 132,
               resident: int = 2) -> Tuple[int, int]:
    """(n_splits, tiles per split) for ``pairs`` (sequence x query row, KV
    head [x head share]) blocks' worth of ``n_tiles`` slot tiles each:
    among the splits that give at least WAVES x ``n_sm`` blocks (or one
    block a tile, where the cache has fewer), the one that finishes in the
    least time as the host can count it — the rounds of ``n_sm`` x
    ``resident`` blocks times the tiles a block streams plus its set-up —
    preferring fewer splits at a tie. Split s covers tiles [s * tps,
    (s + 1) * tps). Uses only what the host knows: no sequence length."""
    if n_tiles <= 0:
        return 1, 1
    floor = min(WAVES * n_sm, pairs * n_tiles)
    slots = n_sm * max(1, resident)
    best = None
    for tps in range(1, n_tiles + 1):
        splits = -(-n_tiles // tps)
        if pairs * splits < floor:
            break
        if splits > MAX_GRID_X:
            continue
        cost = -(-pairs * splits // slots) * (tps + SETUP_TILES)
        if best is None or cost <= best[0]:
            best = (cost, splits, tps)
    if best is None:
        raise ValueError(f"flash_decode: {n_tiles} tiles need more than "
                         f"{MAX_GRID_X} splits")
    return best[1], best[2]


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor, *, q_offset: int, window: int = 0,
                 scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,d); k: (B,cap,KV,d), v: (B,cap,KV,dv) with dv <= d, each
    head dim unit-stride and rows 4-byte aligned; pos: (B,cap) int32 with
    unit-stride slots; all CUDA tensors on one device. Query row i sits at
    ``q_offset + i``; ``scale`` defaults to 1/sqrt(d). Returns (B,Sq,H,dv)
    in q's dtype."""
    return _launch(q, k, v, pos, q_offset, window, scale, partial=False)


def flash_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor, *, q_offset: int,
                         window: int = 0, scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_decode``'s split kernel on the same inputs, stopped before
    the merge: (acc (B,Sq,S,H,dv), ml (B,Sq,S,H,2)) float32, split s's
    unnormalised P·V and its running max m (natural-log units) and sum l
    — S splits of the call's own plan, at least one. A split that sees no
    slot has m = -1e30 and l = 0. ``decode_combine`` merges the partials
    of several such calls (a cache whose slots are cut across ranks)."""
    return _launch(q, k, v, pos, q_offset, window, scale, partial=True)


def decode_combine(acc: torch.Tensor, ml: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Merge partials (acc (B,Sq,S,H,d), ml (B,Sq,S,H,2) float32,
    contiguous CUDA tensors: the splits of one or more
    ``flash_decode_partial`` calls concatenated on axis 2) into (B,Sq,H,d)
    in ``out_dtype`` (float32 or bfloat16): each split weighs exp(m_s -
    max m), the output is sum(w acc) / sum(w l), or 0 where every l is 0
    — the combine kernel of ``flash_decode``'s own splits."""
    if acc.dim() != 5 or ml.shape != acc.shape[:4] + (2,):
        raise ValueError(f"decode_combine: acc{tuple(acc.shape)} "
                         f"ml{tuple(ml.shape)}")
    for name, t in (("acc", acc), ("ml", ml)):
        if not t.is_cuda or t.device != acc.device \
                or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"decode_combine: {name} must be a contiguous "
                             f"float32 CUDA tensor on {acc.device}")
    if out_dtype not in Q_DTYPES:
        raise TypeError(f"decode_combine: out dtype {out_dtype}")
    b, sq, n_splits, h, d = acc.shape
    if b * sq > MAX_GRID_Z or h > MAX_GRID_Y or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"decode_combine: acc{tuple(acc.shape)}")
    o = torch.empty((b, sq, h, d), dtype=out_dtype, device=acc.device)
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    err = _combine_kernel()(
        acc.data_ptr(), ml.data_ptr(), o.data_ptr(), Q_DTYPES[out_dtype], b,
        sq, h, d, n_splits, o.stride(0), o.stride(1), o.stride(2), stream)
    _build.check(err, "decode_combine")
    LAUNCHES["decode_combine"] += 1
    return o


def _launch(q, k, v, pos, q_offset, window, scale, partial: bool):
    b, sq, h, d = q.shape
    what = "flash_decode_partial" if partial else "flash_decode"
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what}: {name} must be on {q.device} "
                             f"(CUDA), got {t.device}")
    check_dtypes(q, k, v)
    if pos.dtype != torch.int32:
        raise TypeError(f"{what}: pos is int32, got {pos.dtype}")
    dv = v.shape[-1] if v.dim() == 4 else 0
    if (k.dim() != 4 or v.shape[:3] != k.shape[:3] or not 0 < dv <= d
            or k.shape[0] != b or k.shape[3] != d
            or pos.shape != k.shape[:2]):
        raise ValueError(f"{what}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"pos{tuple(pos.shape)}")
    if q.stride(-1) != 1 or pos.stride(-1) != 1:
        raise ValueError(f"{what}: q's head dim and pos's slots must be "
                         "unit-stride")
    # bytes per cp.async of a K and a V row, from each cache's (batch,
    # slot, head) strides and alignment as the paged kernel's pages: the
    # narrower of the two serves both
    cb = min(stage_copy_bytes(k, k, k.stride(), d),
             stage_copy_bytes(v, v, v.stride(), dv))
    if cb == 0:
        raise ValueError(f"{what}: K/V rows must be unit-stride and "
                         "4-byte aligned (base pointers, strides and the "
                         f"row), got strides {k.stride()} {v.stride()}")
    cap, kvh = k.shape[1], k.shape[2]
    if b * sq > MAX_GRID_Z or not 0 <= q_offset <= 2 ** 31 - 1 - sq:
        raise ValueError(f"{what}: {b} x {sq} query rows at q_offset "
                         f"{q_offset}")
    plan = launch_plan(h, kvh, d, k.element_size(), dv)
    n_splits, tps = split_plan(-(-cap // plan["tile"]),
                               b * sq * kvh * plan["head_split"],
                               sm_count(q.device), plan["resident"])
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = None if partial else torch.empty((b, sq, h, dv), dtype=q.dtype,
                                         device=q.device)
    part = None
    part_acc = part_ml = None
    if n_splits > 1 or partial:   # (B*Sq, splits, H, dv) then (.., H, 2)
        rows = b * sq * n_splits * h
        part = torch.empty(rows * (dv + 2), dtype=torch.float32,
                           device=q.device)
        part_acc, part_ml = part.data_ptr(), part.data_ptr() + 4 * rows * dv
    # o's strides: those of the (B, Sq, H, dv) output, or zeros (unused)
    o_st = o.stride() if o is not None else (0, 0, 0, 0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        None if o is None else o.data_ptr(), part_acc, part_ml,
        Q_DTYPES[q.dtype], KV_DTYPES[k.dtype], b, sq, h, kvh,
        plan["head_split"], d, dv, cap, plan["tile"], n_splits, tps,
        plan["pitch_k"], plan["pitch_v"], plan["stages"], cb, q.stride(0),
        q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        pos.stride(0), o_st[0], o_st[1], o_st[2], scale,
        int(window), int(q_offset), stream)
    _build.check(err, what)
    LAUNCHES[what] += 1
    if o is not None:
        return o
    rows = b * sq * n_splits * h
    return (part[:rows * dv].view(b, sq, n_splits, h, dv),
            part[rows * dv:].view(b, sq, n_splits, h, 2))

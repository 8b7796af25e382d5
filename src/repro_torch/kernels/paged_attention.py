"""Wrapper for the CUDA paged decode-attention kernel
(``csrc/paged_attention.cu``).

Counterpart of ``repro.kernels.paged_attention`` (the Pallas TPU kernel,
which takes only nbhd pools). This kernel reads nbhd, nhbd and nhdb pools
through their strides, so a D vendor's native layout needs no permute.

The kernel cuts each sequence's pages across blocks (``split_plan``) and,
with more than one split, merges the splits' float32 partials in a second
launch of the same call; ``launch_plan`` holds every other choice the
host makes (padded head dim, the head split, stage row pitch, ring depth,
shared memory), so the CPU tests can check them. A block holds at most
2048 flattened (query head, padded dim) elements in its lanes' registers;
a wider group (RecurrentGemma's 16 heads x 256 on one KV head: 4096) is
cut into the fewest blocks that share its heads evenly (two there).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kv_repack import vector_width
from repro_torch.serving.paged_cache import _FROM_CANON

LAUNCHES = {"paged_attention": 0}      # wrapper calls that launched
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_GROUP_DIM = 16 * 128        # a block's query heads x padded head_dim
MAX_GRID_Y = 65535                # KV heads x head split, CUDA's grid limit
MAX_HEAD_DIM = 256
SMEM_LIMIT = 227 * 1024
WARPS = 4                         # warps per block of the split kernel
BLOCKS_PER_SM = 16                # blocks the split plan aims for, per SM
MIN_PAGES_PER_SPLIT = 4           # below this a block is mostly set-up

_fn = None
_n_sm: Dict[int, int] = {}


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load().rt_paged_attention
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 13
                      + [ctypes.c_longlong] * 8
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        _fn = f
    return _fn


def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device, read once per device (no sync)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _n_sm:
        props = torch.cuda.get_device_properties(idx)
        _n_sm[idx] = props.multi_processor_count
    return _n_sm[idx]


def pool_strides(pool: torch.Tensor, layout: str):
    """(block, token, head, dim) element strides of a (N, *page) pool."""
    perm = _FROM_CANON[layout]            # page axis a holds canonical perm[a]
    axis = {c: a + 1 for a, c in enumerate(perm)}
    return (pool.stride(0), pool.stride(axis[0]), pool.stride(axis[1]),
            pool.stride(axis[2]))


def split_plan(max_pages: int, batch: int, kv_heads: int, n_sm: int = 132,
               blocks_per_sm: int = BLOCKS_PER_SM,
               min_pages: int = MIN_PAGES_PER_SPLIT) -> Tuple[int, int]:
    """(n_splits, pages per split) of a block table ``max_pages`` wide:
    enough splits per (sequence, KV head) that the grid has about
    ``blocks_per_sm`` blocks per SM, but no fewer than ``min_pages`` pages
    per split (where the table has them), and no split past the table's
    width. Split s covers table pages [s * pps, (s + 1) * pps). Uses only
    what the host knows: no sequence length."""
    if max_pages <= 0:
        return 1, 1
    want = -(-n_sm * blocks_per_sm // max(1, batch * kv_heads))
    pps = min(max_pages, max(min_pages, -(-max_pages // want)))
    return -(-max_pages // pps), pps


def split_ranges(seq_len: int, block_size: int, max_pages: int, pps: int,
                 window: int = 0):
    """The splits that hold pages of one sequence, as (split, first page,
    end page): the pages the kernel reads are those from the first page
    inside the window to ceil(seq_len / block_size), clipped to the
    table; every split outside them exits without a partial."""
    n_pages = min(-(-seq_len // block_size), max_pages)
    p0 = max(0, seq_len - window) // block_size if window > 0 else 0
    out = []
    for s in range(-(-max_pages // pps)):
        pa, pb = max(s * pps, p0), min((s + 1) * pps, n_pages)
        if pa < pb:
            out.append((s, pa, pb))
    return out


def stage_copy_bytes(k_pool: torch.Tensor, v_pool: torch.Tensor,
                     strides, d: int) -> int:
    """Bytes per cp.async when a page's token rows are d contiguous
    elements: 16 where both pools' bases and the (block, token, head)
    strides and d allow it, 8 or 4 where they allow less; 0 (stage through
    registers) for token-innermost pages or 2-byte alignment."""
    p_sn, p_st, p_sh, p_sd = strides
    if p_sd != 1:
        return 0
    es = k_pool.element_size()
    vec = vector_width(16 // es, k_pool.data_ptr() // es,
                       v_pool.data_ptr() // es, p_sn, p_st, p_sh, d)
    return vec * es if vec * es >= 4 else 0


def launch_plan(h: int, kvh: int, d: int, bs: int, elem_size: int,
                copy_bytes: int) -> Dict[str, int]:
    """Head dim padded to the lanes' layout (32, 64, 128 or 256), the
    head split (blocks per KV head's group: the fewest that divide the
    group into equal shares of at most BLOCK_GROUP_DIM query heads x
    padded head dim, which the lanes hold in registers), stage row pitch
    (elements), ring stages and dynamic shared memory of one launch;
    raises ValueError for a shape the kernel does not take."""
    if kvh <= 0 or h % kvh or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: unsupported h={h} kv={kvh} d={d}")
    grp = h // kvh
    hd = next(n for n in (32, 64, 128, MAX_HEAD_DIM) if d <= n)
    hs = next(s for s in range(-(-grp * hd // BLOCK_GROUP_DIM), grp + 1)
              if grp % s == 0)
    if kvh * hs > MAX_GRID_Y:
        raise ValueError(f"paged_attention: {kvh} KV heads x head split "
                         f"{hs} > {MAX_GRID_Y} blocks on the grid's y axis")
    grp //= hs
    if copy_bytes:                        # 16-byte aligned rows for cp.async
        unit = 16 // elem_size
        pitch = -(-d // unit) * unit
    else:                                 # transposed rows, off the banks
        pitch = -(-d // 4) * 4 + 4
    merge = 4 * WARPS * (2 * grp + grp * hd)
    for stages in (3, 2, 1):
        smem = max(stages * 2 * bs * pitch * elem_size, merge)
        if smem <= SMEM_LIMIT:
            return {"head_dim": hd, "head_split": hs, "pitch": pitch,
                    "stages": stages, "smem": smem}
    raise ValueError(f"paged_attention: block_size {bs} x head_dim {d} needs "
                     f"{smem} bytes of shared memory > {SMEM_LIMIT}")


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
    cb = stage_copy_bytes(k_pool, v_pool, strides, d)
    plan = launch_plan(h, kvh, d, bs, q.element_size(), cb)
    max_pages = block_table.shape[1]
    n_splits, pps = split_plan(max_pages, b, kvh * plan["head_split"],
                               sm_count(q.device), BLOCKS_PER_SM,
                               MIN_PAGES_PER_SPLIT)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    part_acc = part_ml = None
    if n_splits > 1:
        part_acc = torch.empty((b, n_splits, h, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b, n_splits, h, 2), dtype=torch.float32,
                              device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), seq_lens.data_ptr(), o.data_ptr(),
        part_acc.data_ptr() if part_acc is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        DTYPES[q.dtype], b, h, kvh, plan["head_split"], d, bs, max_pages,
        n_splits, pps,
        plan["pitch"], plan["stages"], cb, q.stride(0), q.stride(1), *strides,
        o.stride(0), o.stride(1), scale, int(window), stream)
    _build.check(err, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return o

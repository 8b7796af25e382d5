"""Wrapper for the CUDA flash-attention kernels.

Counterpart of ``repro.kernels.flash_attention`` (the Pallas TPU kernel).
The kernels add what chunked prefill needs: ``q_offset`` (the absolute
position of query row 0, so a chunk at c0 masks causally against a cache
that holds positions 0..) and ``kv_len`` (keys at or past it are masked).

The value head dim may be smaller than the key head dim, as in MLA's
prefill (q and k 192 wide: 128 nope + 64 rope columns; v 128): the
kernels take dk up to 256 (RecurrentGemma's head dim) and dv up to dk
(``check_shapes``).

The dtype picks the kernel: bfloat16 runs the tensor-core kernel
(``csrc/flash_attention_wgmma.cu``: wgmma, TMA; 128x128 tiles up to dk
192 and dv 128, 64x64 tiles above), float32 the CUDA-core kernel
(``csrc/flash_attention.cu``), since the tensor cores take float32 only
as TF32. ``tile_plan`` is the bf16 kernel's launch plan in Python, so the
CPU tests can hold it against the masks (at 64 x 64 tiles for the wide
instance).
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build

LAUNCHES = {"flash_attention": 0}      # kernel launches, by kernel name
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256                     # q and k; v and the output up to it
BLOCK_M, BLOCK_N = 128, 128            # the bf16 kernel's query / key tiles
TMA_ALIGN = 16                         # bytes: TMA's base and stride unit

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load().rt_flash_attention
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                      + [ctypes.c_longlong] * 12
                      + [ctypes.c_float] + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])
        _fn = f
    return _fn


def tile_plan(sq: int, kv_len: int, *, causal: bool, window: int,
              q_offset: int, block_m: int = BLOCK_M,
              block_n: int = BLOCK_N) -> List[Tuple[int, range]]:
    """The bf16 kernel's blocks of one (batch, head), in launch order:
    (query tile, the key tiles it visits). Query tiles go heaviest first
    (the last tile of a causal launch sees the most keys); a tile visits
    every key tile that holds a visible key of one of its rows, and no
    other (``flash_tile_range`` in the kernel)."""
    n_q = -(-sq // block_m)
    plan = []
    for qt in reversed(range(n_q)):
        q0, q1 = qt * block_m, min((qt + 1) * block_m, sq)
        kv_end = min(kv_len, q_offset + q1) if causal else kv_len
        kv_start = max(0, q_offset + q0 - window + 1) if window > 0 else 0
        t_begin = kv_start // block_n
        t_end = -(-kv_end // block_n) if kv_end > kv_start else t_begin
        plan.append((qt, range(t_begin, t_end)))
    return plan


def _tma_strides(name: str, t: torch.Tensor) -> List[int]:
    """(batch, head, seq) element strides of a bf16 input for the TMA
    maps; raises ValueError, naming the cause, where TMA cannot take them
    (a base pointer or a stride not a multiple of 16 bytes). An axis of
    length 1 is never stepped, so its stride is replaced by one that is."""
    if t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"flash_attention: {name}'s base pointer is not "
                         f"{TMA_ALIGN}-byte aligned (storage offset "
                         f"{t.storage_offset()}); the bf16 kernel loads "
                         "through TMA")
    strides = []
    for axis, what in enumerate(("batch", "head", "seq")):
        st = t.stride(axis)
        if t.shape[axis] == 1:
            st = TMA_ALIGN // t.element_size()
        elif (st * t.element_size()) % TMA_ALIGN:
            raise ValueError(f"flash_attention: {name}'s {what} stride {st} "
                             f"is not a multiple of {TMA_ALIGN} bytes; the "
                             "bf16 kernel loads through TMA")
        strides.append(st)
    return strides


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: Optional[int] = None, q_offset: int = 0
                 ) -> Tuple[int, int, int]:
    """The kernels' shape rules, on any device: q (B,H,Sq,dk), k (B,KV,
    Skv,dk), v (B,KV,Skv,dv) with H a multiple of KV, dv <= dk <= 256,
    and in bfloat16 dk and dv multiples of 16. Returns (dk, dv, kv_len);
    raises ValueError otherwise."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be 4-D")
    b, h, _, dk = q.shape
    kvh, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    kv_len = skv if kv_len is None else int(kv_len)
    if k.shape[0] != b or k.shape[3] != dk or tuple(v.shape[:3]) != \
            tuple(k.shape[:3]):
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if (kvh <= 0 or h % kvh or dk > MAX_HEAD_DIM or dv > dk
            or not 0 <= kv_len <= skv or q_offset < 0):
        raise ValueError(f"flash_attention: unsupported h={h} kv={kvh} "
                         f"dk={dk} dv={dv} kv_len={kv_len} "
                         f"q_offset={q_offset} (dv <= dk <= {MAX_HEAD_DIM})")
    if q.dtype == torch.bfloat16 and (dk % 16 or dv % 16):
        raise ValueError(f"flash_attention: bf16 head dims dk={dk} dv={dv}:"
                         " each must be a multiple of 16")
    return dk, dv, kv_len


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,Sq,dk); k: (B,KV,Skv,dk); v: (B,KV,Skv,dv), CUDA tensors of
    one dtype (f32 or bf16) whose last axis is contiguous; any (batch,
    head, seq) strides. Returns (B,H,Sq,dv), laid out in memory as
    (B,Sq,H,dv). ``scale`` defaults to 1/sqrt(dk).

    Head dims as ``check_shapes`` says. bfloat16 also needs base pointers
    16-byte aligned and (batch, head, seq) strides that are multiples of
    8 elements; anything else raises ValueError."""
    b, h, sq, _ = q.shape
    kvh = k.shape[1]
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
    dk, dv, kv_len = check_shapes(q, k, v, kv_len, q_offset)
    if q.dtype == torch.bfloat16:
        strides = [st for name, t in (("q", q), ("k", k), ("v", v))
                   for st in _tma_strides(name, t)]
    else:
        strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    o = torch.empty((b, sq, h, dv), dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), DTYPES[q.dtype],
        b, h, kvh, sq, dk, dv, *strides, o.stride(0), o.stride(1), o.stride(2),
        scale, int(causal), int(window), int(q_offset), kv_len, stream)
    _build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o

"""Dispatch seam of the port's kernels (counterpart of
``repro.kernels.ops``).

A CPU tensor goes to the kernel's plain PyTorch version in ``ref``; a
CUDA tensor launches the hand-written kernel or raises. There is no
fallback from one to the other. Each kernel wrapper counts its launches
(``launch_counts``), so a run can show that the serving path went through
the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import kv_repack as _kr
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.serving.paged_cache import KVPageSpec

_WRAPPERS = {"flash_attention": _fa, "paged_attention": _pa,
             "scatter_pages_overlay": _kr}


def _on_cuda(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: unsupported device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,Sq,d); k,v: (B,KV,Skv,d) → (B,H,Sq,d). Query row i is at
    absolute position ``q_offset + i``; keys from ``kv_len`` on are
    masked."""
    if _on_cuda(q, "flash_attention"):
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=q_offset,
                                   kv_len=kv_len)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=q_offset,
                                   kv_len=kv_len)


def paged_attention(q, k_pool, v_pool, block_table, seq_lens, *,
                    layout: str = "nbhd", scale: Optional[float] = None,
                    window: int = 0) -> torch.Tensor:
    """Decode attention over paged pools in any layout. q: (B,H,d)."""
    if _on_cuda(q, "paged_attention"):
        return _pa.paged_attention(q, k_pool, v_pool, block_table, seq_lens,
                                   layout=layout, scale=scale, window=window)
    return ref.paged_attention_ref(q, k_pool, v_pool, block_table, seq_lens,
                                   layout=layout, scale=scale, window=window)


def scatter_pages_overlay(spec: KVPageSpec, pool, block_ids, canon, *,
                          front: int, seq_len: int) -> torch.Tensor:
    """In-place overlay scatter into a (L, N, *page) pool of canonical KV,
    either whole pages (L, nb, bs, kv, hd) or the stream's rows alone
    (L, seq_len, kv, hd) landing at flat row ``front``; rows outside
    [front, front+seq_len) keep their contents."""
    if _on_cuda(pool, "scatter_pages_overlay"):
        return _kr.scatter_pages_overlay(spec, pool, block_ids, canon,
                                         front=front, seq_len=seq_len)
    return ref.scatter_pages_overlay_ref(spec, pool, block_ids, canon,
                                         front=front, seq_len=seq_len)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: mod.LAUNCHES for name, mod in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod in _WRAPPERS.values():
        mod.LAUNCHES = 0

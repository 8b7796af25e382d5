"""Dispatch seam of the port's kernels (counterpart of
``repro.kernels.ops``).

A CPU tensor goes to the kernel's plain PyTorch version in ``ref``; a
CUDA tensor launches the hand-written kernel or raises. There is no
fallback from one to the other. A ``meta`` tensor (shapes only) goes to
the plain version too, which computes nothing there; within
``count_as_card`` (the roofline's count) it takes the card's route
instead, and ``flash_attention`` and ``cache_attention`` tally the
products their kernels do rather than those of their plain versions. The kernels have no backward pass: a
CUDA input that requires grad while grad mode is on raises, so that no
path can drop a gradient silently (training takes the plain attention
route explicitly, ``models.layers``). Each kernel wrapper counts its launches
by kernel name (``launch_counts``), so a run can show that the serving
path went through each kernel; a call that goes to a plain version counts
nothing.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import kv_repack as _kr
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.serving.paged_cache import KVPageSpec

_WRAPPERS = (_fa, _fd, _pa, _kr)          # modules holding LAUNCHES by name
FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2)
_card_tally: Optional[Dict[str, float]] = None   # set by count_as_card


@contextlib.contextmanager
def count_as_card() -> Iterator[Dict[str, float]]:
    """Within, ``meta`` tensors take the card's route
    (``models.layers.kernel_route``), and ``flash_attention`` and
    ``cache_attention`` on them raise where the card raises, return an
    uninitialised output and add the FLOPs their kernels do — each query
    row against its visible keys or slots only — to the tally it yields,
    ``{"flash_attention": FLOPs, "flash_decode": FLOPs}``."""
    global _card_tally
    prev, _card_tally = _card_tally, {}
    try:
        yield _card_tally
    finally:
        _card_tally = prev


def counting_as_card(where) -> bool:
    """Whether ``where`` (a tensor or a device) is on ``meta`` inside
    ``count_as_card``."""
    dev = where.device if isinstance(where, torch.Tensor) else \
        torch.device(where)
    return _card_tally is not None and dev.type == "meta"


def flash_visible_keys(sq: int, kv_len: int, *, causal: bool = True,
                       window: int = 0, q_offset: int = 0) -> int:
    """Keys that the ``sq`` query rows at ``q_offset..`` see in all: below
    ``kv_len``, at or before the row's position when ``causal``, within
    ``window`` of it when > 0 — the pairs flash computes."""
    pos = torch.arange(q_offset, q_offset + sq, dtype=torch.int64)
    hi = (pos + 1).clamp(max=kv_len) if causal else \
        torch.full_like(pos, kv_len)
    lo = (pos - window + 1).clamp(min=0) if window > 0 else \
        torch.zeros_like(pos)
    return int((hi - lo).clamp(min=0).sum())


def cache_visible_slots(sq: int, capacity: int, *, window: int = 0,
                        q_offset: int = 0) -> int:
    """Slots that the ``sq`` query rows at ``q_offset..`` see in all on a
    ``capacity``-slot cache that holds every position up to each row's
    own, as a decode step's does (a full ring, or a full-capacity cache
    filled up to the row): min(position + 1, capacity, ``window`` when
    > 0) a row — the pairs ``cache_attention``'s kernel scores."""
    pos = torch.arange(q_offset, q_offset + sq, dtype=torch.int64)
    seen = (pos + 1).clamp(max=capacity)
    if window > 0:
        seen = seen.clamp(max=window)
    return int(seen.sum())


def _on_cuda(t: torch.Tensor, op: str, *inputs: torch.Tensor) -> bool:
    """Whether ``t`` sends the call to the kernel. On the card, raises if
    any of ``inputs`` requires grad while grad mode is on: the kernel's
    output would carry no gradient back to it."""
    if t.device.type == "cuda":
        if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
            raise RuntimeError(
                f"{op}: the CUDA kernel has no backward pass, and an input "
                "requires grad; differentiate the plain route "
                "(models.layers: plain=True)")
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{op}: unsupported device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,Sq,dk); k: (B,KV,Skv,dk); v: (B,KV,Skv,dv) → (B,H,Sq,dv).
    Query row i is at absolute position ``q_offset + i``; keys from
    ``kv_len`` on are masked; ``scale`` defaults to 1/sqrt(dk). On the
    card, dv <= dk <= 256 (MLA's prefill: 192 and 128; RecurrentGemma:
    256 and 256); bfloat16 takes head dims that are multiples of 16 and 16-byte
    aligned pointers and (batch, head, seq) strides (TMA); float32 any
    head dims within those limits. Float8 K/V (a float8 dense cache) on the
    card raise: the kernel reads bfloat16 or float32; a float8 decode
    cache goes to ``cache_attention``."""
    counted = counting_as_card(q)
    if counted or _on_cuda(q, "flash_attention", q, k, v):
        if any(t.dtype in FLOAT8 for t in (k, v)):
            raise NotImplementedError(
                f"flash_attention: {k.dtype} K/V on the card; the kernel "
                "reads bfloat16 or float32 — a float8 decode cache takes "
                "ops.cache_attention")
        if counted:
            b, h, sq, dk = q.shape
            dv = v.shape[-1]
            seen = flash_visible_keys(
                sq, k.shape[2] if kv_len is None else kv_len, causal=causal,
                window=window, q_offset=q_offset)
            _card_tally["flash_attention"] = _card_tally.get(
                "flash_attention", 0.0) + 2.0 * b * h * seen * (dk + dv)
            return q.new_empty((b, h, sq, dv))
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=q_offset,
                                   kv_len=kv_len)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=q_offset,
                                   kv_len=kv_len)


def cache_attention(q, k, v, pos, *, q_offset: int, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over a dense position-tagged cache (a ring buffer
    or a full-capacity cache). q: (B,Sq,H,d); k, v: (B,cap,KV,d); pos:
    (B,cap) int32, -1 = empty → (B,Sq,H,d). Query row i at absolute
    position ``q_offset + i`` sees the slots with 0 <= pos <= its position
    and, when ``window`` > 0, within ``window`` of it — whatever the slot
    order. On the card, the flash_decode kernel: K/V bfloat16 or float32 as
    q, or float8 e4m3 under a bfloat16 q (widened exactly, no scale)."""
    counted = counting_as_card(q)
    if counted or _on_cuda(q, "cache_attention", q, k, v):
        _fd.check_dtypes(q, k, v)
        if counted:
            b, sq, h, dk = q.shape
            dv = v.shape[-1]
            seen = cache_visible_slots(sq, k.shape[1], window=window,
                                       q_offset=q_offset)
            _card_tally["flash_decode"] = _card_tally.get(
                "flash_decode", 0.0) + 2.0 * b * h * seen * (dk + dv)
            return q.new_empty((b, sq, h, dv))
        return _fd.flash_decode(q, k, v, pos, q_offset=q_offset,
                                window=window, scale=scale)
    return ref.cache_attention_ref(q, k, v, pos, q_offset=q_offset,
                                   window=window, scale=scale)


def cache_attention_partial(q, k, v, pos, *, q_offset: int,
                            window: int = 0, scale: Optional[float] = None):
    """``cache_attention`` over one part of a cache's slots (a rank's half
    of a capacity-sharded cache), stopped before the merge: (acc
    (B,Sq,S,H,d), ml (B,Sq,S,H,2)) float32, the S splits' unnormalised
    P·V, running max (natural log) and sum. ``cache_attention_combine``
    merges the partials of every part. On the card, flash_decode's split
    kernel with its merge left out (S from its own plan); elsewhere the
    plain version (one split)."""
    if _on_cuda(q, "cache_attention_partial", q, k, v):
        _fd.check_dtypes(q, k, v)
        return _fd.flash_decode_partial(q, k, v, pos, q_offset=q_offset,
                                        window=window, scale=scale)
    return ref.cache_attention_partial_ref(q, k, v, pos, q_offset=q_offset,
                                           window=window, scale=scale)


def cache_attention_combine(acc, ml, out_dtype) -> torch.Tensor:
    """Merge partials (acc (B,Sq,S,H,d), ml (B,Sq,S,H,2) float32: the
    splits of several ``cache_attention_partial`` calls concatenated on
    axis 2) into (B,Sq,H,d) in ``out_dtype``: flash_decode's combine
    kernel on the card, its plain version elsewhere."""
    if _on_cuda(acc, "cache_attention_combine", acc, ml):
        return _fd.decode_combine(acc.contiguous(), ml.contiguous(),
                                  out_dtype)
    return ref.decode_combine_ref(acc, ml, out_dtype)


def paged_attention(q, k_pool, v_pool, block_table, seq_lens, *,
                    layout: str = "nbhd", scale: Optional[float] = None,
                    window: int = 0) -> torch.Tensor:
    """Decode attention over paged pools in any layout. q: (B,H,d). On
    the card, each sequence's pages are split across blocks and the splits
    merged in float32 within the call; a KV head's group wider than 2048
    (query heads x padded head dim) is split evenly over blocks."""
    if _on_cuda(q, "paged_attention", q, k_pool, v_pool):
        return _pa.paged_attention(q, k_pool, v_pool, block_table, seq_lens,
                                   layout=layout, scale=scale, window=window)
    return ref.paged_attention_ref(q, k_pool, v_pool, block_table, seq_lens,
                                   layout=layout, scale=scale, window=window)


def scatter_pages_overlay(spec: KVPageSpec, pool, block_ids, canon, *,
                          front: int, seq_len: int) -> torch.Tensor:
    """In-place overlay scatter into a (L, N, *page) pool of canonical KV,
    either whole pages (L, nb, bs, kv, hd) or the stream's rows alone
    (L, seq_len, kv, hd) landing at flat row ``front``; rows outside
    [front, front+seq_len) keep their contents. Any canon strides; on the
    card, only the chunks of pages that hold such rows are launched, with
    accesses as wide (up to 16 bytes) as the alignments allow."""
    if _on_cuda(pool, "scatter_pages_overlay", pool, canon):
        return _kr.scatter_pages_overlay(spec, pool, block_ids, canon,
                                         front=front, seq_len=seq_len)
    return ref.scatter_pages_overlay_ref(spec, pool, block_ids, canon,
                                         front=front, seq_len=seq_len)


def gather_pages(spec: KVPageSpec, pool, block_ids,
                 out_dtype=None) -> torch.Tensor:
    """Pages ``block_ids`` of a (L, N, *page) pool → new canonical pages
    (L, nb, bs, kv, hd) in ``out_dtype`` (default the pool's). Any pool
    strides; on the card, accesses are as wide (up to 16 bytes) as the
    pointers' and strides' alignment allows."""
    if _on_cuda(pool, "gather_pages", pool):
        return _kr.gather_pages(spec, pool, block_ids, out_dtype)
    return ref.gather_pages_ref(spec, pool, block_ids, out_dtype)


def scatter_pages(spec: KVPageSpec, pool, block_ids, canon) -> torch.Tensor:
    """Canonical pages (L, nb, bs, kv, hd) → pages ``block_ids`` of a
    (L, N, *page) pool, cast to its dtype; in place, returns ``pool``. Any
    canon strides; on the card, accesses are as wide (up to 16 bytes) as
    the pointers' and strides' alignment allows."""
    if _on_cuda(pool, "scatter_pages", pool, canon):
        return _kr.scatter_pages(spec, pool, block_ids, canon)
    return ref.scatter_pages_ref(spec, pool, block_ids, canon)


def repack(src: KVPageSpec, dst: KVPageSpec, src_pool, src_blocks,
           dst_pool, dst_blocks, seq_len: int) -> torch.Tensor:
    """Vendor alignment (paper Fig. 3): ``seq_len`` tokens from the src
    pool's pages into the dst pool's, every layer, gathered then
    scattered; in place, returns ``dst_pool``."""
    if _on_cuda(dst_pool, "repack", src_pool, dst_pool):
        return _kr.repack(src, dst, src_pool, src_blocks, dst_pool,
                          dst_blocks, seq_len)
    return ref.repack_ref(src, dst, src_pool, src_blocks, dst_pool,
                          dst_blocks, seq_len)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel name since the last reset."""
    return {name: n for mod in _WRAPPERS for name, n in mod.LAUNCHES.items()}


def reset_launch_counts() -> None:
    for mod in _WRAPPERS:
        for name in mod.LAUNCHES:
            mod.LAUNCHES[name] = 0

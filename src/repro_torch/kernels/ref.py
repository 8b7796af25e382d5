"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes what its kernel computes, on any device, with
fully materialized scores. The CPU tests hold them against the JAX
package's Pallas kernels and oracles; ``chip_smoke.py`` holds each CUDA
kernel against them on the card. Nothing on the serving path calls them
with a CUDA tensor.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.serving.paged_cache import (KVPageSpec, _to_canon_perm,
                                             pages_from_canonical,
                                             pages_to_canonical)

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: Optional[float] = None, q_offset: int = 0,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,Sq,d); k,v: (B,KV,Skv,d) → (B,H,Sq,d).

    Query row i sits at absolute position ``q_offset + i``; key j at j.
    Keys at or past ``kv_len`` (default Skv) are masked. A row with no
    visible key returns zeros."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    grp = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kv_len = skv if kv_len is None else kv_len
    qg = q.reshape(b, kv, grp, sq, d).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    qi = torch.arange(sq, device=q.device)[:, None] + q_offset
    kj = torch.arange(skv, device=q.device)[None, :]
    ok = kj < kv_len
    if causal:
        ok = ok & (kj <= qi)
    if window > 0:
        ok = ok & ((qi - kj) < window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1) * ok.any(-1, keepdim=True)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_table: torch.Tensor,
                        seq_lens: torch.Tensor, *, layout: str = "nbhd",
                        scale: Optional[float] = None,
                        window: int = 0) -> torch.Tensor:
    """q: (B,H,d); pools (N, *page) in ``layout``; block_table
    (B, max_pages) int32; seq_lens (B,) lengths including the current
    token → (B,H,d)."""
    b, h, d = q.shape
    perm = _to_canon_perm(layout)
    kc = k_pool.permute((0,) + tuple(i + 1 for i in perm))   # (N,bs,KV,d)
    vc = v_pool.permute((0,) + tuple(i + 1 for i in perm))
    _, bs, kv, _ = kc.shape
    grp = h // kv
    maxp = block_table.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    ids = block_table.reshape(-1).long()
    k = kc[ids].reshape(b, maxp * bs, kv, d)
    v = vc[ids].reshape(b, maxp * bs, kv, d)
    qg = q.reshape(b, kv, grp, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    pos = torch.arange(maxp * bs, device=q.device)[None]
    lens = seq_lens.long()[:, None]
    ok = pos < lens
    if window > 0:
        ok = ok & (pos >= (lens - window))
    s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(b, h, d).to(q.dtype)


def scatter_pages_overlay_ref(spec: KVPageSpec, pool: torch.Tensor,
                              block_ids: torch.Tensor, canon: torch.Tensor,
                              *, front: int, seq_len: int) -> torch.Tensor:
    """pool: (L, N, *page) in ``spec.layout``; canon either whole pages
    (L, nb, bs, kv, hd) whose flat rows ``front .. front+seq_len`` hold the
    incoming stream, or those rows alone (L, seq_len, kv, hd). Writes them
    into pages ``block_ids`` cast to the pool dtype and keeps every other
    row; in place, returns ``pool``."""
    n_layers, nb = canon.shape[0], block_ids.shape[0]
    bs = spec.block_size
    ids = block_ids.long()
    cur = pages_to_canonical(spec, pool[:, ids].flatten(0, 1)).reshape(
        (n_layers, nb * bs, spec.kv_heads, spec.head_dim))
    if canon.dim() == 5:
        canon = canon.reshape(n_layers, nb * bs, spec.kv_heads,
                              spec.head_dim)[:, front:front + seq_len]
    cur[:, front:front + seq_len] = canon.to(pool.dtype)
    pages = pages_from_canonical(
        spec, cur.reshape(n_layers * nb, bs, spec.kv_heads, spec.head_dim))
    pool[:, ids] = pages.reshape((n_layers, nb) + spec.page_shape())
    return pool

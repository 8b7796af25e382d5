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
    """q: (B,H,Sq,dk); k: (B,KV,Skv,dk); v: (B,KV,Skv,dv) → (B,H,Sq,dv):
    the output takes v's head dim, which may differ from q's (MLA).

    Query row i sits at absolute position ``q_offset + i``; key j at j.
    Keys at or past ``kv_len`` (default Skv) are masked; ``scale``
    defaults to 1/sqrt(dk). A row with no visible key returns zeros."""
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
    return o.reshape(b, h, sq, v.shape[-1]).to(q.dtype)


def cache_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pos: torch.Tensor, *, q_offset: int, window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,dk); k: (B,cap,KV,dk); v: (B,cap,KV,dv); pos: (B,cap)
    int position tags (-1 = empty) → (B,Sq,H,dv) in q's dtype.

    Query row i sits at absolute position ``q_offset + i`` and sees the
    slots with 0 <= pos <= its position and, when ``window`` > 0, within
    ``window`` of it: ``cache_attention_mask`` + ``sdpa`` of
    ``models.layers``, whatever the slot order (a ring buffer or a
    full-capacity cache). K and V are widened to float32 (float8 exactly,
    no scale); scores and the softmax are float32. A row that sees no slot
    returns zeros, and a slot that no row sees is selected away, V
    included (it may hold anything), as in the kernel."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    grp = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, kv, grp, d).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    qp = torch.arange(q_offset, q_offset + sq, device=q.device)[None, :, None]
    cp = pos.long()[:, None, :]                              # (B,1,cap)
    ok = (cp >= 0) & (cp <= qp)                              # (B,Sq,cap)
    if window > 0:
        ok = ok & ((qp - cp) < window)
    s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1) * ok.any(-1)[:, None, None, :, None]
    v = torch.where(ok.any(1)[:, :, None, None], v.float(), 0.0)  # select
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def cache_attention_partial_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, pos: torch.Tensor, *,
                                q_offset: int, window: int = 0,
                                scale: Optional[float] = None):
    """``cache_attention_ref``'s slots as one split, stopped before the
    normalisation: (acc (B,Sq,1,H,dv), ml (B,Sq,1,H,2)) float32 — the
    unnormalised sum of exp(s - m) v over the visible slots, the running
    max m of their scores (natural-log units; -1e30 where no slot is
    seen) and the sum l of exp(s - m) (0 there): what
    ``flash_decode_partial`` returns for each of its splits."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    grp = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, kv, grp, d).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    qp = torch.arange(q_offset, q_offset + sq, device=q.device)[None, :, None]
    cp = pos.long()[:, None, :]                              # (B,1,cap)
    ok = (cp >= 0) & (cp <= qp)                              # (B,Sq,cap)
    if window > 0:
        ok = ok & ((qp - cp) < window)
    okb = ok[:, None, None]                                  # (B,1,1,Sq,cap)
    s = torch.where(okb, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                       # (B,KV,G,Sq)
    p = torch.where(okb, torch.exp(s - m[..., None]), 0.0)
    v = torch.where(ok.any(1)[:, :, None, None], v.float(), 0.0)  # select
    acc = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    ml = torch.stack([m, p.sum(-1)], dim=-1).permute(0, 3, 1, 2, 4)
    return (acc.reshape(b, sq, 1, h, v.shape[-1]),
            ml.reshape(b, sq, 1, h, 2).contiguous())


def decode_combine_ref(acc: torch.Tensor, ml: torch.Tensor,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """Merge partials acc (B,Sq,S,H,d), ml (B,Sq,S,H,2) over the S splits:
    weights exp(m_s - max m), sum(w acc) / sum(w l), 0 where every l is 0;
    (B,Sq,H,d) in ``out_dtype``."""
    m, l = ml[..., 0], ml[..., 1]
    w = torch.exp(m - m.amax(dim=2, keepdim=True))           # (B,Sq,S,H)
    big_l = (l * w).sum(dim=2)
    big_a = (acc * w[..., None]).sum(dim=2)
    o = torch.where(big_l[..., None] > 0,
                    big_a / torch.clamp_min(big_l, 1e-30)[..., None], 0.0)
    return o.to(out_dtype)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_table: torch.Tensor,
                        seq_lens: torch.Tensor, *, layout: str = "nbhd",
                        scale: Optional[float] = None,
                        window: int = 0) -> torch.Tensor:
    """q: (B,H,d); pools (N, *page) in ``layout``; block_table
    (B, max_pages) int32; seq_lens (B,) lengths including the current
    token → (B,H,d). Rows past the sequence or below the window are
    selected away, scores and values alike, so they may hold anything
    (NaN included), as in the kernel."""
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
    v = torch.where(ok[:, :, None, None], v.float(), 0.0)   # select, not 0*v
    o = torch.einsum("bkgs,bskd->bkgd", p, v)
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


def gather_pages_ref(spec: KVPageSpec, pool: torch.Tensor,
                     block_ids: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """pool: (L, N, *page) in ``spec.layout``; block_ids (nb,). Returns
    canonical pages (L, nb, bs, kv, hd) in ``out_dtype`` (default the
    pool's), as a new contiguous tensor."""
    n_layers, nb = pool.shape[0], block_ids.shape[0]
    pages = pool[:, block_ids.long()].flatten(0, 1)
    canon = pages_to_canonical(spec, pages).to(out_dtype or pool.dtype)
    return canon.reshape(n_layers, nb, spec.block_size, spec.kv_heads,
                         spec.head_dim).contiguous()


def scatter_pages_ref(spec: KVPageSpec, pool: torch.Tensor,
                      block_ids: torch.Tensor,
                      canon: torch.Tensor) -> torch.Tensor:
    """canon: (L, nb, bs, kv, hd) → pages ``block_ids`` of the (L, N,
    *page) pool, every row, cast to the pool dtype; in place, returns
    ``pool``."""
    n_layers, nb = canon.shape[0], block_ids.shape[0]
    pages = pages_from_canonical(spec, canon.flatten(0, 1)).to(pool.dtype)
    pool[:, block_ids.long()] = pages.reshape((n_layers, nb)
                                              + spec.page_shape())
    return pool


def repack_ref(src: KVPageSpec, dst: KVPageSpec, src_pool: torch.Tensor,
               src_blocks: torch.Tensor, dst_pool: torch.Tensor,
               dst_blocks: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Paper Fig. 3 with a leading layer axis: ``seq_len`` tokens of the
    src pages → the dst pages, zero tail in the last dst page; in place,
    returns ``dst_pool``."""
    canon = gather_pages_ref(src, src_pool, src_blocks, out_dtype=dst.tdtype)
    n_layers = canon.shape[0]
    flat = canon.reshape(n_layers, -1, src.kv_heads, src.head_dim)[:, :seq_len]
    nb_d = dst.blocks_for(seq_len)
    pad = nb_d * dst.block_size - seq_len
    flat = torch.nn.functional.pad(flat, (0, 0, 0, 0, 0, pad))
    canon_d = flat.reshape(n_layers, nb_d, dst.block_size, dst.kv_heads,
                           dst.head_dim)
    return scatter_pages_ref(dst, dst_pool, dst_blocks[:nb_d], canon_d)

"""Core layers of the dense family — PyTorch port of
``repro.models.layers`` (norms, RoPE, GQA attention, SwiGLU).

Layers are plain functions over plain dict params, as in the JAX package.
Conventions: activations (B, S, d); attention heads (B, S, H, hd);
softmax and norms accumulate in float32.

Two routes through attention. On a CUDA tensor (``kernel_route``) prefill
and chunked prefill call the flash kernel and paged decode calls the paged
kernel, both through ``repro_torch.kernels.ops``. On the CPU the layers
take the plain path the JAX package takes — ``sdpa`` under an additive
mask, ``paged_cache.paged_attention_ref`` — so the two packages compute
the same expressions. Caches and pools are updated in place (the JAX code
returns new arrays).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.serving import paged_cache as PC

Params = Dict[str, Any]

NEG_INF = -1e30


def kernel_route(x: torch.Tensor) -> bool:
    """Attention runs through the hand-written kernels on CUDA tensors."""
    return x.is_cuda


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies, fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate ``x`` (..., S, H, hd) by per-position angles (llama
    half-split convention, fp32 angles). positions: (..., S) int."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, x.device)
    ang = positions.float()[..., None] * inv                # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# Attention core (plain path). Masks are additive fp32.
# --------------------------------------------------------------------------- #
def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,hd)  k,v: (B,Skv,KV,hd)  mask: (B|1,1,Sq,Skv) additive.
    Returns (B,Sq,H,hd)."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    grp = h // kv
    qg = q.reshape(b, sq, kv, grp, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    scores = scores + mask[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def causal_mask(sq: int, skv: int, q_offset: int = 0, window: int = 0,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """(1,1,sq,skv) additive mask; query i at abs pos q_offset+i may see
    key j at abs pos j if j <= i (and i - j < window when window > 0)."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    kj = torch.arange(skv, device=device)[None, :]
    ok = kj <= qi
    if window > 0:
        ok &= (qi - kj) < window
    return torch.where(ok, 0.0, NEG_INF)[None, None].float()


# --------------------------------------------------------------------------- #
# KV cache (dense, position-tagged), updated in place.
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class KVCache:
    k: torch.Tensor          # (..., B, cap, KV, hd)
    v: torch.Tensor          # (..., B, cap, KV, hd)
    pos: torch.Tensor        # (..., B, cap) int32 absolute positions, -1 = empty
    # slot == position for every write (chunked-prefill caches): what the
    # flash route of attention_decode relies on
    full_capacity: bool = False

    @property
    def capacity(self) -> int:
        return self.k.shape[-3]

    def layer(self, i: int) -> "KVCache":
        """View of layer ``i`` of a group-stacked cache."""
        return KVCache(self.k[i], self.v[i], self.pos[i], self.full_capacity)


def kv_cache_init(batch: int, capacity: int, kv_heads: int, hd: int, dtype,
                  device: torch.device, count: int = 1,
                  full_capacity: bool = False) -> KVCache:
    shape = (count, batch, capacity, kv_heads, hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((count, batch, capacity), -1, dtype=torch.int32,
                       device=device),
        full_capacity=full_capacity)


def kv_cache_write(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                   positions: torch.Tensor) -> KVCache:
    """Write S_new entries per sequence at slots ``positions % capacity``,
    in place. positions: (B, S_new) absolute, all >= 0 (the dense family
    never pads a prompt)."""
    slots = (positions % cache.capacity).long()
    bidx = torch.arange(k_new.shape[0], device=k_new.device)[:, None]
    cache.k[bidx, slots] = k_new.to(cache.k.dtype)
    cache.v[bidx, slots] = v_new.to(cache.v.dtype)
    cache.pos[bidx, slots] = positions.to(torch.int32)
    return cache


def kv_cache_from_prefill(cache: KVCache, k_new: torch.Tensor,
                          v_new: torch.Tensor,
                          positions: torch.Tensor) -> KVCache:
    """Fill a cache from a full prefill pass (positions 0..S-1, capacity
    >= S), in place."""
    s = k_new.shape[1]
    assert cache.capacity >= s, (cache.capacity, s)
    cache.k[:, :s] = k_new.to(cache.k.dtype)
    cache.v[:, :s] = v_new.to(cache.v.dtype)
    cache.pos[:, :s] = positions.to(torch.int32)
    return cache


def cache_attention_mask(cache: KVCache, q_positions: torch.Tensor,
                         window: int = 0) -> torch.Tensor:
    """(B,1,Sq,cap) additive mask: valid entries with pos <= q_pos
    (and within window if sliding)."""
    cp = cache.pos[:, None, :]
    qp = q_positions[:, :, None]
    ok = (cp >= 0) & (cp <= qp)
    if window > 0:
        ok &= (qp - cp) < window
    return torch.where(ok, 0.0, NEG_INF)[:, None].float()


# --------------------------------------------------------------------------- #
# Standard attention block (GQA / MHA / MQA)
# --------------------------------------------------------------------------- #
def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   device: torch.device) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    s = 1.0 / math.sqrt(d)

    def rnd(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale
                ).to(cfg.pdtype)

    p = {"wq": rnd((d, h, hd), s), "wk": rnd((d, kv, hd), s),
         "wv": rnd((d, kv, hd), s),
         "wo": rnd((h, hd, d), s / math.sqrt(2 * cfg.num_layers))}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=cfg.pdtype, device=device)
        p["bk"] = torch.zeros((kv, hd), dtype=cfg.pdtype, device=device)
        p["bv"] = torch.zeros((kv, hd), dtype=cfg.pdtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=cfg.pdtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=cfg.pdtype, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = wo.shape
    return out.reshape(*out.shape[:-2], h * k) @ wo.to(out.dtype).reshape(h * k, d)


def _project_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, rope: bool = True):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    window: int = 0
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over a full sequence (prefill). positions: (B,S),
    0..S-1. Returns (out, (k, v)) — k/v for cache construction."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    if kernel_route(x):
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window, q_offset=0,
                                  kv_len=s).transpose(1, 2)
    else:
        mask = causal_mask(s, s, 0, window, x.device) if causal else \
            torch.zeros((1, 1, s, s), device=x.device)
        out = sdpa(q, k, v, mask)
    return _out_proj(out, p["wo"]), (k, v)


def attention_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor, cache: KVCache,
                     window: int = 0, q_offset: Optional[int] = None
                     ) -> Tuple[torch.Tensor, KVCache]:
    """Few-token decode (a chunk of incremental prefill) against a
    position-tagged cache, written in place. x: (B,Sq,d); positions:
    (B,Sq) absolute.

    The flash route needs ``q_offset`` — the absolute position of query
    row 0, equal to positions[:, 0] — and a full-capacity cache, where the
    slot of every entry is its position: slots below q_offset hold earlier
    chunks, slots at or past q_offset + Sq were never written (pos -1) and
    lie above the causal diagonal. Then ``causal_mask(q_offset)`` over the
    slots is exactly ``cache_attention_mask`` over the positions."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    kv_cache_write(cache, k, v, positions)
    if kernel_route(x):
        if q_offset is None or not cache.full_capacity \
                or q_offset + x.shape[1] > cache.capacity:
            raise AssertionError(
                "flash route of attention_decode needs q_offset and a "
                "full-capacity cache (slot == position)")
        out = ops.flash_attention(q.transpose(1, 2), cache.k.transpose(1, 2),
                                  cache.v.transpose(1, 2), causal=True,
                                  window=window, q_offset=q_offset,
                                  kv_len=cache.capacity).transpose(1, 2)
    else:
        mask = cache_attention_mask(cache, positions, window)
        out = sdpa(q, cache.k, cache.v, mask)
    return _out_proj(out, p["wo"]), cache


# --------------------------------------------------------------------------- #
# Paged decode attention (serving path).
# --------------------------------------------------------------------------- #
def attention_decode_paged(p: Params, cfg: ModelConfig, x: torch.Tensor,
                           positions: torch.Tensor,
                           pcache: Dict[str, torch.Tensor],
                           block_table: torch.Tensor, seq_lens: torch.Tensor,
                           write_blocks: torch.Tensor,
                           write_slots: torch.Tensor, spec: PC.KVPageSpec,
                           window: int = 0
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode against paged pools (appended in place).

    x: (B,1,d); positions: (B,1) == old seq_lens; block_table: (B,maxb)
    int32; seq_lens: (B,) int32 lengths BEFORE this token;
    write_blocks/slots: (B,)."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    k_pool = PC.append_token(spec, pcache["k_pool"], write_blocks,
                             write_slots, k[:, 0])
    v_pool = PC.append_token(spec, pcache["v_pool"], write_blocks,
                             write_slots, v[:, 0])
    new_lens = seq_lens + 1
    if kernel_route(x):
        out = ops.paged_attention(q[:, 0], k_pool, v_pool, block_table,
                                  new_lens, layout=spec.layout,
                                  window=window)[:, None]
    else:
        out = PC.paged_attention_ref(q, k_pool, v_pool, block_table, new_lens,
                                     spec, window=window)
    return _out_proj(out, p["wo"]), pcache


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #
def init_mlp(gen: torch.Generator, cfg: ModelConfig, device: torch.device,
             d_ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(f) / math.sqrt(2 * cfg.num_layers)

    def rnd(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale
                ).to(cfg.pdtype)

    return {"w_gate": rnd((d, f), s_in), "w_up": rnd((d, f), s_in),
            "w_down": rnd((f, d), s_out)}


def swiglu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return (F.silu(g) * u) @ p["w_down"].to(x.dtype)

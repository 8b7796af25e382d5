"""Core layers of the ported families — PyTorch port of
``repro.models.layers`` (norms, RoPE, GQA attention with an optional
sliding window, position-tagged KV caches with the ring buffer,
multi-head latent attention (MLA) with its latent cache, SwiGLU, top-k
routed MoE with shared experts, the RG-LRU recurrent block of Griffin /
RecurrentGemma with its layer state, the Mamba-2 SSD mixer with its
layer state, the cross-attention of encoder-decoder models with its
memory rows).

Layers are plain functions over plain dict params, as in the JAX package.
Conventions: activations (B, S, d); attention heads (B, S, H, hd);
softmax and norms accumulate in float32.

Two routes through attention. On a CUDA tensor (``kernel_route``) prefill
and chunked prefill call the flash kernel, paged decode calls the paged
kernel, and decode over a ring-buffer or float8 dense cache calls the
flash_decode kernel (``ops.cache_attention``), all through
``repro_torch.kernels.ops``. Cross-attention runs
flash non-causal over the memory where one memory length serves the whole
batch (a prefill, a chunk of one request) and, with a per-sequence length
(D's decode slots), the plain masked ``sdpa`` on both devices, as the
reference computes it in no kernel. Training asks for the plain route
explicitly (``plain=True`` on ``attention_block`` and ``mla_block``;
``cross_attention`` without ``kv_len``), on the card as well: the kernels
have no backward pass, and ``ops`` refuses a CUDA input that requires
grad. On the CPU the layers
take the plain path the JAX package takes — ``sdpa`` under an additive
mask, ``paged_cache.paged_attention_ref`` — so the two packages compute
the same expressions. Caches and pools are updated in place (the JAX code
returns new arrays).

MLA attends through ``ops`` on both devices (the kernels on the card,
their plain versions on the CPU): prefill and chunked prefill expand the
latent to per-head K (192 wide: 128 nope + 64 rope) and V (128) and call
flash; paged decode gathers the latent pages (``ops.gather_pages``) and
attends in the latent space in float32 with plain tensor products, as
the reference does.

On a rank's mesh whose model axis has more than one rank (the launch
layer's tensor parallelism, ``dist.DistContext.model_shard``), the
layers take the rank's shards of the weights and caches as the
reference's specs give them (``launch/sharding.py``) and reduce with
``models/collectives.py``: attention projects q on the rank's heads and
K/V on its head_dim columns, gathers K/V on head_dim before qk-norm and
RoPE, attends with the rank's heads (prefill: its head_dim half goes to
the cache; decode over a capacity-sharded cache: all heads over the
rank's slots — a ring's slot share, or float8 e4m3 — partials exchanged
and combined per head), and sums ``wo``'s partial with ``psum``; the MLP
is column then row parallel; the MoE is expert-TP (every expert's
d_ff_expert slice) with a replicated router; MLA's prefill splits its
heads (``w_ukv``, ``wo``) and keeps the latent whole, and its decode
expands the rank's capacity share of the latent through every head's
``w_ukv`` (gathered) and merges the ranks' partials per head; the RG-LRU
block runs on the rank's channels of the width, gathering the conv's
output before the gate products and summing ``w_out``'s partial; the
cross-attention projects q on the rank's heads and the memory's K/V on
its head_dim columns (the cache's shard), gathers K/V on head_dim before
attending and sums ``wo``'s partial; the SSD mixer is replicated (every
rank computes the whole block) but its conv tail is the rank's channels:
the tail is gathered before the conv and the rank keeps its channels of
the new one.

The RG-LRU block has no kernel of its own in either package: the causal
depthwise conv, the two float32 gate products and the recurrence are
plain tensor code (the reference's ``jax.lax.associative_scan`` becomes a
log-depth scan over the token axis). Its state — the float32 hidden
``h`` and the conv's last ``d_conv - 1`` inputs — is updated in place by
the model, like the caches.

The Mamba-2 SSD mixer has no kernel either (the reference computes it in
jnp): the chunked scan's intra-chunk scores, chunk end states and
inter-chunk terms are float32 tensor products (``torch.einsum`` of two
operands, a batched product each; TF32 stays off, as PyTorch's default
has it), and the recurrence across chunks is a loop in chunk order. Its
``SSMState`` (float32 ``h`` of (heads, head dim, d_state) and the conv
tail) is carried and updated like the RG-LRU state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import collectives as C
from repro_torch.models import dist
from repro_torch.serving import paged_cache as PC

Params = Dict[str, Any]

NEG_INF = -1e30


def kernel_route(x: torch.Tensor) -> bool:
    """Attention runs through the hand-written kernels on CUDA tensors,
    and on ``meta`` tensors counted as the card runs them
    (``ops.count_as_card``)."""
    return x.is_cuda or ops.counting_as_card(x)


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


def _pad_chunks(chunk: int, k_pos: torch.Tensor, *kv: torch.Tensor):
    """Pad the key axis (1) of ``kv`` with zeros and ``k_pos`` with -1 up
    to a multiple of ``chunk``; returns (number of chunks, k_pos, *kv)."""
    skv = k_pos.shape[1]
    pad = (-skv) % chunk
    if pad:
        kv = tuple(F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in kv)
        k_pos = F.pad(k_pos, (0, pad), value=-1)
    return (skv + pad) // chunk, k_pos, *kv


def chunked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                 causal: bool = True, window: int = 0,
                 scale: Optional[float] = None,
                 chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the reference's scan, as a
    loop in chunk order): ``sdpa`` under the positional mask with a score
    buffer of (..., Sq, chunk) in place of (..., Sq, Skv), in float32.

    q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd); q_pos: (B,Sq), k_pos: (B,Skv) int
    absolute positions, -1 = invalid (padding). Returns (B,Sq,H,hd).

    The reference's arithmetic, step for step: a masked score is NEG_INF,
    so a row whose chunk holds no valid key adds exp(0) = 1 for each
    masked column until a chunk with a valid key rescales the sums by
    alpha = 0; a row that never sees one returns the mean of V. Under the
    context's ``attn_p_bf16`` the probabilities and V are rounded to
    bfloat16 and multiplied in float32 (exact products, float32 sums), as
    the reference's bf16 product with a float32 result."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    grp = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    nc, k_pos, k, v = _pad_chunks(chunk, k_pos, k, v)
    qg = q.reshape(b, sq, kvh, grp, hd).float()
    p_bf16 = dist.ctx().attn_p_bf16
    m = torch.full((b, kvh, grp, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, grp, sq), dtype=torch.float32, device=q.device)
    # the accumulator keeps the scores' (b,kv,grp,sq,hd) layout throughout
    acc = torch.zeros((b, kvh, grp, sq, hd), dtype=torch.float32,
                      device=q.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        kj, vj, pj = k[:, sl], v[:, sl], k_pos[:, sl]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kj.float()) * scale
        ok = pj[:, None, :] >= 0                            # (B,1,C)
        if causal:
            ok = ok & (pj[:, None, :] <= q_pos[:, :, None])   # (B,Sq,C)
        if window > 0:
            ok = ok & ((q_pos[:, :, None] - pj[:, None, :]) < window)
        s = torch.where(ok[:, None, None], s, NEG_INF)      # (B,KV,G,Sq,C)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        if p_bf16:
            p, vj = p.bfloat16(), vj.bfloat16()
        upd = torch.einsum("bkgqs,bskd->bkgqd", p.float(), vj.float())
        acc = acc * alpha[..., None] + upd
        m = m_new
    out = (acc / torch.clamp_min(l[..., None], 1e-30)).movedim(3, 1)
    return out.reshape(b, sq, h, hd).to(q.dtype)


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


def _kv_cache_put(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                  positions: torch.Tensor) -> KVCache:
    """Write every entry at slot ``positions % capacity``, in place.
    positions all >= 0: the chunks of a prompt and decode tokens never
    carry -1, so the hot path reads nothing back from the card."""
    slots = (positions % cache.capacity).long()
    bidx = torch.arange(k_new.shape[0], device=k_new.device)[:, None]
    cache.k[bidx, slots] = k_new.to(cache.k.dtype)
    cache.v[bidx, slots] = v_new.to(cache.v.dtype)
    cache.pos[bidx, slots] = positions.to(torch.int32)
    return cache


def kv_cache_write(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                   positions: torch.Tensor) -> KVCache:
    """Write S_new entries per sequence at slots ``positions % capacity``,
    in place. k_new/v_new: (B, S_new, KV, hd); positions: (B, S_new)
    absolute, -1 = skip: those entries are dropped, as the reference's
    ``mode="drop"`` scatter drops them (selecting the kept entries reads
    the mask back from the card)."""
    keep = positions >= 0
    bidx = torch.arange(k_new.shape[0], device=k_new.device)[:, None]
    bidx = bidx.expand_as(positions)[keep]
    pos = positions[keep]
    slots = (pos % cache.capacity).long()
    cache.k[bidx, slots] = k_new[keep].to(cache.k.dtype)
    cache.v[bidx, slots] = v_new[keep].to(cache.v.dtype)
    cache.pos[bidx, slots] = pos.to(torch.int32)
    return cache


def kv_cache_from_prefill(cache: KVCache, k_new: torch.Tensor,
                          v_new: torch.Tensor,
                          positions: torch.Tensor) -> KVCache:
    """Fill a cache from a full prefill pass (positions 0..S-1), in place.
    When the capacity covers the prompt the rows go to slots 0..S-1; a
    ring buffer (a sliding layer's window-sized cache) keeps the last
    ``capacity`` positions at slots ``position % capacity`` — those the
    reference's ``_ring_positions`` keeps, taken as a slice, so no shape
    depends on the data (the ``meta`` device runs it)."""
    s = k_new.shape[1]
    if cache.capacity < s:
        keep = slice(s - cache.capacity, s)
        return _kv_cache_put(cache, k_new[:, keep], v_new[:, keep],
                             positions[:, keep])
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


def _out_proj(out: torch.Tensor, wo: torch.Tensor,
              tp: Optional[C.AxisShard] = None) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul; on a model axis (``tp``)
    over the rank's heads, summed over the axis (``_row_parallel``)."""
    h, k, d = wo.shape
    return _row_parallel(out.reshape(*out.shape[:-2], h * k),
                         wo.reshape(h * k, d), tp)


def _project_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, rope: bool = True,
                 tp: Optional[C.AxisShard] = None):
    """(q, k, v) of x: on a model axis (``tp``) q has the rank's heads and
    K/V every KV head at the whole head_dim, gathered from the ranks'
    head_dim columns before qk-norm and RoPE (both need the whole head).
    Under autograd x enters the column-parallel projections, and the
    replicated qk-norm weights the rank's heads, through
    ``collectives.column_entry``; the gathered K/V feed only the rank's
    query heads, so their gather's backward sums before it slices."""
    x = C.column_entry(x, tp)
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if tp is not None:
        _rank_heads(cfg, q.shape[2], tp)
        if k.shape[-1] != cfg.hd:              # head_dim-sharded K/V
            k, v = C.all_gather(torch.stack([k, v]), 4, tp,
                                grad="split").unbind(0)
    if cfg.qk_norm:
        q = rms_norm(C.column_entry(p["q_norm"], tp), q, cfg.norm_eps)
        k = rms_norm(C.column_entry(p["k_norm"], tp), k, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _rank_heads(cfg: ModelConfig, n: int, tp: C.AxisShard
                ) -> Tuple[int, int]:
    """(first KV head, KV heads) of the rank's ``n`` query heads: a block
    of ``n`` heads a rank, which must cover whole KV groups or share one
    (``pad_heads`` makes the heads divide the axis in prefill)."""
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    if n * tp.size != h:
        raise NotImplementedError(
            f"{cfg.name}: {n} query heads a rank on a model axis of "
            f"{tp.size} ({h} heads): q must be sharded on heads")
    grp = h // kvh
    h0 = tp.index * n
    if n % grp == 0:
        return h0 // grp, n // grp
    if grp % n == 0:
        return h0 // grp, 1
    raise NotImplementedError(f"{cfg.name}: {n} heads a rank split a "
                              f"KV group of {grp}")


def _row_parallel(x: torch.Tensor, w: torch.Tensor,
                  tp: Optional[C.AxisShard]) -> torch.Tensor:
    """``x @ w`` where ``w`` holds the rank's rows of a row-parallel
    product: the partial in x's dtype summed over the model axis in that
    dtype, as the reference's psum sums it (off an axis, ``x @ w``)."""
    return C.psum(x @ w.to(x.dtype), tp)


def _rank_cols(t: torch.Tensor, cfg: ModelConfig, local: int,
               tp: Optional[C.AxisShard]) -> torch.Tensor:
    """The rank's head_dim columns of K or V (a view) when its cache is
    head_dim-sharded (``local`` < the head dim), else ``t``."""
    if tp is None or local == cfg.hd:
        return t
    c0, c1 = tp.part(cfg.hd)
    return t[..., c0:c1]


def attention_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    window: int = 0, lengths: Optional[torch.Tensor] = None,
                    plain: bool = False
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over a full sequence (prefill, training). positions:
    (B,S), 0..S-1 (-1 at a training batch's padding). Returns (out,
    (k, v)) — k/v for cache construction.

    ``plain`` takes ``sdpa`` under the reference's additive masks on any
    device: the training route, which autograd differentiates (the flash
    kernel has no backward pass). ``lengths`` (B,) blanks the keys at or
    past each sequence's length, on the plain route only. On that route a
    distribution context with ``chunk_kv`` <= S takes ``chunked_sdpa``
    (``chunk_size`` keys a chunk), as the reference does.

    On a model axis the rank attends with its query heads over the KV
    heads they group, returns its head_dim columns of K/V (the prefill
    cache's shard) and sums ``wo``'s partial over the axis."""
    b, s, _ = x.shape
    dctx = dist.ctx()
    tp = dctx.model_shard()
    q, k, v = _project_qkv(p, cfg, x, positions, tp=tp)
    rows = (_rank_cols(k, cfg, p["wk"].shape[-1], tp),
            _rank_cols(v, cfg, p["wv"].shape[-1], tp))
    if tp is not None:
        kv0, nkv = _rank_heads(cfg, q.shape[2], tp)
        k, v = k[:, :, kv0:kv0 + nkv], v[:, :, kv0:kv0 + nkv]
    if (plain or not kernel_route(x)) and dctx.chunk_kv \
            and s >= dctx.chunk_kv:
        out = chunked_sdpa(q, k, v, positions,
                           _valid_key_positions(positions, lengths),
                           causal=causal, window=window,
                           chunk=dctx.chunk_size)
    elif plain or not kernel_route(x):
        mask = causal_mask(s, s, 0, window, x.device) if causal else \
            torch.zeros((1, 1, s, s), device=x.device)
        if lengths is not None:
            mask = mask + length_mask(lengths, s)
        out = sdpa(q, k, v, mask)
    elif lengths is not None:
        raise ValueError("per-sequence lengths take the plain route "
                         "(plain=True)")
    else:
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window, q_offset=0,
                                  kv_len=s).transpose(1, 2)
    return _out_proj(out, p["wo"], tp), rows


def attention_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor, cache: KVCache,
                     window: int = 0, q_offset: Optional[int] = None
                     ) -> Tuple[torch.Tensor, KVCache]:
    """Few-token decode (a chunk of incremental prefill) against a
    position-tagged cache, written in place. x: (B,Sq,d); positions:
    (B,Sq) absolute.

    The kernel route needs ``q_offset`` — the absolute position of query
    row 0, equal to positions[:, 0]. One query row (a decode step) takes
    ``ops.cache_attention`` on every cache: the flash_decode kernel, which
    reads each slot's position tag and streams the cache once for the
    row's KV groups. A chunk of several rows (incremental prefill) over a
    full-capacity bfloat16 or float32 cache takes flash, which reads the
    cache once for the whole chunk: there the slot of every entry is its
    position, slots below q_offset hold earlier chunks, slots at or past
    q_offset + Sq were never written (pos -1) and lie above the causal
    diagonal, so ``causal_mask(q_offset)`` over the slots is exactly
    ``cache_attention_mask`` over the positions. A chunk over any other
    cache — a ring buffer (a sliding layer's window-sized cache) or
    float8 K/V — takes ``ops.cache_attention`` too. Rows past a
    full-capacity cache raise on either kernel.

    On a model axis the cache is the rank's contiguous share of the slots
    (capacity-sharded): ``_attention_decode_sharded``."""
    tp = dist.ctx().model_shard()
    if tp is not None:
        return _attention_decode_sharded(p, cfg, x, positions, cache,
                                         window, q_offset, tp)
    q, k, v = _project_qkv(p, cfg, x, positions)
    _kv_cache_put(cache, k, v, positions)
    if kernel_route(x):
        if q_offset is None:
            raise AssertionError("the kernel route of attention_decode "
                                 "needs q_offset (== positions[:, 0])")
        dense = cache.full_capacity and cache.k.dtype not in ops.FLOAT8
        if dense and q_offset + x.shape[1] > cache.capacity:
            raise AssertionError(
                f"attention_decode: rows up to {q_offset + x.shape[1]} "
                f"past a full-capacity cache of {cache.capacity}")
        if dense and x.shape[1] > 1:
            out = ops.flash_attention(
                q.transpose(1, 2), cache.k.transpose(1, 2),
                cache.v.transpose(1, 2), causal=True, window=window,
                q_offset=q_offset, kv_len=cache.capacity).transpose(1, 2)
        else:
            out = ops.cache_attention(q, cache.k, cache.v, cache.pos,
                                      q_offset=q_offset, window=window)
    else:
        mask = cache_attention_mask(cache, positions, window)
        out = sdpa(q, cache.k, cache.v, mask)
    return _out_proj(out, p["wo"]), cache


def _owned_positions(positions: torch.Tensor, cap_l: int,
                     tp: C.AxisShard) -> torch.Tensor:
    """``positions`` where the rank owns the slot they go to in a
    capacity-sharded cache (global slot position % (cap_l x ranks) in the
    rank's [index x cap_l, (index + 1) x cap_l): a full-capacity cache's
    slot or a ring's), -1 elsewhere: what the rank writes."""
    slot = positions.long() % (cap_l * tp.size)
    lo = tp.index * cap_l
    own = (slot >= lo) & (slot < lo + cap_l)
    return torch.where(own, positions, torch.full_like(positions, -1))


def _merge_rank_partials(acc: torch.Tensor, ml: torch.Tensor, n: int,
                         tp: C.AxisShard, dtype) -> torch.Tensor:
    """The rank's ``n`` heads of attention over every rank's slots: each
    rank sends every other the partials (acc (B,Sq,S,H,dv), ml
    (B,Sq,S,H,2)) of that rank's heads, and the rank merges its heads'
    partials of all ranks (``ops.cache_attention_combine``) into
    (B,Sq,n,dv) in ``dtype``."""
    d = acc.shape[-1]
    part = torch.cat([acc, ml], dim=-1)                  # (B,Sq,S,H,d+2)
    got = C.exchange([part[:, :, :, j * n:(j + 1) * n]
                      for j in range(tp.size)], tp)
    part = torch.cat(got, dim=2)                         # every rank's splits
    return ops.cache_attention_combine(part[..., :d].contiguous(),
                                       part[..., d:].contiguous(), dtype)


def _attention_decode_sharded(p: Params, cfg: ModelConfig, x: torch.Tensor,
                              positions: torch.Tensor, cache: KVCache,
                              window: int, q_offset: Optional[int],
                              tp: C.AxisShard
                              ) -> Tuple[torch.Tensor, KVCache]:
    """``attention_decode`` over the rank's share of a capacity-sharded
    cache (slots [index x cap, (index + 1) x cap) of the whole cache's
    size x cap; a ring's too, its slot position % (size x cap)): q is
    gathered to every head; the new rows are written, with their position
    tags and cast to the cache's dtype (float8 e4m3 as ``_kv_cache_put``
    casts), only by the rank that owns their slot; every head attends the
    rank's slots and stops at the partials (flash_decode's split kernel on
    the card, ``ops.cache_attention_partial``; the tags give the causal
    and window masks whatever the slot order), then
    ``_merge_rank_partials``, ``wo`` over the rank's heads and ``psum``."""
    q, k, v = _project_qkv(p, cfg, x, positions, tp=tp)
    n = q.shape[2]
    q = C.all_gather(q, 2, tp)
    cap_l = cache.capacity
    kv_cache_write(cache, k, v, _owned_positions(positions, cap_l, tp))
    if q_offset is None:
        raise AssertionError("attention_decode on a model axis needs "
                             "q_offset (== positions[:, 0]) on every route")
    if cache.full_capacity and q_offset + x.shape[1] > cap_l * tp.size:
        raise AssertionError(
            f"attention_decode: rows up to {q_offset + x.shape[1]} past a "
            f"full-capacity cache of {cap_l * tp.size}")
    acc, ml = ops.cache_attention_partial(q, cache.k, cache.v, cache.pos,
                                          q_offset=q_offset, window=window)
    out = _merge_rank_partials(acc, ml, n, tp, q.dtype)
    return _out_proj(out, p["wo"], tp), cache


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
# Cross-attention (enc-dec). Cache = encoder memory K/V, built once.
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class CrossKVCache(KVCache):
    """A decoder layer's self-attention ``KVCache`` and its cross-attention
    rows: the encoder memory's K and V (..., B, mem, KV, hd) and each
    sequence's memory length (..., B) int32 (the reference's {"self",
    "cross_k", "cross_v", "mem_len"})."""
    cross_k: Optional[torch.Tensor] = None
    cross_v: Optional[torch.Tensor] = None
    mem_len: Optional[torch.Tensor] = None

    def layer(self, i: int) -> "CrossKVCache":
        return CrossKVCache(self.k[i], self.v[i], self.pos[i],
                            self.full_capacity, self.cross_k[i],
                            self.cross_v[i], self.mem_len[i])


def cross_rows_init(batch: int, mem_len: int, cfg: ModelConfig, dtype,
                    device: torch.device, count: int = 1
                    ) -> Dict[str, torch.Tensor]:
    """Zeroed cross rows of ``count`` layers: {"cross_k", "cross_v"}
    (count, B, mem_len, KV, hd) and "mem_len" (count, B) int32 — an idle
    slot attends no memory row."""
    shape = (count, batch, mem_len, cfg.num_kv_heads, cfg.hd)
    return {"cross_k": torch.zeros(shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=dtype, device=device),
            "mem_len": torch.zeros((count, batch), dtype=torch.int32,
                                   device=device)}


def length_mask(lengths: torch.Tensor, skv: int) -> torch.Tensor:
    """(B,1,1,skv) additive mask blanking positions >= per-seq length."""
    ok = torch.arange(skv, device=lengths.device)[None] < lengths[:, None]
    return torch.where(ok, 0.0, NEG_INF)[:, None, None].float()


def _valid_key_positions(positions: torch.Tensor,
                         lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """The chunked routes' key positions: -1 at or past each sequence's
    length, the query positions otherwise."""
    if lengths is None:
        return positions
    s = positions.shape[1]
    ok = torch.arange(s, device=positions.device)[None] < lengths[:, None]
    return torch.where(ok, positions, torch.full_like(positions, -1))


def init_cross_attention(gen: torch.Generator, cfg: ModelConfig,
                         device: torch.device) -> Params:
    return init_attention(gen, cfg.with_(qkv_bias=False, qk_norm=False),
                          device)


def cross_attention_kv(p: Params, cfg: ModelConfig, memory: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The memory's (B,S_mem,d) cross K and V (B,S_mem,KV,hd): no RoPE.
    On a model axis ``wk``/``wv`` hold the rank's head_dim columns, which
    the memory enters through ``collectives.column_entry``."""
    if p["wk"].shape[-1] != cfg.hd:
        memory = C.column_entry(memory, dist.ctx().model_shard())
    return _proj(memory, p["wk"]), _proj(memory, p["wv"])


def cross_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    mem_kv: Tuple[torch.Tensor, torch.Tensor],
                    mem_lengths: Optional[torch.Tensor] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Queries x (B,Sq,d) over the memory's K/V (B,S_mem,KV,hd), no RoPE,
    no causal mask. ``kv_len`` (host int): the memory rows that every
    sequence of the batch attends; with it a CUDA tensor runs the flash
    kernel non-causal over the first ``kv_len`` rows (a prefill or a
    chunk of one request). Otherwise the plain path: ``sdpa`` under an
    additive mask that blanks rows at or past each sequence's
    ``mem_lengths`` (all rows when None), as the reference computes it
    — a slot with length 0 attends uniformly over finite scores and stays
    finite.

    On a model axis q has the rank's heads and the memory's K/V the
    rank's head_dim columns (``cross_attention_kv``'s, the cache's
    shard): K/V are gathered on head_dim, the rank's heads attend their
    KV heads, and ``wo``'s partial is summed over the axis. Under
    autograd x enters the rank's query heads through
    ``collectives.column_entry``, and the gathered K/V feed only the
    rank's heads, so their gather's backward sums before it slices
    (``"cross.kv"``)."""
    k, v = mem_kv
    tp = dist.ctx().model_shard()
    q = _proj(C.column_entry(x, tp), p["wq"])
    if tp is not None:
        kv0, nkv = _rank_heads(cfg, q.shape[2], tp)
        if k.shape[-1] != cfg.hd:              # head_dim-sharded rows
            k, v = C.all_gather(torch.stack([k, v]), 4, tp, grad="split",
                                name="cross.kv").unbind(0)
        k, v = k[:, :, kv0:kv0 + nkv], v[:, :, kv0:kv0 + nkv]
    if kv_len is not None and kernel_route(x):
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=False,
                                  kv_len=kv_len).transpose(1, 2)
    else:
        mask = torch.zeros((x.shape[0], 1, x.shape[1], k.shape[1]),
                           device=x.device)
        if mem_lengths is not None:
            mask = mask + length_mask(mem_lengths, k.shape[1])
        out = sdpa(q, k, v, mask)
    return _out_proj(out, p["wo"], tp)


# --------------------------------------------------------------------------- #
# MLA — multi-head latent attention (DeepSeek-V2). Cache = compressed latent.
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class MLACache:
    ckv: torch.Tensor        # (..., B, cap, lora)   normalised latent
    kpe: torch.Tensor        # (..., B, cap, rope)   roped shared key part
    pos: torch.Tensor        # (..., B, cap) int32 absolute positions, -1 = empty
    # slot == position for every write (chunked-prefill caches): what
    # mla_decode's expanded route relies on
    full_capacity: bool = False

    @property
    def capacity(self) -> int:
        return self.ckv.shape[-2]

    def layer(self, i: int) -> "MLACache":
        """View of layer ``i`` of a group-stacked cache."""
        return MLACache(self.ckv[i], self.kpe[i], self.pos[i],
                        self.full_capacity)


def mla_cache_init(batch: int, capacity: int, cfg: ModelConfig, dtype,
                   device: torch.device, count: int = 1,
                   full_capacity: bool = False) -> MLACache:
    m = cfg.mla
    lead = (count, batch, capacity)
    return MLACache(
        ckv=torch.zeros(lead + (m.kv_lora_rank,), dtype=dtype, device=device),
        kpe=torch.zeros(lead + (m.qk_rope_head_dim,), dtype=dtype,
                        device=device),
        pos=torch.full(lead, -1, dtype=torch.int32, device=device),
        full_capacity=full_capacity)


def _mla_cache_put(cache: MLACache, ckv_new: torch.Tensor,
                   kpe_new: torch.Tensor, positions: torch.Tensor) -> MLACache:
    """Write every entry at slot ``positions % capacity`` (all >= 0), in
    place, with no read-back: the chunks of a prompt."""
    slots = (positions % cache.capacity).long()
    bidx = torch.arange(ckv_new.shape[0], device=ckv_new.device)[:, None]
    cache.ckv[bidx, slots] = ckv_new.to(cache.ckv.dtype)
    cache.kpe[bidx, slots] = kpe_new.to(cache.kpe.dtype)
    cache.pos[bidx, slots] = positions.to(torch.int32)
    return cache


def mla_cache_write(cache: MLACache, ckv_new: torch.Tensor,
                    kpe_new: torch.Tensor, positions: torch.Tensor) -> MLACache:
    """Write S_new latent entries per sequence at slots ``positions %
    capacity``, in place; -1 positions are dropped, as the reference's
    ``mode="drop"`` scatter drops them."""
    keep = positions >= 0
    bidx = torch.arange(ckv_new.shape[0], device=ckv_new.device)[:, None]
    bidx = bidx.expand_as(positions)[keep]
    pos = positions[keep]
    slots = (pos % cache.capacity).long()
    cache.ckv[bidx, slots] = ckv_new[keep].to(cache.ckv.dtype)
    cache.kpe[bidx, slots] = kpe_new[keep].to(cache.kpe.dtype)
    cache.pos[bidx, slots] = pos.to(torch.int32)
    return cache


def mla_cache_from_prefill(cache: MLACache, ckv_new: torch.Tensor,
                           kpe_new: torch.Tensor,
                           positions: torch.Tensor) -> MLACache:
    """Fill a cache from a full prefill pass (positions 0..S-1), in place:
    slots 0..S-1, or the last ``capacity`` positions of a shorter cache
    (a slice, as ``kv_cache_from_prefill``)."""
    s = ckv_new.shape[1]
    if cache.capacity < s:
        keep = slice(s - cache.capacity, s)
        return _mla_cache_put(cache, ckv_new[:, keep], kpe_new[:, keep],
                              positions[:, keep])
    cache.ckv[:, :s] = ckv_new.to(cache.ckv.dtype)
    cache.kpe[:, :s] = kpe_new.to(cache.kpe.dtype)
    cache.pos[:, :s] = positions.to(torch.int32)
    return cache


def init_mla(gen: torch.Generator, cfg: ModelConfig,
             device: torch.device) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    s = 1.0 / math.sqrt(d)
    sl = 1.0 / math.sqrt(m.kv_lora_rank)

    def rnd(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale
                ).to(cfg.pdtype)

    return {"wq": rnd((d, h, qk_hd), s),
            "w_dkv": rnd((d, m.kv_lora_rank + m.qk_rope_head_dim), s),
            "kv_norm": torch.ones((m.kv_lora_rank,), dtype=cfg.pdtype,
                                  device=device),
            "w_ukv": rnd((m.kv_lora_rank, h,
                          m.qk_nope_head_dim + m.v_head_dim), sl),
            "wo": rnd((h, m.v_head_dim, d),
                      s / math.sqrt(2 * cfg.num_layers))}


def _mla_qkv_latent(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor):
    """Shared projections → (q_nope, q_pe, ckv, kpe): rope on q_pe per head
    and on the shared kpe; ckv normalised before it is cached.

    On a model axis ``wq`` holds the rank's heads and the latent
    (``w_dkv``, ``kv_norm``) is whole. Under autograd x enters ``wq``
    through ``collectives.column_entry``, and so do the latent and the
    shared kpe the rank's heads (``"mla.latent"``): each rank's gradient
    of them is the partial of its heads."""
    m = cfg.mla
    tp = dist.ctx().model_shard()
    q = _proj(C.column_entry(x, tp), p["wq"])
    q_nope, q_pe = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    dkv = x @ p["w_dkv"].to(x.dtype)
    ckv, kpe = dkv.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    ckv = rms_norm(p["kv_norm"], ckv, cfg.norm_eps)
    kpe = apply_rope(kpe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_pe, C.column_entry(ckv, tp, "mla.latent"), \
        C.column_entry(kpe, tp, "mla.latent")


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)


def _mla_expanded_attention(p: Params, cfg: ModelConfig, q_nope, q_pe,
                            ckv: torch.Tensor, kpe: torch.Tensor,
                            q_offset: int) -> torch.Tensor:
    """Causal flash attention of queries at ``q_offset..`` over the latent
    rows ``ckv``/``kpe`` (B, kv_len, ·) of positions 0..kv_len-1, expanded
    through ``w_ukv``: K = k_nope ‖ kpe broadcast over heads (contiguous,
    192 wide, as TMA takes it), Q = q_nope ‖ q_pe, V the 128-wide value
    part. Returns (B, Sq, H, dv)."""
    m = cfg.mla
    b, kv_len, _ = ckv.shape
    h = p["w_ukv"].shape[1]
    ukv = _proj(ckv, p["w_ukv"])                          # (B, kv_len, H, 256)
    k_nope, v = ukv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, kpe[:, :, None, :].expand(
        b, kv_len, h, m.qk_rope_head_dim).to(k_nope.dtype)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True,
                              scale=_mla_scale(cfg), q_offset=q_offset,
                              kv_len=kv_len)
    return out.transpose(1, 2)


def mla_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, lengths: Optional[torch.Tensor] = None,
              plain: bool = False
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Prefill MLA over a whole sequence (positions 0..S-1): the latent
    expanded to per-head K/V and one flash call (dk 192, dv 128). Returns
    (out, (ckv, kpe)) for latent caching. On the plain route a
    distribution context with ``chunk_kv`` <= S takes
    ``_chunked_mla_sdpa``, as the reference; the flash kernel never
    materialises the scores, so the kernel route ignores it.

    ``plain`` takes the reference's float32 expression (the nope and rope
    scores summed, the causal mask plus ``lengths``' mask, softmax, the
    value product) on any device: the training route, which autograd
    differentiates. A CPU tensor takes it too. ``lengths`` is taken on
    that route only.

    On a model axis ``wq``, ``w_ukv`` and ``wo`` hold the rank's heads;
    the latent (``w_dkv``, ``kv_norm``) is whole on every rank, so is the
    returned latent; ``wo``'s partial is summed over the axis."""
    q_nope, q_pe, ckv, kpe = _mla_qkv_latent(p, cfg, x, positions)
    dctx = dist.ctx()
    tp = dctx.model_shard()
    if tp is not None and p["w_ukv"].shape[1] * tp.size != cfg.num_heads:
        raise NotImplementedError(f"{cfg.name}: MLA on a model axis of "
                                  f"{tp.size} needs w_ukv on heads")
    s = x.shape[1]
    if (plain or not kernel_route(x)) and dctx.chunk_kv \
            and s >= dctx.chunk_kv:
        m = cfg.mla
        k_nope, v = _proj(ckv, p["w_ukv"]).split(
            [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
        out = _chunked_mla_sdpa(q_nope, q_pe, k_nope, kpe, v, positions,
                                _valid_key_positions(positions, lengths),
                                scale=_mla_scale(cfg),
                                chunk=dctx.chunk_size).to(x.dtype)
    elif plain or not kernel_route(x):
        m = cfg.mla
        k_nope, v = _proj(ckv, p["w_ukv"]).split(
            [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
        mask = causal_mask(s, s, device=x.device)
        if lengths is not None:
            mask = mask + length_mask(lengths, s)
        scores = (torch.einsum("bqhd,bshd->bhqs", q_nope.float(),
                               k_nope.float())
                  + torch.einsum("bqhd,bsd->bhqs", q_pe.float(), kpe.float())
                  ) * _mla_scale(cfg)
        probs = torch.softmax(scores + mask, dim=-1)
        out = torch.einsum("bhqs,bshd->bqhd", probs, v.float()).to(x.dtype)
    elif lengths is not None:
        raise ValueError("per-sequence lengths take the plain route "
                         "(plain=True)")
    else:
        out = _mla_expanded_attention(p, cfg, q_nope, q_pe, ckv, kpe, 0)
    return _out_proj(out, p["wo"], tp), (ckv, kpe)


def _chunked_mla_sdpa(q_nope: torch.Tensor, q_pe: torch.Tensor,
                      k_nope: torch.Tensor, kpe: torch.Tensor,
                      v: torch.Tensor, q_pos: torch.Tensor,
                      k_pos: torch.Tensor, *, scale: float,
                      chunk: int = 1024) -> torch.Tensor:
    """Chunked online-softmax for MLA's two-term scores (nope + rope),
    causal, in float32 — the reference's scan as a loop in chunk order.

    q_nope/k_nope: (B,S,H,dn); q_pe: (B,S,H,dr); kpe: (B,S,dr);
    v: (B,S,H,dv). Returns (B,Sq,H,dv) float32."""
    b, sq, h, _ = q_nope.shape
    dv = v.shape[-1]
    nc, k_pos, k_nope, kpe, v = _pad_chunks(chunk, k_pos, k_nope, kpe, v)
    qn, qp = q_nope.float(), q_pe.float()
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                   device=q_nope.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q_nope.device)
    acc = torch.zeros((b, sq, h, dv), dtype=torch.float32,
                      device=q_nope.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        kn, kp, vj, pj = k_nope[:, sl], kpe[:, sl], v[:, sl], k_pos[:, sl]
        s = (torch.einsum("bqhd,bshd->bhqs", qn, kn.float())
             + torch.einsum("bqhd,bsd->bhqs", qp, kp.float())) * scale
        ok = (pj[:, None, :] >= 0) & (pj[:, None, :] <= q_pos[:, :, None])
        s = torch.where(ok[:, None], s, NEG_INF)            # (B,H,Sq,C)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        upd = torch.einsum("bhqs,bshd->bqhd", p, vj.float())
        acc = acc * alpha.movedim(1, 2)[..., None] + upd
        m = m_new
    return acc / torch.clamp_min(l.movedim(1, 2)[..., None], 1e-30)


def mla_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, cache: MLACache,
               q_offset: Optional[int] = None
               ) -> Tuple[torch.Tensor, MLACache]:
    """A chunk of incremental prefill (or a few decode tokens) against a
    full-capacity latent cache (slot == position), written in place.
    x: (B,T,d); positions (B,T) = q_offset + 0..T-1.

    The reference computes this in absorbed form (scores in the 576-wide
    latent space); the port computes the same function in expanded form,
    so that it runs through flash at dk 192 / dv 128: the chunk's latent
    is written, the cache's first ``q_offset + T`` rows (every earlier
    position, slot == position) are expanded through ``w_ukv``, and flash
    attends causally from ``q_offset`` — a host integer, so nothing is
    read back from the card.

    On a model axis the cache is the rank's capacity share of the latent:
    ``_mla_decode_sharded``."""
    tp = dist.ctx().model_shard()
    if tp is not None:
        return _mla_decode_sharded(p, cfg, x, positions, cache, q_offset, tp)
    t = x.shape[1]
    if q_offset is None or not cache.full_capacity \
            or q_offset + t > cache.capacity:
        raise AssertionError(
            "mla_decode needs q_offset and a full-capacity cache "
            "(slot == position)")
    q_nope, q_pe, ckv_new, kpe_new = _mla_qkv_latent(p, cfg, x, positions)
    _mla_cache_put(cache, ckv_new, kpe_new, positions)
    c1 = q_offset + t
    out = _mla_expanded_attention(p, cfg, q_nope, q_pe, cache.ckv[:, :c1],
                                  cache.kpe[:, :c1], q_offset)
    return _out_proj(out, p["wo"]), cache


def _mla_decode_sharded(p: Params, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, cache: MLACache,
                        q_offset: Optional[int], tp: C.AxisShard
                        ) -> Tuple[torch.Tensor, MLACache]:
    """``mla_decode`` over the rank's share of a capacity-sharded latent
    cache (``ckv``/``kpe``/``pos`` slots [index x cap, (index + 1) x
    cap)), with ``wq``, ``w_ukv`` and ``wo`` on the rank's heads: the
    rank's q_nope ‖ q_pe are gathered to every head, and ``w_ukv`` on
    heads (once a call); the new latent row (whole on every rank: the
    latent's weights are replicated) is written only by its slot's owner;
    the rank's latent slots are expanded through every head's ``w_ukv``
    to K (nope ‖ kpe, 192 wide) and V (128), as ``mla_decode`` expands
    them on one card; ``ops.cache_attention_partial`` at dk 192 / dv 128
    attends every head over the rank's slots by their tags; then
    ``_merge_rank_partials``, ``wo`` over the rank's heads and ``psum``."""
    m = cfg.mla
    n = p["w_ukv"].shape[1]
    if n * tp.size != cfg.num_heads:
        raise NotImplementedError(f"{cfg.name}: MLA on a model axis of "
                                  f"{tp.size} needs w_ukv on heads")
    if q_offset is None:
        raise AssertionError("mla_decode on a model axis needs q_offset "
                             "(== positions[:, 0])")
    q_nope, q_pe, ckv_new, kpe_new = _mla_qkv_latent(p, cfg, x, positions)
    q = C.all_gather(torch.cat([q_nope, q_pe], dim=-1), 2, tp)
    w_ukv = C.all_gather(p["w_ukv"], 1, tp)               # (lora, H, 256)
    mla_cache_write(cache, ckv_new, kpe_new,
                    _owned_positions(positions, cache.capacity, tp))
    b, cap_l, _ = cache.ckv.shape
    h = w_ukv.shape[1]
    k_nope, v = _proj(cache.ckv.to(x.dtype), w_ukv).split(
        [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, cache.kpe[:, :, None, :].expand(
        b, cap_l, h, m.qk_rope_head_dim).to(k_nope.dtype)], dim=-1)
    acc, ml = ops.cache_attention_partial(q, k, v, cache.pos,
                                          q_offset=q_offset,
                                          scale=_mla_scale(cfg))
    out = _merge_rank_partials(acc, ml, n, tp, q.dtype)
    return _out_proj(out, p["wo"], tp), cache


def mla_decode_paged(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor,
                     pcache: Dict[str, torch.Tensor],
                     block_table: torch.Tensor, seq_lens: torch.Tensor,
                     write_blocks: torch.Tensor, write_slots: torch.Tensor,
                     ckv_spec: PC.KVPageSpec, kpe_spec: PC.KVPageSpec,
                     max_len: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed MLA decode against paged latent pools (one KV "head" of
    width lora and one of width rope), appended in place. x: (B,1,d);
    seq_lens (B,) lengths BEFORE this token.

    The sequences' pages go to canonical rows through ``ops.gather_pages``
    (the gather kernel on the card): only the first ceil(max_len / bs)
    columns of the block table when ``max_len`` — the longest length after
    this token, a host integer — is given, since later columns are masked
    anyway. Then scores in float32 in the latent space (q_nope absorbed
    through w_uk, plus q_pe over kpe), the length mask, softmax, the
    latent context, w_uv and wo, as the reference computes them (the
    profiler span ``mla.latent_attention``)."""
    m = cfg.mla
    b = x.shape[0]
    q_nope, q_pe, ckv_new, kpe_new = _mla_qkv_latent(p, cfg, x, positions)
    PC.append_token(ckv_spec, pcache["ckv_pool"], write_blocks, write_slots,
                    ckv_new[:, 0, None, :])
    PC.append_token(kpe_spec, pcache["kpe_pool"], write_blocks, write_slots,
                    kpe_new[:, 0, None, :])
    new_lens = seq_lens + 1
    bs = ckv_spec.block_size
    cols = block_table.shape[1]
    if max_len is not None:
        cols = min(cols, -(-int(max_len) // bs))
    ids = block_table[:, :cols].reshape(-1).contiguous()
    s_max = cols * bs
    ckv = ops.gather_pages(ckv_spec, pcache["ckv_pool"][None], ids).reshape(
        b, s_max, m.kv_lora_rank)
    kpe = ops.gather_pages(kpe_spec, pcache["kpe_pool"][None], ids).reshape(
        b, s_max, m.qk_rope_head_dim)
    w_uk, w_uv = p["w_ukv"].split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    with torch.profiler.record_function("mla.latent_attention"):
        q_lat = torch.einsum("bqhd,khd->bqhk", q_nope, w_uk.to(x.dtype))
        scores = (torch.einsum("bqhk,bsk->bhqs", q_lat.float(), ckv.float())
                  + torch.einsum("bqhd,bsd->bhqs", q_pe.float(), kpe.float())
                  ) * _mla_scale(cfg)
        pos = torch.arange(s_max, device=x.device)[None]
        mask = torch.where(pos < new_lens[:, None].long(), 0.0, NEG_INF)
        probs = torch.softmax(scores + mask[:, None, None, :], dim=-1)
        ctx_lat = torch.einsum("bhqs,bsk->bqhk", probs,
                               ckv.float()).to(x.dtype)
        out = torch.einsum("bqhk,khd->bqhd", ctx_lat, w_uv.to(x.dtype))
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


def swiglu_mlp(p: Params, x: torch.Tensor,
               d_ff: Optional[int] = None) -> torch.Tensor:
    """SwiGLU of x. With ``d_ff`` (the layer's whole width) on a model
    axis, column then row parallel: ``w_gate``/``w_up`` hold the rank's
    d_ff columns and ``w_down`` its rows, and the partial is summed over
    the axis (``_row_parallel``) — unless the width was too narrow to
    shard: then the weights are whole and so is the output. Under
    autograd x enters the column products through
    ``collectives.column_entry``."""
    tp = dist.ctx().model_shard() if d_ff is not None else None
    if tp is not None and p["w_gate"].shape[-1] == d_ff:
        tp = None
    if tp is not None and p["w_gate"].shape[-1] * tp.size != d_ff:
        raise ValueError(f"swiglu_mlp: {p['w_gate'].shape[-1]} of {d_ff} "
                         f"columns on a model axis of {tp.size}")
    x = C.column_entry(x, tp)
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return _row_parallel(F.silu(g) * u, p["w_down"], tp)


# --------------------------------------------------------------------------- #
# MoE — top-k routed experts (+ shared), sort-based grouping, one product
# per expert. No token dropping (every token reaches its k experts).
# --------------------------------------------------------------------------- #
def init_moe(gen: torch.Generator, cfg: ModelConfig,
             device: torch.device) -> Params:
    e = cfg.moe
    d, fe = cfg.d_model, e.d_ff_expert
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(fe) / math.sqrt(2 * cfg.num_layers)

    def rnd(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device=device) * scale
                ).to(dtype)

    p = {"router": rnd((d, e.num_experts), s_in, torch.float32),
         "w_gate": rnd((e.num_experts, d, fe), s_in, cfg.pdtype),
         "w_up": rnd((e.num_experts, d, fe), s_in, cfg.pdtype),
         "w_down": rnd((e.num_experts, fe, d), s_out, cfg.pdtype)}
    if e.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, device,
                               d_ff=e.num_shared_experts * fe)
    return p


def moe_route(p: Params, cfg: ModelConfig, x2d: torch.Tensor):
    """x2d: (T, d) → (weights (T,k) float32, expert_idx (T,k)): the router
    in float32, softmax, top-k, renormalised."""
    logits = x2d.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return weights / weights.sum(dim=-1, keepdim=True), idx


def moe_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Route → the chosen experts → combine. x: (B,S,d) or (T,d). The
    reference's single-device path (``_moe_mlp_local``), exact: every
    token reaches its k experts. Under a distribution context with
    ``moe_shard_map`` and a mesh, the launch layer's capacity-bounded route
    (``_moe_mlp_shard_map``), as in the reference."""
    dctx = dist.ctx()
    if dctx.moe_shard_map and dctx.mesh is not None:
        return _moe_mlp_shard_map(p, cfg, x, dctx)
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    weights, idx = moe_route(p, cfg, x2d)
    return moe_experts(p, cfg, x2d, weights, idx).reshape(shape)


def moe_experts(p: Params, cfg: ModelConfig, x2d: torch.Tensor,
                weights: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The routed experts of tokens x2d (T, d) for given choices idx (T,k)
    and weights (T,k), plus the shared experts. The (token, choice) pairs
    are sorted by expert with a stable sort (as ``jnp.argsort``), each
    expert's rows go through its SwiGLU, and the weighted outputs are put
    back in (token, choice) order and summed over the k choices: a gather
    and a sum, so two runs on the card give the same bits (no atomics).
    The group sizes go to the host to cut the sorted rows per expert: one
    read-back per layer, which waits for the work queued before it (the
    profiler span ``moe.group_sizes_to_host``; the products run in the
    span ``moe.expert_loop``)."""
    e = cfg.moe
    t, d = x2d.shape
    flat_expert = idx.reshape(-1)                                # (T*k,)
    order = torch.argsort(flat_expert, stable=True)
    xs = x2d[order // e.top_k]                                   # (T*k, d)
    with torch.profiler.record_function("moe.group_sizes_to_host"):
        sizes = torch.bincount(flat_expert, minlength=e.num_experts).tolist()
    outs = []
    with torch.profiler.record_function("moe.expert_loop"):
        for ei, xe in enumerate(torch.split(xs, sizes)):
            if xe.shape[0] == 0:
                continue
            g = xe @ p["w_gate"][ei].to(x2d.dtype)
            u = xe @ p["w_up"][ei].to(x2d.dtype)
            outs.append((F.silu(g) * u) @ p["w_down"][ei].to(x2d.dtype))
    y_sorted = torch.cat(outs)
    w_sorted = weights.reshape(-1)[order][:, None].to(y_sorted.dtype)
    unsort = torch.argsort(order)
    y = (y_sorted * w_sorted)[unsort].view(t, e.top_k, d).sum(dim=1)
    if e.num_shared_experts:
        y = y + swiglu_mlp(p["shared"], x2d)
    return y


def _moe_mlp_shard_map(p: Params, cfg: ModelConfig, x: torch.Tensor,
                       dctx) -> torch.Tensor:
    """The reference's expert-TP MoE under ``shard_map``: each shard routes
    its own tokens and computes every expert's d_ff slice, then the slices
    are summed over the model axis — its body, ``_moe_mlp_capacity`` with
    ``psum_axis``. On a rank's mesh the weights are the rank's slices
    (``moe_mlp_dist_specs``: every expert's and the shared experts'
    d_ff_expert columns, the router whole), so every rank routes the same
    (replicated) tokens alike and ``psum`` sums the slices. A rank of a
    data axis holds its own batch rows: it routes its own tokens with the
    capacity of its shard (``moe_capacity`` of its token count), as the
    reference's shard_map body does on its data shard; only the model
    axis is summed. On one card (a model axis of 1) the sum is over one
    member; on the ``meta`` device (a shape-only count) the same global
    program stands for every shard's. A mesh of more than one device
    outside a world raises."""
    mesh = dctx.mesh
    tp = dctx.model_shard()
    if mesh.size > 1 and not getattr(mesh, "in_world", False) \
            and getattr(mesh.device, "type", None) != "meta":
        raise NotImplementedError(
            f"the MoE over a mesh of {mesh.size} devices runs in a world "
            "of as many ranks (launch/ranks.py), or on meta as a count")
    if tp is not None and p["w_gate"].shape[-1] * tp.size \
            != cfg.moe.d_ff_expert:
        raise ValueError(f"the expert-TP MoE: {p['w_gate'].shape[-1]} of "
                         f"{cfg.moe.d_ff_expert} columns a rank")
    return C.psum(_moe_mlp_capacity(
        p, cfg, x, capacity_factor=dctx.moe_capacity_factor, tp=tp), tp)


def moe_mlp_dist_specs(cfg: ModelConfig, model_axis: str) -> Dict[str, Any]:
    """The weight specs ``_moe_mlp_shard_map`` expects (as tuples, one
    entry a dimension): the launch layer shards MoE weights exactly so."""
    spec: Dict[str, Any] = {"router": (None, None),
                            "w_gate": (None, None, model_axis),
                            "w_up": (None, None, model_axis),
                            "w_down": (None, model_axis, None)}
    if cfg.moe.num_shared_experts:
        spec["shared"] = {"w_gate": (None, model_axis),
                          "w_up": (None, model_axis),
                          "w_down": (model_axis, None)}
    return spec


def moe_capacity(cfg: ModelConfig, tokens: int,
                 capacity_factor: float = 1.25) -> int:
    """Rows of an expert's window in ``_moe_mlp_capacity``: the routed
    pairs an expert would get under an even split, times the factor,
    rounded up to 8, at least 8 and at most every pair."""
    e = cfg.moe
    tk = tokens * e.top_k
    return min(tk, max(8, int(math.ceil(tk / e.num_experts
                                        * capacity_factor / 8) * 8)))


def moe_capacity_drops(group_sizes, cap: int) -> int:
    """Routed (token, choice) pairs that ``_moe_mlp_capacity``'s windows
    leave out, from the group sizes (host ints, expert order) and the
    window ``cap``. A window starts at its expert's offset, or at
    ``tk - cap`` where that is earlier (then it covers the whole group):
    so an expert drops max(size - cap, 0) pairs if its offset is at most
    ``tk - cap``, else none."""
    sizes = [int(n) for n in group_sizes]
    tk, off, dropped = sum(sizes), 0, 0
    for n in sizes:
        if off <= tk - cap:
            dropped += max(n - cap, 0)
        off += n
    return dropped


def _moe_mlp_capacity(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      capacity_factor: float = 1.25,
                      tp: Optional[C.AxisShard] = None) -> torch.Tensor:
    """Capacity-bounded experts: the (token, choice) pairs sorted by expert
    (a stable sort, as ``jnp.argsort``), then a fixed window of ``cap``
    rows (``moe_capacity``) into the sorted stream for each expert —
    starting at its offset, clamped to end at the stream's end — whose
    rows outside the expert's range get weight 0; pairs past an expert's
    window are dropped. Three batched products over (E, cap, d) (no Pallas
    kernel computes them in the reference either), so no shape depends on
    the data and nothing is read back to the host; group sizes are
    counted with ``scatter_add_``, which the ``meta`` device runs.

    The combine is in a fixed order, so two runs on the card give the same
    bits: each window row in range lands on its own row of the sorted
    stream (rows out of range go to a spare row that is dropped), the
    stream goes back to (token, choice) order and the k choices are summed
    — where the reference adds the rows into the tokens with ``.at[].add``
    (atomics on a GPU). With a rank's d_ff_expert slices (expert-TP) the
    output is the rank's partial, which ``_moe_mlp_shard_map`` sums;
    under autograd the tokens enter the rank's columns (routed and
    shared) through ``collectives.column_entry`` on the model axis
    ``tp``, and so do the gate weights, which scale the rank's partial:
    the replicated router's gradient is summed over the axis
    (``"moe.router"``)."""
    e = cfg.moe
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    t, d = x2d.shape
    weights, idx = moe_route(p, cfg, x2d)
    weights = C.column_entry(weights, tp, "moe.router")
    x2d = C.column_entry(x2d, tp)
    flat_expert = idx.reshape(-1)                                # (T*k,)
    order = torch.argsort(flat_expert, stable=True)
    token_of = order // e.top_k
    flat_w = weights.reshape(-1)[order]
    group_sizes = torch.zeros(e.num_experts, dtype=torch.int64,
                              device=x.device).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert))
    offsets = torch.cumsum(group_sizes, 0) - group_sizes
    tk = t * e.top_k
    cap = moe_capacity(cfg, t, capacity_factor)
    starts = torch.clamp(offsets, max=tk - cap)
    pos = starts[:, None] + torch.arange(cap, device=x.device)[None]
    valid = (pos >= offsets[:, None]) & (pos < (offsets + group_sizes)[:, None])
    flat_pos = pos.reshape(-1)
    xw = x2d[token_of[flat_pos]].reshape(e.num_experts, cap, d)
    gate_w = torch.where(valid, flat_w[flat_pos].reshape(pos.shape), 0.0)
    g = torch.bmm(xw, p["w_gate"].to(x.dtype))
    u = torch.bmm(xw, p["w_up"].to(x.dtype))
    ye = torch.bmm(F.silu(g) * u, p["w_down"].to(x.dtype))
    ye = ye * gate_w[..., None].to(x.dtype)
    dest = torch.where(valid, pos, tk).reshape(-1)
    y_sorted = x2d.new_zeros((tk + 1, d)).index_copy_(
        0, dest, ye.reshape(-1, d))[:tk]
    y = x2d.new_empty((tk, d)).index_copy_(0, order, y_sorted)
    y = y.view(t, e.top_k, d).sum(dim=1)
    if e.num_shared_experts:
        y = y + swiglu_mlp(p["shared"], x2d)
    return y.reshape(shape)


def moe_load_balance_loss(p: Params, cfg: ModelConfig,
                          x: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss E * sum_e f_e * P_e of tokens x (..., d):
    f_e the share of the top-k choices that go to expert e, P_e the mean
    router probability of e. ``loss_fn`` does not add it, as in the
    reference."""
    e = cfg.moe
    x2d = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(x2d.float() @ p["router"].float(), dim=-1)
    _, idx = torch.topk(probs, e.top_k, dim=-1)
    counts = F.one_hot(idx, e.num_experts).float().sum(dim=(0, 1))
    frac = counts / torch.clamp_min(counts.sum(), 1.0)
    return e.num_experts * torch.sum(frac * probs.mean(dim=0))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) with no threshold, as ``jax.nn.softplus``."""
    return torch.logaddexp(x, torch.zeros_like(x))


# --------------------------------------------------------------------------- #
# RG-LRU recurrent block (Griffin / RecurrentGemma)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class RGLRUState:
    h: torch.Tensor          # (..., B, w) float32 recurrent hidden
    conv: torch.Tensor       # (..., B, d_conv-1, w) conv tail (compute dtype)

    def layer(self, i: int) -> "RGLRUState":
        """View of layer ``i`` of a group-stacked state."""
        return RGLRUState(self.h[i], self.conv[i])


def rglru_state_init(batch: int, cfg: ModelConfig, dtype,
                     device: torch.device, count: int = 1) -> RGLRUState:
    r = cfg.recurrent
    w = r.lru_width or cfg.d_model
    return RGLRUState(
        h=torch.zeros((count, batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((count, batch, r.d_conv - 1, w), dtype=dtype,
                         device=device))


def state_put(dst, src) -> None:
    """Write a layer state's new values (a state, or a dict of its fields
    on any device) into ``dst`` (views of a stacked state) in place, cast
    to its dtypes, as the reference's scan writes ``new.astype(buf.dtype)``
    back."""
    rows = src if isinstance(src, dict) else vars(src)
    for name, t in vars(dst).items():
        t.copy_(rows[name])


def init_rglru(gen: torch.Generator, cfg: ModelConfig,
               device: torch.device) -> Params:
    r = cfg.recurrent
    d = cfg.d_model
    w = r.lru_width or d
    s = 1.0 / math.sqrt(d)

    def rnd(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale
                ).to(cfg.pdtype)

    # Λ so that a = sigmoid(Λ)^(8r) sits in (0.9, 0.999), as the reference
    lo, hi = 0.9 ** (1 / 8), 0.999 ** (1 / 8)
    u = torch.rand((w,), generator=gen, device=device) * (hi - lo) + lo
    return {
        "w_x": rnd((d, w), s), "w_gate": rnd((d, w), s),
        "conv_w": rnd((r.d_conv, w), 1.0 / math.sqrt(r.d_conv)),
        "conv_b": torch.zeros((w,), dtype=cfg.pdtype, device=device),
        "lru_in_w": rnd((w, w), 0.1 / math.sqrt(w)),
        "lru_a_w": rnd((w, w), 0.1 / math.sqrt(w)),
        "lru_in_b": torch.zeros((w,), dtype=torch.float32, device=device),
        "lru_a_b": torch.zeros((w,), dtype=torch.float32, device=device),
        "lam": torch.log(torch.expm1(-torch.log(u))),
        "w_out": rnd((w, d), 1.0 / math.sqrt(w)
                     / math.sqrt(2 * cfg.num_layers)),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,w); w: (K,w); tail: (B,K-1,w) — the
    inputs before x (zeros when None)."""
    k = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(k))
    return out + b.to(x.dtype)


def _rglru_scan(a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t from h0. a, b: (B,S,w) float32; h0 (B,w).
    Returns h_1..h_S (B,S,w). A log-depth inclusive scan over the tokens
    (Hillis-Steele: ceil(log2 S) rounds of the reference's combine
    (a_l, b_l), (a_r, b_r) -> (a_l a_r, b_r + a_r b_l)), then the
    reference's ``a_prefix * h0 + b_prefix``."""
    s = a.shape[1]
    step = 1
    while step < s:
        a_r, b_r = a[:, step:], b[:, step:]
        b = torch.cat([b[:, :step], b_r + a_r * b[:, :-step]], dim=1)
        a = torch.cat([a[:, :step], a_r * a[:, :-step]], dim=1)
        step *= 2
    return a * h0[:, None, :] + b


def rglru_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                state: RGLRUState) -> Tuple[torch.Tensor, RGLRUState]:
    """Recurrent block over a sequence x (B,S,d) from ``state`` (B rows,
    unstacked). Returns (out, final state); ``state`` is not written. The
    gates and the recurrence run in float32 (the reference's ``lam`` and
    gate biases are float32, its gate weights cast up per call); ``h``
    ends float32, the conv tail in x's dtype. Profiler spans:
    ``rglru.block`` around the whole block, ``rglru.f32_weights`` around
    the gate weights' cast to float32 (a copy per call in bf16),
    ``rglru.scan`` around the recurrence.

    On a model axis (the reference's specs: ``w_x``, ``w_gate``,
    ``conv_w``, ``conv_b``, ``lam`` and the gate biases on the width,
    ``lru_a_w`` / ``lru_in_w`` on their columns, ``w_out`` on its rows;
    the state ``h`` and ``conv`` on the width) the rank computes its
    channels: its columns of ``xb`` and ``gate``, the conv over them with
    its part of the tail, then ``xb`` gathered on the width for the gate
    products, which give the rank's half of the gates; the scan over its
    channels; ``w_out``'s partial summed over the axis in x's dtype
    (``_row_parallel``). Under autograd x enters the rank's columns
    through ``collectives.column_entry``, and the gathered ``xb`` feeds
    the rank's gate channels only, so its gather's backward sums before
    it slices (``"rglru.xb"``)."""
    tp = dist.ctx().model_shard()
    if tp is not None and p["w_x"].shape[-1] == p["lru_a_w"].shape[0]:
        tp = None                        # a width too narrow to shard
    with torch.profiler.record_function("rglru.block"):
        x = C.column_entry(x, tp)
        xb = x @ p["w_x"].to(x.dtype)
        gate = x @ p["w_gate"].to(x.dtype)
        k = p["conv_w"].shape[0]
        new_tail = torch.cat([state.conv, xb], dim=1)[:, -(k - 1):]
        xb = _causal_conv1d(xb, p["conv_w"], p["conv_b"], state.conv)
        xf = xb.float()
        xg = xf if tp is None else C.all_gather(
            xb, 2, tp, grad="split", name="rglru.xb").float()
        with torch.profiler.record_function("rglru.f32_weights"):
            w_a, w_i = p["lru_a_w"].float(), p["lru_in_w"].float()
        r_g = torch.sigmoid(xg @ w_a + p["lru_a_b"])
        i_g = torch.sigmoid(xg @ w_i + p["lru_in_b"])
        log_a = -8.0 * r_g * _softplus(p["lam"])
        a = torch.exp(log_a)
        b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
            * (xf * i_g)
        with torch.profiler.record_function("rglru.scan"):
            h = _rglru_scan(a, b, state.h)
        out = h.to(x.dtype) * F.gelu(gate, approximate="tanh")
        out = _row_parallel(out, p["w_out"], tp)
    return out, RGLRUState(h=h[:, -1], conv=new_tail)


def rglru_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 state: RGLRUState) -> Tuple[torch.Tensor, RGLRUState]:
    """Single-step decode; x: (B,1,d)."""
    return rglru_block(p, cfg, x, state)


# --------------------------------------------------------------------------- #
# Mamba-2 SSD (state-space duality, chunked)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class SSMState:
    h: torch.Tensor          # (..., B, H, P, N) float32 SSD state
    conv: torch.Tensor       # (..., B, d_conv-1, conv_dim) conv tail

    def layer(self, i: int) -> "SSMState":
        """View of layer ``i`` of a group-stacked state."""
        return SSMState(self.h[i], self.conv[i])


def _ssd_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads, groups x d_state, conv width)."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.d_state
    return di, s.n_heads(cfg.d_model), gn, di + 2 * gn


def ssm_state_init(batch: int, cfg: ModelConfig, dtype,
                   device: torch.device, count: int = 1) -> SSMState:
    s = cfg.ssm
    _, nh, _, conv_dim = _ssd_dims(cfg)
    return SSMState(
        h=torch.zeros((count, batch, nh, s.head_dim, s.d_state),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((count, batch, s.d_conv - 1, conv_dim), dtype=dtype,
                         device=device))


def init_ssd(gen: torch.Generator, cfg: ModelConfig,
             device: torch.device) -> Params:
    s = cfg.ssm
    d = cfg.d_model
    di, nh, gn, conv_dim = _ssd_dims(cfg)

    def rnd(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale
                ).to(cfg.pdtype)

    def uniform(lo, hi):
        return torch.rand((nh,), generator=gen, device=device) * (hi - lo) + lo

    return {
        "w_in": rnd((d, 2 * di + 2 * gn + nh), 1.0 / math.sqrt(d)),
        "conv_w": rnd((s.d_conv, conv_dim), 1.0 / math.sqrt(s.d_conv)),
        "conv_b": torch.zeros((conv_dim,), dtype=cfg.pdtype, device=device),
        "a_log": torch.log(uniform(1.0, 16.0)),
        "d_skip": torch.ones((nh,), dtype=torch.float32, device=device),
        "dt_bias": torch.log(torch.expm1(uniform(1e-3, 0.1))),
        "out_norm": torch.ones((di,), dtype=cfg.pdtype, device=device),
        "w_out": rnd((di, d), 1.0 / math.sqrt(di)
                     / math.sqrt(2 * cfg.num_layers)),
    }


def _ssd_inputs(p: Params, cfg: ModelConfig, x: torch.Tensor,
                state: SSMState):
    """The in-projection, the conv over the state's tail and the split:
    (z, x heads (B,S,H,P), B and C per head (B,S,H,N), dt (B,S,H), new conv
    tail). x, B, C and dt in float32, z in x's dtype.

    On a model axis the parameters are whole and the block is computed
    whole on every rank, but the state's conv tail holds the rank's
    channels (the reference's cache spec): it is gathered on the channels
    before the conv, and the new tail is the rank's channels of it."""
    s = cfg.ssm
    b, S, _ = x.shape
    di, nh, gn, conv_dim = _ssd_dims(cfg)
    z, xbc, dt = torch.split(x @ p["w_in"].to(x.dtype), [di, di + 2 * gn, nh],
                             dim=-1)
    tail = state.conv.to(xbc.dtype)
    tp = dist.ctx().model_shard()
    if tp is not None and tail.shape[-1] == conv_dim:
        tp = None                        # a tail too narrow to shard
    if tp is not None:
        tail = C.all_gather(tail, 2, tp)
    new_tail = torch.cat([tail, xbc], dim=1)[:, -(s.d_conv - 1):]
    if tp is not None:
        c0, c1 = tp.part(conv_dim)
        new_tail = new_tail[..., c0:c1]
    xbc = F.silu(_causal_conv1d(xbc, p["conv_w"], p["conv_b"], tail))
    xs, b_, c_ = torch.split(xbc, [di, gn, gn], dim=-1)
    rep = nh // s.n_groups

    def heads(t):            # groups → heads, as the reference's jnp.repeat
        return t.reshape(b, S, s.n_groups, s.d_state).float() \
            .repeat_interleave(rep, dim=2)
    xh = xs.reshape(b, S, nh, s.head_dim).float()
    dtf = _softplus(dt.float() + p["dt_bias"])
    return z, xh, heads(b_), heads(c_), dtf, new_tail


def _ssd_out(p: Params, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """The gated norm and the out-projection of y (B,S,di) float32."""
    y = rms_norm(p["out_norm"], y.to(x.dtype) * F.silu(z), cfg.norm_eps)
    return y @ p["w_out"].to(x.dtype)


def _segsum_exp(da_cs: torch.Tensor) -> torch.Tensor:
    """L[i,j] = exp(cum_i - cum_j) for i >= j else 0. da_cs: (..., Q).
    The upper triangle is masked to -inf before the exp, so no inf is
    ever made (an inf there times a zero elsewhere would be NaN)."""
    diff = da_cs[..., :, None] - da_cs[..., None, :]
    q = diff.shape[-1]
    mask = torch.ones((q, q), dtype=torch.bool, device=diff.device).tril()
    return torch.exp(diff.masked_fill(~mask, float("-inf")))


def ssd_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
              state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """Chunked SSD over a sequence x (B,S,d) from ``state`` (B rows,
    unstacked; not written). The sequence is padded to a multiple of
    ``Q = min(chunk_size, S)``; within a chunk the scores are quadratic,
    across chunks the states recur in order (``h_prev`` is the state
    entering each chunk). Everything after the projections runs in
    float32, with plain tensor products as the reference's einsums (three-
    operand contractions taken as an elementwise product, then one
    batched product). Returns (out, final state). Profiler spans:
    ``ssd.block`` around the block, ``ssd.scan`` around the inter-chunk
    recurrence."""
    s = cfg.ssm
    with torch.profiler.record_function("ssd.block"):
        b, S, _ = x.shape
        di, nh, _, _ = _ssd_dims(cfg)
        z, xh, bh, ch, dtf, new_tail = _ssd_inputs(p, cfg, x, state)
        da = dtf * -torch.exp(p["a_log"])                    # (B,S,H)
        q = min(s.chunk_size, S)
        pad = (-S) % q
        if pad:
            xh, bh, ch = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xh, bh, ch))
            da, dtf = (F.pad(t, (0, 0, 0, pad)) for t in (da, dtf))
        nc = (S + pad) // q

        def chunks(t):                     # (B, S', ...) -> (B, nc, Q, ...)
            return t.reshape((b, nc, q) + tuple(t.shape[2:]))
        xc, bc, cc, dac, dtc = map(chunks, (xh, bh, ch, da, dtf))
        da_cs = torch.cumsum(dac, dim=2)                     # (B,nc,Q,H)
        # intra-chunk: quadratic within each chunk
        seg = _segsum_exp(da_cs.movedim(-1, 2))              # (B,nc,H,Q,Q)
        scores = torch.einsum("bcqhn,bckhn->bchqk", cc, bc) * seg \
            * dtc.movedim(-1, 2)[:, :, :, None, :]
        y = torch.einsum("bchqk,bckhp->bcqhp", scores, xc)
        # chunk-local end states
        decay_to_end = torch.exp(da_cs[:, :, -1:, :] - da_cs)
        states = torch.einsum("bcqhn,bcqhp->bchpn",
                              (decay_to_end * dtc)[..., None] * bc, xc)
        # inter-chunk recurrence, in chunk order
        chunk_decay = torch.exp(dac.sum(dim=2))              # (B,nc,H)
        with torch.profiler.record_function("ssd.scan"):
            h = state.h
            h_prev = []
            for c in range(nc):
                h_prev.append(h)
                h = h * chunk_decay[:, c, :, None, None] + states[:, c]
            h_prev = torch.stack(h_prev, dim=1)              # (B,nc,H,P,N)
        y = y + torch.einsum("bcqhn,bchpn->bcqhp",
                             torch.exp(da_cs)[..., None] * cc, h_prev)
        y = y.reshape(b, S + pad, nh, s.head_dim)[:, :S]
        y = y + xh[:, :S] * p["d_skip"][None, None, :, None]
        out = _ssd_out(p, cfg, y.reshape(b, S, di), z, x)
    return out, SSMState(h=h, conv=new_tail)


def ssd_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
               state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """Single-step SSD recurrence. x: (B,1,d)."""
    b = x.shape[0]
    di = _ssd_dims(cfg)[0]
    z, xh, bh, ch, dtf, new_tail = _ssd_inputs(p, cfg, x, state)
    xh, bh, ch, dtf = xh[:, 0], bh[:, 0], ch[:, 0], dtf[:, 0]
    decay = torch.exp(dtf * -torch.exp(p["a_log"]))          # (B,H)
    h = state.h * decay[:, :, None, None] + \
        (dtf[:, :, None, None] * xh[..., None]) * bh[:, :, None, :]
    y = torch.einsum("bhn,bhpn->bhp", ch, h) + xh * p["d_skip"][None, :, None]
    return _ssd_out(p, cfg, y.reshape(b, 1, di), z, x), \
        SSMState(h=h, conv=new_tail)

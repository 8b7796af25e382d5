"""Config-driven model assembly — PyTorch port of ``repro.models.model``
for the dense, sliding-window, MoE, MLA, hybrid RG-LRU and Mamba-2 SSD
families, the vision frontend's patch embeddings before the prompt
(VLM), and the encoder-decoder family (the audio frontend: a non-causal
encoder over frame embeddings whose memory every decoder layer
cross-attends). Both frontends are stubs, as in the reference: a request
carries precomputed patch or frame embeddings.

A model is a list of *block groups* whose parameters are stacked along a
leading ``count`` axis, exactly as in the JAX package (so
``convert.params_from_numpy`` carries JAX parameters across unchanged).
A group repeats its tuple of layer kinds ``count`` times (the hybrid:
(rglru, rglru, attn) x 12, then (rglru, rglru) once), one stacked
parameter tree per position in the tuple. Where the JAX code scans over
the stacked axis with the caches in the carry, the port loops over layer
slices of the stacked tensors (each repetition's positions in order) and
updates each layer's cache or recurrent state slice in place. An SSM
model is one group of SSD layers (a norm and the SSD mixer, no MLP). An
encoder-decoder model has its encoder groups beside (``enc_groups``,
``enc_norm``), and each decoder layer a cross-attention (``cross``, its
norm ``norm_x``) over the encoder's memory; its caches hold the memory's
cross K/V rows beside the self-attention KV (``L.CrossKVCache``; in the
paged caches ``cross_k``/``cross_v``/``mem_len`` per slot).

Entry points:
  train_forward(params, cfg, batch, remat=True)         -> logits (B,S,V)
  loss_fn(params, cfg, batch, remat=True)               -> mean NLL ()
  encode(params, cfg, frames, frame_lengths)            -> memory (B,S,d)
  encoder_cross_kv(params, cfg, memory)                 -> {(gi, pi): (k, v)}
  prefill(params, cfg, inputs, caches)                  -> (last_logits, caches)
  decode_step(params, cfg, tokens, positions, caches)   -> (logits, caches)
  decode_step_embeds(params, cfg, embeds, positions, caches)
                                                        -> (logits, caches)
  decode_step_paged(params, cfg, tokens, seq_lens, ...) -> (logits, caches)

Training (``train_forward``, ``loss_fn``) runs every layer over the whole
sequence from zero recurrent states, writes no cache and no state, and
takes the plain attention route on every device (``plain=True``): the
kernels have no backward pass. Each stacked leaf is unbound once per
forward (``unbind_layers``), so its backward stacks the layer gradients
once instead of summing a stack-sized zero tensor per layer; with
``remat`` each layer runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` around its scan body).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _dev
from repro_torch.configs.base import ATTN, RECURRENT, SSD, ModelConfig
from repro_torch.models import collectives as C
from repro_torch.models import dist
from repro_torch.models import layers as L
from repro_torch.serving import paged_cache as PC

Params = Dict[str, Any]
# (path of a parameter leaf, the leaf as drawn) -> the part to keep
Keep = Callable[[str, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Group:
    kinds: Tuple[str, ...]
    count: int
    moe: bool = False
    cross: bool = False     # decoder layers of an enc-dec model
    causal: bool = True


def block_groups(cfg: ModelConfig) -> List[Group]:
    """dense: [Group(("attn",), L)]; moe: the first dense layers, if any,
    then the MoE layers; hybrid: the block pattern repeated, then its
    first L mod len(pattern) kinds once; ssm: [Group(("ssd",), L)];
    enc-dec: the decoder's [Group(("attn",), L, cross=True)] — as in the
    reference."""
    _dev.check_family(cfg)
    if cfg.family == "ssm":
        return [Group((SSD,), cfg.num_layers)]
    if cfg.recurrent is not None:
        pat = cfg.recurrent.block_pattern
        full, rem = divmod(cfg.num_layers, len(pat))
        gs = [Group(pat, full)]
        if rem:
            gs.append(Group(pat[:rem], 1))
        return gs
    if cfg.is_moe and cfg.moe.first_dense_layers:
        fd = cfg.moe.first_dense_layers
        return [Group((ATTN,), fd, moe=False),
                Group((ATTN,), cfg.num_layers - fd, moe=True)]
    return [Group((ATTN,), cfg.num_layers, moe=cfg.is_moe,
                  cross=cfg.is_enc_dec)]


def encoder_groups(cfg: ModelConfig) -> List[Group]:
    """The encoder of an enc-dec model: non-causal attention layers."""
    return [Group((ATTN,), cfg.encoder_layers, causal=False)]


def layer_params(stacked: Any, i: int) -> Any:
    """Layer ``i`` of a stacked parameter tree (views, no copy)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def unbind_layers(stacked: Any) -> List[Any]:
    """Every layer of a stacked parameter tree, as trees of views: one
    ``torch.unbind`` per leaf, whose backward stacks the layers' gradients
    once (indexing each layer, as ``layer_params`` does, would add a
    stack-sized zero tensor per layer)."""
    if isinstance(stacked, dict):
        per_key = {k: unbind_layers(v) for k, v in stacked.items()}
        count = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(count)]
    return list(torch.unbind(stacked, 0))


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str,
                moe: bool, cross: bool, device: torch.device) -> Params:
    d = cfg.d_model
    if kind == SSD:
        return {"norm": torch.ones((d,), dtype=cfg.pdtype, device=device),
                "ssd": L.init_ssd(gen, cfg, device)}
    if kind == RECURRENT:
        return {"norm1": torch.ones((d,), dtype=cfg.pdtype, device=device),
                "rglru": L.init_rglru(gen, cfg, device),
                "norm2": torch.ones((d,), dtype=cfg.pdtype, device=device),
                "mlp": L.init_mlp(gen, cfg, device)}
    mlp = L.init_moe(gen, cfg, device) if moe else \
        L.init_mlp(gen, cfg, device)
    attn = L.init_mla(gen, cfg, device) if _is_mla(cfg) else \
        L.init_attention(gen, cfg, device)
    p = {"norm1": torch.ones((d,), dtype=cfg.pdtype, device=device),
         "norm2": torch.ones((d,), dtype=cfg.pdtype, device=device),
         "attn": attn, "mlp": mlp}
    if cross:
        p["norm_x"] = torch.ones((d,), dtype=cfg.pdtype, device=device)
        p["cross"] = L.init_cross_attention(gen, cfg, device)
    return p


def _init_group(gen: torch.Generator, cfg: ModelConfig, g: Group,
                kind: str, device: torch.device, prefix: str = "",
                keep: Optional[Keep] = None) -> Params:
    """The ``g.count`` layers of one position of a group, drawn one after
    the other, each written into its slot of the stacked tensors as it is
    made: the values of stacking every layer at the end, at the memory of
    the stack plus one layer. With ``keep``, each layer's leaf is cut to
    ``keep(path of the stacked leaf, leaf)`` before it is stored (``prefix``
    is the path of this position's tree)."""
    count = g.count
    keep = keep or (lambda path, t: t)
    # a keeper of whole layers (ZeRO-3 weights split on the layer axis)
    slot = getattr(keep, "layer_slot", lambda path, i, n: i)
    kept = getattr(keep, "layers_kept", lambda path, n: n)

    def put(dst, src, i, path):
        if isinstance(src, dict):
            for k in src:
                put(dst[k], src[k], i, f"{path}[{k!r}]")
        else:
            j = slot(path, i, count)
            if j is not None:
                dst[j] = keep(path, src)

    def empty(t, path):
        if isinstance(t, dict):
            return {k: empty(v, f"{path}[{k!r}]") for k, v in t.items()}
        return t.new_empty((kept(path, count),) + tuple(keep(path, t).shape))

    layer = _init_layer(gen, cfg, kind, g.moe, g.cross, device)
    stacked = empty(layer, prefix)
    put(stacked, layer, 0, prefix)
    for i in range(1, count):
        put(stacked, _init_layer(gen, cfg, kind, g.moe, g.cross, device), i,
            prefix)
    return stacked


def init_params(cfg: ModelConfig, seed: int = 0,
                device: _dev.DeviceLike = None,
                keep: Optional[Keep] = None) -> Params:
    """Random parameters with the JAX package's shapes and scales, drawn
    from a ``torch.Generator`` seeded with ``seed`` on the target device
    (the card unless ``device="cpu"``). ``keep(path, tensor)`` — the
    rank's slice on a model axis, ``launch.sharding.param_keeper`` —
    cuts each leaf as it is drawn (a stacked group's leaves one layer at a
    time; ``path`` is the stacked leaf's): the same values as slicing the
    whole tree, at the memory of the slices plus one layer. A keeper with
    ``layer_slot(path, i, count)`` and ``layers_kept(path, count)`` keeps
    only some layers of a stacked leaf (ZeRO-3 weights split on the layer
    axis): layer i goes to the returned slot, or is dropped for None."""
    return _init_params(cfg, seed, _dev.resolve(device), keep)


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameter tree's shapes and dtypes as tensors on the ``meta``
    device: nothing is allocated or drawn."""
    return _init_params(cfg, 0, torch.device("meta"))


def _init_params(cfg: ModelConfig, seed: int, dev: torch.device,
                 keep: Optional[Keep] = None) -> Params:
    groups = block_groups(cfg)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    cut = keep or (lambda path, t: t)

    def stacks(name, gs):
        return tuple(
            tuple(_init_group(gen, cfg, g, kind, dev, f"[{name!r}][{gi}][{pi}]",
                              keep) for pi, kind in enumerate(g.kinds))
            for gi, g in enumerate(gs))

    p: Params = {
        "embed": cut("['embed']", (torch.randn((v, d), generator=gen,
                                               device=dev) * 0.02
                                   ).to(cfg.pdtype)),
        "final_norm": cut("['final_norm']", torch.ones(
            (d,), dtype=cfg.pdtype, device=dev)),
        "groups": stacks("groups", groups),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = cut("['lm_head']", (torch.randn(
            (d, v), generator=gen, device=dev) / math.sqrt(d)
        ).to(cfg.pdtype))
    if cfg.is_enc_dec:
        p["enc_groups"] = stacks("enc_groups", encoder_groups(cfg))
        p["enc_norm"] = cut("['enc_norm']", torch.ones(
            (d,), dtype=cfg.pdtype, device=dev))
    return p


# --------------------------------------------------------------------------- #
# Caches
# --------------------------------------------------------------------------- #
def init_caches(cfg: ModelConfig, batch: int, capacity: int, dtype=None,
                full_capacity: bool = False,
                device: _dev.DeviceLike = None, mem_len: int = 0):
    """Dense position-tagged caches, one group-stacked ``KVCache`` (an
    ``MLACache`` of latent rows for MLA; a ``CrossKVCache`` with
    ``mem_len`` zeroed memory rows for an enc-dec decoder) per attention
    position of a group and one group-stacked ``RGLRUState`` per recurrent
    position or ``SSMState`` per SSD position (leaves are (count, B,
    ...)). A sliding
    layer's cache is a ring buffer of ``min(capacity, window)`` slots
    unless ``full_capacity``: chunked prefill opts out (writing chunk c
    would evict positions still inside the window of chunk c's own
    queries), so slot == position and attention applies the window."""
    dev = _dev.resolve(device)
    dtype = dtype or cfg.cdtype
    cap = capacity
    if _window(cfg) and not full_capacity:
        cap = min(cap, _window(cfg))

    def one(kind, g):
        count = g.count
        if kind == SSD:
            return L.ssm_state_init(batch, cfg, dtype, dev, count=count)
        if kind == RECURRENT:
            return L.rglru_state_init(batch, cfg, dtype, dev, count=count)
        if _is_mla(cfg):
            return L.mla_cache_init(batch, cap, cfg, dtype, dev, count=count,
                                    full_capacity=full_capacity)
        c = L.kv_cache_init(batch, cap, cfg.num_kv_heads, cfg.hd, dtype,
                            dev, count=count, full_capacity=full_capacity)
        if g.cross:
            return L.CrossKVCache(**vars(c), **L.cross_rows_init(
                batch, mem_len, cfg, dtype, dev, count=count))
        return c

    return tuple(tuple(one(kind, g) for kind in g.kinds)
                 for g in block_groups(cfg))


def abstract_caches(cfg: ModelConfig, batch: int, capacity: int, dtype=None,
                    mem_len: int = 0, full_capacity: bool = False):
    """``init_caches``' tree on the ``meta`` device: shapes and dtypes,
    nothing allocated (the reference's ``jax.eval_shape`` of it)."""
    return init_caches(cfg, batch, capacity, dtype, full_capacity,
                       device="meta", mem_len=mem_len)


def init_paged_caches(cfg: ModelConfig, specs: Dict[str, PC.KVPageSpec],
                      num_blocks: int, batch: int = 0,
                      device: _dev.DeviceLike = None, mem_len: int = 0):
    """Paged pools of (count, N, *page) per attention position of a group:
    {"k_pool", "v_pool"} of ``specs["kv"]``, or for MLA {"ckv_pool",
    "kpe_pool"} of ``specs["ckv"]`` and ``specs["kpe"]``; an enc-dec
    decoder position also holds each slot's memory rows ("cross_k",
    "cross_v": (count, batch, mem_len, KV, hd) in the compute dtype,
    "mem_len": (count, batch) int32, 0 for an idle slot); a recurrent or
    SSD position holds its dense per-slot state, an ``RGLRUState`` or
    ``SSMState`` of ``batch`` rows in the compute dtype (h float32), so a
    model with such layers needs ``batch`` > 0. An SSM model has no pool
    at all."""
    dev = _dev.resolve(device)
    names = (("ckv_pool", "ckv"), ("kpe_pool", "kpe")) if _is_mla(cfg) \
        else (("k_pool", "kv"), ("v_pool", "kv"))

    def one(kind, g):
        count = g.count
        if kind in (RECURRENT, SSD):
            if batch <= 0:
                raise ValueError(f"init_paged_caches: {cfg.name} holds "
                                 "per-slot recurrent states; pass batch > 0")
            init = L.ssm_state_init if kind == SSD else L.rglru_state_init
            return init(batch, cfg, cfg.cdtype, dev, count=count)
        pools = {name: torch.zeros((count,) + specs[key].pool_shape(
            num_blocks), dtype=specs[key].tdtype, device=dev)
            for name, key in names}
        if g.cross:
            pools.update(L.cross_rows_init(batch, mem_len, cfg, cfg.cdtype,
                                           dev, count=count))
        return pools

    return tuple(tuple(one(kind, g) for kind in g.kinds)
                 for g in block_groups(cfg))


# --------------------------------------------------------------------------- #
# Embedding / head
# --------------------------------------------------------------------------- #
def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings (B,S,d) in the compute dtype. On a model axis the
    table holds the rank's vocab rows: ids outside them take zeros, and
    the ranks' rows are summed (``psum``: each id is one rank's)."""
    table = params["embed"]
    tp = dist.ctx().model_shard()
    if tp is not None and table.shape[0] != cfg.vocab_size:
        v0, v1 = tp.part(cfg.vocab_size)
        ids = tokens.long() - v0
        inside = ((ids >= 0) & (ids < v1 - v0))[..., None]
        e = table[ids.clamp(0, v1 - v0 - 1)].to(cfg.cdtype)
        e = C.psum(torch.where(inside, e, torch.zeros_like(e)), tp)
    else:
        e = table[tokens.long()].to(cfg.cdtype)
    if cfg.tie_embeddings:
        return e * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype)
    return e


def merged_embeds(params, cfg: ModelConfig, patches: Optional[torch.Tensor],
                  tokens: torch.Tensor) -> torch.Tensor:
    """The sequence a vision model runs: the patch embeddings (B,P,d) in
    the compute dtype, then the token embeddings (ref ``_merge_frontend``
    and the engine's merged embeds). Tokens alone when ``patches`` is
    None. Patches given to a model without a vision frontend raise: the
    serving path counts them in a sequence's length, so dropping them
    would size the stream for positions the embeddings do not have."""
    emb = embed_tokens(params, cfg, tokens)
    if patches is None:
        return emb
    if cfg.frontend.kind != "vision":
        raise ValueError(f"{cfg.name}: patches given to a model without a "
                         "vision frontend")
    return torch.cat([patches.to(device=emb.device, dtype=cfg.cdtype), emb],
                     dim=1)


def lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits of x (..., d) over the head's vocab: on a model axis the
    rank's vocab shard (the reference's output spec (dp, ..., model)),
    which the caller gathers where it needs the whole row. Under autograd
    x enters the vocab-sharded head through ``collectives.column_entry``."""
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    if head.shape[-1] != cfg.vocab_size:
        x = C.column_entry(x, dist.ctx().model_shard())
    return x @ head.to(x.dtype)


# --------------------------------------------------------------------------- #
# Layer application
# --------------------------------------------------------------------------- #
def _window(cfg: ModelConfig) -> int:
    return cfg.sliding_window if cfg.attention_kind == "sliding" else 0


def _is_mla(cfg: ModelConfig) -> bool:
    return cfg.attention_kind == "mla"


def attention_full(p, cfg: ModelConfig, h: torch.Tensor,
                   positions: torch.Tensor):
    """A layer's attention over a whole prompt (positions 0..S-1):
    (out, cache rows) — (k, v) or, for MLA, the latent (ckv, kpe)."""
    if _is_mla(cfg):
        return L.mla_block(p, cfg, h, positions)
    return L.attention_block(p, cfg, h, positions, window=_window(cfg))


def _mlp_residual(p, cfg: ModelConfig, moe: bool,
                  x: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(p["norm2"], x, cfg.norm_eps)
    return x + (L.moe_mlp(p["mlp"], cfg, h) if moe
                else L.swiglu_mlp(p["mlp"], h, cfg.d_ff))


def _recurrent(p, cfg: ModelConfig, x: torch.Tensor, state) -> torch.Tensor:
    """A recurrent layer: the RG-LRU block from ``state`` (views of one
    layer's stacked state, written in place), then the MLP."""
    h, new = L.rglru_block(p["rglru"], cfg,
                           L.rms_norm(p["norm1"], x, cfg.norm_eps), state)
    L.state_put(state, new)
    return _mlp_residual(p, cfg, False, x + h)


def _ssd(p, cfg: ModelConfig, x: torch.Tensor, state,
         step: bool = False) -> torch.Tensor:
    """An SSD layer: the chunked block (or, with ``step``, the single-token
    recurrence) from ``state`` (views of one layer's stacked state,
    written in place), added to the residual."""
    fn = L.ssd_decode if step else L.ssd_block
    h, new = fn(p["ssd"], cfg, L.rms_norm(p["norm"], x, cfg.norm_eps), state)
    L.state_put(state, new)
    return x + h


def _cross(p, cfg: ModelConfig, x: torch.Tensor, mem_kv,
           mem_lengths: Optional[torch.Tensor] = None,
           kv_len: Optional[int] = None) -> torch.Tensor:
    """A decoder layer's cross-attention over the memory rows, added to
    the residual (``L.cross_attention``'s routes)."""
    hx = L.rms_norm(p["norm_x"], x, cfg.norm_eps)
    return x + L.cross_attention(p["cross"], cfg, hx, mem_kv, mem_lengths,
                                 kv_len)


def _check_mem(cache: L.CrossKVCache, mem: int) -> None:
    if mem > cache.cross_k.shape[-3]:
        raise ValueError(f"encoder memory of {mem} rows exceeds the "
                         f"cache's {cache.cross_k.shape[-3]} (mem_len)")


def _layers(params, cfg: ModelConfig):
    """(group index, position, layer index, kind, group, layer params) in
    model order: each repetition of a group runs its positions in turn."""
    for gi, g in enumerate(block_groups(cfg)):
        for li in range(g.count):
            for pi, kind in enumerate(g.kinds):
                yield gi, pi, li, kind, g, layer_params(
                    params["groups"][gi][pi], li)


# --------------------------------------------------------------------------- #
# The encoder (enc-dec)
# --------------------------------------------------------------------------- #
def encode(params, cfg: ModelConfig, frames: torch.Tensor,
           frame_lengths: Optional[torch.Tensor] = None, *,
           plain: bool = False, remat: bool = False) -> torch.Tensor:
    """Encoder forward over frame embeddings (B,S,d) (the audio frontend is
    a stub: frames are embeddings): non-causal self-attention with RoPE at
    positions 0..S-1 (flash with ``causal=False`` on the card unless
    ``plain``), the MLP, then the encoder's final norm. ``frame_lengths``
    (B,) blanks each sequence's frames at or past its length as keys (the
    plain route only). ``remat`` recomputes each layer in the backward
    (training; ZeRO-3 weights are gathered a layer at a time, as the
    decoder's). Returns the memory (B,S,d) in the compute dtype."""
    x = frames.to(cfg.cdtype)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    x = _run_stack(params, "enc_groups", encoder_groups(cfg), x, remat,
                   cfg=cfg, positions=positions, lengths=frame_lengths,
                   plain=plain)
    return L.rms_norm(params["enc_norm"], x, cfg.norm_eps)


def encoder_cross_kv(params, cfg: ModelConfig, memory: torch.Tensor):
    """Every decoder layer's cross-attention K/V of the encoder's
    ``memory`` (B,S_mem,d) — the non-resumable preamble of a chunked
    enc-dec prefill. Returns {(gi, pi): (k, v)}, each stacked (count, B,
    S_mem, KV, hd) as the cache rows are."""
    out = {}
    for gi, g in enumerate(block_groups(cfg)):
        if not g.cross:
            continue
        for pi, _kind in enumerate(g.kinds):
            cp = params["groups"][gi][pi]["cross"]
            ks, vs = zip(*(L.cross_attention_kv(layer_params(cp, li), cfg,
                                                memory)
                           for li in range(g.count)))
            out[(gi, pi)] = (torch.stack(ks), torch.stack(vs))
    return out


def seed_cross(caches, cross, mem: int):
    """Write ``encoder_cross_kv``'s rows into the first ``mem`` memory rows
    of every sequence of the dense ``caches``, in place, and set each
    sequence's memory length to ``mem``. Returns ``caches``."""
    for (gi, pi), (mk, mv) in cross.items():
        c = caches[gi][pi]
        _check_mem(c, mem)
        c.cross_k[:, :, :mem] = mk.to(c.cross_k.dtype)
        c.cross_v[:, :, :mem] = mv.to(c.cross_v.dtype)
        c.mem_len.fill_(mem)
    return caches


# --------------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------------- #
def prefill(params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor], caches):
    """Fill ``caches`` (capacity >= the sequence; recurrent states from
    zero) from a prompt, in place. inputs: tokens (B,S) and, for a vision
    model, optional patches (B,P,d): the sequence is the patches, then
    the tokens, at positions 0..P+S-1; for an enc-dec model, frames
    (B,S_mem,d): the encoder runs first, each decoder layer cross-attends
    to its memory (every row of it) and its cache keeps the memory's K/V
    rows and length. Returns (last_token_logits (B,V), caches)."""
    tokens = inputs["tokens"]
    x = merged_embeds(params, cfg, inputs.get("patches"), tokens)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    if cfg.is_enc_dec:
        memory = encode(params, cfg, inputs["frames"].to(tokens.device))
        mem = memory.shape[1]
    fill = L.mla_cache_from_prefill if _is_mla(cfg) else \
        L.kv_cache_from_prefill
    for gi, pi, li, kind, g, p in _layers(params, cfg):
        cache = caches[gi][pi].layer(li)
        if kind == SSD:
            x = _ssd(p, cfg, x, cache)
            continue
        if kind == RECURRENT:
            x = _recurrent(p, cfg, x, cache)
            continue
        h = L.rms_norm(p["norm1"], x, cfg.norm_eps)
        out, rows = attention_full(p["attn"], cfg, h, positions)
        fill(cache, *rows, positions)
        x = x + out
        if g.cross:
            _check_mem(cache, mem)
            mk, mv = L.cross_attention_kv(p["cross"], cfg, memory)
            x = _cross(p, cfg, x, (mk, mv), kv_len=mem)
            cache.cross_k[:, :mem] = mk.to(cache.cross_k.dtype)
            cache.cross_v[:, :mem] = mv.to(cache.cross_v.dtype)
            cache.mem_len.fill_(mem)
        x = _mlp_residual(p, cfg, g.moe, x)
    return lm_logits(params, cfg, x[:, -1]), caches


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, caches,
                q_offset: Optional[int] = None,
                mem_len: Optional[int] = None):
    """One decode step / incremental-prefill chunk over dense caches (and
    recurrent states carried from the previous chunk). tokens, positions:
    (B,T). ``q_offset`` (host int == positions[:, 0]) and, for an enc-dec
    model, ``mem_len`` (host int == the caches' ``mem_len``, which
    ``seed_cross`` set) let the CUDA route call the flash kernel without
    reading positions or memory lengths back from the card; MLA needs
    ``q_offset`` on both devices (``mla_decode``). Returns (logits
    (B,T,V), caches)."""
    return decode_step_embeds(params, cfg, embed_tokens(params, cfg, tokens),
                              positions, caches, q_offset=q_offset,
                              mem_len=mem_len)


def decode_step_embeds(params, cfg: ModelConfig, embeds: torch.Tensor,
                       positions: torch.Tensor, caches,
                       q_offset: Optional[int] = None,
                       mem_len: Optional[int] = None):
    """``decode_step`` over precomputed embeddings (B,T,d): the route of
    chunked prefill over a vision prompt, where each chunk is a slice of
    the merged patch + token sequence. An SSD layer takes the chunk scan
    for more than one position and the single-step recurrence for one,
    as the reference. An enc-dec decoder layer cross-attends to its
    cache's memory rows (seeded by ``seed_cross``): on the card through
    flash non-causal at ``kv_len`` = ``mem_len``. Returns
    (logits (B,T,V), caches)."""
    x = embeds.to(cfg.cdtype)
    win = _window(cfg)
    for gi, pi, li, kind, g, p in _layers(params, cfg):
        cache = caches[gi][pi].layer(li)
        if kind == SSD:
            x = _ssd(p, cfg, x, cache, step=x.shape[1] == 1)
            continue
        if kind == RECURRENT:
            x = _recurrent(p, cfg, x, cache)
            continue
        h = L.rms_norm(p["norm1"], x, cfg.norm_eps)
        if _is_mla(cfg):
            out, _ = L.mla_decode(p["attn"], cfg, h, positions, cache,
                                  q_offset=q_offset)
        else:
            out, _ = L.attention_decode(p["attn"], cfg, h, positions, cache,
                                        window=win, q_offset=q_offset)
        x = x + out
        if g.cross:
            if L.kernel_route(x) and mem_len is None:
                raise ValueError("the flash route of the cross-attention "
                                 "needs the host's mem_len")
            x = _cross(p, cfg, x, (cache.cross_k, cache.cross_v),
                       cache.mem_len, kv_len=mem_len)
        x = _mlp_residual(p, cfg, g.moe, x)
    return lm_logits(params, cfg, x), caches


def decode_step_paged(params, cfg: ModelConfig, tokens: torch.Tensor,
                      seq_lens: torch.Tensor, block_table: torch.Tensor,
                      write_blocks: torch.Tensor, write_slots: torch.Tensor,
                      caches, specs: Dict[str, PC.KVPageSpec],
                      max_len: Optional[int] = None):
    """One continuous-batching decode step against paged pools (appended
    in place) and per-slot recurrent or SSD states (stepped in place). An
    enc-dec decoder layer cross-attends to each slot's memory rows under
    its own length, in plain tensor ops as the reference (profiler span
    ``encdec.cross_decode``). tokens:
    (B,1); seq_lens: (B,) int32 lengths BEFORE this
    step (== rope position); block_table: (B, max_blocks) int32;
    write_blocks/slots: (B,). ``max_len`` (host int, the longest length
    after this step) lets MLA gather only the table's live columns.
    Returns (logits (B,1,V), caches)."""
    positions = seq_lens[:, None].to(torch.int32)
    x = embed_tokens(params, cfg, tokens)
    win = _window(cfg)
    for gi, pi, li, kind, g, p in _layers(params, cfg):
        if kind == SSD:
            x = _ssd(p, cfg, x, caches[gi][pi].layer(li), step=True)
            continue
        if kind == RECURRENT:
            x = _recurrent(p, cfg, x, caches[gi][pi].layer(li))
            continue
        pools = {name: pool[li] for name, pool in caches[gi][pi].items()}
        h = L.rms_norm(p["norm1"], x, cfg.norm_eps)
        if _is_mla(cfg):
            out, _ = L.mla_decode_paged(
                p["attn"], cfg, h, positions, pools, block_table, seq_lens,
                write_blocks, write_slots, specs["ckv"], specs["kpe"],
                max_len=max_len)
        else:
            out, _ = L.attention_decode_paged(
                p["attn"], cfg, h, positions, pools, block_table, seq_lens,
                write_blocks, write_slots, specs["kv"], window=win)
        x = x + out
        if g.cross:
            with torch.profiler.record_function("encdec.cross_decode"):
                x = _cross(p, cfg, x, (pools["cross_k"], pools["cross_v"]),
                           pools["mem_len"])
        x = _mlp_residual(p, cfg, g.moe, x)
    return lm_logits(params, cfg, x), caches


# --------------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------------- #
def _layer_full(p, x: torch.Tensor, *, cfg: ModelConfig, g: Group,
                kind: str, positions: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                memory: Optional[torch.Tensor] = None,
                mem_lengths: Optional[torch.Tensor] = None,
                plain: bool = True) -> torch.Tensor:
    """One layer over a whole sequence with no cache (the reference's
    ``_apply_layer_full`` with ``cache=None``; also the encoder's layer on
    the serving route, with ``plain=False``): a recurrent or SSD layer
    from zero states, whose final state is dropped; an attention layer
    with ``lengths``' mask (the encoder's: non-causal, no window); a
    decoder layer's cross-attention over ``memory`` under
    ``mem_lengths`` (plain ``sdpa``)."""
    b = x.shape[0]
    if kind == SSD:
        zero = L.ssm_state_init(b, cfg, x.dtype, x.device).layer(0)
        h, _ = L.ssd_block(p["ssd"], cfg,
                           L.rms_norm(p["norm"], x, cfg.norm_eps), zero)
        return x + h
    if kind == RECURRENT:             # at the rank's width on a model axis
        w = p["rglru"]["w_x"].shape[-1]
        zero = L.RGLRUState(
            h=torch.zeros((b, w), dtype=torch.float32, device=x.device),
            conv=x.new_zeros((b, cfg.recurrent.d_conv - 1, w)))
        h, _ = L.rglru_block(p["rglru"], cfg,
                             L.rms_norm(p["norm1"], x, cfg.norm_eps), zero)
        return _mlp_residual(p, cfg, False, x + h)
    h = L.rms_norm(p["norm1"], x, cfg.norm_eps)
    if _is_mla(cfg):
        out, _ = L.mla_block(p["attn"], cfg, h, positions, lengths=lengths,
                             plain=plain)
    else:
        out, _ = L.attention_block(p["attn"], cfg, h, positions,
                                   causal=g.causal, lengths=lengths,
                                   window=_window(cfg) if g.causal else 0,
                                   plain=plain)
    x = x + out
    if g.cross:
        x = _cross(p, cfg, x, L.cross_attention_kv(p["cross"], cfg, memory),
                   mem_lengths)
    return _mlp_residual(p, cfg, g.moe, x)


def _merge_frontend(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """(x (B,S,d), positions (B,S), lengths or None) of a training batch:
    a vision model's patches before the tokens (its lengths then count
    them); positions at or past a sequence's length are -1. Patches given
    to another model are ignored, as in the reference."""
    tokens = batch["tokens"]
    patches = batch.get("patches") if cfg.frontend.kind == "vision" else None
    x = merged_embeds(params, cfg, patches, tokens)
    lengths = batch.get("lengths")
    if lengths is not None and patches is not None:
        lengths = lengths + patches.shape[1]
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    if lengths is not None:
        positions = torch.where(positions < lengths[:, None], positions,
                                torch.full_like(positions, -1))
    return x, positions, lengths


def train_forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  remat: bool = True) -> torch.Tensor:
    """Teacher-forced logits (B,S,V) of a batch: tokens (B,S), optional
    lengths (B,), patches (B,P,d) for a vision model (S counts them),
    frames (B,F,d) and optional frame_lengths (B,) for an enc-dec model.
    Attention takes the plain route on every device; ``remat`` recomputes
    each layer's activations in the backward pass.

    With ZeRO-3 weights (the distribution context's ``zero3`` on a
    rank's mesh) the rank holds its data-axis share of every weight: the
    top-level ones are gathered once, and each layer's inside the layer's
    own (remat) function, so a layer's gathered weights live only while
    it runs — gathered again in the backward's recompute — and their
    gradients go back to the owning slices
    (``collectives.gather_weights``)."""
    dims = dist.ctx().zero3
    zero3 = dims and dist.ctx().data_shard()
    if zero3:
        params = _zero3_top(params, dims, zero3)
    memory = mem_lengths = None
    if cfg.is_enc_dec:
        mem_lengths = batch.get("frame_lengths")
        memory = encode(params, cfg, batch["frames"], mem_lengths,
                        plain=True, remat=remat)
    x, positions, lengths = _merge_frontend(params, cfg, batch)
    x = _run_stack(params, "groups", block_groups(cfg), x, remat, cfg=cfg,
                   positions=positions, lengths=lengths, memory=memory,
                   mem_lengths=mem_lengths)
    return lm_logits(params, cfg, x)


def _run_stack(params, key: str, groups: List[Group], x: torch.Tensor,
               remat: bool, **kw) -> torch.Tensor:
    """``x`` through every layer of the stacked groups ``params[key]``
    (``_layer_full`` with ``kw``), each under ``checkpoint`` with
    ``remat``; under a ZeRO-3 context each layer's weights gathered
    inside the layer's own function (``_zero3_layer``)."""
    dims = dist.ctx().zero3
    zero3 = dims and dist.ctx().data_shard()
    for gi, g in enumerate(groups):
        per_pos = [unbind_layers(t) for t in params[key][gi]]
        for li in range(g.count):
            for pi, kind in enumerate(g.kinds):
                layer = functools.partial(_layer_full, g=g, kind=kind, **kw)
                # the rank's layer li, or (ZeRO-3 on the layer axis) the
                # layer at li's slot of its own block
                ways = g.count // len(per_pos[pi])
                p = per_pos[pi][dist.layer_block(li, g.count, ways)[1]]
                if zero3:
                    layer = functools.partial(
                        _zero3_layer, layer, prefix=f"[{key!r}][{gi}][{pi}]",
                        li=li, count=g.count, dims=dims, shard=zero3)
                if remat:
                    x = checkpoint(layer, p, x, use_reentrant=False)
                else:
                    x = layer(p, x)
    return x


def _zero3_top(params, dims: Dict[str, Optional[int]], shard):
    """``params`` with each top-level leaf that the data plane ``shard``
    splits (``dims``) gathered whole (the rank's model shard of it)."""
    out = dict(params)
    for k, t in params.items():
        d = dims.get(f"[{k!r}]")
        if isinstance(t, torch.Tensor) and d is not None:
            out[k] = C.gather_weights(t, d, 0, shard)
    return out


def _zero3_layer(layer, p, x, *, prefix: str, li: int, count: int,
                 dims: Dict[str, Optional[int]], shard):
    """``layer(p, x)`` with the layer's weights gathered whole over the
    data plane ``shard`` first: a leaf split on the layer axis (dim 0 of
    the stacked leaf) lies whole on the data rank that holds layer ``li``
    (``p`` is the rank's layer at the same place: ``li``'s own on that
    rank, an anchor elsewhere); a leaf split on dim k > 0 is gathered on
    the layer's dim k - 1 (a group whose ``count`` the data plane does
    not divide, such as a single dense first layer, is split so)."""

    def whole(t, path):
        if isinstance(t, dict):
            return {k: whole(v, f"{path}[{k!r}]") for k, v in t.items()}
        d = dims.get(path)
        if d is None:
            return t
        if d == 0:
            owner = dist.layer_block(li, count, shard.size)[0]
            return C.gather_weights(t, None, owner, shard)
        return C.gather_weights(t, d - 1, 0, shard)

    return layer(whole(p, prefix), x)


# float32 log-softmax elements that a chunk of ``_nll_sum``'s rows holds
LOSS_CHUNK_ELEMS = 1 << 26


def _nll_sum(logits: torch.Tensor, lab: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """The sum over the positions in ``mask`` of -log_softmax(float32
    logits) at each label, in chunks of rows of at most
    ``LOSS_CHUNK_ELEMS`` elements (small logits: one chunk), each under
    ``checkpoint``: its float32 log-softmax is made again in the
    backward, so a step holds one chunk's float32 rows rather than the
    whole batch's (at a vocabulary of 256,000, 3.9 GiB a sequence of
    4,096 tokens); the chunks' sums add in row order."""
    def part(z, y, m):
        lp = torch.log_softmax(z.float(), dim=-1)
        return torch.sum(-torch.gather(lp, -1, y[..., None])[..., 0] * m)

    v = logits.shape[-1]
    z, y, m = logits.reshape(-1, v), lab.reshape(-1), mask.reshape(-1)
    rows = max(1, LOSS_CHUNK_ELEMS // v)
    total = 0
    for i in range(0, z.shape[0], rows):
        total = total + checkpoint(part, z[i:i + rows], y[i:i + rows],
                                   m[i:i + rows], use_reentrant=False)
    return total


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy (float32 ``log_softmax``) over the
    positions whose label is >= 0; a vision model's patch positions take
    label -1.

    On a rank's mesh: vocab-sharded logits are gathered whole first (the
    reference's arithmetic over the whole row; the gather's backward is
    the rank's slice), and over the data axes the mean is the whole
    batch's — the numerator and the count each summed over the data
    plane, then divided — so every rank's loss is the global one (a
    rank's own mean, averaged, differs whenever the shards hold different
    counts of labels >= 0)."""
    logits = train_forward(params, cfg, batch, remat=remat)
    dctx = dist.ctx()
    if logits.shape[-1] != cfg.vocab_size:
        logits = C.all_gather(logits, logits.dim() - 1, dctx.model_shard(),
                              grad="replicated")
    labels = batch["labels"]
    if cfg.frontend.kind == "vision" and "patches" in batch:
        n = batch["patches"].shape[1]
        labels = torch.cat([labels.new_full((labels.shape[0], n), -1),
                            labels], dim=1)
    mask = labels >= 0
    lab = torch.where(mask, labels, torch.zeros_like(labels)).long()
    total, count = _nll_sum(logits, lab, mask), torch.sum(mask)
    dp = dctx.data_shard()
    if dp is not None:
        total = C.psum(total, dp)
        with torch.no_grad():
            count = C.psum(count, dp)
    return total / torch.clamp_min(count, 1)

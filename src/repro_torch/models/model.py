"""Config-driven model assembly — PyTorch port of ``repro.models.model``
for the dense family.

A model is a list of *block groups* whose parameters are stacked along a
leading ``count`` axis, exactly as in the JAX package (so
``convert.params_from_numpy`` carries JAX parameters across unchanged).
Where the JAX code scans over the stacked axis with the caches in the
carry, the port loops over layer slices of the stacked tensors and
updates each layer's cache slice in place.

Entry points:
  prefill(params, cfg, inputs, caches)                  -> (last_logits, caches)
  decode_step(params, cfg, tokens, positions, caches)   -> (logits, caches)
  decode_step_paged(params, cfg, tokens, seq_lens, ...) -> (logits, caches)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import device as _dev
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models import layers as L
from repro_torch.serving import paged_cache as PC

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Group:
    kinds: Tuple[str, ...]
    count: int


def block_groups(cfg: ModelConfig) -> List[Group]:
    _dev.check_family(cfg)
    return [Group((ATTN,), cfg.num_layers)]


def layer_params(stacked: Any, i: int) -> Any:
    """Layer ``i`` of a stacked parameter tree (views, no copy)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
def _init_layer(gen: torch.Generator, cfg: ModelConfig,
                device: torch.device) -> Params:
    d = cfg.d_model
    return {"norm1": torch.ones((d,), dtype=cfg.pdtype, device=device),
            "norm2": torch.ones((d,), dtype=cfg.pdtype, device=device),
            "attn": L.init_attention(gen, cfg, device),
            "mlp": L.init_mlp(gen, cfg, device)}


def _init_group(gen: torch.Generator, cfg: ModelConfig, count: int,
                device: torch.device) -> Params:
    """``count`` layers drawn one after the other, each written into its
    slot of the stacked tensors as it is made: the values of stacking
    every layer at the end, at the memory of the stack plus one layer."""
    def put(dst, src, i):
        if isinstance(src, dict):
            for k in src:
                put(dst[k], src[k], i)
        else:
            dst[i] = src

    def empty(t):
        if isinstance(t, dict):
            return {k: empty(v) for k, v in t.items()}
        return t.new_empty((count,) + tuple(t.shape))

    layer = _init_layer(gen, cfg, device)
    stacked = empty(layer)
    put(stacked, layer, 0)
    for i in range(1, count):
        put(stacked, _init_layer(gen, cfg, device), i)
    return stacked


def init_params(cfg: ModelConfig, seed: int = 0,
                device: _dev.DeviceLike = None) -> Params:
    """Random parameters with the JAX package's shapes and scales, drawn
    from a ``torch.Generator`` seeded with ``seed`` on the target device
    (the card unless ``device="cpu"``)."""
    dev = _dev.resolve(device)
    groups = block_groups(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    p: Params = {
        "embed": (torch.randn((v, d), generator=gen, device=dev) * 0.02
                  ).to(cfg.pdtype),
        "final_norm": torch.ones((d,), dtype=cfg.pdtype, device=dev),
        "groups": tuple(
            (_init_group(gen, cfg, g.count, dev),)
            for g in groups),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = (torch.randn((d, v), generator=gen, device=dev)
                        / math.sqrt(d)).to(cfg.pdtype)
    return p


# --------------------------------------------------------------------------- #
# Caches
# --------------------------------------------------------------------------- #
def init_caches(cfg: ModelConfig, batch: int, capacity: int, dtype=None,
                full_capacity: bool = False,
                device: _dev.DeviceLike = None):
    """Dense position-tagged caches, one group-stacked ``KVCache`` per
    group position (leaves are (count, B, cap, ...))."""
    dev = _dev.resolve(device)
    dtype = dtype or cfg.cdtype
    return tuple(
        tuple(L.kv_cache_init(batch, capacity, cfg.num_kv_heads, cfg.hd,
                              dtype, dev, count=g.count,
                              full_capacity=full_capacity)
              for _kind in g.kinds)
        for g in block_groups(cfg))


def init_paged_caches(cfg: ModelConfig, specs: Dict[str, PC.KVPageSpec],
                      num_blocks: int, device: _dev.DeviceLike = None):
    """Paged pools {"k_pool", "v_pool"} of (count, N, *page) per group
    position."""
    dev = _dev.resolve(device)
    spec = specs["kv"]
    shape = spec.pool_shape(num_blocks)
    return tuple(
        tuple({"k_pool": torch.zeros((g.count,) + shape, dtype=spec.tdtype,
                                     device=dev),
               "v_pool": torch.zeros((g.count,) + shape, dtype=spec.tdtype,
                                     device=dev)}
              for _kind in g.kinds)
        for g in block_groups(cfg))


# --------------------------------------------------------------------------- #
# Embedding / head
# --------------------------------------------------------------------------- #
def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    e = params["embed"][tokens.long()].to(cfg.cdtype)
    if cfg.tie_embeddings:
        return e * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype)
    return e


def lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return x @ head.to(x.dtype)


# --------------------------------------------------------------------------- #
# Layer application
# --------------------------------------------------------------------------- #
def _mlp_residual(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x + L.swiglu_mlp(p["mlp"], L.rms_norm(p["norm2"], x, cfg.norm_eps))


def _layers(params, cfg: ModelConfig):
    """(group index, position, layer index, layer params) in model order."""
    for gi, g in enumerate(block_groups(cfg)):
        for pi, _kind in enumerate(g.kinds):
            stacked = params["groups"][gi][pi]
            for li in range(g.count):
                yield gi, pi, li, layer_params(stacked, li)


# --------------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------------- #
def prefill(params, cfg: ModelConfig, inputs: Dict[str, torch.Tensor], caches):
    """Fill ``caches`` (capacity >= prompt) from a prompt, in place.
    inputs: tokens (B,S). Returns (last_token_logits (B,V), caches)."""
    tokens = inputs["tokens"]
    b, s = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    for gi, pi, li, p in _layers(params, cfg):
        h = L.rms_norm(p["norm1"], x, cfg.norm_eps)
        out, (k, v) = L.attention_block(p["attn"], cfg, h, positions)
        L.kv_cache_from_prefill(caches[gi][pi].layer(li), k, v, positions)
        x = _mlp_residual(p, cfg, x + out)
    return lm_logits(params, cfg, x[:, -1]), caches


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, caches,
                q_offset: Optional[int] = None):
    """One decode step / incremental-prefill chunk over dense caches.
    tokens, positions: (B,T). ``q_offset`` (host int == positions[:, 0])
    lets the CUDA route call the flash kernel without reading positions
    back from the card. Returns (logits (B,T,V), caches)."""
    x = embed_tokens(params, cfg, tokens)
    for gi, pi, li, p in _layers(params, cfg):
        h = L.rms_norm(p["norm1"], x, cfg.norm_eps)
        out, _ = L.attention_decode(p["attn"], cfg, h, positions,
                                    caches[gi][pi].layer(li),
                                    q_offset=q_offset)
        x = _mlp_residual(p, cfg, x + out)
    return lm_logits(params, cfg, x), caches


def decode_step_paged(params, cfg: ModelConfig, tokens: torch.Tensor,
                      seq_lens: torch.Tensor, block_table: torch.Tensor,
                      write_blocks: torch.Tensor, write_slots: torch.Tensor,
                      caches, specs: Dict[str, PC.KVPageSpec]):
    """One continuous-batching decode step against paged pools (appended
    in place). tokens: (B,1); seq_lens: (B,) int32 lengths BEFORE this
    step (== rope position); block_table: (B, max_blocks) int32;
    write_blocks/slots: (B,). Returns (logits (B,1,V), caches)."""
    positions = seq_lens[:, None].to(torch.int32)
    x = embed_tokens(params, cfg, tokens)
    for gi, pi, li, p in _layers(params, cfg):
        pools = caches[gi][pi]
        h = L.rms_norm(p["norm1"], x, cfg.norm_eps)
        out, _ = L.attention_decode_paged(
            p["attn"], cfg, h, positions,
            {"k_pool": pools["k_pool"][li], "v_pool": pools["v_pool"][li]},
            block_table, seq_lens, write_blocks, write_slots, specs["kv"])
        x = _mlp_residual(p, cfg, x + out)
    return lm_logits(params, cfg, x), caches

"""Model configuration system (PyTorch port).

One frozen dataclass covers every assigned architecture family:
dense / MoE / MLA / enc-dec (audio) / hybrid (RG-LRU) / VLM / SSM.
Configs are pure data — the model builder in ``repro_torch.models.model``
interprets them. Field for field the same as the JAX package's configs;
only ``pdtype`` / ``cdtype`` resolve to ``torch`` dtypes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name ("bfloat16", "float32", ...) → ``torch.dtype``."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


# Layer-kind tags used in block patterns.
ATTN = "attn"
RECURRENT = "rglru"
SSD = "ssd"


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts
    num_shared_experts: int = 0     # always-on experts (DeepSeek style)
    top_k: int = 0
    d_ff_expert: int = 0            # per-expert hidden dim
    first_dense_layers: int = 0     # leading layers that use the dense MLP
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk_size: int = 256
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RecurrentConfig:
    """RG-LRU recurrent block (Griffin / RecurrentGemma)."""
    lru_width: int = 0              # defaults to d_model if 0
    d_conv: int = 4
    block_pattern: Tuple[str, ...] = (RECURRENT, RECURRENT, ATTN)
    local_window: int = 2048


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: input_specs() provides precomputed embeddings."""
    kind: str = "none"              # "audio" | "vision" | "none"
    # audio: conv stem downsampling factor (Whisper: 2 after two conv1d)
    downsample: int = 2
    # vision: number of image patch embeddings prepended to the text sequence
    num_patches: int = 256


@dataclass(frozen=True)
class PrefillCapabilities:
    """What the prefill path can do for one model family — the prefill
    analogue of the connector ``capabilities()`` descriptor: a frozen
    dataclass that the engine, scheduler, router, and planner *consume*
    (no ``cfg.attention_kind`` string checks outside this module).

      incremental      chunk-at-a-time prefill compute (every family —
                       attention chunks against a position-tagged cache,
                       recurrent/SSM layers carry state across chunks,
                       enc-dec/vision run a preamble then chunk tokens)
      resumable        a mid-stream snapshot (layer states + window KV
                       tail) restarts compute at the crash point instead
                       of from token 0
      prefix_cache     shared-prefix KV replay/skip is *safe*: every
                       cached row is still attendable by later tokens
                       (false for ring-buffer caches, which only retain
                       the last window of whatever prompt built them)
      encoder_preamble a non-resumable encoder/vision pass must run on P
                       before token chunking starts
      kv_on_wire       per-token KV ships P→D (false for pure-SSM
                       stacks, whose handoff is states only)
      latent_kv        KV is the MLA compressed latent (ckv+kpe), which
                       changes wire bytes/token and pool layout
      window           sliding-window size (0 = full attention)
    """
    family: str
    incremental: bool
    resumable: bool
    prefix_cache: bool
    encoder_preamble: bool
    kv_on_wire: bool
    latent_kv: bool
    window: int = 0


@dataclass(frozen=True)
class ConnectorConfig:
    """Deployment-side selection of the P→D KV-transport backend.

    Pure data, like every config here: ``kind`` names a backend in the
    ``repro_torch.core.transport`` registry, and ``build()`` instantiates it
    (fields a backend does not accept are dropped by the factory, so one
    config can describe any backend)."""
    kind: str = "inproc"            # inproc | shm | rdma (registry name)
    bandwidth_gbps: float = 25.0
    fixed_latency_s: float = 5e-6   # per-read setup cost (modeled backends)
    max_inflight: int = 32          # concurrent issued-but-unread reads
    buffer_capacity_bytes: int = 1 << 32
    tick_seconds: float = 1e-4      # rdma: wire progress per scheduler tick
    chunk_bytes: int = 256 << 10    # rdma: preferred wire granularity

    def build(self):
        """Instantiate the configured KV connector."""
        from repro_torch.core.transport import make_connector
        return make_connector(self.kind,
                              bandwidth_gbps=self.bandwidth_gbps,
                              fixed_latency_s=self.fixed_latency_s,
                              max_inflight=self.max_inflight,
                              buffer_capacity_bytes=self.buffer_capacity_bytes,
                              tick_seconds=self.tick_seconds,
                              chunk_bytes=self.chunk_bytes)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | audio | hybrid | vlm | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // num_heads
    # -- attention flavour ------------------------------------------------
    attention_kind: str = "full"    # full | sliding | mla | none
    sliding_window: int = 0         # >0 with attention_kind=="sliding"
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # -- optional sub-configs ---------------------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    # -- enc-dec ----------------------------------------------------------
    encoder_layers: int = 0         # >0 → encoder-decoder (num_layers = decoder)
    max_source_len: int = 1500      # encoder positions (Whisper: 1500 frames)
    # -- numerics ---------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # -- citation / provenance --------------------------------------------
    source: str = ""

    # ------------------------------------------------------------------ #
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.moe is not None and self.moe.num_experts > 0

    def prefill_capabilities(self) -> PrefillCapabilities:
        """Derive the per-family prefill capability descriptor. This is
        the single place family structure maps to prefill behaviour —
        everything downstream consumes the dataclass."""
        kinds = set(self.layer_kinds())
        preamble = self.is_enc_dec or self.frontend.kind in ("vision",
                                                             "audio")
        window = self.sliding_window if self.attention_kind == "sliding" \
            else 0
        has_state = (RECURRENT in kinds) or (SSD in kinds)
        return PrefillCapabilities(
            family=self.family,
            incremental=True,
            # snapshot resume needs bounded carried state: layer states
            # and/or a window KV tail. Full-attention KV grows with the
            # prompt (those families resume via the prefix cache), and a
            # preamble (encoder memory) is not snapshot-restorable.
            resumable=(has_state or window > 0) and not preamble,
            prefix_cache=(self.family in ("dense", "moe")
                          and self.attention_kind in ("full", "mla")
                          and not preamble),
            encoder_preamble=preamble,
            kv_on_wire=ATTN in kinds,
            latent_kv=self.attention_kind == "mla",
            window=window)

    @property
    def supports_chunked_prefill(self) -> bool:
        """Incremental (chunk-at-a-time) prefill compute — now supported
        for every family (see ``prefill_capabilities``): attention-only
        stacks chunk against a dense position-tagged cache, sliding
        windows chunk with window-aware masking, recurrent/SSM layers
        carry state across chunks, and enc-dec/multimodal families run
        their encoder preamble once then chunk the token sequence."""
        return self.prefill_capabilities().incremental

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-decoder-layer block kind, length == num_layers."""
        if self.family == "ssm":
            return (SSD,) * self.num_layers
        if self.recurrent is not None:
            pat = self.recurrent.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.num_layers))
        return (ATTN,) * self.num_layers

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (used by planner + roofline) ------------------ #
    def param_count(self) -> int:
        """Exact-ish analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        n = v * d                       # token embedding
        if not self.tie_embeddings:
            n += v * d                  # lm head
        n += d                          # final norm
        kinds = self.layer_kinds()
        for k in kinds:
            n += self._block_params(k)
        if self.is_enc_dec:
            # encoder self-attn blocks + cross-attn in decoder
            n += self.encoder_layers * self._block_params(ATTN)
            n += self.num_layers * self._attn_params()      # cross-attn
            n += self.num_layers * self.d_model              # extra norm
        return n

    def _attn_params(self) -> int:
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.hd
        if self.attention_kind == "mla":
            m = self.mla
            qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            n = d * h * qk_hd                               # q proj (no q-lora in V2-Lite)
            n += d * (m.kv_lora_rank + m.qk_rope_head_dim)  # kv down-proj
            n += m.kv_lora_rank                             # kv-a norm
            n += m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)  # kv up
            n += h * m.v_head_dim * d                       # o proj
            return n
        n = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.qkv_bias:
            n += h * hd + 2 * kv * hd
        return n

    def _mlp_params(self, layer_idx_is_moe: bool) -> int:
        d = self.d_model
        if layer_idx_is_moe and self.is_moe:
            e = self.moe
            per = 3 * d * e.d_ff_expert
            n = (e.num_experts + e.num_shared_experts) * per
            n += d * e.num_experts                          # router
            return n
        return 3 * d * self.d_ff                            # SwiGLU

    def _block_params(self, kind: str) -> int:
        d = self.d_model
        if kind == SSD:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            g = s.n_groups
            n = d * (2 * di + 2 * g * s.d_state + nh)       # in_proj (x,z,B,C,dt)
            n += s.d_conv * (di + 2 * g * s.d_state)        # conv
            n += nh * 3                                     # A, D, dt_bias
            n += di                                         # out norm
            n += di * d                                     # out proj
            return n + d                                    # block norm
        if kind == RECURRENT:
            r = self.recurrent
            w = r.lru_width or d
            n = 2 * d * w                                   # x/gate proj
            n += r.d_conv * w                               # conv
            n += 3 * w                                      # lru a, input gate params (approx)
            n += w * d                                      # out proj
            return n + 2 * d + self._mlp_params(False) + d
        # attention block
        n = self._attn_params() + 2 * d
        moe_layer = self.is_moe
        n += self._mlp_params(moe_layer)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        e = self.moe
        full = self.param_count()
        moe_layers = self.num_layers - e.first_dense_layers
        per_expert = 3 * self.d_model * e.d_ff_expert
        inactive = moe_layers * (e.num_experts - e.top_k) * per_expert
        return full - inactive


_SUBCONFIGS = {"moe": MoEConfig, "mla": MLAConfig, "ssm": SSMConfig,
               "recurrent": RecurrentConfig, "frontend": FrontendConfig}


def config_from_dict(d: dict) -> ModelConfig:
    """Inverse of ``dataclasses.asdict`` for a ModelConfig (sub-configs
    included): how a config arrives from JSON or from another package."""
    kw = dict(d)
    for name, cls in _SUBCONFIGS.items():
        if isinstance(kw.get(name), dict):
            sub = dict(kw[name])
            if "block_pattern" in sub:
                sub["block_pattern"] = tuple(sub["block_pattern"])
            kw[name] = cls(**sub)
    return ModelConfig(**kw)


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # Import side-effect registration of all shipped configs.
    from repro_torch import configs as _c  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    from repro_torch import configs as _c  # noqa: F401
    return sorted(_REGISTRY)

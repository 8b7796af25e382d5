"""Layered inference-system simulator (paper §III-D, Fig. 5) — port of
``repro.core.planner.simulator``.

Layers, bottom-up, exactly as the paper draws them:

  1. *theoretical model*   — per-layer operator list from the transformer
     structure (FLOPs, weight bytes, activation bytes, KV bytes), no
     hardware or framework effects. `layer_ops`.
  2. *hardware features*   — data alignment (head padding under TP),
     VRAM management (page rounding), dtype widths. `align_ops`.
  3. *framework features*  — prefix-cache hit ratio, chunked prefill,
     scheduling overhead per step. `FrameworkModel`.
  4. *operator libraries*  — computing operator library (roofline op time
     with launch overhead) and communication operator library (ring
     all-reduce / all-gather / p2p). `op_time`, `comm`.
  5. *latency & VRAM model* — l_p (TTFT), l_d (TPOT), m_p, m_d feeding the
     joint optimizer. `InstanceModel`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from repro_torch.configs.base import ATTN, RECURRENT, SSD, ModelConfig
from repro_torch.core.planner.hardware import HardwareSpec


# --------------------------------------------------------------------------- #
# Parallel strategy
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ParallelStrategy:
    dp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1         # expert parallel (must divide tp; folded into tp ranks)

    @property
    def gpus(self) -> int:
        return self.dp * self.tp * self.pp

    def label(self) -> str:
        return f"dp{self.dp}tp{self.tp}pp{self.pp}ep{self.ep}"


# --------------------------------------------------------------------------- #
# Layer 1: theoretical operator list
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class Op:
    name: str
    flops: float = 0.0
    weight_bytes: float = 0.0    # parameters streamed from VRAM
    act_bytes: float = 0.0       # activation/KV traffic from/to VRAM
    kind: str = "gemm"           # gemm | attn | mem | elementwise


def _dtype_bytes(cfg: ModelConfig) -> int:
    return 2 if "16" in cfg.param_dtype else 4


def layer_ops(cfg: ModelConfig, kind: str, mode: str, tokens: int,
              kv_len: int, moe_layer: bool, wbytes: int) -> List[Op]:
    """Theoretical per-layer ops. ``tokens``: S (prefill) or B (decode);
    ``kv_len``: attention context length."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, max(cfg.num_kv_heads, 1), cfg.hd
    t = tokens
    ops: List[Op] = []
    if kind == SSD:
        s = cfg.ssm
        di, nh, g = s.d_inner(d), s.n_heads(d), s.n_groups
        e_in = d * (2 * di + 2 * g * s.d_state + nh)
        ops.append(Op("ssd_in", 2 * t * e_in, e_in * wbytes, t * d * wbytes))
        q = min(s.chunk_size, max(t, 1))
        scan_flops = 2 * t * nh * s.head_dim * s.d_state * 2 + \
            (2 * t * q * nh * (s.d_state + s.head_dim) if mode == "prefill" else 0)
        state_bytes = nh * s.head_dim * s.d_state * 4
        ops.append(Op("ssd_scan", scan_flops, 0.0,
                      (t * di + state_bytes) * wbytes, kind="attn"))
        ops.append(Op("ssd_out", 2 * t * di * d, di * d * wbytes,
                      t * di * wbytes))
        return ops
    if kind == RECURRENT:
        r = cfg.recurrent
        w = r.lru_width or d
        e_in = 2 * d * w
        ops.append(Op("lru_in", 2 * t * e_in, e_in * wbytes, t * d * wbytes))
        ops.append(Op("lru_gates", 2 * t * w * w * 2, 2 * w * w * wbytes,
                      t * w * wbytes))
        ops.append(Op("lru_scan", 8 * t * w, 0.0, (t * w + w) * wbytes,
                      kind="mem"))
        ops.append(Op("lru_out", 2 * t * w * d, w * d * wbytes, t * w * wbytes))
        ops.append(Op("mlp", 3 * 2 * t * d * cfg.d_ff, 3 * d * cfg.d_ff * wbytes,
                      t * (d + cfg.d_ff) * wbytes))
        return ops
    # attention layer
    if cfg.attention_kind == "mla":
        m = cfg.mla
        qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
        e_q = d * h * qk_hd
        e_dkv = d * (m.kv_lora_rank + m.qk_rope_head_dim)
        e_ukv = m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
        e_o = h * m.v_head_dim * d
        ops.append(Op("mla_proj", 2 * t * (e_q + e_dkv + e_o),
                      (e_q + e_dkv + e_o) * wbytes, t * d * wbytes))
        if mode == "prefill":
            ops.append(Op("mla_up", 2 * t * e_ukv, e_ukv * wbytes,
                          t * m.kv_lora_rank * wbytes))
            attn_flops = 2 * t * kv_len * h * (qk_hd + m.v_head_dim)
            kv_bytes = kv_len * (m.kv_lora_rank + m.qk_rope_head_dim) * h and \
                t * h * (qk_hd + m.v_head_dim) * wbytes
            ops.append(Op("attn", attn_flops, 0.0, kv_bytes, kind="attn"))
        else:
            # absorbed decode: latent-space attention
            absorb = 2 * t * h * m.qk_nope_head_dim * m.kv_lora_rank * 2
            attn_flops = 2 * t * kv_len * h * \
                (m.kv_lora_rank + m.qk_rope_head_dim + m.kv_lora_rank)
            kv_bytes = t * kv_len * (m.kv_lora_rank + m.qk_rope_head_dim) * wbytes
            ops.append(Op("mla_absorb", absorb, e_ukv * wbytes, 0.0))
            ops.append(Op("attn", attn_flops, 0.0, kv_bytes, kind="attn"))
    else:
        e_qkv = d * (h + 2 * kv) * hd
        e_o = h * hd * d
        ops.append(Op("qkv_o", 2 * t * (e_qkv + e_o),
                      (e_qkv + e_o) * wbytes, t * d * wbytes))
        ctx = kv_len
        if cfg.attention_kind == "sliding" and cfg.sliding_window:
            ctx = min(kv_len, cfg.sliding_window)
        attn_flops = 2 * t * ctx * h * hd * 2
        kv_bytes = t * ctx * 2 * kv * hd * wbytes if mode == "decode" else \
            t * h * hd * wbytes
        ops.append(Op("attn", attn_flops, 0.0, kv_bytes, kind="attn"))
    # FFN
    if moe_layer and cfg.is_moe:
        e = cfg.moe
        ops.append(Op("router", 2 * t * d * e.num_experts,
                      d * e.num_experts * 4, t * d * wbytes))
        act_w = 3 * d * e.d_ff_expert * (e.top_k + e.num_shared_experts)
        touched = min(e.num_experts, max(t * e.top_k, 1) if mode == "decode"
                      else e.num_experts)
        stream_w = 3 * d * e.d_ff_expert * (touched + e.num_shared_experts)
        ops.append(Op("moe_mlp", 2 * t * act_w, stream_w * wbytes,
                      t * (d + e.d_ff_expert) * wbytes))
    elif cfg.d_ff:
        ops.append(Op("mlp", 3 * 2 * t * d * cfg.d_ff,
                      3 * d * cfg.d_ff * wbytes, t * (d + cfg.d_ff) * wbytes))
    return ops


def embedding_ops(cfg: ModelConfig, tokens: int, wbytes: int) -> List[Op]:
    return [Op("lm_head", 2 * tokens * cfg.d_model * cfg.vocab_size,
               cfg.d_model * cfg.vocab_size * wbytes,
               tokens * cfg.vocab_size * wbytes)]


# --------------------------------------------------------------------------- #
# Layer 2: hardware feature alignment
# --------------------------------------------------------------------------- #
def align_ops(cfg: ModelConfig, ops: List[Op], strat: ParallelStrategy
              ) -> List[Op]:
    """Shard each op across TP, with data-alignment padding: a head count
    that does not divide tp is padded up (the GSPMD behaviour, and the
    vendor alignment issue the paper's compat module covers)."""
    tp = strat.tp
    out = []
    pad = 1.0
    if cfg.num_heads % tp:
        pad = (math.ceil(cfg.num_heads / tp) * tp) / cfg.num_heads
    for op in ops:
        f = op.flops / tp
        w = op.weight_bytes / tp
        a = op.act_bytes / tp if op.kind == "attn" else op.act_bytes
        if op.kind in ("gemm", "attn"):
            f *= pad
            w *= pad if op.name.startswith(("qkv", "attn", "mla")) else 1.0
        out.append(Op(op.name, f, w, a, op.kind))
    return out


def page_rounded_kv_bytes(cfg: ModelConfig, seq_len: int, block_size: int,
                          wbytes: int) -> float:
    """VRAM management layer: paged allocation rounds up to block_size."""
    blocks = math.ceil(max(seq_len, 1) / block_size)
    alloc = blocks * block_size
    caps = cfg.prefill_capabilities()
    if caps.latent_kv:
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    elif not caps.kv_on_wire:
        s = cfg.ssm
        return s.n_heads(cfg.d_model) * s.head_dim * s.d_state * 4 * cfg.num_layers
    else:
        per_tok = 2 * max(cfg.num_kv_heads, 1) * cfg.hd
        if cfg.attention_kind == "sliding" and cfg.sliding_window:
            alloc = min(alloc, math.ceil(cfg.sliding_window / block_size)
                        * block_size)
    n_attn = sum(1 for k in cfg.layer_kinds() if k == ATTN)
    n_other = cfg.num_layers - n_attn
    state = 0.0
    if cfg.recurrent is not None:
        w = cfg.recurrent.lru_width or cfg.d_model
        state = n_other * w * 4
    return n_attn * alloc * per_tok * wbytes + state


# --------------------------------------------------------------------------- #
# Layer 3: framework features
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class FrameworkModel:
    prefix_cache_hit: float = 0.0     # fraction of prompt FLOPs skipped
    sched_overhead_s: float = 3e-4    # per engine step (batching, host)
    kernel_launch_s: float = 6e-6     # per fused op
    chunked_prefill: bool = False     # stream KV chunk-wise during prefill
    prefill_chunk_tokens: int = 512   # chunk size when chunked_prefill
    weight_dtype_bytes: int = 2

    def __post_init__(self):
        # an out-of-range fraction silently yields a nonsense effective
        # sequence length (s_eff) in prefill_latency; 1.0 would claim the
        # whole prompt is cached — prefill always computes ≥ 1 token
        if not 0.0 <= self.prefix_cache_hit < 1.0:
            raise ValueError(
                "FrameworkModel.prefix_cache_hit must be in [0.0, 1.0): "
                f"got {self.prefix_cache_hit!r} (it is the fraction of "
                "prompt tokens served from the prefix cache; at least the "
                "final token is always computed)")

    def handoff_exposed_seconds(self, prefill_s: float, transfer_s: float,
                                input_len: int) -> float:
        """P→D wire time left on the critical path after the prefill.

        Monolithic transmission exposes the whole transfer. With chunked
        streaming (the serving stack's StreamedHandoff), chunk i's wire
        time hides under chunk i+1's compute: only the last chunk's
        transfer — or, when the wire is the bottleneck, the un-hidden
        residue of the pipelined stream — remains exposed."""
        if not self.chunked_prefill or transfer_s <= 0 or prefill_s <= 0:
            return transfer_s
        n = max(1, math.ceil(input_len / max(self.prefill_chunk_tokens, 1)))
        per_chunk_xfer = transfer_s / n
        per_chunk_comp = prefill_s / n
        return max(per_chunk_xfer,
                   per_chunk_comp + transfer_s - prefill_s)


# --------------------------------------------------------------------------- #
# Layer 4: operator libraries
# --------------------------------------------------------------------------- #
def op_time(op: Op, hw: HardwareSpec, fw: FrameworkModel) -> float:
    bytes_total = op.weight_bytes + op.act_bytes
    t_compute = op.flops / hw.eff_flops
    t_memory = bytes_total / hw.eff_hbm
    return max(t_compute, t_memory) + fw.kernel_launch_s


def allreduce_time(nbytes: float, tp: int, hw: HardwareSpec) -> float:
    if tp <= 1 or nbytes <= 0:
        return 0.0
    wire = 2.0 * (tp - 1) / tp * nbytes
    return wire / hw.eff_link + 2e-6 * math.log2(tp)


def p2p_time(nbytes: float, hw: HardwareSpec) -> float:
    return nbytes / hw.eff_link + 2e-6


def connector_wire_time(nbytes: float, caps, *, concurrent: int = 1) -> float:
    """P→D wire entry of the communication operator library, sourced from a
    KV connector's ``capabilities()`` (fixed latency + bytes/bandwidth)
    instead of a hard-coded bandwidth constant. ``caps`` is any object with
    the :class:`repro_torch.core.transport.base.ConnectorCapabilities`
    shape.

    The connector-declared fixed per-chunk codec overhead
    (``header_bytes``) rides on the payload. ``concurrent`` models the
    declared link arbitration for simultaneous flights: a fair-share link
    divides bandwidth (each flight sees ``bw / n``, one setup latency); an
    exclusive link serializes (the last read waits out the others)."""
    if nbytes <= 0:
        return 0.0
    wire_bytes = nbytes + getattr(caps, "header_bytes", 0)
    xfer = wire_bytes / (caps.bandwidth_gbps * 1e9)
    if concurrent > 1:
        if getattr(caps, "link_sharing", "exclusive") == "fair":
            return caps.fixed_latency_s + concurrent * xfer
        return concurrent * (caps.fixed_latency_s + xfer)
    return caps.fixed_latency_s + xfer


def connector_chunk_tokens(caps, per_token_wire_bytes: float,
                           default: int = 512) -> int:
    """Streaming chunk size (tokens) honoring the connector's preferred
    wire granularity. Falls back to ``default`` when the connector
    declares none (``chunk_bytes == 0``) — or when the granularity is
    smaller than a single token's wire bytes, where honoring it would
    degenerate to 1-token chunks instead of a comparable regime."""
    if caps is None or getattr(caps, "chunk_bytes", 0) <= 0 \
            or per_token_wire_bytes <= 0 \
            or caps.chunk_bytes < per_token_wire_bytes:
        return default
    return int(caps.chunk_bytes // per_token_wire_bytes)


def alltoall_time(nbytes: float, ep: int, hw: HardwareSpec) -> float:
    if ep <= 1:
        return 0.0
    return (nbytes * (ep - 1) / ep) / hw.eff_link + 2e-6 * math.log2(ep)


# --------------------------------------------------------------------------- #
# Layer 5: latency + VRAM model (feeds the paper's Eq. 1-6)
# --------------------------------------------------------------------------- #
class InstanceModel:
    """Performance model of one model instance on one hardware type."""

    def __init__(self, cfg: ModelConfig, hw: HardwareSpec,
                 strat: ParallelStrategy,
                 fw: Optional[FrameworkModel] = None,
                 kv_block_size: int = 16):
        self.cfg = cfg
        self.hw = hw
        self.strat = strat
        self.fw = fw or FrameworkModel()
        self.kv_block = kv_block_size
        self.wb = _dtype_bytes(cfg)

    # -- Eq. (2): l_p ------------------------------------------------------ #
    def prefill_latency(self, seq_len: int, encoder_tokens: int = 0) -> float:
        """``encoder_tokens``: encoder positions (audio frames / image
        patches) run as a non-resumable P-side preamble before token
        chunks. For enc-dec families this adds the encoder stack's cost
        (``encoder_layers`` attention layers over the source length); for
        vision frontends the patch rows join the decoded sequence itself,
        so they extend the effective prefill length instead."""
        cfg, strat = self.cfg, self.strat
        s_eff = int(seq_len * (1.0 - self.fw.prefix_cache_hit))
        total = 0.0
        comm = 0.0
        if encoder_tokens > 0 and cfg.prefill_capabilities().encoder_preamble:
            if cfg.is_enc_dec:
                enc_ops: List[Op] = []
                for _ in range(cfg.encoder_layers):
                    enc_ops.extend(layer_ops(cfg, ATTN, "prefill",
                                             encoder_tokens, encoder_tokens,
                                             False, self.wb))
                for o in align_ops(cfg, enc_ops, strat):
                    total += op_time(o, self.hw, self.fw)
                comm += 2 * cfg.encoder_layers * allreduce_time(
                    encoder_tokens * cfg.d_model * self.wb, strat.tp, self.hw)
            else:
                s_eff += encoder_tokens
        for i, kind in enumerate(cfg.layer_kinds()):
            moe_layer = cfg.is_moe and i >= (cfg.moe.first_dense_layers or 0)
            ops = layer_ops(cfg, kind, "prefill", s_eff, s_eff, moe_layer,
                            self.wb)
            ops = align_ops(cfg, ops, strat)
            total += sum(op_time(o, self.hw, self.fw) for o in ops)
            act = s_eff * cfg.d_model * self.wb
            comm += 2 * allreduce_time(act, strat.tp, self.hw)
            if moe_layer and strat.ep > 1:
                comm += 2 * alltoall_time(
                    s_eff * cfg.moe.top_k * cfg.d_model * self.wb / strat.ep,
                    strat.ep, self.hw)
        for o in embedding_ops(cfg, s_eff, self.wb):
            total += op_time(o, self.hw, self.fw) / strat.tp
        comm += (strat.pp - 1) * p2p_time(s_eff * cfg.d_model * self.wb, self.hw)
        return total + comm + self.fw.sched_overhead_s

    # -- Eq. (5): l_d ------------------------------------------------------ #
    def decode_latency(self, batch: int, kv_len: int) -> float:
        cfg, strat = self.cfg, self.strat
        total = 0.0
        comm = 0.0
        for i, kind in enumerate(cfg.layer_kinds()):
            moe_layer = cfg.is_moe and i >= (cfg.moe.first_dense_layers or 0)
            ops = layer_ops(cfg, kind, "decode", batch, kv_len, moe_layer,
                            self.wb)
            ops = align_ops(cfg, ops, strat)
            total += sum(op_time(o, self.hw, self.fw) for o in ops)
            act = batch * cfg.d_model * self.wb
            comm += 2 * allreduce_time(act, strat.tp, self.hw)
            if moe_layer and strat.ep > 1:
                comm += 2 * alltoall_time(
                    batch * cfg.moe.top_k * cfg.d_model * self.wb / strat.ep,
                    strat.ep, self.hw)
        for o in embedding_ops(cfg, batch, self.wb):
            total += op_time(o, self.hw, self.fw) / strat.tp
        comm += (strat.pp - 1) * p2p_time(batch * cfg.d_model * self.wb, self.hw)
        return total + comm + self.fw.sched_overhead_s

    # -- Eq. (3)/(6): m_p, m_d --------------------------------------------- #
    def weight_bytes_per_gpu(self) -> float:
        # experts sit inside the tp shards (ep | tp): no separate ep term
        shard = self.strat.tp * self.strat.pp
        return self.cfg.param_count() * self.wb / shard

    def activation_bytes_per_gpu(self, tokens: int) -> float:
        cfg = self.cfg
        widest = max(cfg.d_ff, cfg.d_model * 4,
                     (cfg.moe.d_ff_expert * cfg.moe.top_k) if cfg.is_moe else 0)
        return 4.0 * tokens * (cfg.d_model + widest / self.strat.tp) * self.wb

    def kv_bytes_per_gpu(self, batch: int, seq_len: int) -> float:
        full = page_rounded_kv_bytes(self.cfg, seq_len, self.kv_block, self.wb)
        kvh = max(self.cfg.num_kv_heads, 1)
        tp_share = min(self.strat.tp, kvh)
        return batch * full / (tp_share * self.strat.pp)

    def vram_prefill(self, seq_len: int, concurrent: int = 1) -> float:
        return (self.weight_bytes_per_gpu()
                + concurrent * self.activation_bytes_per_gpu(seq_len)
                + concurrent * self.kv_bytes_per_gpu(1, seq_len))

    def vram_decode(self, batch: int, seq_len: int) -> float:
        return (self.weight_bytes_per_gpu()
                + self.activation_bytes_per_gpu(batch)
                + self.kv_bytes_per_gpu(batch, seq_len))

    def fits(self, vram_bytes: float) -> bool:
        return vram_bytes <= self.hw.hbm_bytes * 0.92   # runtime reserve

    # -- instance-level throughput ------------------------------------------ #
    def max_decode_batch(self, seq_len: int, cap: int = 512) -> int:
        lo, hi = 0, cap
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.fits(self.vram_decode(mid, seq_len)):
                lo = mid
            else:
                hi = mid - 1
        return lo

    def prefill_qps_capacity(self, seq_len: int, microbatches: int = 4) -> float:
        l = self.prefill_latency(seq_len)
        pp = self.strat.pp
        pipe_eff = microbatches / (microbatches + pp - 1)
        return self.strat.dp * pp * pipe_eff / l

    def decode_token_capacity(self, batch: int, kv_len: int) -> float:
        return self.strat.dp * batch / self.decode_latency(batch, kv_len)

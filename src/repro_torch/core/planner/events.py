"""Discrete-event simulation of the serving cluster — port of
``repro.core.planner.events`` (the same ``default_rng(seed)`` draws).

Drives the paper's experiments (Figs. 6-10) on top of the layered latency
model. Every instance is a single shared resource (one GPU timeline):

  * ``disagg``    — P instances run prefill only; D instances run
    continuous-batching decode only; a KV transfer (bytes/NIC) sits between.
  * ``integrated``— each instance runs BOTH stages with prefill-priority:
    an arriving prefill runs before the next decode step (the paper's
    baseline), so decode stalls and, under load, prefill queueing blows up
    TTFT — the interference the paper sets out to remove.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.planner.simulator import (InstanceModel,
                                                connector_wire_time)
from repro_torch.core.planner.workload import Workload


def kv_wire_bytes_per_token(cfg: ModelConfig, wbytes: int = 2) -> int:
    """Canonical per-token P→D wire bytes across all attention layers —
    the single source for both the event sim's transfer time and the
    connector-granularity chunk sizing. Family-awareness routes through
    ``cfg.prefill_capabilities()``: latent-KV families ship the latent
    cache, states-only families (no KV on the wire) ship no per-token
    bytes at all (their recurrent state travels once in the tail
    package, amortized to ~0 per token)."""
    caps = cfg.prefill_capabilities()
    if not caps.kv_on_wire:
        per_tok = 0
    elif caps.latent_kv:
        per_tok = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * wbytes
    else:
        per_tok = 2 * max(cfg.num_kv_heads, 1) * cfg.hd * wbytes
    n_attn = sum(1 for k in cfg.layer_kinds() if k == "attn")
    return per_tok * max(n_attn, 1)


@dataclasses.dataclass
class SimRequest:
    rid: int
    arrival: float
    input_len: int
    output_len: int
    prefill_start: float = -1.0
    first_token: float = -1.0
    tokens_emitted: int = 0
    finish: float = -1.0

    def ttft(self) -> float:
        return self.first_token - self.arrival

    def tpot(self) -> float:
        n = max(self.tokens_emitted - 1, 1)
        return (self.finish - self.first_token) / n


@dataclasses.dataclass
class SimResult:
    requests: List[SimRequest]
    duration: float
    total_tokens: int
    p_busy: float = 0.0
    d_busy: float = 0.0
    #: seconds of prefill compute executed on ``role="both"`` instances
    #: while decode work sat active/waiting on the same timeline — the
    #: modeled decode stall the paper's disagg design removes. Compare
    #: against the measured ``EngineStats.contention_stall_seconds``.
    contention_stall_s: float = 0.0

    def _done(self) -> List[SimRequest]:
        return [r for r in self.requests if r.finish >= 0]

    def ttft_mean(self) -> float:
        d = self._done()
        return float(np.mean([r.ttft() for r in d])) if d else float("inf")

    def ttft_p99(self) -> float:
        d = self._done()
        return float(np.percentile([r.ttft() for r in d], 99)) if d else float("inf")

    def tpot_mean(self) -> float:
        d = self._done()
        return float(np.mean([r.tpot() for r in d])) if d else float("inf")

    def throughput_tok_s(self) -> float:
        return self.total_tokens / self.duration

    def completed(self) -> int:
        return len(self._done())

    def goodput_req_s(self, wl: "Workload") -> float:
        """Requests/s finishing within BOTH SLOs (throughput under SLO
        constraints — the comparison regime of the paper's Figs. 9-10)."""
        ok = [r for r in self._done()
              if r.ttft() <= wl.slo_ttft_s and r.tpot() <= wl.slo_tpot_s]
        return len(ok) / self.duration

    def goodput_tok_s(self, wl: "Workload") -> float:
        ok = [r for r in self._done()
              if r.ttft() <= wl.slo_ttft_s and r.tpot() <= wl.slo_tpot_s]
        return sum(r.tokens_emitted for r in ok) / self.duration

    def slo_attainment(self, wl: "Workload") -> float:
        d = self._done()
        if not d:
            return 0.0
        ok = [r for r in d
              if r.ttft() <= wl.slo_ttft_s and r.tpot() <= wl.slo_tpot_s]
        return len(ok) / len(d)

    def summary(self) -> Dict[str, float]:
        return {"ttft_mean_s": self.ttft_mean(), "ttft_p99_s": self.ttft_p99(),
                "tpot_mean_s": self.tpot_mean(),
                "throughput_tok_s": self.throughput_tok_s(),
                "completed": float(self.completed()),
                "contention_stall_s": self.contention_stall_s}


class _Instance:
    """One GPU timeline. role: 'prefill' | 'decode' | 'both'."""

    def __init__(self, name: str, model: InstanceModel, role: str,
                 max_batch: int):
        self.name = name
        self.model = model
        self.role = role
        self.max_batch = max_batch
        self.prefill_q: List[SimRequest] = []
        self.decode_active: List[SimRequest] = []
        self.decode_wait: List[SimRequest] = []
        self.busy_prefill = 0.0
        self.busy_decode = 0.0
        self.stall = 0.0            # prefill time while decode work waited
        self.working = False

    # queue-depth proxies for routing
    def p_load(self) -> float:
        return len(self.prefill_q)

    def d_load(self) -> float:
        return (len(self.decode_active) + len(self.decode_wait)) / \
            max(self.max_batch, 1)


def simulate(cfg: ModelConfig, wl: Workload, *,
             p_model: InstanceModel, d_model: InstanceModel,
             n_prefill: int = 1, n_decode: int = 1,
             mode: str = "disagg", duration_s: float = 120.0,
             transfer_gbps: float = 25.0, connector_caps=None,
             poisson: bool = False,
             seed: int = 0, max_batch_cap: int = 256,
             drain: bool = True) -> SimResult:
    """In ``integrated`` mode the (p_model, n_prefill) pair describes the
    first integrated pool and (d_model, n_decode) the second — pass the same
    hardware sets as the disagg run for a cost-fair comparison.

    ``connector_caps``: a KV connector's ``capabilities()`` descriptor —
    when given, the P→D wire time is sourced from it (bandwidth + fixed
    per-read latency) instead of the bare ``transfer_gbps`` constant."""
    rng = np.random.default_rng(seed)
    arrivals: List[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / wl.qps) if poisson else 1.0 / wl.qps
        if t >= duration_s:
            break
        arrivals.append(t)
    reqs = [SimRequest(i, a, wl.input_len, wl.output_len)
            for i, a in enumerate(arrivals)]

    seq_total = wl.input_len + wl.output_len
    if mode == "integrated":
        insts = [
            _Instance(f"I{i}", p_model if i < n_prefill else d_model, "both",
                      max(min((p_model if i < n_prefill else d_model)
                              .max_decode_batch(seq_total), max_batch_cap), 1))
            for i in range(n_prefill + n_decode)]
        p_pool = insts
        d_pool = insts
    else:
        p_pool = [_Instance(f"P{i}", p_model, "prefill", 0)
                  for i in range(n_prefill)]
        d_pool = [_Instance(f"D{i}", d_model, "decode",
                            max(min(d_model.max_decode_batch(seq_total),
                                    max_batch_cap), 1))
                  for i in range(n_decode)]
        insts = p_pool + d_pool

    # P→D wire bytes per request (canonical KV of the prompt). Encoder
    # preamble families also ship per-position KV for the encoder output:
    # enc-dec streams cross-KV rows (one set per decoder layer — same
    # width as self-KV), vision frontends prepend patch rows to the
    # decoded sequence itself.
    wire_len = wl.input_len
    if cfg.prefill_capabilities().encoder_preamble:
        wire_len += wl.encoder_len
    kv_bytes = kv_wire_bytes_per_token(cfg) * wire_len
    if mode != "disagg":
        xfer = 0.0
    elif connector_caps is not None:
        xfer = connector_wire_time(kv_bytes, connector_caps)
    else:
        xfer = kv_bytes / (transfer_gbps * 1e9)

    evq: List[Tuple[float, int, str, object]] = []
    counter = 0

    def push(when: float, kind: str, payload) -> None:
        nonlocal counter
        counter += 1
        heapq.heappush(evq, (when, counter, kind, payload))

    for r in reqs:
        push(r.arrival, "arrive", r)

    total_tokens = 0
    end = duration_s if not drain else duration_s + 3600.0

    def kick(inst: _Instance, now: float) -> None:
        if not inst.working:
            inst.working = True
            push(now, "work", inst)

    while evq:
        now, _, kind, payload = heapq.heappop(evq)
        if now > end:
            break
        if kind == "arrive":
            r: SimRequest = payload
            pi = min(p_pool, key=lambda i: i.p_load())
            pi.prefill_q.append(r)
            kick(pi, now)
        elif kind == "admit":
            r, src = payload
            if mode == "integrated":
                di = src                      # decode where it prefilled
            else:
                di = min(d_pool, key=lambda i: i.d_load())
            di.decode_wait.append(r)
            kick(di, now)
        elif kind == "work":
            inst: _Instance = payload
            # prefill-priority (the paper's baseline behaviour)
            if inst.role in ("prefill", "both") and inst.prefill_q:
                r = inst.prefill_q.pop(0)
                dt = inst.model.prefill_latency(r.input_len,
                                                encoder_tokens=wl.encoder_len)
                inst.busy_prefill += dt
                if inst.role == "both" and (inst.decode_active or
                                            inst.decode_wait):
                    inst.stall += dt
                r.prefill_start = now
                r.first_token = now + dt       # first token from prefill
                r.tokens_emitted = 1
                total_tokens += 1
                if r.tokens_emitted >= r.output_len:
                    r.finish = now + dt
                else:
                    # chunked streaming overlaps the wire with chunk compute
                    # (serving stack's StreamedHandoff); only the exposed
                    # residue delays admission to the D pool. Families the
                    # engine cannot chunk-compute ship after the whole
                    # prefill — full wire time exposed.
                    if cfg.supports_chunked_prefill:
                        exposed = inst.model.fw.handoff_exposed_seconds(
                            dt, xfer, r.input_len)
                    else:
                        exposed = xfer
                    push(now + dt + exposed, "admit", (r, inst))
                push(now + dt, "work", inst)
                continue
            if inst.role in ("decode", "both") and \
                    (inst.decode_active or inst.decode_wait):
                while inst.decode_wait and \
                        len(inst.decode_active) < inst.max_batch:
                    inst.decode_active.append(inst.decode_wait.pop(0))
                batch = len(inst.decode_active)
                kv = float(np.mean([q.input_len + q.tokens_emitted
                                    for q in inst.decode_active]))
                dt = inst.model.decode_latency(batch, int(kv))
                inst.busy_decode += dt
                total_tokens += batch
                finished = []
                for q in inst.decode_active:
                    q.tokens_emitted += 1
                    if q.tokens_emitted >= q.output_len:
                        q.finish = now + dt
                        finished.append(q)
                inst.decode_active = [q for q in inst.decode_active
                                      if q not in finished]
                push(now + dt, "work", inst)
                continue
            inst.working = False

    dur = max(duration_s,
              max((r.finish for r in reqs if r.finish > 0), default=0.0))
    pb = sum(i.busy_prefill for i in insts)
    db = sum(i.busy_decode for i in insts)
    return SimResult(requests=reqs, duration=dur, total_tokens=total_tokens,
                     p_busy=pb / (len(insts) * dur),
                     d_busy=db / (len(insts) * dur),
                     contention_stall_s=sum(i.stall for i in insts))

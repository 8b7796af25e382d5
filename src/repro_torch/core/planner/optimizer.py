"""Joint optimization of parallel strategy and P:D instance allocation
(paper §III-C / §IV) — a serial two-stage global search. Port of
``repro.core.planner.optimizer``.

Stage 1 (Eq. 1): over (dp, tp, pp, ep), maximize per-GPU prefill throughput
  T_p / (dp·tp·pp)  s.t.  (c1) l_p ≤ L_ttft   (c2) m_p ≤ M_p

Stage 2 (Eq. 4): over (dp, tp, pp, ep, Y), maximize per-instance decode
throughput  Σ_y T_y^d / Y  s.t.  (c1) l_d ≤ L_tpot  (c2) m_d ≤ M_d,
with total D capacity covering the stage-1 (P-side) admitted rate.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.planner.hardware import HardwareSpec
from repro_torch.core.planner.simulator import (FrameworkModel,
                                                InstanceModel,
                                                ParallelStrategy)
from repro_torch.core.planner.workload import Workload


@dataclasses.dataclass
class StageResult:
    strategy: ParallelStrategy
    latency_s: float              # l_p or l_d at the operating point
    vram_gb: float
    per_gpu_throughput: float     # stage-1 objective (req/s/GPU)
    instance_capacity: float      # req/s per instance
    batch: int = 0                # decode operating batch (stage 2)
    candidates_evaluated: int = 0
    rejected_slo: int = 0
    rejected_vram: int = 0


@dataclasses.dataclass
class DeploymentPlan:
    model: str
    workload: Workload
    p_hw: str
    d_hw: str
    prefill: StageResult
    decode: StageResult
    n_prefill: int
    n_decode: int                 # Y
    cost_per_hour: float
    qps_capacity: float

    def ratio(self) -> str:
        return f"{self.n_prefill}P{self.n_decode}D"

    def to_cluster_spec(self, cfg: ModelConfig, *,
                        p_vendor=None, d_vendor=None,
                        params_seed: int = 0, num_blocks: int = 256,
                        max_batch: int = 8, max_seq_len: int = 512,
                        num_p: Optional[int] = None,
                        num_d: Optional[int] = None,
                        device: Optional[str] = None):
        """Make the plan executable: the chosen instance counts and TP
        degrees as a ``ClusterSpec`` the multi-process ``ClusterRuntime``
        launches unmodified. ``num_p``/``num_d`` override the planned
        counts (the CLI's ``--num-p/--num-d``); vendors default to one
        profile per stage named after the planned hardware, with the KV
        shard TP clamped to a divisor of the model's KV heads (stored KV
        is sharded by head, so the planner's TP may exceed what the KV
        layout can express). ``device`` goes to every ``EngineSpec``:
        None is the card, ``"cpu"`` the plain path."""
        # imported here: the serving layer imports the planner for
        # plan-vs-measured reporting, so a module-level import would cycle
        from repro_torch.serving.engine import VendorProfile
        from repro_torch.serving.multiproc.messages import (ClusterSpec,
                                                            EngineSpec)
        if p_vendor is None:
            p_vendor = VendorProfile(
                self.p_hw, tp=_kv_tp(cfg, self.prefill.strategy.tp),
                hardware=self.p_hw)
        if d_vendor is None:
            d_vendor = VendorProfile(
                self.d_hw, tp=_kv_tp(cfg, self.decode.strategy.tp),
                hardware=self.d_hw)
        n_p = self.n_prefill if num_p is None else num_p
        n_d = self.n_decode if num_d is None else num_d
        common = dict(cfg=cfg, params_seed=params_seed,
                      num_blocks=num_blocks, max_batch=max_batch,
                      max_seq_len=max_seq_len, device=device)
        return ClusterSpec(
            p=tuple(EngineSpec(name=f"{self.p_hw}-p{i}", vendor=p_vendor,
                               role="prefill", **common)
                    for i in range(n_p)),
            d=tuple(EngineSpec(name=f"{self.d_hw}-d{i}", vendor=d_vendor,
                               role="decode", **common)
                    for i in range(n_d)))


def _kv_tp(cfg: ModelConfig, want: int) -> int:
    """Largest KV-shard TP ≤ the planned TP that divides the model's KV
    heads (1 for latent-KV families: the latent cache is not
    head-sharded)."""
    if cfg.prefill_capabilities().latent_kv:
        return 1
    heads = max(cfg.num_kv_heads, 1)
    return max(t for t in range(1, max(want, 1) + 1) if heads % t == 0)


def _strategy_space(cfg: ModelConfig, hw: HardwareSpec,
                    max_gpus: int) -> List[ParallelStrategy]:
    tps = [t for t in (1, 2, 4, 8) if t <= max_gpus]
    pps = [p for p in (1, 2, 4) if p <= max_gpus]
    dps = [d for d in (1, 2, 4, 8) if d <= max_gpus]
    eps = [1]
    if cfg.is_moe:
        eps = sorted({e for e in (1, 2, 4, 8)
                      if cfg.moe.num_experts % e == 0})
    out = []
    for dp, tp, pp, ep in itertools.product(dps, tps, pps, eps):
        if dp * tp * pp > max_gpus:
            continue
        if ep > 1 and tp % ep != 0:
            continue
        out.append(ParallelStrategy(dp=dp, tp=tp, pp=pp, ep=ep))
    return out


def optimize_prefill(cfg: ModelConfig, hw: HardwareSpec, wl: Workload,
                     max_gpus: int = 8,
                     fw: Optional[FrameworkModel] = None) -> StageResult:
    """Stage 1: Eq. (1) global search."""
    best: Optional[StageResult] = None
    n_eval = n_slo = n_vram = 0
    for strat in _strategy_space(cfg, hw, max_gpus):
        n_eval += 1
        m = InstanceModel(cfg, hw, strat, fw)
        l_p = m.prefill_latency(wl.input_len)
        if l_p > wl.slo_ttft_s:                        # (c1)
            n_slo += 1
            continue
        vram = m.vram_prefill(wl.input_len, concurrent=1)
        if not m.fits(vram):                           # (c2)
            n_vram += 1
            continue
        cap = m.prefill_qps_capacity(wl.input_len)
        per_gpu = cap / strat.gpus
        cand = StageResult(strategy=strat, latency_s=l_p,
                           vram_gb=vram / (1 << 30),
                           per_gpu_throughput=per_gpu,
                           instance_capacity=cap)
        if best is None or cand.per_gpu_throughput > best.per_gpu_throughput:
            best = cand
    if best is None:
        raise ValueError(
            f"no feasible prefill strategy for {cfg.name} on {hw.name} "
            f"(TTFT SLO {wl.slo_ttft_s}s, {wl.input_len} tokens)")
    best.candidates_evaluated = n_eval
    best.rejected_slo = n_slo
    best.rejected_vram = n_vram
    return best


def optimize_decode(cfg: ModelConfig, hw: HardwareSpec, wl: Workload,
                    required_qps: float, max_gpus: int = 8,
                    fw: Optional[FrameworkModel] = None
                    ) -> Tuple[StageResult, int]:
    """Stage 2: Eq. (4) global search (strategy × operating batch × Y)."""
    seq = wl.input_len + wl.output_len
    best: Optional[Tuple[StageResult, int]] = None
    n_eval = n_slo = n_vram = 0
    for strat in _strategy_space(cfg, hw, max_gpus):
        n_eval += 1
        m = InstanceModel(cfg, hw, strat, fw)
        bmax = m.max_decode_batch(seq)
        if bmax < 1:
            n_vram += 1
            continue
        # largest batch still meeting the TPOT SLO (l_d grows with batch)
        batch, l_d = 0, float("inf")
        for b in sorted({1, 2, 4, 8, 16, 24, 32, 48, 64, 96, 128, bmax}):
            if b > bmax:
                break
            l = m.decode_latency(b, seq)
            if l <= wl.slo_tpot_s:
                batch, l_d = b, l
        if batch == 0:                                  # (c1)
            n_slo += 1
            continue
        vram = m.vram_decode(batch, seq)
        if not m.fits(vram):                            # (c2)
            n_vram += 1
            continue
        inst_qps = strat.dp * batch / l_d / wl.output_len
        y = max(1, math.ceil(required_qps / inst_qps))
        cand = StageResult(strategy=strat, latency_s=l_d,
                           vram_gb=vram / (1 << 30),
                           per_gpu_throughput=inst_qps / strat.gpus,
                           instance_capacity=inst_qps, batch=batch)
        # objective: max mean per-instance throughput; tie-break on fewer
        # GPUs total (Y × gpus) = cost
        key = (cand.instance_capacity, -(y * strat.gpus))
        if best is None or key > (best[0].instance_capacity,
                                  -(best[1] * best[0].strategy.gpus)):
            best = (cand, y)
    if best is None:
        raise ValueError(
            f"no feasible decode strategy for {cfg.name} on {hw.name} "
            f"(TPOT SLO {wl.slo_tpot_s}s, seq {seq})")
    best[0].candidates_evaluated = n_eval
    best[0].rejected_slo = n_slo
    best[0].rejected_vram = n_vram
    return best


def plan_deployment(cfg: ModelConfig, wl: Workload, p_hw: HardwareSpec,
                    d_hw: HardwareSpec, max_gpus_per_instance: int = 8,
                    fw: Optional[FrameworkModel] = None) -> DeploymentPlan:
    """Serial two-stage optimization: P first (QPS-driven), then D sized to
    match the P side's admitted rate (the paper's coupling)."""
    s1 = optimize_prefill(cfg, p_hw, wl, max_gpus_per_instance, fw)
    n_p = max(1, math.ceil(wl.qps / s1.instance_capacity))
    admitted = min(wl.qps, n_p * s1.instance_capacity)
    s2, y = optimize_decode(cfg, d_hw, wl, admitted, max_gpus_per_instance, fw)
    cost = (n_p * s1.strategy.gpus * p_hw.cost_per_hour
            + y * s2.strategy.gpus * d_hw.cost_per_hour)
    cap = min(n_p * s1.instance_capacity, y * s2.instance_capacity)
    return DeploymentPlan(model=cfg.name, workload=wl, p_hw=p_hw.name,
                          d_hw=d_hw.name, prefill=s1, decode=s2,
                          n_prefill=n_p, n_decode=y, cost_per_hour=cost,
                          qps_capacity=cap)

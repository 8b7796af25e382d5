"""Plan-vs-measured reporting for the cluster runtime — port of
``repro.serving.multiproc.report`` (stdlib only).

The planner's joint optimization (``plan_deployment``) predicts a
topology — instance counts, per-instance capacity, stage latencies —
from closed-form models. The cluster runtime *measures* the same
quantities while serving: per-instance dispatch counts, heartbeat load
snapshots, worker engine/transfer stats, request TTFTs. This module puts
the two side by side so the joint optimization can be validated against
the running system, and quantifies how evenly the router spread work
(the utilization-imbalance metric the router benchmark tracks).

Stdlib-only and duck-typed over the runtime: it reads the attributes
``ClusterRuntime`` exposes (``stats``, ``worker_stats``,
``transfer_stats``, ``crashes``, ``respawns``) without importing it, so
the planner layer can consume reports without a serving-layer import.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input."""
    if not values:
        return 0.0
    xs = sorted(values)
    idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[idx]


def imbalance(counts: Dict[str, int]) -> float:
    """(max − min) / mean over per-instance work counts — 0.0 means the
    router spread work perfectly evenly, 2.0 (for 2 instances) means one
    instance did everything."""
    if not counts:
        return 0.0
    vals = list(counts.values())
    mean = sum(vals) / len(vals)
    if mean <= 0:
        return 0.0
    return (max(vals) - min(vals)) / mean


def ttfts_s(requests: List[Any]) -> List[float]:
    """Measured time-to-first-token per finished request."""
    out = []
    for r in requests:
        if r.first_token_time is not None and r.arrival_time is not None:
            out.append(r.first_token_time - r.arrival_time)
    return out


def tpots_s(requests: List[Any]) -> List[float]:
    """Measured per-output-token latency per finished request."""
    return [t for t in (r.tpot() for r in requests) if t is not None]


def goodput_rps(requests: List[Any], wall_s: float,
                slo_ttft_s: Optional[float] = None,
                slo_tpot_s: Optional[float] = None) -> float:
    """Finished requests that met *every* configured SLO, per second —
    the metric an open-loop run optimizes (raw throughput counts
    SLO-violating responses nobody would wait for)."""
    if not wall_s:
        return 0.0
    good = 0
    for r in requests:
        if r.finish_time is None:
            continue
        ttft, tpot = r.ttft(), r.tpot()
        if slo_ttft_s is not None and (ttft is None or ttft > slo_ttft_s):
            continue
        if slo_tpot_s is not None and (tpot is None or tpot > slo_tpot_s):
            continue
        good += 1
    return good / wall_s


def slo_section(requests: List[Any], wall_s: float,
                slo_ttft_s: Optional[float] = None,
                slo_tpot_s: Optional[float] = None) -> Dict[str, Any]:
    """Latency-distribution + goodput summary of an open-loop run: TTFT
    and TPOT at p50/p95/p99 over the *scheduled-arrival* accounting, and
    goodput under the configured SLOs."""
    tt, tp = ttfts_s(requests), tpots_s(requests)
    sec: Dict[str, Any] = {
        "wall_s": wall_s,
        "ttft_p50_s": percentile(tt, 50),
        "ttft_p95_s": percentile(tt, 95),
        "ttft_p99_s": percentile(tt, 99),
        "tpot_p50_s": percentile(tp, 50),
        "tpot_p95_s": percentile(tp, 95),
        "tpot_p99_s": percentile(tp, 99),
    }
    if slo_ttft_s is not None or slo_tpot_s is not None:
        sec["slo"] = {"ttft_s": slo_ttft_s, "tpot_s": slo_tpot_s}
        sec["goodput_rps"] = goodput_rps(requests, wall_s,
                                         slo_ttft_s, slo_tpot_s)
    return sec


def measured_section(runtime: Any, requests: List[Any],
                     wall_s: Optional[float] = None) -> Dict[str, Any]:
    """What the cluster actually did, per instance and in aggregate."""
    p_disp = dict(runtime.stats.p_dispatches)
    d_disp = dict(runtime.stats.d_dispatches)
    tt = ttfts_s(requests)
    sec: Dict[str, Any] = {
        "n_prefill": len(p_disp),
        "n_decode": len(d_disp),
        "submitted": runtime.stats.submitted,
        "finished": runtime.stats.finished,
        "failed": runtime.stats.failed,
        "shed": getattr(runtime.stats, "shed", 0),
        "requeues": runtime.stats.requeues,
        "crashes": dict(runtime.crashes),
        "respawns": dict(getattr(runtime, "respawns", {})),
        "p_dispatches": p_disp,
        "d_dispatches": d_disp,
        "p_imbalance": imbalance(p_disp),
        "d_imbalance": imbalance(d_disp),
        "ttft_p50_s": percentile(tt, 50),
        "ttft_p95_s": percentile(tt, 95),
        "worker_stats": dict(runtime.worker_stats),
        "transfer": {
            "chunks": runtime.transfer_stats.chunks,
            "retries": runtime.transfer_stats.retries,
            "wall_handoff_seconds":
                runtime.transfer_stats.wall_handoff_seconds,
            "wall_overlap_seconds":
                runtime.transfer_stats.wall_overlap_seconds,
            "prefix_hit_tokens": runtime.transfer_stats.prefix_hit_tokens,
            "bytes_saved": runtime.transfer_stats.bytes_saved,
            # wire vs raw payload bytes: the int8 wire's compression and
            # the fixed-layout format's header overhead both show up here
            "wire_bytes": runtime.transfer_stats.bytes_moved,
            "payload_bytes": runtime.transfer_stats.payload_bytes,
            "wire_compression": runtime.transfer_stats.wire_compression,
            # link congestion: modeled fair-share delay plus the measured
            # read wall time delivered under concurrency
            "congested_seconds": runtime.transfer_stats.congested_seconds,
            "contended_read_seconds":
                runtime.transfer_stats.contended_read_seconds,
            "concurrent_reads_peak":
                runtime.transfer_stats.concurrent_reads_peak,
        },
    }
    # integrated-baseline honesty metrics, aggregated over workers:
    # prefill seconds that stalled decode-ready work on role="both"
    # engines (the interference disaggregation removes — ~0 on a disagg
    # topology), requests that silently could not use resume/replay, and
    # prompt tokens recovered from mid-stream snapshots after failures
    ws = runtime.worker_stats.values()
    sec["contention_stall_seconds"] = sum(
        w.get("contention_stall_seconds", 0.0) for w in ws)
    sec["resume_unsupported"] = int(sum(
        w.get("resume_unsupported", 0) for w in ws))
    sec["resumed_tokens"] = int(sum(
        w.get("resumed_tokens", 0) for w in ws))
    # measured prefix-cache hit ratio: wire tokens skipped over prompt
    # tokens submitted — the honest counterpart of the planner's assumed
    # FrameworkModel.prefix_cache_hit
    prompt_tokens = sum(getattr(r, "prompt_len", 0) for r in requests)
    sec["prefix_hit_ratio"] = (
        runtime.transfer_stats.prefix_hit_tokens / prompt_tokens
        if prompt_tokens else 0.0)
    if wall_s:
        sec["wall_s"] = wall_s
        sec["measured_qps"] = runtime.stats.finished / wall_s
    return sec


def plan_section(plan: Any) -> Dict[str, Any]:
    """The planner's predictions, in the same units as the measurement."""
    return {
        "model": plan.model,
        "ratio": plan.ratio(),
        "n_prefill": plan.n_prefill,
        "n_decode": plan.n_decode,
        "p_hw": plan.p_hw,
        "d_hw": plan.d_hw,
        "predicted_ttft_s": plan.prefill.latency_s,
        "predicted_tpot_s": plan.decode.latency_s,
        "p_instance_qps": plan.prefill.instance_capacity,
        "d_instance_qps": plan.decode.instance_capacity,
        "qps_capacity": plan.qps_capacity,
        "cost_per_hour": plan.cost_per_hour,
    }


def plan_vs_measured(runtime: Any, requests: List[Any],
                     plan: Any = None,
                     wall_s: Optional[float] = None,
                     sim_summary: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """Full post-run report: measured cluster behaviour, optionally laid
    against the ``DeploymentPlan`` that launched it (with deltas where
    the two describe the same quantity). ``sim_summary`` — a
    ``SimResult.summary()`` dict from the event sim run in the same mode
    (disagg/integrated) — adds the modeled-vs-measured decode-stall
    comparison for the integrated baseline."""
    rep: Dict[str, Any] = {"measured": measured_section(runtime, requests,
                                                        wall_s)}
    if plan is not None:
        rep["plan"] = plan_section(plan)
        m = rep["measured"]
        rep["deltas"] = {
            "n_prefill": m["n_prefill"] - plan.n_prefill,
            "n_decode": m["n_decode"] - plan.n_decode,
            "ttft_p50_vs_predicted_s":
                m["ttft_p50_s"] - plan.prefill.latency_s,
        }
        if "measured_qps" in m:
            rep["deltas"]["qps_vs_capacity"] = \
                m["measured_qps"] - plan.qps_capacity
    if sim_summary is not None and "contention_stall_s" in sim_summary:
        rep["sim"] = dict(sim_summary)
        rep.setdefault("deltas", {})["contention_stall_vs_modeled_s"] = \
            rep["measured"]["contention_stall_seconds"] - \
            sim_summary["contention_stall_s"]
    return rep


def format_report(rep: Dict[str, Any]) -> str:
    """Readable multi-line rendering for CLI output."""
    m = rep["measured"]
    lines = ["== measured ==",
             f"  topology     {m['n_prefill']}P{m['n_decode']}D"
             f"  finished {m['finished']}/{m['submitted']}"
             f"  requeues {m['requeues']}"
             f"  crashes P={m['crashes'].get('P', 0)}"
             f" D={m['crashes'].get('D', 0)}",
             f"  ttft         p50 {m['ttft_p50_s'] * 1e3:.1f} ms"
             f"  p95 {m['ttft_p95_s'] * 1e3:.1f} ms",
             f"  p dispatches {m['p_dispatches']}"
             f"  (imbalance {m['p_imbalance']:.2f})",
             f"  d dispatches {m['d_dispatches']}"
             f"  (imbalance {m['d_imbalance']:.2f})"]
    if m["transfer"].get("wire_bytes"):
        t = m["transfer"]
        lines.append(
            f"  wire         {t['wire_bytes']} B moved for "
            f"{t['payload_bytes']} B of KV "
            f"(ratio {t['wire_compression']:.2f}, "
            f"peak {t['concurrent_reads_peak']} concurrent reads, "
            f"{t['contended_read_seconds'] * 1e3:.1f} ms read under "
            f"contention)")
    if m["transfer"].get("prefix_hit_tokens"):
        lines.append(
            f"  prefix cache {m['transfer']['prefix_hit_tokens']} wire "
            f"tokens skipped (hit ratio {m['prefix_hit_ratio']:.2f}, "
            f"{m['transfer']['bytes_saved']} B saved)")
    if m.get("contention_stall_seconds"):
        lines.append(
            f"  contention   {m['contention_stall_seconds'] * 1e3:.1f} ms "
            f"decode stalled behind prefill (integrated baseline)")
    if m.get("resumed_tokens") or m.get("resume_unsupported"):
        lines.append(
            f"  resume       {m.get('resumed_tokens', 0)} tokens recovered "
            f"from snapshots, {m.get('resume_unsupported', 0)} requests "
            f"fell back to full recompute")
    if "measured_qps" in m:
        lines.append(f"  throughput   {m['measured_qps']:.2f} req/s "
                     f"over {m['wall_s']:.1f} s")
    if "plan" in rep:
        p = rep["plan"]
        lines += ["== planned ==",
                  f"  topology     {p['ratio']}  ({p['p_hw']} → {p['d_hw']})",
                  f"  ttft         {p['predicted_ttft_s'] * 1e3:.1f} ms"
                  f"  capacity {p['qps_capacity']:.2f} req/s"
                  f"  cost ${p['cost_per_hour']:.2f}/h"]
        d = rep["deltas"]
        lines.append(f"== deltas ==\n  n_p {d['n_prefill']:+d}"
                     f"  n_d {d['n_decode']:+d}"
                     f"  ttft_p50 {d['ttft_p50_vs_predicted_s'] * 1e3:+.1f} ms")
    return "\n".join(lines)

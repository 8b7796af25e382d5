"""End-to-end run of the PyTorch port: serve a ~100M-param model with
batched requests through the full disaggregated stack — heterogeneous P/D
vendor profiles, load-aware routing, a mid-run D-instance failure
(recovered via re-prefill), and elastic scale-up. The PyTorch
counterpart of ``examples/serve_disagg.py``: the same flags, defaults,
model, vendors, request draws, fault and join ticks and printed lines.

Two runtimes share the stack:

  * single-process (default): every engine lives in this process and the
    ``GlobalScheduler`` pumps the P-side flight loop and D-side decode
    loop in one tick loop.
  * multi-process (``--num-p/--num-d``, or ``--two-process`` for the
    degenerate 1P+1D point): N prefill + M decode engines run in
    *separate OS processes* (``repro_torch.serving.multiproc``), each in
    its own CUDA context on the card, the parent routes each request by
    measured load, control plane over multiprocessing queues, KV data
    plane over SharedMemoryConnector segments. Requires ``--connector
    shm``. ``--plan`` sizes the topology with the planner's joint
    optimization (``plan_deployment`` → ``to_cluster_spec``) and prints a
    plan-vs-measured report; ``--num-p/--num-d`` override the planned
    counts.

``--parity`` runs both runtimes back to back and exits nonzero with a
per-request token diff unless the output is token-exact.

Everything runs on the card (the hand-written CUDA kernels: flash for
the prefill chunks, paged attention for decode, the overlay for the
re-page) unless ``--device cpu`` asks for the plain PyTorch path. The
weights are random, drawn from ``PARAMS_SEED``. ``--codec`` keeps only
the fixed-layout segments: the port has no legacy pickled KV codec.

  PYTHONPATH=src python examples/torch_serve_disagg.py [--requests 24]
  PYTHONPATH=src python examples/torch_serve_disagg.py --device cpu
  PYTHONPATH=src python examples/torch_serve_disagg.py --two-process \\
      --connector shm
  PYTHONPATH=src python examples/torch_serve_disagg.py --num-p 2 \\
      --num-d 2 --connector shm --parity
  PYTHONPATH=src python examples/torch_serve_disagg.py --plan \\
      --connector shm
"""
import argparse
import sys
import time

import numpy as np

from repro_torch.configs.base import ConnectorConfig, ModelConfig
from repro_torch.core.compat.precision import WireFormat
from repro_torch.serving.engine import VendorProfile
from repro_torch.serving.request import Request

# ~100M params: 16L × d640 (GQA 10/5), vocab 16k
CFG = ModelConfig(name="demo-100m", family="dense", num_layers=16,
                  d_model=640, num_heads=10, num_kv_heads=5, head_dim=64,
                  d_ff=2560, vocab_size=16384, param_dtype="float32",
                  compute_dtype="float32")
# tp must divide the model's KV heads (5) — the KV shards on the wire
# are per-TP-rank slices of the head axis
VENDOR_P = VendorProfile("vendorB", block_size=16, layout="nhbd",
                         kv_dtype="float32", tp=5, hardware="gpu-b")
VENDOR_D = VendorProfile("vendorA", block_size=8, layout="nbhd",
                         kv_dtype="float32", tp=1, hardware="gpu-a")
PARAMS_SEED = 0
# the port ships KV only as fixed-layout segments
NO_PICKLE = ("--codec pickle: the port has no legacy pickled KV codec "
             "(ROADMAP §3 B7); use --codec fixed")


def device_label(device) -> str:
    """What the printed rates ran on: the card's name, or "CPU"."""
    import torch

    from repro_torch import device as _dev
    dev = _dev.resolve(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"


def build_requests(n: int, max_new: int):
    rng = np.random.default_rng(0)
    return [Request(req_id=f"req-{i:03d}",
                    prompt=rng.integers(0, CFG.vocab_size,
                                        int(rng.integers(16, 64))
                                        ).astype(np.int32),
                    max_new_tokens=max_new)
            for i in range(n)]


class SingleRun(dict):
    """The single-process run's tokens by request id (what
    ``run_single`` returns, as the reference's does), with the requests,
    the scheduler's and the wire's stats, each engine's stats and the
    scheduler clock's readings at the loop's start, the failure and the
    join (``events``) beside them."""

    def __init__(self, reqs, sched, engines, events):
        super().__init__({r.req_id: list(r.output_tokens) for r in reqs})
        self.requests = reqs
        self.stats = sched.stats
        self.wire = sched.pipeline.transfer.stats
        self.engines = {e.name: e.stats.as_dict() for e in engines}
        self.events = events


def run_single(args, faults: bool, params=None):
    """Single-process runtime: all engines in this process, on
    ``args.device`` (None: the card). ``params``: the model's weights on
    that device, drawn from ``PARAMS_SEED`` when not given."""
    from repro_torch import device as _dev
    from repro_torch.core.disagg import DisaggPipeline
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import GlobalScheduler
    from repro_torch.serving.server import Server
    from repro_torch.training.tree import leaves

    dev = _dev.resolve(args.device)
    n = sum(p.numel() for p in leaves(M.abstract_params(CFG)))
    print(f"model: {CFG.name} ({n/1e6:.0f}M params)")
    if params is None:
        params = M.init_params(CFG, seed=PARAMS_SEED, device=dev)

    mk = lambda name, vendor, role: Engine(  # noqa: E731
        name, CFG, params, vendor, num_blocks=512, max_batch=8,
        max_seq_len=256, role=role, prefix_cache=args.prefix_cache,
        device=dev)
    p0 = mk("P0", VENDOR_P, "prefill")
    d0 = mk("D0", VENDOR_D, "decode")

    connector = ConnectorConfig(kind=args.connector,
                                bandwidth_gbps=25.0).build()
    caps = connector.capabilities()
    print(f"KV connector: {caps.transport} ({caps.bandwidth_gbps:g} Gbps, "
          f"{caps.fixed_latency_s*1e6:g} µs/read, "
          f"max {caps.max_inflight} in flight, "
          f"{'cross-process' if caps.cross_process else 'in-process'})")
    pipeline = DisaggPipeline(connector, WireFormat("raw", "float32"))
    # chunked streaming: each prefill chunk's KV hits the wire while the
    # next chunk computes, and decode steps interleave with long prefills
    sched = GlobalScheduler(pipeline, prefill_chunk=args.prefill_chunk,
                            device=dev)
    engines = [p0, d0] + ([mk("D1", VENDOR_D, "decode")] if faults else [])
    for e in engines:
        sched.add_instance(e)
    server = Server(sched)

    reqs = build_requests(args.requests, args.max_new)
    print(f"serving {len(reqs)} requests "
          f"({'1P+2D, fault injection on' if faults else '1P+1D'}) ...")
    for r in reqs:
        server.submit(r)
    t0 = time.perf_counter()
    events = {"start": sched.clock()}
    tick = 0
    failed = scaled = False
    while sched.stats.finished + sched.stats.failed < len(reqs) \
            and tick < 5000:
        sched.step()
        tick += 1
        if faults and tick == 6 and not failed:   # kill a decode node mid-run
            print("  !! injecting D0 failure (volatile KV lost)")
            d0.fail()
            events["fail"] = sched.clock()
            failed = True
        if faults and tick == 14 and not scaled:   # elastic scale-up
            print("  ++ joining D2 (elastic scale-up)")
            engines.append(mk("D2", VENDOR_D, "decode"))
            sched.add_instance(engines[-1])
            events["join"] = sched.clock()
            scaled = True
    wall = time.perf_counter() - t0

    done = [r for r in reqs if r.done]
    total_tokens = sum(len(r.output_tokens) for r in done)
    print(f"\nfinished {len(done)}/{len(reqs)} requests, "
          f"{total_tokens} tokens in {wall:.1f}s "
          f"({total_tokens / wall:.0f} tok/s on {device_label(dev)})")
    print(f"requeues after failure: {sched.stats.requeues}")
    print(f"P dispatches: {dict(sched.stats.p_dispatches)}")
    print(f"D dispatches: {dict(sched.stats.d_dispatches)}")
    _print_wire(pipeline.transfer.stats)
    assert len(done) == len(reqs), "lost requests!"
    sample = reqs[0]
    print(f"sample stream {sample.req_id}: {sample.output_tokens[:12]}...")
    connector.close()                 # free staged buffers / shm segments
    return SingleRun(reqs, sched, engines, events)


def _build_cluster(args):
    """Resolve the multi-process topology: planner-fed (--plan) with
    --num-p/--num-d overriding, or explicit counts (default 1P+1D). Every
    worker runs on ``args.device`` (None: the card)."""
    from repro_torch.serving.multiproc import ClusterSpec, EngineSpec

    plan = None
    if args.plan:
        from repro_torch.core.planner.hardware import GPU_A, GPU_B
        from repro_torch.core.planner.optimizer import plan_deployment
        from repro_torch.core.planner.workload import Workload
        wl = Workload(qps=args.plan_qps, input_len=48,
                      output_len=args.max_new,
                      slo_ttft_s=10.0, slo_tpot_s=1.0)
        plan = plan_deployment(CFG, wl, GPU_B, GPU_A)
        print(f"planner chose {plan.ratio()} "
              f"(capacity {plan.qps_capacity:.2f} req/s, "
              f"${plan.cost_per_hour:.2f}/h)")
        spec = plan.to_cluster_spec(CFG, p_vendor=VENDOR_P,
                                    d_vendor=VENDOR_D,
                                    params_seed=PARAMS_SEED,
                                    num_blocks=512, max_batch=8,
                                    max_seq_len=256,
                                    num_p=args.num_p, num_d=args.num_d,
                                    device=args.device)
        if args.prefix_cache:
            import dataclasses
            spec = ClusterSpec(
                p=tuple(dataclasses.replace(e, prefix_cache=True)
                        for e in spec.p),
                d=tuple(dataclasses.replace(e, prefix_cache=True)
                        for e in spec.d))
        return spec, plan
    n_p = args.num_p or 1
    n_d = args.num_d or 1
    common = dict(params_seed=PARAMS_SEED, num_blocks=512, max_batch=8,
                  max_seq_len=256, prefix_cache=args.prefix_cache,
                  device=args.device)
    spec = ClusterSpec(
        p=tuple(EngineSpec(f"P{i}", CFG, VENDOR_P, role="prefill", **common)
                for i in range(n_p)),
        d=tuple(EngineSpec(f"D{i}", CFG, VENDOR_D, role="decode", **common)
                for i in range(n_d)))
    return spec, plan


def run_cluster(args):
    """Multi-process runtime: N P + M D engines in separate OS processes.
    Returns the token streams; the runtime's counters are printed."""
    import os

    from repro_torch.serving.multiproc import serve_cluster
    from repro_torch.serving.multiproc.report import (format_report,
                                                      plan_vs_measured)

    if args.connector != "shm":
        raise SystemExit("the multi-process runtime needs the cross-process "
                         "staging backend: pass --connector shm")
    cluster, plan = _build_cluster(args)
    reqs = build_requests(args.requests, args.max_new)
    print(f"serving {len(reqs)} requests on {cluster.ratio()} "
          f"(separate OS processes; parent pid {os.getpid()}) ...")
    t0 = time.perf_counter()
    tokens, rt = serve_cluster(cluster, reqs,
                               prefill_chunk=args.prefill_chunk,
                               max_wall_s=600.0)
    wall = time.perf_counter() - t0
    total_tokens = sum(len(t) for t in tokens.values())
    print(f"\nfinished {rt.stats.finished}/{len(reqs)} requests, "
          f"{total_tokens} tokens in {wall:.1f}s "
          f"({total_tokens / wall:.0f} tok/s on "
          f"{device_label(args.device)})")
    print(f"worker pids: {rt.worker_pids} (parent {os.getpid()})")
    _print_wire(rt.transfer_stats)
    print()
    print(format_report(plan_vs_measured(rt, reqs, plan=plan, wall_s=wall)))
    assert rt.stats.finished == len(reqs), "lost requests!"
    return tokens


def _print_wire(ts) -> None:
    print(f"KV wire: {ts.transfers} transfers ({ts.chunks} streamed chunks), "
          f"{ts.bytes_moved/1e6:.1f} MB, "
          f"peak pinned buffer {ts.peak_buffer_bytes/1e6:.1f} MB")
    if ts.payload_bytes:
        print(f"wire/payload: {ts.bytes_moved/1e6:.2f}/"
              f"{ts.payload_bytes/1e6:.2f} MB "
              f"(compression ratio {ts.wire_compression:.2f})")
    if ts.chunks and ts.overlap_modeled_seconds:
        print(f"overlap (modeled): {ts.overlap_modeled_seconds*1e6:.1f} µs of "
              f"{ts.modeled_seconds*1e6:.1f} µs wire time hidden under "
              f"chunk compute")
    if ts.wall_handoff_seconds:
        print(f"overlap (measured): {ts.wall_overlap_seconds*1e3:.1f} ms of "
              f"wire time hidden under prefill compute across "
              f"{ts.wall_handoff_seconds*1e3:.1f} ms of total handoff wall "
              f"time")


def _parity_diff(ref, got) -> int:
    """Print a readable per-request token diff; returns mismatch count."""
    bad = 0
    for rid in sorted(set(ref) | set(got)):
        a, b = ref.get(rid), got.get(rid)
        if a == b:
            continue
        bad += 1
        if a is None or b is None:
            print(f"  {rid}: only in "
                  f"{'single-process' if b is None else 'multi-process'} run",
                  file=sys.stderr)
            continue
        div = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                   min(len(a), len(b)))
        print(f"  {rid}: diverges at token {div} "
              f"(single has {len(a)}, multi has {len(b)})", file=sys.stderr)
        lo, hi = max(0, div - 2), div + 4
        print(f"    single[{lo}:{hi}] = {a[lo:hi]}", file=sys.stderr)
        print(f"    multi [{lo}:{hi}] = {b[lo:hi]}", file=sys.stderr)
    return bad


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="tokens per streamed prefill chunk (0 = monolithic "
                         "single-tick handoff)")
    ap.add_argument("--connector", default="inproc",
                    choices=["inproc", "shm", "rdma"],
                    help="KV-transport backend: in-process (zero-copy), "
                         "shared-memory (real cross-process staging), or "
                         "modeled-RDMA (async multi-tick completion)")
    ap.add_argument("--codec", default="fixed",
                    choices=["fixed", "pickle"],
                    help="chunk wire codec: zero-copy fixed-layout "
                         "segments (the port has no legacy pickled blob: "
                         "'pickle' exits)")
    ap.add_argument("--num-p", type=int, default=None,
                    help="prefill worker processes (multi-process runtime; "
                         "overrides --plan)")
    ap.add_argument("--num-d", type=int, default=None,
                    help="decode worker processes (multi-process runtime; "
                         "overrides --plan)")
    ap.add_argument("--plan", action="store_true",
                    help="size the topology with the planner's joint "
                         "optimization (plan_deployment → to_cluster_spec) "
                         "and print a plan-vs-measured report")
    ap.add_argument("--plan-qps", type=float, default=0.5,
                    help="workload QPS fed to --plan")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable the shared-prefix KV cache on every "
                         "engine: cache-hit prompt blocks skip prefill "
                         "compute on P and KV bytes on the wire, and the "
                         "cluster router scores D-side prefix affinity")
    ap.add_argument("--two-process", action="store_true",
                    help="run the degenerate 1P+1D multi-process runtime "
                         "(alias for --num-p 1 --num-d 1; requires "
                         "--connector shm)")
    ap.add_argument("--parity", action="store_true",
                    help="run single-process then multi-process and exit "
                         "nonzero with a token diff unless output is "
                         "token-exact")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain PyTorch "
                         "path")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.codec == "pickle":
        raise SystemExit(NO_PICKLE)
    multiproc = (args.two_process or args.plan
                 or args.num_p is not None or args.num_d is not None)

    if args.parity:
        print("== parity: single-process reference ==")
        ref = run_single(args, faults=False)
        print("\n== parity: multi-process runtime ==")
        got = run_cluster(args)
        bad = _parity_diff(ref, got)
        if bad:
            print(f"\nPARITY FAILED: {bad}/{len(set(ref) | set(got))} "
                  "request(s) diverge between the single-process and "
                  "multi-process runtimes", file=sys.stderr)
            sys.exit(1)
        print(f"\nPARITY OK: {len(ref)} requests token-exact across "
              "single-process and multi-process runtimes")
    elif multiproc:
        run_cluster(args)
    else:
        run_single(args, faults=True)


if __name__ == "__main__":
    main()

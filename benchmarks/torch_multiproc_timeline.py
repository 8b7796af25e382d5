"""Where the cross-process runtime's time goes, chunk by chunk.

Serves ``chip_smoke.py`` phase 5's configuration — llama2-7b at full
width, bf16, P and D engines in two spawned worker processes on one GPU,
500-token streamed prefill chunks over shared-memory segments — with a
runtime that keeps the interval every ``ChunkStaged`` and
``ChunkRepaged`` message carries (``time.monotonic``, comparable across
the processes of one host). Four runs, one JSON line each:

  * ``together_first``: phase 5's eight requests at once on fresh
    workers, as phase 5 serves them;
  * ``together_again``: the same eight on the now warm workers;
  * ``alone``: the longest of them (1781 tokens) by itself, cross-process;
  * ``alone_in_process_first`` / ``_again``: the same request twice
    through phase 3's in-process ``GlobalScheduler`` on the same card (the
    parent's engines; the second run is warm).

A last line, ``host_copies``, times on this host the copies one
chunk's wire makes (262 MB, a 500-token llama2-7b chunk in bf16): the
device→host copy into a fresh shared-memory segment, into the same
segment again, into a fresh ``bytearray`` (where the in-process
connector stages), and the copy out of a fresh mapping of a written
segment (what the D worker does after ``adopt_segment``), first and
second time.

For each run: TTFT/TPOT, and per chunk (summed and as a list) the P worker's
compute (``next_chunk``), its stage (device→host into the segment), the
wait on the wire (stage end → re-page start) and the D worker's re-page,
plus the D worker's decode steps and seconds. Comparing ``alone`` with
``together`` separates the per-chunk cost of crossing processes from
what the two contexts cost each other on one card, and the two
``together`` runs show what the workers' first use costs.

    python3 benchmarks/torch_multiproc_timeline.py

Needs a CUDA device (it fails without one). The kernels build first, as
in ``chip_smoke.py``.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _spans(rt):
    """Per chunk: (compute, stage, wire wait, re-page) seconds."""
    staged = {m.key: m for m in rt.staged}
    rows = []
    for m in rt.repaged:
        s = staged.get(m.key)
        if s is None:
            continue
        rows.append((s.t_compute[1] - s.t_compute[0],
                     s.t_stage[1] - s.t_stage[0],
                     m.t_repage[0] - s.t_stage[1],
                     m.t_repage[1] - m.t_repage[0]))
    return rows


def _summary(name, reqs, wall, rows=(), extra=None):
    import numpy as np
    from repro_torch.serving.server import ServeResult
    res = ServeResult(reqs, wall)
    ttft, tpot = res.ttft(), res.tpot()
    out = {"run": name, "requests": len(reqs),
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_max_s": float(ttft.max()),
           "tpot_p50_s": float(np.percentile(tpot, 50)),
           "output_tok_s": res.throughput_tok_s(), "wall_s": wall}
    if rows:
        cols = np.asarray(rows)
        out.update({"chunks": len(rows),
                    "compute_s": float(cols[:, 0].sum()),
                    "stage_s": float(cols[:, 1].sum()),
                    "wire_wait_s": float(cols[:, 2].sum()),
                    "repage_s": float(cols[:, 3].sum()),
                    "per_chunk_ms": [[round(x * 1e3, 2) for x in r]
                                     for r in rows]})
    out.update(extra or {})
    return out


def host_copy_rates(nbytes: int, dev) -> dict:
    """GB/s of each copy a chunk's wire makes, on fresh and on touched
    pages."""
    from multiprocessing import shared_memory

    import numpy as np
    import torch
    src = torch.empty(nbytes // 2, dtype=torch.bfloat16,
                      device=dev).normal_()
    torch.cuda.synchronize()

    def d2h(buf) -> float:
        dst = torch.frombuffer(buf, dtype=torch.bfloat16, count=src.numel())
        t0 = time.perf_counter()
        dst.copy_(src)
        return nbytes / (time.perf_counter() - t0) / 1e9

    def read(buf) -> float:
        t0 = time.perf_counter()
        np.array(np.frombuffer(buf, np.uint8, count=nbytes))
        return nbytes / (time.perf_counter() - t0) / 1e9

    seg = shared_memory.SharedMemory(create=True, size=nbytes)
    out = {"bytes": nbytes, "d2h_fresh_shm_gb_s": d2h(seg.buf),
           "d2h_same_shm_gb_s": d2h(seg.buf)}
    heap = bytearray(nbytes)
    out.update(d2h_fresh_bytearray_gb_s=d2h(heap),
               d2h_same_bytearray_gb_s=d2h(heap))
    reader = shared_memory.SharedMemory(name=seg.name)
    out.update(read_fresh_mapping_gb_s=read(reader.buf),
               read_same_mapping_gb_s=read(reader.buf))
    reader.close()
    seg.close()
    seg.unlink()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_multiproc_timeline: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.core.compat.precision import WireFormat
    from repro_torch.core.disagg import DisaggPipeline
    from repro_torch.core.kv_transfer import TransferEngine
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, VendorProfile
    from repro_torch.serving.multiproc import EngineSpec, TwoProcessRuntime
    from repro_torch.serving.multiproc.messages import (ChunkRepaged,
                                                        ChunkStaged)
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import GlobalScheduler
    from repro_torch.serving.server import Server

    class Timeline(TwoProcessRuntime):
        """Keeps every chunk's stage and re-page interval."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.staged, self.repaged = [], []

        def _handle(self, msg):
            if isinstance(msg, ChunkStaged):
                self.staged.append(msg)
            elif isinstance(msg, ChunkRepaged):
                self.repaged.append(msg)
            super()._handle(msg)

    _build.load()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = get_config(C.MODEL)
    p_vendor = VendorProfile(**C.P_VENDOR)
    d_vendor = VendorProfile(**C.D_VENDOR)
    rng = np.random.default_rng(C.SEED)               # phase 3's draws
    lens = rng.integers(C.PROMPT_RANGE[0], C.PROMPT_RANGE[1] + 1,
                        C.N_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    longest = int(np.argmax(lens))
    max_seq = C.PROMPT_RANGE[1] + C.MAX_NEW
    d_blocks = C.N_REQUESTS * -(-max_seq // d_vendor.block_size) + 1
    p_spec = EngineSpec("P0", cfg, p_vendor, params_seed=C.SEED,
                        num_blocks=2, max_batch=1, max_seq_len=max_seq,
                        role="prefill")
    d_spec = EngineSpec("D0", cfg, d_vendor, params_seed=C.SEED,
                        num_blocks=d_blocks, max_batch=C.N_REQUESTS,
                        max_seq_len=max_seq, role="decode")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)

    rt = Timeline(p_spec, d_spec, wire=WireFormat("raw", "bfloat16"),
                  prefill_chunk=C.PREFILL_CHUNK)
    try:
        rt.start(spawn_timeout_s=300.0)
        everyone = range(C.N_REQUESTS)
        for name, picks in (("together_first", everyone),
                            ("together_again", everyone),
                            ("alone", [longest])):
            rt.staged.clear()
            rt.repaged.clear()
            reqs = [Request(f"{name}{i}", prompts[i].copy(), C.MAX_NEW)
                    for i in picks]
            t0 = time.perf_counter()
            rt.serve(reqs, max_wall_s=600.0)
            wall = time.perf_counter() - t0
            C.check_outputs(cfg, reqs)
            C.emit(_summary(name, reqs, wall, _spans(rt)))
    finally:
        rt.shutdown()
    C.emit({"run": "workers", "worker_stats": rt.worker_stats,
            "worker_launches": rt.worker_launches,
            "stage_s": rt.transfer_stats.stage_seconds,
            "read_s": rt.transfer_stats.read_seconds})

    params = M.init_params(cfg, seed=C.SEED, device=dev)
    p_eng = Engine("P0", cfg, params, p_vendor, num_blocks=2, max_batch=1,
                   max_seq_len=max_seq, role="prefill", device=dev)
    d_eng = Engine("D0", cfg, params, d_vendor, num_blocks=d_blocks,
                   max_batch=C.N_REQUESTS, max_seq_len=max_seq,
                   role="decode", device=dev)
    for attempt in ("first", "again"):       # the second one is warm
        sched = GlobalScheduler(DisaggPipeline(
            TransferEngine(), WireFormat("raw", "bfloat16")),
            prefill_chunk=C.PREFILL_CHUNK, device=dev)
        sched.add_instance(p_eng)
        sched.add_instance(d_eng)
        steps0, decode0 = d_eng.stats.decode_steps, d_eng.stats.decode_seconds
        prefill0 = p_eng.stats.prefill_seconds
        reqs = [Request(f"inproc_{attempt}", prompts[longest].copy(),
                        C.MAX_NEW)]
        result = Server(sched).serve(reqs, max_ticks=100_000)
        C.check_outputs(cfg, reqs)
        tr = sched.pipeline.transfer.stats
        C.emit(_summary(f"alone_in_process_{attempt}", reqs,
                        result.wall_seconds, (),
                        {"prefill_s": p_eng.stats.prefill_seconds - prefill0,
                         "decode_steps": d_eng.stats.decode_steps - steps0,
                         "decode_s": d_eng.stats.decode_seconds - decode0,
                         "wall_handoff_s": tr.wall_handoff_seconds}))
    C.emit(dict(run="host_copies", **host_copy_rates(
        C.PREFILL_CHUNK * cfg.num_layers * 2 * cfg.num_kv_heads * cfg.hd * 2,
        dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

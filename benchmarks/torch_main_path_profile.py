"""Where the device time goes on the port's main path.

Runs ``chip_smoke.phase3`` — llama2-7b at full width, bf16, one P and one
D engine on one GPU, 8 requests of 256-2048 prompt tokens and 32 greedy
output tokens, 500-token streamed prefill chunks — or, with ``--phase 6``,
``chip_smoke.phase6`` (Mixtral-8x7B, 24 layers, sliding window and MoE,
8 requests of 2048-8192 tokens), with ``--phase 7``
``chip_smoke.phase7`` (DeepSeek-V2-Lite, 27 layers, MLA and MoE, the same
8 prompts), with ``--phase 8`` ``chip_smoke.phase8`` (RecurrentGemma-9B,
38 layers, RG-LRU and local attention at head dim 256, the same 8
prompts), with ``--phase 9`` ``chip_smoke.phase9`` (Mamba2-370M, 48 SSD
layers, no attention, the same 8 prompts), with ``--phase 10``
``chip_smoke.phase10`` (InternVL2-2B, 24 layers, phase 3's prompts after
256 patch embeddings each) or with ``--phase 11`` ``chip_smoke.phase11``
(Whisper-large-v3, 32 encoder + 32 decoder layers, 8 requests of 1500
frames and 16-224 prompt tokens, 64-token chunks) — under ``torch.profiler`` (CPU + CUDA
activity) around the serving loop only, and prints one JSON line: device
time by kernel family (the port's kernels, flash at dk 192 and at dk 256
apart, matrix products, copies, everything else), the top kernels by name, the
device's idle share of the serving wall time, and for each profiler span
of the port the host time inside it and the device time of the kernels
it launched (``moe.group_sizes_to_host``: the MoE layer's read-back of its
group sizes, which waits for the work queued before it;
``moe.expert_loop``: the per-expert products; ``mla.latent_attention``:
paged MLA decode's float32 products in the latent space;
``rglru.block``: a whole RG-LRU block, with inside it
``rglru.f32_weights``, the gate weights' cast to float32, and
``rglru.scan``, the recurrence; ``ssd.block``: a whole SSD block, with
inside it ``ssd.scan``, the recurrence across chunks;
``encdec.cross_decode``: D's per-slot cross-attention over the memory
rows, plain tensor ops). Spans may nest:
a kernel counts in every span whose device range holds it.

    PYTHONPATH=src python benchmarks/torch_main_path_profile.py \
        [--phase 6|7|8|9|10|11]

Needs a CUDA device (it fails without one). The kernels build first, as
in ``chip_smoke.py``.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# first match wins; a family matches if its name holds any one key. The
# port's kernels are matched with their namespace separator, so PyTorch's
# own kernels (vectorized_gather_kernel<...>, say) are not counted as ours.
FAMILIES = (("flash_attention_dk192", ("Cfg<192",)),
            ("flash_attention_dk256", ("Cfg<256",)),
            ("flash_attention", ("flash_fwd_kernel",)),
            ("paged_attention", ("::paged_split_kernel<",
                                 "::paged_combine_kernel<")),
            ("scatter_pages_overlay", ("::page_overlay_kernel<",
                                       "::tile_overlay_kernel<")),
            ("scatter_pages", ("::page_scatter_kernel<",
                               "::tile_scatter_kernel<")),
            ("gather_pages", ("::page_gather_kernel<",
                              "::tile_gather_kernel<")),
            ("matmul", ("gemm", "gemv", "xmma", "cutlass", "cublas", "nvjet")),
            ("copy", ("memcpy", "memset")))


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    return "other"


def summarize(events, wall_s: float):
    """Chrome-trace events ("X" phases) → spans, device time by family,
    top kernels, busy ms and idle share. A span's host time is its
    ``user_annotation``; its device range (``gpu_user_annotation``) is an
    annotation, not work, and stays out of the busy time; the kernels that
    start inside a span's device range are its device time (one stream:
    the ranges of one span name do not overlap, those of two names may
    nest)."""
    spans, ranges = {}, {}
    for e in events:
        if e["name"].startswith(("moe.", "mla.", "rglru.", "ssd.",
                                 "encdec.")) and e.get(
                "cat") in (
                "user_annotation", "gpu_user_annotation"):
            host = e["cat"] == "user_annotation"
            row = spans.setdefault(e["name"], {"calls": 0, "host_ms": 0.0,
                                               "device_range_ms": 0.0,
                                               "device_kernel_ms": 0.0})
            row["calls"] += host
            row["host_ms" if host else "device_range_ms"] += e["dur"] / 1e3
            if not host:
                ranges.setdefault(e["name"], []).append(
                    (e["ts"], e["ts"] + e["dur"]))
    for rs in ranges.values():
        rs.sort()
    starts = {name: [r[0] for r in rs] for name, rs in ranges.items()}
    by_name = {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ms_e = e["dur"] / 1e3
        calls, ms = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (calls + 1, ms + ms_e)
        for name, rs in ranges.items():
            i = bisect.bisect_right(starts[name], e["ts"]) - 1
            if i >= 0 and e["ts"] < rs[i][1]:
                spans[name]["device_kernel_ms"] += ms_e
    by_family = {}
    for name, (_, ms) in by_name.items():
        by_family[family(name)] = by_family.get(family(name), 0.0) + ms
    busy_ms = sum(by_family.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {"spans": spans, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / 1e3 / wall_s,
            "device_ms_by_family": by_family,
            "top_kernels": [{"name": n[:90], "calls": c, "device_ms": ms}
                            for n, (c, ms) in top]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_main_path_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build
    _build.load()
    dev = torch.device("cuda", 0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    trace = ROOT / "build" / "main_path_profile.json"
    trace.parent.mkdir(exist_ok=True)

    @contextlib.contextmanager
    def profiled():
        with torch.profiler.profile(activities=acts) as prof:
            yield
            torch.cuda.synchronize()
        # the profiler's C++ side writes the Chrome trace; reading it back
        # is far cheaper than its Python event objects (phase 7 records
        # millions of kernels)
        prof.export_chrome_trace(str(trace))

    phase = int(sys.argv[sys.argv.index("--phase") + 1]) \
        if "--phase" in sys.argv else 3
    run = {3: chip_smoke.phase3, 6: chip_smoke.phase6,
           7: chip_smoke.phase7, 8: chip_smoke.phase8,
           9: chip_smoke.phase9, 10: chip_smoke.phase10,
           11: chip_smoke.phase11}[phase]
    out = run(dev, around_serve=profiled)
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    trace.unlink()
    print(json.dumps({
        "card": chip_smoke.subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "phase": phase, "serve_wall_s": out["wall_s"],
        **summarize(events, out["wall_s"]),
        "launches": out["launches"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

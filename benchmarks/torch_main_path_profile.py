"""Where the device time goes on the port's main path.

Runs ``chip_smoke.phase3`` — llama2-7b at full width, bf16, one P and one
D engine on one GPU, 8 requests of 256-2048 prompt tokens and 32 greedy
output tokens, 500-token streamed prefill chunks — or, with ``--phase 6``,
``chip_smoke.phase6`` (Mixtral-8x7B, 24 layers, sliding window and MoE,
8 requests of 2048-8192 tokens), under ``torch.profiler`` (CPU + CUDA
activity) around the serving loop only, and prints one JSON line: device
time by kernel family (the port's kernels, matrix products, copies,
everything else), the top kernels by name, the device's idle share of
the serving wall time, and the host time spent in each profiler span of
the port (``moe.group_sizes_to_host``: the MoE layer's read-back of its
group sizes, which waits for the work queued before it).

    PYTHONPATH=src python benchmarks/torch_main_path_profile.py [--phase 6]

Needs a CUDA device (it fails without one). The kernels build first, as
in ``chip_smoke.py``.
"""
from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# first match wins; a family matches if its name holds any one key. The
# port's kernels are matched with their namespace separator, so PyTorch's
# own kernels (vectorized_gather_kernel<...>, say) are not counted as ours.
FAMILIES = (("flash_attention", ("flash_fwd_kernel",)),
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
    holder = {}

    @contextlib.contextmanager
    def profiled():
        with torch.profiler.profile(activities=acts) as prof:
            yield
            torch.cuda.synchronize()
        holder["prof"] = prof

    phase = 6 if "--phase" in sys.argv and sys.argv[-1] == "6" else 3
    if phase == 6:
        out = chip_smoke.phase6(dev, around_serve=profiled)
    else:
        out = chip_smoke.phase3(dev, around_serve=profiled)
    # the port's profiler spans: host time inside them (a read-back waits
    # there for the work queued before it), and their device-side ranges,
    # which are annotations, not work, and stay out of the busy time
    spans = {}
    for e in holder["prof"].events():
        if e.name.startswith("moe."):
            side = "host_ms" if e.device_type == \
                torch.autograd.DeviceType.CPU else "device_range_ms"
            row = spans.setdefault(e.name, {"calls": 0, "host_ms": 0.0,
                                            "device_range_ms": 0.0})
            row["calls"] += side == "host_ms"
            row[side] += e.time_range.elapsed_us() / 1e3
    # device-side events only (kernels, copies), each counted once
    by_name = {}
    for e in holder["prof"].events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name not in spans):
            calls, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (calls + 1, ms + e.time_range.elapsed_us() / 1e3)
    by_family = {}
    for name, (_, ms) in by_name.items():
        by_family[family(name)] = by_family.get(family(name), 0.0) + ms
    busy_ms = sum(by_family.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    print(json.dumps({
        "card": chip_smoke.subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "phase": phase, "serve_wall_s": out["wall_s"],
        "spans": spans,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / 1e3 / out["wall_s"],
        "device_ms_by_family": by_family,
        "top_kernels": [{"name": n[:90], "calls": c, "device_ms": ms}
                        for n, (c, ms) in top],
        "launches": out["launches"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What bounds the bf16 flash kernel: its loads or its arithmetic.

    python benchmarks/torch_flash_limits.py

Builds the port's kernels three times from ``src/repro_torch`` into a
temporary copy: as they are, with the consumers' arithmetic removed (they
wait for each K/V tile and release it: the TMA loads alone), and with the
producer's loads removed after the first ring of tiles (it completes each
later stage's barriers without a copy, so the consumers compute on
resident tiles: the arithmetic alone). Times each with CUDA-graph replays
at the main path's chunk shape (q (1,32,500,128) at q_offset 1500 over a
2000-slot cache) and the 2048-token causal prefill, beside
``scaled_dot_product_attention``, and prints one JSON line. The two
variants compute nothing useful; only their times mean anything. Needs a
CUDA device and nvcc.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = "repro_torch/kernels/csrc/flash_attention_wgmma.cu"

# consumers: wait for the tile's K and V, release the stage, nothing else
LOADS_ONLY = ("      float sc[64];\n      mbar_wait(k_full(s), phase);\n",
              "      float sc[64];\n      mbar_wait(k_full(s), phase);\n"
              "      if (n_tiles > 0) {\n"
              "        mbar_wait(v_full(s), phase);\n"
              "        mbar_arrive(empty(s));\n"
              "        continue;\n"
              "      }\n")
# producer: after the first ring, complete the full barriers without a copy
MATH_ONLY = ("        const int kt0 = (t_begin + it) * BN;\n",
             "        const int kt0 = (t_begin + it) * BN;\n"
             "        if (it >= STAGES) {\n"
             "          mbar_arrive(k_full(s));\n"
             "          mbar_arrive(v_full(s));\n"
             "          continue;\n"
             "        }\n")
VARIANTS = {"kernel": None, "loads_only": LOADS_ONLY, "math_only": MATH_ONLY}


def measure() -> dict:
    """In a child process whose ``repro_torch`` is one variant."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    def graph_ms(fn, iters=20, reps=5):
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (iters * reps)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, sq, cap, c0 in (("chunk", 500, 2000, 1500),
                              ("prefill_2048", 2048, 2048, 0)):
        q, k, v = (torch.randn((1, 32, n, 128), generator=gen, device=dev)
                   .bfloat16() for n in (sq, cap, cap))
        qi = torch.arange(c0, c0 + sq, device=dev)[:, None]
        mask = torch.arange(cap, device=dev)[None, :] <= qi
        out[name] = {
            "ms": graph_ms(lambda: ops.flash_attention(q, k, v, q_offset=c0)),
            "sdpa_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask))}
    return out


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--measure":
        print(json.dumps(measure()), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_limits: no CUDA device", file=sys.stderr)
        return 2
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, patch in VARIANTS.items():
            tree = Path(tmp) / name
            shutil.copytree(ROOT / "src", tree / "src")
            if patch is not None:
                src = tree / "src" / KERNEL
                text = src.read_text()
                if text.count(patch[0]) != 1:
                    raise RuntimeError(f"{name}: the kernel source no longer "
                                       "has the line this variant patches")
                src.write_text(text.replace(patch[0], patch[1]))
            env = dict(os.environ, PYTHONPATH=str(tree / "src"),
                       REPRO_TORCH_BUILD_DIR=str(tree / "build"))
            run = subprocess.run([sys.executable, __file__, "--measure"],
                                 env=env, capture_output=True, text=True,
                                 timeout=600)
            if run.returncode:
                raise RuntimeError(f"{name}:\n{run.stderr[-3000:]}")
            results[name] = json.loads(run.stdout.strip().splitlines()[-1])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "device_ms": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

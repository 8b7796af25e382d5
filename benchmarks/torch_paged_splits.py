"""Paged decode attention against the split plan's two knobs.

Times the paged kernel (device time of a CUDA-graph replay, as
``chip_smoke.py`` phase 1 takes it) at the shapes phase 1 times it at —
8 sequences of 1836-2056 tokens, one sequence of 2048 tokens, and phase
3's lengths at its last decode step in its 65-page table; llama2-7b
widths, block 32, nbhd, bf16 — for each pair of
``paged_attention.BLOCKS_PER_SM`` (the blocks per SM the wrapper's split
plan aims for) and ``MIN_PAGES_PER_SPLIT`` (the fewest pages it gives a
split). Each setting is first checked against the plain version with
phase 1's one-step test. Prints one JSON line per setting and shape.

    PYTHONPATH=src python benchmarks/torch_paged_splits.py

Needs a CUDA device (it fails without one).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = [(bps, mp) for mp in (1, 4) for bps in (2, 4, 8, 16, 32, 64)]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_paged_splits: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    decode = [int(x) for x in torch.randint(
        1800, 2081, (8,), generator=torch.Generator().manual_seed(cs.SEED))]
    prompts = np.random.default_rng(cs.SEED).integers(
        cs.PROMPT_RANGE[0], cs.PROMPT_RANGE[1] + 1, cs.N_REQUESTS)
    width = -(-(cs.PROMPT_RANGE[1] + cs.MAX_NEW) // 32)
    shapes = {"timing shape": (decode, None), "one sequence": ([2048], None),
              "phase 3's lengths": ([int(n) + cs.MAX_NEW for n in prompts],
                                    width)}
    inputs = {name: cs._paged_inputs(gen, dev, "bfloat16", "nbhd", len(lens),
                                     32, 32, 128, 32, lens, wd)
              for name, (lens, wd) in shapes.items()}
    card = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    for bps, min_pages in SETTINGS:
        pa.BLOCKS_PER_SM, pa.MIN_PAGES_PER_SPLIT = bps, min_pages
        for name, args in inputs.items():
            got = ops.paged_attention(*args)
            cs._check(f"paged {name} at {bps} blocks per SM", got,
                      ref.paged_attention_ref(*args), "bfloat16", True)
            tok = int(args[4].sum())
            b_ms, _ = cs.bound(4.0 * 128 * 32 * tok, 2.0 * 2 * tok * 32 * 128
                               + 2.0 * 2 * args[0].shape[0] * 32 * 128,
                               "bfloat16")
            splits, pps = pa.split_plan(args[3].shape[1], args[0].shape[0],
                                        32, pa.sm_count(dev), bps,
                                        min_pages)
            ms, method = cs.device_ms(lambda: ops.paged_attention(*args))
            print(json.dumps({"card": card, "blocks_per_sm": bps,
                              "min_pages_per_split": min_pages,
                              "shape": name, "splits": splits,
                              "pages_per_split": pps, "device_ms": ms,
                              "method": method, "bound_ms": b_ms,
                              "share_of_bound": b_ms / ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

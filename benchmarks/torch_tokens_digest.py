"""Output-token digests of ``chip_smoke.py``'s serving phases for a
checkout, so two commits can be compared on one card.

    python benchmarks/torch_tokens_digest.py [ROOT] [--flash kernel|plain|sdpa]

ROOT (default: this checkout) holds ``chip_smoke.py`` and
``src/repro_torch``. Runs that checkout's phase 3 (the main path) and
phase 4 (the prefix-cache path, cached then cold) with llama2-7b's weights
from seed 0, and prints two JSON lines: every request's output tokens of
each run, then each run's sha256 (first 16 hex digits) of those tokens in
request order, as ``chip_smoke.tokens_digest`` computes it. Needs a CUDA
device.

``--flash`` routes prefill attention (default: the flash kernel) through
the float32 plain version, which rounds once at the output, or through
``scaled_dot_product_attention`` with the same mask (a library kernel on
the tensor cores). Only a run's tokens then mean anything: its launch
checks are skipped.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path


def digest(reqs) -> str:
    h = hashlib.sha256()
    for r in reqs:
        h.update(repr([int(t) for t in r.output_tokens]).encode())
    return h.hexdigest()[:16]


def sdpa_flash(q, k, v, *, causal=True, window=0, scale=None, q_offset=0,
               kv_len=None):
    """The flash op's function through scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F
    skv = k.shape[2]
    kv_len = skv if kv_len is None else kv_len
    qi = torch.arange(q.shape[2], device=q.device)[:, None] + q_offset
    kj = torch.arange(skv, device=q.device)[None, :]
    ok = kj < kv_len
    if causal:
        ok = ok & (kj <= qi)
    if window > 0:
        ok = ok & (qi - kj < window)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=ok, scale=scale,
                                          enable_gqa=k.shape[1] != q.shape[1])


def main() -> int:
    import torch
    args = argparse.ArgumentParser()
    args.add_argument("root", nargs="?",
                      default=str(Path(__file__).resolve().parents[1]))
    args.add_argument("--flash", choices=("kernel", "plain", "sdpa"),
                      default="kernel")
    args = args.parse_args()
    if not torch.cuda.is_available():
        print("torch_tokens_digest: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models import model as M

    if args.flash != "kernel":
        ops.flash_attention = (ref.flash_attention_ref
                               if args.flash == "plain" else sdpa_flash)
        chip_smoke.check_launched = lambda *a: None

    runs, tokens = [], []
    check = chip_smoke.check_outputs

    def recording_check(cfg, reqs):      # phase 3 once, phase 4 twice
        runs.append(digest(reqs))
        tokens.append([[int(t) for t in r.output_tokens] for r in reqs])
        return check(cfg, reqs)

    chip_smoke.check_outputs = recording_check
    _build.load()
    dev = torch.device("cuda", 0)
    params = M.init_params(get_config(chip_smoke.MODEL), seed=chip_smoke.SEED,
                           device=dev)
    chip_smoke.phase3(dev, params=params)
    torch.cuda.empty_cache()
    chip_smoke.phase4(dev, params)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    names = ("phase3", "phase4_cached", "phase4_cold")
    head = {"card": card, "root": str(root), "flash": args.flash}
    print(json.dumps({**head, "tokens": dict(zip(names, tokens))}),
          flush=True)
    print(json.dumps({**head, "tokens_sha256": dict(zip(names, runs))}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Training launcher: run ``make_train_artifacts`` for an assigned
architecture's ``train_4k`` cell on the one-card mesh, cut to
``--batch`` sequences of 4,096 tokens and ``--n-micro`` micro-batches
(PyTorch port of ``repro.launch.train``; XLA's compile at scale becomes a
run of a few steps on the card).

  python -m repro_torch.launch.train --arch qwen3-4b --batch 2 --n-micro 2 --steps 3

Weights are random from ``--seed``, tokens from ``default_rng(seed)``. It
prints each step's seconds, tokens/s, peak GiB and the MFU: the model's
FLOPs (``roofline.model_flops``, 6·N·D) over the step seconds and the
NOMINAL bf16 peak of an H100 SXM (989.4 TFLOP/s, the planner's
``h100-sxm``). ``--multi-pod`` raises (ROADMAP queue 1 item 14).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Any, Dict, Optional

import torch


def run_steps(arch: str, batch: int = 2, n_micro: int = 2, steps: int = 3,
              layers: Optional[int] = None, seed: int = 0,
              device=None) -> Dict[str, Any]:
    """One warmup step, then ``steps`` timed ones. Returns the seconds,
    tokens/s, losses, grad norms, peak GiB (card only) and MFU of each
    timed step (the MFU counts the arch's full depth, so it reads low for
    a ``layers`` cut)."""
    from repro_torch.launch.cells import get_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_artifacts, random_inputs
    from repro_torch.roofline.analysis import H100_SXM, model_flops
    from repro_torch.training.train_step import train_state_init

    mesh = make_mesh((1, 1), ("data", "model"), device)
    dev = mesh.device
    cell = dataclasses.replace(get_cell(arch, "train_4k"), batch=batch,
                               n_micro=n_micro)
    art = make_train_artifacts(
        cell, mesh, layer_override={"num_layers": layers} if layers else None)
    state = train_state_init(art.cfg, seed=seed, device=dev)
    tokens = batch * cell.seq_len
    flops = model_flops(arch, "train", tokens)
    out: Dict[str, Any] = {"arch": arch, "batch": batch, "n_micro": n_micro,
                           "seq_len": cell.seq_len,
                           "layers": art.cfg.num_layers, "steps": []}
    for i in range(steps + 1):
        batch_in = random_inputs(art.abstract_args[1], art.cfg.vocab_size,
                                 seed + i, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            if i == 1:
                torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state, metrics = art.fn(state, batch_in)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        dt = time.perf_counter() - t0
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise FloatingPointError(f"step {i}: loss {loss}, grad norm {gnorm}")
        if i == 0:
            out["warmup_s"] = dt
            continue
        out["steps"].append({"s": dt, "tokens_per_s": tokens / dt,
                             "loss": loss, "grad_norm": gnorm,
                             "mfu": flops / dt / H100_SXM.peak_flops})
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                       if dev.type == "cuda" else None)
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else dev.type)
    out["mfu_peak"] = f"{H100_SXM.name} nominal {H100_SXM.peak_flops:.4g}"
    return out


def main(argv=None) -> None:
    from repro_torch.configs import ASSIGNED
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b", choices=ASSIGNED)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3,
                    help="timed steps after one warmup step")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: the arch's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    ap.add_argument("--multi-pod", action="store_true",
                    help="not on one card: raises")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod: training on a mesh of ranks is not run yet — "
            "see ROADMAP queue 1 item 14 (a multi-GPU mesh)")
    print(json.dumps(run_steps(args.arch, args.batch, args.n_micro,
                               args.steps, args.layers, args.seed,
                               args.device)))


if __name__ == "__main__":
    main()

"""Serving launcher: build P's (prefill) and D's (decode) programs for an
assigned architecture on the one-card mesh and run them: prefill →
handoff → a few greedy decode steps, each program timed (PyTorch port of
``repro.launch.serve``'s ``compile_programs``; XLA's "compiled, GiB/chip"
becomes seconds and peak GiB of a run on the card).

  python -m repro_torch.launch.serve --arch qwen3-4b --shape decode_32k --batch 2

Weights are random from ``--seed``, tokens from ``default_rng(seed)``.
Every assigned arch's decode runs on the card: D's dense caches of a
sliding-window arch (mixtral-8x7b, recurrentgemma-9b) are rings of the
window and qwen1.5-32b's are float8 e4m3 (the handoff's cast), and both
go through the flash_decode kernel; the rest through flash.
``--layers`` cuts the depth. One card only:
``--multi-pod`` raises (ROADMAP queue 1 item 14).

``--demo`` runs ``examples/torch_serve_disagg.py --requests 8 --max-new
8`` in a subprocess, as the reference's ``--demo`` runs its example:
disaggregated serving of a ~100M-param model with a D failure and an
elastic join, or, with ``--two-process`` / ``--num-p`` / ``--num-d`` /
``--plan``, N x M worker processes over ``--connector shm``; on the card
unless ``--device cpu``.

  python -m repro_torch.launch.serve --demo [--connector rdma]
  python -m repro_torch.launch.serve --demo --num-p 2 --num-d 2 \\
      --connector shm
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional

import torch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gib(dev: torch.device) -> Optional[float]:
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


def run_programs(arch: str, shape: str = "decode_32k", batch: int = 2,
                 steps: int = 4, layers: Optional[int] = None, seed: int = 0,
                 device=None) -> Dict[str, Any]:
    """Prefill ``batch`` random prompts of the prefill cell's length, hand
    the caches to D and decode ``steps`` greedy tokens through the step
    builders on the one-card mesh. Returns each program's seconds, the
    peak GiB (card only), the tokens and the device's name."""
    from repro_torch.launch.cells import get_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (make_handoff_artifacts,
                                          make_prefill_artifacts,
                                          make_serve_artifacts, random_inputs)
    from repro_torch.models import model as M

    mesh = make_mesh((1, 1), ("data", "model"), device)
    dev = mesh.device
    cell = get_cell(arch, shape)
    if cell.skip:
        return {"arch": arch, "shape": shape, "skip": cell.skip}
    cell_p = get_cell(arch, "prefill_32k")
    cell_d = get_cell(arch, "decode_32k")
    cell_p = dataclasses.replace(cell_p, batch=batch)
    cell_d = dataclasses.replace(cell_d, batch=batch)
    override = {"num_layers": layers} if layers else None
    prefill = make_prefill_artifacts(cell_p, mesh, layer_override=override)
    serve = make_serve_artifacts(cell_d, mesh, layer_override=override)
    handoff = make_handoff_artifacts(arch, mesh, layer_override=override,
                                     batch=batch)
    params = M.init_params(prefill.cfg, seed=seed, device=dev)
    inputs = random_inputs(prefill.abstract_args[1], prefill.cfg.vocab_size,
                           seed, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    secs: Dict[str, Any] = {}
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        last, caches_p = prefill.fn(params, inputs)
        _sync(dev)
        secs["prefill"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        caches = handoff.fn(caches_p)
        _sync(dev)
        secs["handoff"] = time.perf_counter() - t0
        del caches_p
        pos = cell_p.seq_len
        tok = last.argmax(-1).to(torch.int32)[:, None]
        tokens = [tok]
        secs["decode"] = []
        for i in range(steps):
            io = {"tokens": tok,
                  "positions": torch.full_like(tok, pos + i)}
            t0 = time.perf_counter()
            logits, caches = serve.fn(params, caches, io, q_offset=pos + i)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            _sync(dev)
            secs["decode"].append(time.perf_counter() - t0)
            tokens.append(tok)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return {"arch": arch, "batch": batch, "seq_len": cell_d.seq_len,
            "layers": prefill.cfg.num_layers, "device": name,
            "seconds": secs, "peak_gib": _peak_gib(dev),
            "tokens": torch.cat(tokens, 1).tolist()}


def demo(connector: str = "inproc", two_process: bool = False,
         num_p: Optional[int] = None, num_d: Optional[int] = None,
         plan: bool = False, prefix_cache: bool = False,
         device: Optional[str] = None) -> None:
    """Run the serving example on 8 requests of 8 new tokens in a
    subprocess; a non-zero exit raises ``CalledProcessError``."""
    import os
    import subprocess
    import sys
    root = os.path.join(os.path.dirname(__file__), "..", "..", "..")
    cmd = [sys.executable,
           os.path.join(root, "examples", "torch_serve_disagg.py"),
           "--requests", "8", "--max-new", "8",
           "--connector", connector]
    if two_process:
        cmd.append("--two-process")
    if num_p is not None:
        cmd += ["--num-p", str(num_p)]
    if num_d is not None:
        cmd += ["--num-d", str(num_d)]
    if plan:
        cmd.append("--plan")
    if prefix_cache:
        cmd.append("--prefix-cache")
    if device is not None:
        cmd += ["--device", device]
    subprocess.run(cmd, check=True)


def main(argv=None) -> None:
    from repro_torch.configs import ASSIGNED
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b", choices=ASSIGNED)
    ap.add_argument("--shape", default="decode_32k",
                    choices=["prefill_32k", "decode_32k", "long_500k"])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4,
                    help="greedy decode steps after the handoff")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: the arch's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain routes")
    ap.add_argument("--multi-pod", action="store_true",
                    help="not on one card: raises")
    ap.add_argument("--demo", action="store_true",
                    help="run examples/torch_serve_disagg.py on 8 requests")
    ap.add_argument("--connector", default="inproc",
                    choices=["inproc", "shm", "rdma"],
                    help="KV-transport backend for the --demo serving loop")
    ap.add_argument("--two-process", action="store_true",
                    help="--demo only: run the P and D engines in separate "
                         "OS processes (requires --connector shm)")
    ap.add_argument("--num-p", type=int, default=None,
                    help="--demo only: prefill worker processes "
                         "(multi-process runtime; requires --connector shm)")
    ap.add_argument("--num-d", type=int, default=None,
                    help="--demo only: decode worker processes "
                         "(multi-process runtime; requires --connector shm)")
    ap.add_argument("--plan", action="store_true",
                    help="--demo only: size the topology with the planner "
                         "(plan_deployment → to_cluster_spec)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="--demo only: enable the shared-prefix KV cache "
                         "(prefill-compute and wire-byte skipping plus "
                         "cache-aware D routing)")
    args = ap.parse_args(argv)
    if args.demo:
        demo(args.connector, args.two_process, args.num_p, args.num_d,
             args.plan, args.prefix_cache, args.device)
        return
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod needs a torch.distributed mesh — see ROADMAP "
            "queue 1 item 14 (a multi-GPU mesh)")
    rec = run_programs(args.arch, args.shape, args.batch, args.steps,
                       args.layers, args.seed, args.device)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()

"""Serving launcher: build P's (prefill) and D's (decode) programs for an
assigned architecture on a mesh and run them: prefill → handoff → a few
greedy decode steps, each program timed (PyTorch port of
``repro.launch.serve``'s ``compile_programs``; XLA's "compiled, GiB/chip"
becomes seconds and peak GiB of a run on the card).

  python -m repro_torch.launch.serve --arch qwen3-4b --shape decode_32k --batch 2
  python -m repro_torch.launch.serve --arch qwen3-4b --mesh 1x2

``--mesh DxM`` (data x model) runs the programs on a mesh of D x M
ranks: ``1x2`` tensor parallelism on a model axis of 2, ``2x1`` the
batch split over a data axis of 2, and ``--multi-pod`` adds a pod axis
of 2 in front (``(pod 2, data D, model M)``, the data axes ``("pod",
"data")``): a world of as many ranks (``launch/ranks.py``; gloo when they
share one card, their collectives' tensors crossing in the card's
memory, NCCL when each has its own), each holding the shards and batch
rows the launch layer's specs give it and computing with the
collectives they force. It prints one record: each program's seconds
(rank 0's), the backend, every rank's peak GiB, its parameter and cache
bytes beside ``per_chip_bytes``, its collective seconds on the host clock
and the tokens (the logits gathered over the model axis's vocab shards
and the data axes' rows for the greedy tokens). Ranks on one card run
the many-card program — the same shards, collectives and bytes a rank —
but not its time. Every family serves there: dense, MoE, MLA
(DeepSeek-V2-Lite), ring (Mixtral-8x7B), RG-LRU hybrid
(RecurrentGemma-9B), SSD (Mamba2-370M), vision (InternVL2-2B, patches
before the prompt) and encoder-decoder (Whisper-large-v3, frames for the
encoder), D's caches float8 for qwen1.5-32b.

Weights are random from ``--seed``, tokens from ``default_rng(seed)``.
Every assigned arch's decode runs on the card: D's dense caches of a
sliding-window arch (mixtral-8x7b, recurrentgemma-9b) are rings of the
window and qwen1.5-32b's are float8 e4m3 (the handoff's cast), and both
go through the flash_decode kernel; the rest through flash.
``--layers`` cuts the depth.

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
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
                 device=None, mesh: Tuple[int, ...] = (1, 1),
                 keep_logits: bool = False) -> Dict[str, Any]:
    """Prefill ``batch`` random prompts of the prefill cell's length, hand
    the caches to D and decode ``steps`` greedy tokens through the step
    builders (``shape="prefill_32k"`` or ``steps=0``: the prefill alone).
    ``mesh`` (data, model) or (pod, data, model): the one-card mesh by
    default, or a world of as many ranks (``launch.ranks``). Every rank,
    the lone one included, runs ``programs_on_rank``; returns their
    ``mesh_record`` (each program's seconds, the tokens, the device's
    name, per rank peak GiB, bytes, collectives and launches) with the
    arch, batch and mesh. ``keep_logits`` adds the prefill's last logits
    (float32, gathered)."""
    from repro_torch import device as _dev
    from repro_torch.launch import ranks
    from repro_torch.launch.cells import get_cell
    cell = get_cell(arch, shape)
    if cell.skip:
        return {"arch": arch, "shape": shape, "skip": cell.skip}
    args = (arch, shape, batch, steps, layers, seed, tuple(mesh), (),
            keep_logits)
    if math.prod(mesh) > 1:
        with ranks.start(math.prod(mesh), device) as world:
            recs = world.run(programs_on_rank, *args)
        backend = world.backend
    else:
        alone = ranks.Rank(0, 1, None, _dev.resolve(device))
        recs, backend = [programs_on_rank(alone, *args)], None
    return {"arch": arch, "batch": batch, "mesh": list(mesh),
            **mesh_record(recs, backend)}


def programs_on_rank(rank, arch: str, shape: str, batch: int, steps: int,
                     layers: Optional[int], seed: int,
                     mesh_shape: Tuple[int, ...],
                     check_layers: Sequence[int] = (),
                     keep_logits: bool = False) -> Dict[str, Any]:
    """One rank's part of ``run_programs`` (run by ``launch.ranks`` on a
    mesh of ranks; called directly on the one-card mesh, where the
    collectives are the identity): its mesh, its shards of the seed's
    weights (drawn whole one layer at a time and cut,
    ``sharding.param_keeper``), the same prompts on every rank (each step
    cuts them to the rank's rows), then prefill → handoff → ``steps``
    greedy steps, the logits gathered over the model and data axes for
    each token. Returns the rank's record (CPU values): seconds, peak
    GiB, bytes beside ``per_chip_bytes``, collective calls / seconds /
    bytes, launches, tokens, the handoff check of ``check_layers`` (layers
    in model order), and, when ``keep_logits``, the gathered prefill
    logits and each decode step's (float32)."""
    import gc
    from repro_torch.configs.base import torch_dtype
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.cells import get_cell
    from repro_torch.launch.mesh import data_axes, make_mesh
    from repro_torch.launch.steps import (make_handoff_artifacts,
                                          make_prefill_artifacts,
                                          make_serve_artifacts, random_inputs)
    from repro_torch.models import collectives as C
    from repro_torch.models import model as M
    dev = rank.device
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    mesh = make_mesh(mesh_shape, mesh_axes(mesh_shape), dev)
    shard = mesh.axis_shard("model")
    rows = mesh.axis_shard(data_axes(mesh))
    sizes = mesh.shape
    override = {"num_layers": layers} if layers else None
    cell_p = dataclasses.replace(get_cell(arch, "prefill_32k"), batch=batch)
    cell_d = dataclasses.replace(get_cell(arch, "decode_32k"), batch=batch)
    decode = steps > 0 and shape != "prefill_32k"
    pre = make_prefill_artifacts(cell_p, mesh, layer_override=override)
    pspecs, cspecs_p = pre.in_shardings[0], pre.out_shardings[1]
    params = M.init_params(pre.cfg, seed=seed, device=dev,
                           keep=SH.param_keeper(pspecs, mesh))
    inputs = random_inputs(pre.abstract_args[1], pre.cfg.vocab_size, seed,
                           dev)
    abs_p = M.abstract_caches(pre.cfg, batch, cell_p.seq_len,
                              torch_dtype(cell_p.cache_dtype),
                              mem_len=pre.cfg.max_source_len
                              if pre.cfg.is_enc_dec else 0)
    nbytes = {"params": [SH.local_bytes(params), SH.per_chip_bytes(
        pre.abstract_args[0], pspecs, sizes)]}

    def gathered(logits):
        whole = C.all_gather(logits, logits.dim() - 1, shard)
        if logits.shape[0] * (rows.size if rows else 1) == batch:
            whole = C.all_gather(whole, 0, rows)
        return whole

    C.reset_stats()
    ops.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    secs: Dict[str, Any] = {}
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else dev.type
    rec: Dict[str, Any] = {"rank": rank.index, "backend": rank.backend,
                           "device": name}
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        last, caches_p = pre.fn(params, inputs)
        last = gathered(last)
        _sync(dev)
        secs["prefill"] = time.perf_counter() - t0
        nbytes["caches_p"] = [SH.local_bytes(caches_p), SH.per_chip_bytes(
            abs_p, cspecs_p, sizes)]
        tok = last.argmax(-1).to(torch.int32)[:, None]
        tokens = [tok]
        if keep_logits:
            rec["prefill_logits"] = last.float().cpu()
        if decode:
            serve = make_serve_artifacts(cell_d, mesh,
                                         layer_override=override)
            ho = make_handoff_artifacts(arch, mesh, layer_override=override,
                                        batch=batch)
            t0 = time.perf_counter()
            caches = ho.fn(caches_p)
            _sync(dev)
            secs["handoff"] = time.perf_counter() - t0
            nbytes["caches_d"] = [SH.local_bytes(caches), SH.per_chip_bytes(
                serve.abstract_args[1], serve.in_shardings[1], sizes)]
            rec["handoff_held"] = {
                int(i): handoff_held(caches_p, caches, i, ho, mesh)
                for i in check_layers}
            del caches_p
            pos = cell_p.seq_len
            secs["decode"] = []
            steps_logits = []
            for i in range(steps):
                io = {"tokens": tok,
                      "positions": torch.full_like(tok, pos + i)}
                t0 = time.perf_counter()
                logits, caches = serve.fn(params, caches, io,
                                          q_offset=pos + i)
                row = gathered(logits[:, -1])
                tok = row.argmax(-1).to(torch.int32)[:, None]
                _sync(dev)
                secs["decode"].append(time.perf_counter() - t0)
                tokens.append(tok)
                if keep_logits:
                    steps_logits.append(row.float().cpu())
            if keep_logits:
                rec["step_logits"] = steps_logits
            del caches
        else:
            del caches_p
    rec.update(seconds=secs, peak_gib=_peak_gib(dev), bytes=nbytes,
               collectives=C.stats(), launches=ops.launch_counts(),
               tokens=torch.cat(tokens, 1).tolist(),
               layers=pre.cfg.num_layers)
    return rec


def handoff_held(caches_p, caches_d, layer: int, ho, mesh) -> bool:
    """Whether the rank's D shards of layer ``layer`` (in model order: a
    KV cache or latent, a ring with its tags, an RG-LRU or SSM state, a
    decoder layer's cross rows and memory length), gathered
    over the model axis, are bit for bit the realignment
    (``steps.realign_caches``: head slice, capacity pad, cast) of P's
    shards of it gathered likewise: the handoff's reshard held to a direct
    slice of the whole. A collective: every rank calls it."""
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import realign_caches
    from repro_torch.models import collectives as C
    from repro_torch.models import model as M
    shard = mesh.axis_shard("model")
    where = [(gi, pi, li) for gi, g in enumerate(M.block_groups(ho.cfg))
             for li in range(g.count) for pi in range(len(g.kinds))]
    if not 0 <= layer < len(where):
        raise IndexError(f"no layer {layer}")
    gi, pi, li = where[layer]

    def whole(c, specs):
        out = {}
        for name, x in vars(c).items():
            if isinstance(x, torch.Tensor):
                d = SH.model_dim(specs[f"[{gi}][{pi}].{name}"])
                x = x[li:li + 1]
                out[name] = x if d is None else C.all_gather(x, d, shard)
        return dataclasses.replace(c, **out)

    got = whole(caches_d[gi][pi], ho.out_shardings)
    want = realign_caches(whole(caches_p[gi][pi], ho.in_shardings[0]), got)
    return all(torch.equal(_raw(a), _raw(b)) for (_, a), (_, b) in
               zip(SH.named_leaves(want), SH.named_leaves(got)))


def _raw(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def mesh_axes(shape: Sequence[int]) -> Tuple[str, ...]:
    """The axis names of a (data, model) or (pod, data, model) mesh."""
    if len(shape) == 2:
        return ("data", "model")
    if len(shape) == 3:
        return ("pod", "data", "model")
    raise ValueError(f"a mesh of {len(shape)} axes: (data, model) or "
                     "(pod, data, model)")


def parse_mesh(text: str, multi_pod: bool) -> Tuple[int, ...]:
    """``--mesh DxM`` (and ``--multi-pod``: a pod axis of 2 in front) as
    the mesh's shape."""
    shape = tuple(int(n) for n in text.lower().split("x"))
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"--mesh {text}: data x model, e.g. 1x2")
    return (2,) + shape if multi_pod else shape


def mesh_record(recs: List[Dict[str, Any]], backend: Optional[str]) -> Dict[str, Any]:
    """The launcher's record of a run from the ranks' records: rank 0's
    seconds, tokens (every rank's must agree) and device, the backend
    (None for the one-card mesh), and per rank its peak GiB, bytes beside
    ``per_chip_bytes``, collectives and launches."""
    first = recs[0]
    if any(r["tokens"] != first["tokens"] for r in recs):
        raise AssertionError("the ranks' greedy tokens differ")
    out = {"backend": backend, "seconds": first["seconds"],
           "tokens": first["tokens"], "layers": first["layers"],
           "device": first["device"],
           "ranks": [{k: r[k] for k in ("rank", "device", "peak_gib",
                                         "bytes", "collectives", "launches")}
                     for r in recs]}
    for key in ("handoff_held", "prefill_logits", "step_logits"):
        if key in first:
            out[key] = first[key]
    if "handoff_held" in first:
        out["handoff_held_all_ranks"] = all(
            all(r["handoff_held"].values()) for r in recs)
    return out


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
    ap.add_argument("--mesh", default="1x1",
                    help="data x model, e.g. 1x2: tensor parallelism on a "
                         "model axis of 2, 2x1: the batch on a data axis "
                         "of 2; one process a rank")
    ap.add_argument("--multi-pod", action="store_true",
                    help="a pod axis of 2 in front of --mesh (pod, data, "
                         "model)")
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
    try:
        mesh = parse_mesh(args.mesh, args.multi_pod)
    except ValueError as e:
        ap.error(str(e))
    rec = run_programs(args.arch, args.shape, args.batch, args.steps,
                       args.layers, args.seed, args.device, mesh=mesh)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()

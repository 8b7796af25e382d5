"""Training launcher: run ``make_train_artifacts`` for an assigned
architecture's ``train_4k`` cell, cut to ``--batch`` sequences of 4,096
tokens and ``--n-micro`` micro-batches, on the one-card mesh or a mesh of
ranks (PyTorch port of ``repro.launch.train``; XLA's compile at scale
becomes a run of a few steps on the card).

  python -m repro_torch.launch.train --arch qwen3-4b --batch 2 --n-micro 2 --steps 3
  python -m repro_torch.launch.train --arch qwen3-4b --mesh 2x1 --n-micro 1
  python -m repro_torch.launch.train --arch phi3-medium-14b --mesh 1x2 --multi-pod

``--mesh DxM`` (data x model) runs the step on a world of D x M ranks
(``launch/ranks.py``), and ``--multi-pod`` puts a pod axis of 2 in front
(``(pod 2, data D, model M)``, the data axes ``("pod", "data")``): each
rank draws the seed's weights one layer at a time and keeps its shards
(tensor-parallel on the model axis; ZeRO-1 moments on the data axes, and
ZeRO-3 weights for a ``zero3`` cell), and takes its rows of every batch.

Weights are random from ``--seed``, tokens from ``default_rng(seed)``. It
prints each step's seconds, tokens/s, peak GiB and the MFU: the model's
FLOPs (``roofline.model_flops``, 6·N·D over the world's tokens) over the
step seconds and the NOMINAL bf16 peak of an H100 SXM (989.4 TFLOP/s, the
planner's ``h100-sxm``) times the number of ranks. On a mesh it also
prints each rank's step seconds, peak GiB and bytes of parameters and
moments beside ``sharding.per_chip_bytes``. Ranks that share one card run
the many-card program — the same shards, collectives and bytes — but not
its time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch


def run_steps(arch: str, batch: int = 2, n_micro: int = 2, steps: int = 3,
              layers: Optional[int] = None, seed: int = 0,
              device=None, mesh: Tuple[int, ...] = (1, 1)
              ) -> Dict[str, Any]:
    """One warmup step, then ``steps`` timed ones, on the one-card mesh or
    (``mesh`` of more than one device) every rank of a world. Returns the
    seconds, tokens/s, losses, grad norms, peak GiB (card only) and MFU of
    each timed step (rank 0's; the MFU counts the arch's full depth, so it
    reads low for a ``layers`` cut) and, on a mesh, every rank's
    record."""
    from repro_torch import device as _dev
    from repro_torch.launch import ranks
    args = (arch, batch, n_micro, steps, layers, seed, tuple(mesh))
    if math.prod(mesh) > 1:
        with ranks.start(math.prod(mesh), device) as world:
            recs = world.run(steps_on_rank, *args)
        backend = world.backend
    else:
        alone = ranks.Rank(0, 1, None, _dev.resolve(device))
        recs, backend = [steps_on_rank(alone, *args)], None
    out = dict(recs[0])
    out["mesh"], out["backend"] = list(mesh), backend
    if len(recs) > 1:
        out["ranks"] = [{k: r[k] for k in ("rank", "step_s", "peak_gib",
                                            "bytes", "collectives")}
                        for r in recs]
    return out


def steps_on_rank(rank, arch: str, batch: int, n_micro: int, steps: int,
                  layers: Optional[int], seed: int,
                  mesh_shape: Sequence[int]) -> Dict[str, Any]:
    """One rank's part of ``run_steps`` (called directly on the one-card
    mesh): its mesh, its shards of the seed's train state
    (``train_state_on_rank``), each step's whole batch (the step cuts its
    rows). Returns the rank's record (CPU values)."""
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.serve import mesh_axes
    from repro_torch.models import collectives as C
    from repro_torch.roofline.analysis import H100_SXM, model_flops
    dev = rank.device
    art, state = train_state_on_rank(arch, batch, n_micro, layers, seed,
                                     mesh_shape, dev)
    mesh = art.mesh
    cell_len = art.abstract_args[1]["tokens"].shape[1]
    tokens = batch * cell_len
    ranks_n = math.prod(mesh_shape)
    flops = model_flops(arch, "train", tokens)
    peak = H100_SXM.peak_flops * ranks_n
    abs_state = art.abstract_args[0]
    moments = {"mu": state.opt["mu"], "nu": state.opt["nu"]}
    out: Dict[str, Any] = {
        "arch": arch, "batch": batch, "n_micro": n_micro,
        "seq_len": cell_len, "layers": art.cfg.num_layers,
        "mesh_axes": list(mesh_axes(mesh_shape)), "rank": rank.index,
        "steps": [], "step_s": [],
        "bytes": {"params": [SH.local_bytes(state.params), SH.per_chip_bytes(
            abs_state.params, state_specs(art, ".params"), mesh.shape)],
            "moments": [SH.local_bytes(moments), SH.per_chip_bytes(
                {"mu": abs_state.opt["mu"], "nu": abs_state.opt["nu"]},
                state_specs(art, ".opt"), mesh.shape)]}}
    C.reset_stats()
    for i in range(steps + 1):
        batch_in = train_batch(art, seed + i, dev)
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
        out["step_s"].append(dt)
        out["steps"].append({"s": dt, "tokens_per_s": tokens / dt,
                             "loss": loss, "grad_norm": gnorm,
                             "mfu": flops / dt / peak})
    out["collectives"] = C.stats()
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                       if dev.type == "cuda" else None)
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else dev.type)
    out["mfu_peak"] = (f"{H100_SXM.name} nominal {H100_SXM.peak_flops:.4g}"
                       f" x {ranks_n}")
    return out


def train_state_on_rank(arch: str, batch: int, n_micro: int,
                        layers: Optional[int], seed: int,
                        mesh_shape: Sequence[int], dev):
    """The train artifacts of ``arch``'s ``train_4k`` cell at ``batch``
    and ``n_micro`` on the calling rank's mesh of ``mesh_shape`` (the
    one-card mesh for a shape of one device) and the rank's train state:
    the seed's weights drawn one layer at a time, each rank keeping its
    shards (``sharding.param_keeper``), and zero moments at the rank's
    shapes. Returns (artifacts, state)."""
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.cells import get_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import mesh_axes
    from repro_torch.launch.steps import make_train_artifacts
    from repro_torch.models import model as M
    from repro_torch.training.train_step import TrainState
    from repro_torch.training.tree import leaves_with_paths, unflatten
    mesh = make_mesh(tuple(mesh_shape), mesh_axes(mesh_shape), dev)
    cell = dataclasses.replace(get_cell(arch, "train_4k"), batch=batch,
                               n_micro=n_micro)
    art = make_train_artifacts(
        cell, mesh, layer_override={"num_layers": layers} if layers else None)
    params = M.init_params(art.cfg, seed=seed, device=mesh.device,
                           keep=SH.param_keeper(state_specs(art, ".params"),
                                                mesh))
    whole = art.abstract_args[0].opt
    ospecs = state_specs(art, ".opt")
    opt = {key: unflatten(whole[key], [      # zeros at the rank's shapes
        torch.zeros(SH.local_shape(tuple(x.shape), ospecs[f"['{key}']{p}"],
                                   mesh), dtype=x.dtype, device=mesh.device)
        for p, x in leaves_with_paths(whole[key])]) for key in ("mu", "nu")}
    opt["step"] = torch.zeros((), dtype=torch.int32, device=mesh.device)
    return art, TrainState(params=params, opt=opt)


def state_specs(art, prefix: str) -> Dict[str, Any]:
    """The train artifacts' specs of the state's ``prefix`` (".params" or
    ".opt") subtree, keyed by the paths within it."""
    return {p[len(prefix):]: s for p, s in art.in_shardings[0].items()
            if p.startswith(prefix)}


def train_batch(art, seed: int, dev) -> Dict[str, torch.Tensor]:
    """A whole batch of ``art``'s cell drawn from ``seed``
    (``steps.random_inputs``), on ``dev``."""
    from repro_torch.launch.steps import random_inputs
    return random_inputs(art.abstract_args[1], art.cfg.vocab_size, seed, dev)


def main(argv=None) -> None:
    from repro_torch.configs import ASSIGNED
    from repro_torch.launch.serve import parse_mesh
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
    ap.add_argument("--mesh", default="1x1",
                    help="data x model, e.g. 2x1: the batch on a data axis "
                         "of 2; one process a rank")
    ap.add_argument("--multi-pod", action="store_true",
                    help="a pod axis of 2 in front of --mesh (pod, data, "
                         "model)")
    args = ap.parse_args(argv)
    try:
        mesh = parse_mesh(args.mesh, args.multi_pod)
    except ValueError as e:
        ap.error(str(e))
    print(json.dumps(run_steps(args.arch, args.batch, args.n_micro,
                               args.steps, args.layers, args.seed,
                               args.device, mesh)))


if __name__ == "__main__":
    main()

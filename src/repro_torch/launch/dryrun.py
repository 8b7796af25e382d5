"""Dry run of the cell grid on the abstract production mesh (PyTorch port
of ``repro.launch.dryrun``): for every (architecture × input shape) cell,
the per-chip bytes of the step's arguments and outputs from the sharding
rules, and the step's FLOPs counted on ``meta`` at full depth as the card
runs it (the whole program, divided by the chips), with the roofline
terms on the NOMINAL H100 SXM constants (``roofline.H100_SXM``) and
``useful_ratio``. Nothing is allocated or computed.

  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --mesh both --out dryrun.jsonl

Each cell gives one JSON record with the reference's keys where they have
a counterpart: {arch, shape, mode, mesh, seq_len, batch, n_micro,
cache_dtype, ok, seconds, memory_analysis {argument_size_in_bytes,
output_size_in_bytes, alias_size_in_bytes}, roofline {flops_per_chip,
hbm_bytes_per_chip, wire_bytes_per_chip, seconds, dominant,
model_flops_global, useful_ratio, hw}}, or ``skip``. XLA's temporaries,
compiled code size and collective bytes have none (there is no compiled
program); the wire is 0, and the count covers products only
(``roofline.count_flops``). ``alias_size_in_bytes`` is the outputs that
are arguments updated in place (the decode caches, the train state);
the HBM bytes count them once. Every runnable cell has a route on the
card: a ring-buffer or float8 decode cache is counted as the flash_decode
kernel scores it (each row's visible slots).

  python -m repro_torch.launch.dryrun --handoff [--arch A] [--out F]

gives one record per arch of the P→D handoff program's bytes
(``run_handoffs``).
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Any, Dict, List, Optional

from repro_torch.configs import ASSIGNED
from repro_torch.launch import sharding as SH
from repro_torch.launch.cells import Cell, get_cell, make_cells
from repro_torch.launch.mesh import make_production_mesh, shape_only
from repro_torch.launch.steps import (StepArtifacts, make_artifacts,
                                      make_handoff_artifacts)
from repro_torch.roofline import analysis as RA


def _bytes_per_chip(tree: Any, specs: Any, sizes: Dict[str, int]) -> int:
    """Per-chip bytes of one argument or output: a {path: spec} over a
    tree, or a single tensor's spec."""
    if isinstance(specs, dict):
        return SH.per_chip_bytes(tree, specs, sizes)
    return tree.numel() * tree.element_size() // SH.spec_ways(specs, sizes)


def memory_per_chip(art: StepArtifacts, outputs: Any) -> Dict[str, int]:
    sizes = art.mesh.shape
    args = sum(_bytes_per_chip(a, s, sizes)
               for a, s in zip(art.abstract_args, art.in_shardings))
    outs = sum(_bytes_per_chip(o, s, sizes)
               for o, s in zip(outputs, art.out_shardings))
    seen = SH.storage_ids(art.abstract_args)
    alias = sum(SH.per_chip_bytes(o, s, sizes, only=seen)
                for o, s in zip(outputs, art.out_shardings)
                if isinstance(s, dict))
    return {"argument_size_in_bytes": int(args),
            "output_size_in_bytes": int(outs),
            "alias_size_in_bytes": int(alias)}


def run_cell(cell: Cell, mesh_kind: str, *, hw: RA.HW = RA.H100_SXM,
             verbose: bool = True) -> Dict[str, Any]:
    rec: Dict[str, Any] = {
        "arch": cell.arch, "shape": cell.shape, "mode": cell.mode,
        "mesh": mesh_kind, "seq_len": cell.seq_len, "batch": cell.batch,
        "n_micro": cell.n_micro, "cache_dtype": cell.cache_dtype,
    }
    if cell.skip:
        rec["ok"] = None
        rec["skip"] = cell.skip
        if verbose:
            print(f"[skip] {cell.name} ({mesh_kind}): {cell.skip}",
                  flush=True)
        return rec
    mesh = shape_only(make_production_mesh(multi_pod=(mesh_kind == "multi")))
    chips = mesh.size
    t0 = time.time()
    try:
        art = make_artifacts(cell, mesh)
        flops, _, out = RA.count_flops(art.fn, *art.abstract_args)
        rec["ok"] = True
        rec["seconds"] = {"count": round(time.time() - t0, 1)}
        rec["memory_analysis"] = memory_per_chip(art, out)
        ma = rec["memory_analysis"]
        terms = RA.RooflineTerms(
            flops=flops / chips,
            hbm_bytes=float(ma["argument_size_in_bytes"]
                            + ma["output_size_in_bytes"]
                            - ma["alias_size_in_bytes"]))
        tokens = cell.batch * (cell.seq_len if cell.mode != "decode" else 1)
        rec["roofline"] = {
            "flops_per_chip": terms.flops,
            "hbm_bytes_per_chip": terms.hbm_bytes,
            "wire_bytes_per_chip": terms.wire_bytes,
            "seconds": terms.seconds(hw),
            "dominant": terms.dominant(hw),
            "model_flops_global": RA.model_flops(cell.arch, cell.mode,
                                                 tokens),
            "useful_ratio": RA.useful_ratio(cell.arch, cell.mode, tokens,
                                            flops),
            "hw": f"{hw.name} (nominal)",
        }
        if verbose:
            r = rec["roofline"]
            print(f"[ok] {cell.name}:{cell.mode} ({mesh_kind}, {chips}ch) "
                  f"args/chip {ma['argument_size_in_bytes'] / 2**30:.2f} GiB"
                  f", {r['flops_per_chip']:.3e} FLOP/chip → "
                  f"{r['dominant']}-bound, useful {r['useful_ratio']:.2f}",
                  flush=True)
    except Exception as e:            # a record per cell, as the reference
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {str(e)[:400]}"
        if verbose:
            print(f"[FAIL] {cell.name}:{cell.mode} ({mesh_kind}): "
                  f"{rec['error']}", flush=True)
            traceback.print_exc(limit=3)
    return rec


def run_handoffs(arch: Optional[str], out: Optional[str] = None, *,
                 verbose: bool = True) -> List[Dict[str, Any]]:
    """The P→D cache-realignment program (the paper's compatible
    transmission module) of each arch on the abstract production mesh,
    run once on ``meta``: one record of its bytes an arch (the reference's
    ``run_handoffs``). ``kv_bytes_global``: P's caches, the prefill cell's
    32 sequences (the reference's number); ``d_bytes_global``: D's, with
    the capacity pad, the rings of a window and the float8 cast of
    qwen1.5-32b; ``memory_analysis``: both per chip under their specs. The
    reference's ``wire_bytes_per_chip`` and ``by_kind`` read XLA's
    collectives; the port has no collective program (ROADMAP B12), so they
    are 0 and empty."""
    mesh = shape_only(make_production_mesh())
    archs = ASSIGNED if arch in (None, "all") else [arch]
    if verbose:
        print("| arch | P's KV bytes (32-seq batch) | D's bytes | "
              "args / outputs per chip |")
    records = []
    for a in archs:
        try:
            art = make_handoff_artifacts(a, mesh)
            caches_d = art.fn(*art.abstract_args)
            sizes = art.mesh.shape
            ma = {"argument_size_in_bytes": SH.per_chip_bytes(
                      art.abstract_args[0], art.in_shardings[0], sizes),
                  "output_size_in_bytes": SH.per_chip_bytes(
                      caches_d, art.out_shardings, sizes)}
            rec = {"arch": a, "kind": "handoff",
                   "kv_bytes_global": RA.tree_bytes(art.abstract_args[0]),
                   "d_bytes_global": RA.tree_bytes(caches_d),
                   "memory_analysis": ma, "wire_bytes_per_chip": 0.0,
                   "by_kind": {}, "ok": True}
            if verbose:
                print(f"| {a} | {rec['kv_bytes_global'] / 2**30:.2f} GiB | "
                      f"{rec['d_bytes_global'] / 2**30:.2f} GiB | "
                      f"{ma['argument_size_in_bytes'] / 2**20:.1f} / "
                      f"{ma['output_size_in_bytes'] / 2**20:.1f} MiB |",
                      flush=True)
        except Exception as e:        # a record per arch, as the reference
            rec = {"arch": a, "kind": "handoff", "ok": False,
                   "error": f"{type(e).__name__}: {str(e)[:300]}"}
            if verbose:
                print(f"| {a} | FAILED {rec['error'][:120]} |", flush=True)
        records.append(rec)
        if out:
            with open(out, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=ASSIGNED + ["all"],
                    help="architecture id (--all for every arch)")
    ap.add_argument("--shape", default=None,
                    choices=["train_4k", "prefill_32k", "decode_32k",
                             "long_500k"])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape) cell")
    ap.add_argument("--handoff", action="store_true",
                    help="the P→D handoff program's bytes per arch")
    ap.add_argument("--out", default=None, help="append JSON records here")
    args = ap.parse_args(argv)
    if args.handoff:
        if not all(r["ok"] for r in run_handoffs(args.arch, args.out)):
            raise SystemExit(1)
        return

    if args.all or args.arch in (None, "all"):
        cells = make_cells()
        if args.shape:
            cells = [c for c in cells if c.shape == args.shape]
    else:
        cells = ([get_cell(args.arch, args.shape)] if args.shape
                 else make_cells([args.arch]))
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    records = []
    for cell in cells:
        for mk in meshes:
            rec = run_cell(cell, mk)
            records.append(rec)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(json.dumps(rec) + "\n")
    n_ok = sum(1 for r in records if r["ok"])
    n_skip = sum(1 for r in records if r["ok"] is None)
    n_fail = sum(1 for r in records if r["ok"] is False)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED "
          f"of {len(records)}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

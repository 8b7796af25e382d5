"""What the ranks of ``tests/test_torch_mesh_train.py`` and
``tests/test_torch_mesh_train_families*.py`` run: module-level
functions, which the spawned rank processes import by name — this module
imports nothing of JAX or of the JAX package, so neither do they.

Each takes the tiny config as a dict and the port's cells, since a rank
process starts from a fresh interpreter.
"""
import dataclasses
import functools

import torch

from repro_torch.configs.base import config_from_dict
from repro_torch.launch import cells as TC
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as TS
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import mesh_axes
from repro_torch.models import collectives as C
from repro_torch.models import model as M
from repro_torch.training import compression as Z
from repro_torch.training import optim as O
from repro_torch.training.tree import leaves_with_paths

_ADAMW = O.AdamWConfig
_DCTX = TS._dctx


def _patch(cfg_dict, cells=None, opt=None, ctx=None):
    """The tiny config (and ``cells``) for the launch layer's builders,
    the train step's AdamW config (the default, or with the fields
    ``opt`` gives) and its distribution context (with the fields ``ctx``
    gives, e.g. ``moe_capacity_factor``) — set on every call: the rank
    process outlives it."""
    cfg = config_from_dict(cfg_dict)
    TS.get_config = lambda arch: cfg
    TS.AdamWConfig = functools.partial(_ADAMW, **(opt or {}))
    TS._dctx = _DCTX if not ctx else (
        lambda *a, **k: dataclasses.replace(_DCTX(*a, **k), **ctx))
    if cells is not None:
        TS.get_cell = TC.get_cell = lambda arch, shape: cells[shape]
    return cfg


def _mesh(shape, device="cpu"):
    return make_mesh(tuple(shape), mesh_axes(shape), device)


def _flat(tree):
    return {p: x.detach().clone() for p, x in leaves_with_paths(tree)
            if isinstance(x, torch.Tensor)}


def _own(tree):
    """A copy of a tree the parent handed over: its CPU tensors reach
    every rank as one shared-memory copy, which an in-place update would
    change for all of them."""
    return SH.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                       else x, tree)


def _cpu(tree):
    return SH.tree_map(lambda x: x.detach().cpu()
                       if isinstance(x, torch.Tensor) else x, tree)


def grads_on_rank(rank, cfg_dict, cell, shape, state, batch, skip=(),
                  ctx=None, on_card=False):
    """The train step's loss and the rank's reduced gradients
    (``fn.grads``) over the whole ``state`` and ``batch`` on the rank's
    mesh of ``shape`` (its context's fields ``ctx`` replaced; on the
    rank's card with ``on_card``), with the collectives ``skip`` names
    left out (a control, ``collectives.skipping``), keyed as the state's
    specs key them (".params...", on the host); also the collectives it called and the
    specs."""
    _patch(cfg_dict, ctx=ctx)
    art = TS.make_train_artifacts(
        cell, _mesh(shape, rank.device if on_card else "cpu"))
    C.reset_stats()
    with C.skipping(*skip):
        loss, grads = art.fn.grads(state, batch)
    return {"loss": float(loss),
            "grads": {".params" + p: x.cpu()
                      for p, x in _flat(grads).items()},
            "collectives": C.stats(), "specs": art.in_shardings[0]}


def steps_on_rank(rank, cfg_dict, cell, shape, state, batches, opt=None,
                  skip=(), ctx=None):
    """The train step (AdamW with the fields ``opt`` gives; the context's
    fields ``ctx`` replaced) over each of ``batches`` in turn from the
    whole ``state``, the collectives ``skip`` names left out (a control,
    ``collectives.skipping``):
    each step's metrics and the rank's final state (its parameters,
    ZeRO-1 moment slices and step) with the specs."""
    _patch(cfg_dict, opt=opt, ctx=ctx)
    art = TS.make_train_artifacts(cell, _mesh(shape))
    metrics, state = [], _own(state)
    for b in batches:
        with C.skipping(*skip):
            state, m = art.fn(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "state": _flat(state),
            "specs": art.in_shardings[0]}


def launcher_on_rank(rank, cfg_dict, cells, batch, n_micro, shape,
                     ctx=None):
    """``launch.train.steps_on_rank`` — what ``python -m
    repro_torch.launch.train --mesh DxM [--multi-pod]`` runs on each rank
    — under the tiny config and cells, one warmup and one timed step;
    also the rank's parameters as drawn (``train_state_on_rank``) with
    their specs."""
    _patch(cfg_dict, cells, ctx=ctx)
    rec = train.steps_on_rank(rank, "qwen3-4b", batch, n_micro, 1, None, 0,
                              shape)
    art, state = train.train_state_on_rank("qwen3-4b", batch, n_micro, None,
                                           0, shape, torch.device("cpu"))
    rec["params"] = _flat(state.params)
    rec["pspecs"] = train.state_specs(art, ".params")
    return rec


def serve_on_rank(rank, cfg_dict, cells, params, inputs, caches_p, caches_d,
                  io):
    """The serving steps on the rank's (2, 1) mesh, each given whole
    arguments to cut to the rank's rows: the prefill of ``params`` over
    ``inputs``, the handoff of ``caches_p`` and the serve step over
    ``caches_d`` with the tokens ``io``. Returns the rank's outputs and
    its bytes beside ``per_chip_bytes``."""
    _patch(cfg_dict, cells)
    mesh = _mesh((2, 1))
    pre = TS.make_prefill_artifacts(cells["prefill_32k"], mesh)
    ps = SH.shard_params(params, pre.in_shardings[0], mesh)
    with torch.no_grad():
        last, cp = pre.fn(ps, inputs)
    ho = TS.make_handoff_artifacts("qwen3-4b", mesh,
                                   batch=cells["prefill_32k"].batch)
    got = ho.fn(_own(caches_p))
    srv = TS.make_serve_artifacts(cells["decode_32k"], mesh)
    with torch.no_grad():
        logits, cd = srv.fn(ps, _own(caches_d), io)
    sizes = mesh.shape
    mem_len = pre.cfg.max_source_len if pre.cfg.is_enc_dec else 0
    abs_p = M.abstract_caches(pre.cfg, cells["prefill_32k"].batch,
                              cells["prefill_32k"].seq_len, torch.float32,
                              mem_len=mem_len)
    return {"prefill": (last, _cpu(cp)), "handoff": _cpu(got),
            "serve": (logits, _cpu(cd)),
            "specs": {"caches_p": pre.out_shardings[1],
                      "handoff": ho.out_shardings,
                      "caches_d": srv.in_shardings[1]},
            "bytes": {
                "params": (SH.local_bytes(ps), SH.per_chip_bytes(
                    pre.abstract_args[0], pre.in_shardings[0], sizes)),
                "caches_p": (SH.local_bytes(cp), SH.per_chip_bytes(
                    abs_p, pre.out_shardings[1], sizes)),
                "caches_d": (SH.local_bytes(cd), SH.per_chip_bytes(
                    srv.abstract_args[1], srv.in_shardings[1], sizes))}}


def operand(rank_index: int, n: int = 1000) -> torch.Tensor:
    """Rank ``rank_index``'s float32 operand of the compressed psums."""
    g = torch.Generator().manual_seed(17 + rank_index)
    return torch.randn(n, generator=g) * (1 + rank_index)


def compressed_on_rank(rank, wire):
    """``compressed_psum`` over the pod line and ``hierarchical_psum``
    (inner: the data line, outer: the pod line) of ``operand(rank)`` on
    the rank's (pod 2, data 2, model 1) mesh."""
    mesh = _mesh((2, 2, 1))
    pod, data = mesh.axis_shard("pod"), mesh.axis_shard("data")
    x = operand(rank.index)
    return {"compressed": Z.compressed_psum(x, pod, wire),
            "hierarchical": Z.hierarchical_psum(x, data, pod, wire),
            "pod": pod.ranks, "data": data.ranks}


def planes_on_rank(rank, shape):
    """The rank's coordinates and its (index, size, ranks) on each axis
    and on the planes of the data axes and of the whole mesh."""
    mesh = _mesh(shape)

    def seen(s):
        return None if s is None else (s.index, s.size, s.ranks)
    names = mesh.axis_names
    return {"coords": mesh.coords,
            "axes": {a: seen(mesh.axis_shard(a)) for a in names},
            "data": seen(mesh.axis_shard(tuple(a for a in names
                                               if a != "model"))),
            "all": seen(mesh.axis_shard(names)),
            "psum": float(C.psum(torch.tensor([float(rank.index)]),
                                 mesh.axis_shard(names))[0])}


def autograd_collectives_on_rank(rank):
    """On the rank's card and on the host, over the (1, 2) mesh's model
    axis: a function of element-wise products (rounded alike on both) and
    every autograd collective — ``column_entry``, ``psum``,
    ``all_gather`` with a split and a replicated consumer,
    ``gather_weights`` from the owner — and its gradients with respect to
    the replicated input and the rank's weight, in bfloat16 and float32.
    Returns the transport and both results on the host."""
    mesh = _mesh((1, 2))
    shard = mesh.axis_shard("model")
    me = rank.index
    out = {"transport": C.transport(shard, rank.device), "card": [],
           "host": []}
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator().manual_seed(5)
        x0 = torch.randn(2, 64, generator=g)           # every rank's
        g = torch.Generator().manual_seed(100 + me)
        u, v, w0 = (torch.randn(2, 64, generator=g) for _ in range(3))
        gd = torch.randn(4, 128, generator=g)
        ge = torch.randn(2, 64, generator=g)
        for where, dev in (("card", rank.device), ("host", "cpu")):
            def put(t, grad=False):
                return t.to(device=dev, dtype=dtype).requires_grad_(grad)
            x, w = put(x0, True), put(w0, True)
            a = C.column_entry(x, shard) * put(u)
            c = C.all_gather(C.psum(a, shard) * put(v), 1, shard,
                             grad="split")
            d = C.all_gather(c * 0.5, 0, shard, grad="replicated")
            e = C.gather_weights(w, None, 0, shard) * 3.0
            gx, gw = torch.autograd.grad([d, e], [x, w],
                                         [put(gd), put(ge)],
                                         allow_unused=True)
            out[where].append({"x": gx.cpu(), "w": None if gw is None
                               else gw.cpu(), "d": d.detach().cpu()})
    return out

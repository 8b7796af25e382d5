"""What the ranks of ``tests/test_torch_mesh.py`` run: module-level
functions, which the spawned rank processes import by name — this module
imports nothing of JAX or of the JAX package, so neither do they.

Each takes the tiny config as a dict and the cells to patch in, since a
rank process starts from a fresh interpreter.
"""
import dataclasses

import torch
import torch.distributed as tdist

from repro_torch.configs.base import config_from_dict
from repro_torch.launch import cells as TC
from repro_torch.launch import serve
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import collectives as C

MESH = (1, 2)


def _patch(cfg_dict, cells):
    cfg = config_from_dict(cfg_dict)
    TS.get_config = lambda arch: cfg
    TS.get_cell = TC.get_cell = lambda arch, shape: cells[shape]
    return cfg


def _cpu(tree):
    return SH.tree_map(lambda x: x.detach().cpu()
                       if isinstance(x, torch.Tensor) else x, tree)


def _with_d_dtype(cells, dt):
    return dict(cells, decode_32k=dataclasses.replace(cells["decode_32k"],
                                                      cache_dtype=dt))


def steps_on_rank(rank, cfg_dict, cells, params, inputs, caches_p_ref,
                  caches_d_ref, io, d_dtypes):
    """The step builders on the rank's (1, 2) mesh: the prefill of the
    whole ``params`` (cut to the rank's shards), the handoff of the
    reference's P caches (cut likewise) into D caches of each of
    ``d_dtypes``, and the serve step over each of the reference's D caches
    ``caches_d_ref`` ({D dtype: caches}, cut likewise). Returns the rank's
    local outputs and bytes beside ``per_chip_bytes``."""
    _patch(cfg_dict, cells)
    mesh = make_mesh(MESH, ("data", "model"), "cpu")
    sizes = mesh.shape
    out = {"rank": rank.index, "backend": rank.backend}
    pre = TS.make_prefill_artifacts(cells["prefill_32k"], mesh)
    pspecs = pre.in_shardings[0]
    ps = SH.shard_params(params, pspecs, mesh)
    with torch.no_grad():
        last, caches_p = pre.fn(ps, inputs)
    out["prefill"] = (last, _cpu(caches_p))
    mem_len = pre.cfg.max_source_len if pre.cfg.is_enc_dec else 0
    abs_p = TS.M.abstract_caches(pre.cfg, cells["prefill_32k"].batch,
                                 cells["prefill_32k"].seq_len, torch.float32,
                                 mem_len=mem_len)
    out["bytes"] = {"params": (SH.local_bytes(ps), SH.per_chip_bytes(
        pre.abstract_args[0], pspecs, sizes)),
        "caches_p": (SH.local_bytes(caches_p), SH.per_chip_bytes(
            abs_p, pre.out_shardings[1], sizes))}
    out["handoff"] = {}
    for dt in d_dtypes:
        _patch(cfg_dict, _with_d_dtype(cells, dt))
        ho = TS.make_handoff_artifacts("qwen3-4b", mesh,
                                       batch=cells["prefill_32k"].batch)
        mine = SH.to_shardings(mesh, caches_p_ref, ho.in_shardings[0])
        got = ho.fn(mine)
        out["handoff"][dt] = _cpu(got)
        abs_d = TS.M.abstract_caches(
            ho.cfg, cells["prefill_32k"].batch,
            cells["decode_32k"].decode_capacity(), getattr(torch, dt),
            mem_len=mem_len, full_capacity=TS._full_capacity(ho.cfg))
        out["bytes"][f"caches_d_{dt}"] = (SH.local_bytes(got),
                                          SH.per_chip_bytes(
                                              abs_d, ho.out_shardings,
                                              sizes))
    out["serve"] = {}
    for dt, ref in caches_d_ref.items():
        cells_dt = _with_d_dtype(cells, dt)
        _patch(cfg_dict, cells_dt)
        srv = TS.make_serve_artifacts(cells_dt["decode_32k"], mesh)
        mine = SH.to_shardings(mesh, ref, srv.in_shardings[1])
        with torch.no_grad():
            logits, caches = srv.fn(ps, mine, io)
        out["serve"][dt] = (logits, _cpu(caches))
    _patch(cfg_dict, cells)
    return out


def long_step_on_rank(rank, cfg_dict, cell, params, caches_ref, io):
    """long_500k's serve step ``cell`` on the rank's (1, 2) mesh over its
    shards of the reference's D caches ``caches_ref`` (tags already
    shifted): the rank's logits shard and caches, the specs, and the
    rank's bytes beside ``per_chip_bytes``."""
    cfg = config_from_dict(cfg_dict)
    TS.get_config = lambda arch: cfg
    mesh = make_mesh(MESH, ("data", "model"), "cpu")
    srv = TS.make_serve_artifacts(cell, mesh)
    ps = SH.shard_params(params, srv.in_shardings[0], mesh)
    mine = SH.to_shardings(mesh, caches_ref, srv.in_shardings[1])
    with torch.no_grad():
        logits, caches = srv.fn(ps, mine, io)
    return {"logits": logits, "caches": _cpu(caches),
            "specs": srv.in_shardings[1],
            "bytes": {"params": (SH.local_bytes(ps), SH.per_chip_bytes(
                srv.abstract_args[0], srv.in_shardings[0], mesh.shape)),
                "caches_d": (SH.local_bytes(caches), SH.per_chip_bytes(
                    srv.abstract_args[1], srv.in_shardings[1],
                    mesh.shape))}}


def float8_block(src: int, dst: int) -> torch.Tensor:
    """The e4m3 block rank ``src`` sends rank ``dst``: all 256 byte codes
    (NaN and ±448 among them), rolled by the pair, as (4, 64)."""
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    return codes.roll(7 * src + 3 * dst).view(4, 64).view(
        torch.float8_e4m3fn)


def float8_collectives_on_rank(rank):
    """``exchange`` of ``float8_block(rank, j)`` to each rank j and
    ``all_gather`` of the rank's own block on dim 1, over the model axis."""
    mesh = make_mesh(MESH, ("data", "model"), "cpu")
    shard = mesh.axis_shard("model")
    me = rank.index
    got = C.exchange([float8_block(me, j) for j in range(2)], shard)
    return {"exchanged": got,
            "gathered": C.all_gather(float8_block(me, me), 1, shard)}


def shared_card_collectives_on_rank(rank):
    """On the rank's card, ``psum`` (bfloat16, float32), ``all_gather``
    (dim 1) and ``exchange`` (float8 e4m3 blocks) over the model axis,
    and the same collectives of the same operands on the host, which gloo
    carries; twice, the second time past the shared buffers' first 32 MiB
    (they grow). Returns the transport and both results on the host."""
    mesh = make_mesh(MESH, ("data", "model"), rank.device)
    shard = mesh.axis_shard("model")
    me = rank.index
    out = {"transport": C.transport(shard, rank.device), "card": [],
           "host": []}
    for n in (1000, 9 << 20):
        g = torch.Generator().manual_seed(1000 * me + n % 997)
        ops = {"bf16": torch.randn(2, n // 2, generator=g).to(torch.bfloat16),
               "f32": torch.randn(2, n // 2, generator=g),
               "f8": [torch.randint(0, 256, (2, n // 8), generator=g,
                                    dtype=torch.uint8).view(
                                        torch.float8_e4m3fn)
                      for _ in range(2)]}
        for where, dev in (("card", rank.device), ("host", "cpu")):
            def put(x):
                return x.to(dev, copy=True)    # psum sums in place
            got = {"psum_bf16": C.psum(put(ops["bf16"]), shard),
                   "psum_f32": C.psum(put(ops["f32"]), shard),
                   "gather": C.all_gather(put(ops["bf16"]), 1, shard),
                   "exchange": C.exchange([put(b) for b in ops["f8"]],
                                          shard)}
            out[where].append(_cpu(got))
    return out


def programs_on_rank(rank, cfg_dict, cells, *args):
    """``serve.programs_on_rank`` under the tiny config and cells."""
    _patch(cfg_dict, cells)
    return serve.programs_on_rank(rank, *args)


def raise_on_rank_one(rank):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if rank.index == 1:
        raise ValueError("rank one fails on purpose")
    tdist.broadcast(torch.zeros(4), src=1)
    return rank.index

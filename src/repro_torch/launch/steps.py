"""Step builders: (cell, mesh) → the step programs of the launch layer
(PyTorch port of ``repro.launch.steps``).

Three program kinds, the paper's instance roles, and the handoff between
two of them:
  train_step    — loss / gradients / AdamW (micro-batched, remat)
  prefill_step  — P: prompt → (last-token logits, KV caches)
  serve_step    — D: one decode token against seq_len-deep caches
  handoff       — P's caches → D's (head slice, capacity pad, dtype cast)

Each builder returns a ``StepArtifacts``: the deployed config, ``fn`` (the
step as a callable that runs under the cell's ``DistContext`` on the
mesh's device), its arguments' shapes and dtypes as ``meta`` tensors, and
the sharding specs of its arguments and outputs, so the launchers, the
dry run and the roofline share one source of truth.

What the reference's ``jax.jit`` adds has no counterpart here: there is
no XLA program, so nothing is lowered (no ``lower()``); donation is the
in-place update the train step and the cache writes already do; the
shardings are specs (``launch.sharding``), satisfied on one card by
placing the arguments there. ``fn`` runs on the one-card mesh (card or
CPU), for any mesh on ``meta`` as a shape-only count
(``mesh.check_runnable``), and on a rank's mesh in a world of ranks
(``launch/ranks.py``; any (data, model) or (pod, data, model) shape):
there its parameters, caches and train state are the rank's shards
(``sharding.shard_params`` / ``param_keeper``; the caches as the
builders make and hand them off) or whole, cut to them
(``sharding.to_rank``), and its batch, prompts and decode tokens are
given whole and cut to the rank's rows on the data axes
(``batch_pspecs``; a train batch of ``n_micro`` > 1 micro-batches to the
rank's share of each, as the reference's partitioner cuts them:
``sharding.micro_major``). The prefill makes head_dim-sharded caches (their
batch on the data axes), the handoff reshards them on the model axis to
D's capacity-sharded caches by a block exchange between the ranks (the
data-axis entries untouched), and the logits are the rank's rows and
vocab shard. On such a mesh the serving steps cover every family —
dense, MoE (each data rank routing its own tokens), MLA, sliding-window
(ring), RG-LRU hybrid, SSD, vision and encoder-decoder — and every
decode cell, long_500k included, D's caches in bfloat16, float32 or
float8 e4m3. Training covers every family too: data-parallel gradients,
tensor-parallel weights (each family's backward through the adjoints
``models/collectives.py`` gives its sharded layers: the expert-TP MoE
and its router, MLA's latent, the RG-LRU's width gather, the
cross-attention's memory K/V; the SSD replicated), ZeRO-1 moments,
ZeRO-3 weights for a ``zero3`` cell (the encoder's layers gathered as
the decoder's) and micro-batches, a vision model's patches and an
enc-dec model's frames on the data axes beside the tokens. On a data
axis each rank's MoE routes its own tokens with the capacity of its
shard, as the reference's shard_map body does. The reference's
``act_seq`` (a sharding constraint on the residual stream) changes no
value and has no counterpart. The handoff takes a batch (deliberate
difference B12 in ROADMAP): one card cannot hold the prefill cell's 32
sequences of 32k.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config, torch_dtype
from repro_torch.launch import sharding as SH
from repro_torch.launch.cells import Cell, get_cell
from repro_torch.launch.mesh import Mesh, data_axes, model_axis
from repro_torch.models import dist
from repro_torch.models import model as M
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.train_step import (abstract_train_state,
                                             make_train_step)
from repro_torch.training.tree import leaves_with_paths, unflatten


@dataclasses.dataclass
class StepArtifacts:
    name: str
    cfg: ModelConfig                 # deployed (padded) config
    fn: Callable
    abstract_args: Tuple[Any, ...]   # trees of meta tensors
    in_shardings: Tuple[SH.Specs, ...]   # one {path: spec} an argument
    out_shardings: Any
    mesh: Mesh


def _axis_sizes(mesh: Mesh) -> Tuple[Tuple[str, ...], int, Optional[str], int]:
    dp = data_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    m = model_axis(mesh)
    return dp, dp_size, m, (mesh.shape[m] if m else 1)


def _dctx(mesh: Mesh, dp, m, *, mode: str,
          zero3: Optional[Dict[str, Optional[int]]] = None
          ) -> dist.DistContext:
    """The reference's context for ``mode``, less its knobs that one card
    has no use for: the layer loop is Python (no ``unroll``) and one device
    has no activation sharding (no ``act_spec``); with ``zero3`` (the
    dims that the data plane splits, by parameter path) a
    ``dist.TrainContext``."""
    kw = dict(mesh=mesh, dp_axes=dp, model_axis=m,
              chunk_kv=8192 if mode in ("train", "prefill") else 0,
              moe_shard_map=True)
    return dist.TrainContext(**kw, zero3=zero3) if zero3 else \
        dist.DistContext(**kw)


def _new_caches(mesh: Mesh, abstract: Any, specs: SH.Specs, make: Callable):
    """Zeroed caches (``pos`` -1): ``make()`` on one device; on a rank's
    mesh each leaf at the rank's shape under ``specs``."""
    if not mesh.in_world:
        return make()
    flat = []
    for p, x in leaves_with_paths(abstract):
        if isinstance(x, torch.Tensor):
            shape = SH.local_shape(tuple(x.shape), specs[p], mesh)
            fill = -1 if SH.path_names(p)[-1] == "pos" else 0
            x = torch.full(shape, fill, dtype=x.dtype, device=mesh.device)
        flat.append(x)
    return unflatten(abstract, flat)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _input_structs(cfg: ModelConfig, cell: Cell) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for every model input of this cell."""
    b, s = cell.batch, cell.seq_len
    if cell.mode == "decode":
        return {"tokens": _meta((b, 1), torch.int32),
                "positions": _meta((b, 1), torch.int32)}
    toks = s
    out: Dict[str, torch.Tensor] = {}
    if cfg.frontend.kind == "vision":
        npatch = cfg.frontend.num_patches
        toks = s - npatch
        out["patches"] = _meta((b, npatch, cfg.d_model), torch.bfloat16)
    if cfg.is_enc_dec:
        out["frames"] = _meta((b, cfg.max_source_len, cfg.d_model),
                              torch.bfloat16)
    out["tokens"] = _meta((b, toks), torch.int32)
    if cell.mode == "train":
        out["labels"] = _meta((b, toks), torch.int32)
    return out


def _prefixed(prefix: str, specs: SH.Specs) -> SH.Specs:
    return {prefix + p: s for p, s in specs.items()}


def _deployed(arch: str, m_size: int, mode: str,
              layer_override: Optional[Dict[str, int]]) -> ModelConfig:
    cfg = SH.deploy_config(get_config(arch), m_size, mode)
    return cfg.with_(**layer_override) if layer_override else cfg


def _full_capacity(cfg: ModelConfig) -> bool:
    """D's dense caches hold slot == position (what the flash route of
    ``attention_decode`` reads) unless the arch's window makes them ring
    buffers, as the reference's are (those take ``ops.cache_attention``)."""
    return not M._window(cfg)


# --------------------------------------------------------------------------- #
def make_train_artifacts(cell: Cell, mesh: Mesh, *,
                         layer_override: Optional[Dict[str, int]] = None
                         ) -> StepArtifacts:
    dp, dp_size, m, m_size = _axis_sizes(mesh)
    cfg = _deployed(cell.arch, m_size, "train", layer_override)

    state_abs = abstract_train_state(cfg)
    pspecs = SH.param_pspecs(state_abs.params, cfg, m, m_size)
    if cell.zero3:
        # weights sharded over the data axes too
        pspecs = SH.zero1_pspecs(state_abs.params, pspecs, dp, dp_size)
    ospecs = SH.opt_pspecs(state_abs.opt, pspecs, dp, dp_size)
    batch_abs = _input_structs(cfg, cell)
    bspecs = SH.batch_pspecs(batch_abs, dp, dp_size)
    state_specs = {**_prefixed(".params", pspecs), **_prefixed(".opt", ospecs)}
    metrics_specs = {f"['{k}']": () for k in ("loss", "grad_norm", "lr")}
    layout = SH.train_layout(mesh, state_abs.params, pspecs, ospecs, dp)
    zero3 = None
    if cell.zero3 and layout is not None and layout.dp is not None:
        zero3 = {p: SH.model_dim(s, dp[0]) for p, s in pspecs.items()}
    dctx = _dctx(mesh, dp, m, mode="train", zero3=zero3)
    step = make_train_step(cfg, AdamWConfig(), remat=True,
                           n_micro=cell.n_micro, layout=layout)
    rows = None
    if cell.n_micro > 1 and layout is not None and layout.dp is not None:
        rows = SH.micro_major(cell.batch, cell.n_micro, layout.dp.size)

    def train_step(state, batch):
        state, batch = _to_rank(state, batch)
        with dist.use(dctx):
            return step(state, batch)

    def grads(state, batch):
        """The step's loss and the rank's reduced gradients, the state
        untouched."""
        state, batch = _to_rank(state, batch)
        with dist.use(dctx):
            return step.grads(state.params, batch)

    def _to_rank(state, batch):
        if rows is not None:
            batch = {k: v.index_select(0, rows.to(v.device))
                     if v.shape[0] == cell.batch else v
                     for k, v in batch.items()}
        return (SH.to_rank(mesh, state, state_abs, state_specs),
                SH.to_rank(mesh, batch, batch_abs, bspecs))

    train_step.grads = grads
    train_step.layout = layout

    return StepArtifacts(name=f"{cell.name}:train", cfg=cfg, fn=train_step,
                         abstract_args=(state_abs, batch_abs),
                         in_shardings=(state_specs, bspecs),
                         out_shardings=(state_specs, metrics_specs),
                         mesh=mesh)


# --------------------------------------------------------------------------- #
def make_prefill_artifacts(cell: Cell, mesh: Mesh, *,
                           layer_override: Optional[Dict[str, int]] = None
                           ) -> StepArtifacts:
    dp, dp_size, m, m_size = _axis_sizes(mesh)
    cfg = _deployed(cell.arch, m_size, "prefill", layer_override)
    dctx = _dctx(mesh, dp, m, mode="prefill")
    b, s = cell.batch, cell.seq_len
    mem_len = cfg.max_source_len if cfg.is_enc_dec else 0
    dtype = torch_dtype(cell.cache_dtype)

    params_abs = M.abstract_params(cfg)
    pspecs = SH.param_pspecs(params_abs, cfg, m, m_size)
    inputs_abs = _input_structs(cfg, cell)
    ispecs = SH.batch_pspecs(inputs_abs, dp, dp_size)
    caches_abs = M.abstract_caches(cfg, b, s, dtype, mem_len=mem_len)
    cspecs = SH.cache_pspecs(caches_abs, cfg, b, dp, dp_size, m, m_size,
                             mode="prefill")
    logits_spec = (SH._dp(b, dp, dp_size), m)

    def prefill_step(params, inputs):
        params = SH.to_rank(mesh, params, params_abs, pspecs)
        inputs = SH.to_rank(mesh, inputs, inputs_abs, ispecs)
        with dist.use(dctx):
            caches = _new_caches(mesh, caches_abs, cspecs,
                                 lambda: M.init_caches(
                                     cfg, b, s, dtype, device=mesh.device,
                                     mem_len=mem_len))
            return M.prefill(params, cfg, inputs, caches)

    return StepArtifacts(name=f"{cell.name}:prefill", cfg=cfg,
                         fn=prefill_step,
                         abstract_args=(params_abs, inputs_abs),
                         in_shardings=(pspecs, ispecs),
                         out_shardings=(logits_spec, cspecs), mesh=mesh)


# --------------------------------------------------------------------------- #
def make_serve_artifacts(cell: Cell, mesh: Mesh, *,
                         layer_override: Optional[Dict[str, int]] = None
                         ) -> StepArtifacts:
    """One-token decode against caches holding ``cell.seq_len`` positions.

    ``fn(params, caches, io, q_offset=None)``: io {"tokens", "positions"}
    (B, 1). Every row decodes at the same position, ``q_offset`` — a host
    int, ``cell.seq_len`` unless given — so the card reads no position
    back (the kernel routes of attention, MLA's expanded decode). The
    caches are updated in place. D's dense caches of an arch with a window
    are ring buffers of the window, and qwen1.5-32b's are float8: on the
    card (and in a count of its work on ``meta``, ``ops.count_as_card``)
    every one-row step takes the flash_decode kernel
    (``ops.cache_attention``). On a rank's mesh the caches are the rank's
    capacity share (a ring's slot share) and each rank's flash_decode
    stops at its partials (``ops.cache_attention_partial``)."""
    dp, dp_size, m, m_size = _axis_sizes(mesh)
    cfg = _deployed(cell.arch, m_size, "decode", layer_override)
    dctx = _dctx(mesh, dp, m, mode="decode")
    b = cell.batch
    cap = cell.decode_capacity()
    mem_len = cfg.max_source_len if cfg.is_enc_dec else 0
    dtype = torch_dtype(cell.cache_dtype)

    params_abs = M.abstract_params(cfg)
    pspecs = SH.param_pspecs(params_abs, cfg, m, m_size)
    caches_abs = M.abstract_caches(cfg, b, cap, dtype, mem_len=mem_len,
                                   full_capacity=_full_capacity(cfg))
    cspecs = SH.cache_pspecs(caches_abs, cfg, b, dp, dp_size, m, m_size,
                             mode="decode")
    tok_abs = {"tokens": _meta((b, 1), torch.int32),
               "positions": _meta((b, 1), torch.int32)}
    tspecs = SH.batch_pspecs(tok_abs, dp, dp_size)
    logits_spec = (SH._dp(b, dp, dp_size), None, m)

    def serve_step(params, caches, io, q_offset: Optional[int] = None):
        params = SH.to_rank(mesh, params, params_abs, pspecs)
        caches = SH.to_rank(mesh, caches, caches_abs, cspecs)
        io = SH.to_rank(mesh, io, tok_abs, tspecs)
        with dist.use(dctx):
            return M.decode_step(
                params, cfg, io["tokens"], io["positions"], caches,
                q_offset=cell.seq_len if q_offset is None else q_offset,
                mem_len=mem_len if cfg.is_enc_dec else None)

    return StepArtifacts(name=f"{cell.name}:decode", cfg=cfg, fn=serve_step,
                         abstract_args=(params_abs, caches_abs, tok_abs),
                         in_shardings=(pspecs, cspecs, tspecs),
                         out_shardings=(logits_spec, cspecs), mesh=mesh)


# --------------------------------------------------------------------------- #
def _realign_leaf(name: str, x: torch.Tensor,
                  dst: torch.Tensor) -> torch.Tensor:
    """One leaf of ``realign_caches``: ``x`` with its KV heads cut to
    ``dst``'s, its capacity axis padded to ``dst``'s (``pos`` with -1, the
    rest with 0), in ``dst``'s dtype. The pad is written in that dtype
    (a float8 cache's pad is never a bf16 copy); the values are those of
    padding first and casting after."""
    if name in ("k", "v", "cross_k", "cross_v") \
            and x.shape[3] != dst.shape[3]:
        x = x[:, :, :, :dst.shape[3]]               # drop TP pad heads
    if name in ("k", "v", "pos", "ckv", "kpe") \
            and x.shape[2] != dst.shape[2]:         # the decode margin
        shape = x.shape[:2] + dst.shape[2:3] + x.shape[3:]
        out = torch.full(shape, -1 if name == "pos" else 0,
                         dtype=dst.dtype, device=x.device)
        out[:, :, :x.shape[2]] = x
        return out
    return x.to(dst.dtype)


def realign_caches(caches_p: Any, caches_d: Any) -> Any:
    """P's caches as D's: each tensor leaf of ``caches_p`` with its KV
    heads cut to D's (the TP pad heads of the prefill deployment go), its
    capacity axis padded to D's (``pos`` with -1, the rest with 0) and
    cast to D's dtype; ``caches_d`` (any device: ``meta`` will do) gives
    the tree, the shapes, the dtypes and the ``full_capacity`` flags."""
    src = iter(SH.named_leaves(caches_p))
    out = []
    for path, dst in leaves_with_paths(caches_d):
        if isinstance(dst, torch.Tensor):
            _, x = next(src)
            dst = _realign_leaf(SH.path_names(path)[-1], x, dst)
        out.append(dst)
    return unflatten(caches_d, out)


def random_inputs(abstract: Dict[str, torch.Tensor], vocab_size: int,
                  seed: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """Inputs of a step's abstract batch drawn from ``default_rng(seed)``:
    token ids (and labels) uniform below ``vocab_size``, positions the
    caller sets, patches and frames unit normal x 0.02; on ``device``."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, a in abstract.items():
        if a.dtype in (torch.int32, torch.int64):
            v = rng.integers(0, vocab_size, tuple(a.shape)).astype(np.int32)
            out[k] = torch.from_numpy(v).to(device)
        else:
            v = rng.standard_normal(tuple(a.shape)).astype(np.float32) * 0.02
            out[k] = torch.from_numpy(v).to(device=device, dtype=a.dtype)
    return out


def make_handoff_artifacts(arch: str, mesh: Mesh, *,
                           layer_override: Optional[Dict[str, int]] = None,
                           batch: Optional[int] = None) -> StepArtifacts:
    """The P→D cache handoff as one program — the paper's transmission
    module on dense caches:

      * data alignment: the prefill deployment pads KV heads for TP; the
        pad heads are sliced off;
      * VRAM-management alignment: the decode capacity (seq + margin) is
        padded onto the sequence axis (``pos`` with -1);
      * precision alignment: cast to the decode cell's KV dtype (float8
        for qwen1.5-32b);
      * parallel-strategy alignment: the specs go from head_dim- to
        capacity-sharded (one card: a spec change only; on a rank's mesh
        a block exchange on the model axis, ``sharding.reshard``: rank r
        keeps its head_dim columns of its own capacity share and receives
        every other rank's columns of it; the batch stays on the data
        axes as it was).

    ``batch``: the sequences handed off (None: the prefill cell's 32).
    Returns new tensors in D's tree (``full_capacity`` set for an arch
    without a window); on a rank's mesh, the rank's shards of them."""
    dp, dp_size, m, m_size = _axis_sizes(mesh)
    cell_p = get_cell(arch, "prefill_32k")
    cell_d = get_cell(arch, "decode_32k")
    cfg_p = _deployed(arch, m_size, "prefill", layer_override)
    cfg_d = _deployed(arch, m_size, "decode", layer_override)
    b = cell_p.batch if batch is None else batch
    s, cap = cell_p.seq_len, cell_d.decode_capacity()
    mem_len = cfg_p.max_source_len if cfg_p.is_enc_dec else 0

    caches_p = M.abstract_caches(cfg_p, b, s, torch_dtype(cell_p.cache_dtype),
                                 mem_len=mem_len)
    caches_d = M.abstract_caches(cfg_d, b, cap,
                                 torch_dtype(cell_d.cache_dtype),
                                 mem_len=mem_len,
                                 full_capacity=_full_capacity(cfg_d))
    specs_p = SH.cache_pspecs(caches_p, cfg_p, b, dp, dp_size, m, m_size,
                              mode="prefill")
    specs_d = SH.cache_pspecs(caches_d, cfg_d, b, dp, dp_size, m, m_size,
                              mode="decode")

    def handoff(caches):
        caches = SH.to_rank(mesh, caches, caches_p, specs_p)
        if not mesh.in_world:
            return realign_caches(caches, caches_d)
        # a leaf at a time: realigned (P's specs, D's sizes), then
        # resharded, so one realigned leaf is alive at a time
        src = dict(SH.named_leaves(caches))
        flat = [SH.reshard(_realign_leaf(SH.path_names(p)[-1], src[p], x),
                           specs_p[p], specs_d[p], mesh)
                if isinstance(x, torch.Tensor) else x
                for p, x in leaves_with_paths(caches_d)]
        return unflatten(caches_d, flat)

    return StepArtifacts(name=f"{arch}@handoff", cfg=cfg_d, fn=handoff,
                         abstract_args=(caches_p,), in_shardings=(specs_p,),
                         out_shardings=specs_d, mesh=mesh)


def make_artifacts(cell: Cell, mesh: Mesh, **kw) -> StepArtifacts:
    if cell.mode == "train":
        return make_train_artifacts(cell, mesh, **kw)
    if cell.mode == "prefill":
        return make_prefill_artifacts(cell, mesh, **kw)
    return make_serve_artifacts(cell, mesh, **kw)

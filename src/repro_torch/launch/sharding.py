"""Deploy-time config transforms and the sharding rules of params, caches,
batches and optimizer state (PyTorch port of ``repro.launch.sharding``).

Scheme (Megatron-style TP on the "model" axis, DP over ("pod", "data")):

  * attention: q/o weights sharded on the head axis; k/v weights on
    head_dim. Head counts that do not divide the model axis are padded at
    deploy time (``pad_heads``) for train and prefill programs; decode
    runs unpadded.
  * MLP: column (d_ff) then row (d_ff). MoE: expert-TP (d_ff_expert
    sharded), as ``layers.moe_mlp_dist_specs`` states.
  * embeddings / LM head: vocab-sharded (padded by ``pad_vocab``).
  * decode KV caches: sharded on the capacity (sequence) axis; prefill
    emits head-dim-sharded caches, and the P→D handoff reshards.
  * ZeRO-1: optimizer moments also sharded over the data axes on the first
    free divisible dim.

Every rule falls back towards replication when a dim does not divide.

The rules make the reference's decisions over the port's trees. A spec is
a plain tuple with one entry a dimension — an axis name, a tuple of
names, or None — and ``()`` is replicated, as ``tuple(PartitionSpec(...))``
reads. Each ``*_pspecs`` function returns ``{path: spec}`` over a tree's
tensor leaves in the reference's flattening order, the paths being
``training.tree``'s (``['groups'][0][0]['attn']['wq']``, ``[0][0].k``).
Leaf names come from those paths; cache fields are ``k``, ``v``, ``pos``,
``ckv``, ``kpe``, ``cross_k``, ``cross_v``, ``mem_len``, ``h`` and
``conv``.

On one card every spec is satisfied by placing the tree on the card.
On a rank's mesh in a ``torch.distributed`` world (``launch/mesh.py``)
each rank holds its slice of every leaf: along each dim whose spec names
axes of more than one rank, the equal part at the rank's coordinates
(``rank_slice``; a tuple of axes — the data axes ``("pod", "data")`` —
row-major over them). ``to_shardings`` and ``shard_params`` cut whole
trees so, and ``to_rank`` cuts a step's arguments that come whole and
keeps those already at the rank's shapes; ``param_keeper`` cuts
parameters as ``model.init_params`` draws them (a block of whole layers
where ZeRO-3 splits the layer axis); ``train_layout`` gives the train
step how the rank holds each leaf (``optim.Layout``); ``reshard`` moves a
leaf from one spec to another across the model axis (the P→D handoff's
head_dim → capacity reshard; the data-axis entries stay as they are);
``local_bytes`` is what a rank holds, which ``per_chip_bytes`` predicts
from the whole tree and the specs.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh, check_runnable
from repro_torch.models import collectives as C
from repro_torch.models import dist
from repro_torch.training.tree import leaves_with_paths, tree_map, unflatten

Spec = Tuple[Any, ...]
Specs = Dict[str, Spec]

_NAME = re.compile(r"\['([^']*)'\]|\.(\w+)")


# --------------------------------------------------------------------------- #
# Deploy-time config transforms (data alignment)
# --------------------------------------------------------------------------- #
def pad_heads(cfg: ModelConfig, axis: int) -> ModelConfig:
    """Pad num_heads up to a multiple of the model axis, then num_kv_heads
    up to the nearest divisor of the padded head count (the group stays
    integral). Identity when already aligned."""
    h = cfg.num_heads
    if h <= 0 or cfg.attention_kind == "none":
        return cfg
    h2 = math.ceil(h / axis) * axis if h % axis else h
    kv = max(cfg.num_kv_heads, 1)
    kv2 = kv
    while h2 % kv2:
        kv2 += 1
    if (h2, kv2) == (h, kv):
        return cfg
    # hd stays explicit so padding heads keeps the per-head dim
    return cfg.with_(num_heads=h2, num_kv_heads=kv2, head_dim=cfg.hd)


def pad_vocab(cfg: ModelConfig, axis: int) -> ModelConfig:
    v = cfg.vocab_size
    v2 = math.ceil(v / axis) * axis
    return cfg if v2 == v else cfg.with_(vocab_size=v2)


def deploy_config(cfg: ModelConfig, axis: int, mode: str) -> ModelConfig:
    """The deployed model of a program kind: train and prefill shard
    attention scores on heads (head padding); decode shards them on the
    cache's capacity axis (unpadded)."""
    cfg = pad_vocab(cfg, axis)
    if mode in ("train", "prefill"):
        cfg = pad_heads(cfg, axis)
    return cfg


# --------------------------------------------------------------------------- #
# Trees
# --------------------------------------------------------------------------- #
def named_leaves(tree: Any) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor leaf in the reference's order; other
    leaves (a cache's ``full_capacity`` flag) carry no data and are
    skipped."""
    return [(p, x) for p, x in leaves_with_paths(tree)
            if isinstance(x, torch.Tensor)]


def storage_ids(tree: Any) -> Set[int]:
    """The storages that the tensor leaves of a tree lie in (``meta``
    tensors have storages too, without data): an output in one of an
    argument's is that argument updated in place."""
    return {x.untyped_storage()._cdata for _, x in named_leaves(tree)}


def path_names(path: str) -> Tuple[str, ...]:
    """The dict keys and field names along a path, in order."""
    return tuple(a or b for a, b in _NAME.findall(path))


def _leaf_name(path: str) -> str:
    names = path_names(path)
    return names[-1] if names else ""


# --------------------------------------------------------------------------- #
# Param rules
# --------------------------------------------------------------------------- #
def _div(n: int, size: int) -> bool:
    return n >= size and n % size == 0


def _pick(shape: Tuple[int, ...], prefs: Tuple[int, ...], size: int
          ) -> Optional[int]:
    for d in prefs:
        if d < len(shape) and _div(shape[d], size):
            return d
    return None


_LEAF_PREFS = {
    # name: preference order of dims (unstacked leaf coordinates)
    "embed": (0, 1),          # (V, d)
    "lm_head": (1, 0),        # (d, V)
    "wq": (1, 2),             # (d, h, hd)
    "wk": (2,),               # (d, kv, hd) → hd only (kv never divides)
    "wv": (2,),
    "wo": (0, 1),             # (h, hd, d)
    "bq": (0, 1),             # (h, hd)
    "bk": (1,),               # (kv, hd)
    "bv": (1,),
    "w_ukv": (1,),            # (lora, h, ·)
    "w_gate": (1,),           # (d, f) | moe (E, d, fe) handled by ndim
    "w_up": (1,),
    "w_down": (0,),           # (f, d) | moe (E, fe, d)
    "w_x": (1,),              # rglru (d, w)
    "conv_w": (1,),           # rglru (K, w)
    "conv_b": (0,),
    "lru_in_w": (1,),         # (w, w)
    "lru_a_w": (1,),
    "lru_in_b": (0,),
    "lru_a_b": (0,),
    "lam": (0,),
    "w_out": (0,),            # rglru (w, d)
}

_MOE_PREFS = {"w_gate": (2,), "w_up": (2,), "w_down": (1,)}     # (E,d,fe)
_REPLICATED = {"router", "w_dkv", "kv_norm", "q_norm", "k_norm",
               "norm", "norm1", "norm2", "norm_x", "final_norm", "enc_norm"}


def param_pspec(path: str, leaf: torch.Tensor, cfg: ModelConfig,
                axis_name: str, axis_size: int) -> Spec:
    """The spec of one param leaf (a group's stacked leaves have a leading
    ``count`` dim, known from the 'groups' / 'enc_groups' path)."""
    names = path_names(path)
    name = names[-1] if names else ""
    shape = tuple(leaf.shape)
    off = 1 if ("groups" in names or "enc_groups" in names) else 0
    base = shape[off:]
    if "ssd" in names:
        return ()                      # SSD params replicated
    if name in _REPLICATED or len(base) <= 1 and name not in _LEAF_PREFS:
        return ()
    prefs = _LEAF_PREFS.get(name)
    if ("mlp" in names and len(base) == 3 and "shared" not in names
            and name in _MOE_PREFS):
        prefs = _MOE_PREFS[name]
    if prefs is None:
        return ()
    dim = _pick(base, prefs, axis_size)
    if dim is None:
        return ()
    spec: List[Any] = [None] * len(shape)
    spec[dim + off] = axis_name
    return tuple(spec)


def param_pspecs(abstract_params: Any, cfg: ModelConfig,
                 axis_name: str = "model", axis_size: int = 16) -> Specs:
    return {p: param_pspec(p, x, cfg, axis_name, axis_size)
            for p, x in named_leaves(abstract_params)}


# --------------------------------------------------------------------------- #
# ZeRO-1 optimizer-state rules
# --------------------------------------------------------------------------- #
def zero1_pspec(pspec: Spec, shape: Tuple[int, ...],
                data_axes: Tuple[str, ...], data_size: int) -> Spec:
    """Add the data axes on the first unsharded divisible dim (idempotent:
    a spec that already uses a data axis comes back unchanged)."""
    spec = list(pspec) + [None] * (len(shape) - len(pspec))
    used = {a for s in spec if s is not None
            for a in (s if isinstance(s, tuple) else (s,))}
    if used & set(data_axes):
        return tuple(spec)
    for d, s in enumerate(shape):
        if spec[d] is None and _div(s, data_size):
            spec[d] = data_axes if len(data_axes) > 1 else data_axes[0]
            break
    return tuple(spec)


def zero1_pspecs(abstract_params: Any, pspecs: Specs,
                 data_axes: Tuple[str, ...], data_size: int) -> Specs:
    """``zero1_pspec`` over every param leaf (ZeRO-3 weights, the
    accumulator)."""
    return {p: zero1_pspec(pspecs[p], tuple(x.shape), data_axes, data_size)
            for p, x in named_leaves(abstract_params)}


def opt_pspecs(abstract_opt: dict, pspecs: Specs,
               data_axes: Tuple[str, ...], data_size: int) -> Specs:
    """AdamW's {"mu", "nu", "step"}: each moment leaf gets its param's
    spec plus the data axes; the step is replicated."""
    out: Specs = {}
    for key in ("mu", "nu"):
        for p, x in named_leaves(abstract_opt[key]):
            out[f"['{key}']{p}"] = zero1_pspec(pspecs[p], tuple(x.shape),
                                               data_axes, data_size)
    out["['step']"] = ()
    return out


# --------------------------------------------------------------------------- #
# Cache + batch rules
# --------------------------------------------------------------------------- #
def _dp(batch: int, data_axes: Tuple[str, ...], data_size: int):
    if not data_axes or not _div(batch, data_size):
        return None
    return data_axes if len(data_axes) > 1 else data_axes[0]


def cache_pspec(name: str, shape: Tuple[int, ...], batch: int, dp,
                axis_name: str, axis_size: int, mode: str) -> Spec:
    """One stacked (count, B, ...) cache leaf: decode caches sharded on
    capacity (seq), prefill-emitted ones on head_dim; recurrent and SSM
    states on the batch only (an RG-LRU state also on its width)."""
    spec: List[Any] = [None] * len(shape)
    if len(shape) >= 2 and shape[1] == batch:
        spec[1] = dp
    # k/v: (count,B,cap,kv,hd); pos: (count,B,cap)
    if name in ("k", "v"):
        if mode == "decode" and _div(shape[2], axis_size):
            spec[2] = axis_name
        elif mode == "prefill" and _div(shape[4], axis_size):
            spec[4] = axis_name
    elif name == "pos" and len(shape) == 3:
        if mode == "decode" and _div(shape[2], axis_size):
            spec[2] = axis_name
    # MLA: ckv (count,B,cap,lora), kpe (count,B,cap,rope)
    elif name in ("ckv", "kpe"):
        if mode == "decode" and _div(shape[2], axis_size):
            spec[2] = axis_name
    elif name in ("cross_k", "cross_v"):
        if _div(shape[4], axis_size):
            spec[4] = axis_name
    # rglru h: (count,B,w); conv: (count,B,K-1,w)
    elif name == "h" and len(shape) == 3 and _div(shape[2], axis_size):
        spec[2] = axis_name
    elif name == "conv" and len(shape) == 4 and _div(shape[3], axis_size):
        spec[3] = axis_name
    # SSM h (count,B,H,P,N) / conv: batch-sharded only
    return tuple(spec)


def cache_pspecs(abstract_caches: Any, cfg: ModelConfig, batch: int,
                 data_axes: Tuple[str, ...], data_size: int,
                 axis_name: str = "model", axis_size: int = 16,
                 mode: str = "decode") -> Specs:
    dp = _dp(batch, data_axes, data_size)
    return {p: cache_pspec(_leaf_name(p), tuple(x.shape), batch, dp,
                           axis_name, axis_size, mode)
            for p, x in named_leaves(abstract_caches)}


def batch_pspecs(abstract_batch: Any, data_axes: Tuple[str, ...],
                 data_size: int) -> Specs:
    out: Specs = {}
    for p, x in named_leaves(abstract_batch):
        dp = _dp(x.shape[0], data_axes, data_size)
        out[p] = (dp,) + (None,) * (x.dim() - 1)
    return out


def micro_major(batch: int, n_micro: int, ways: int) -> torch.Tensor:
    """The order of a train batch's ``batch`` rows whose ``ways`` equal
    blocks are the data ranks' shares of every one of ``n_micro``
    micro-batches: block r holds rank r's rows of micro-batch 0, then of
    micro-batch 1, ... The reference's micro-batch j is the whole batch's
    j-th block of rows, split over the data axes; a rank's train step
    takes its j-th block of rows as its share of micro-batch j."""
    b = batch // n_micro // ways
    if b * n_micro * ways != batch:
        raise ValueError(f"batch {batch} does not split into {n_micro} "
                         f"micro-batches over {ways} data ranks")
    return torch.arange(batch).reshape(n_micro, ways, b) \
        .transpose(0, 1).reshape(-1)


# --------------------------------------------------------------------------- #
# Placement and per-chip sizes
# --------------------------------------------------------------------------- #
def _entry_axes(entry) -> Tuple[str, ...]:
    return tuple(entry) if isinstance(entry, tuple) else \
        (entry,) if entry else ()


def _part(mesh: Mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(ways, index) of the calling rank along a spec entry's axes
    (row-major over them, as ``PartitionSpec`` reads a tuple)."""
    ways, index = 1, 0
    for a in axes:
        i = mesh.axis_names.index(a)
        ways *= mesh.axis_sizes[i]
        index = index * mesh.axis_sizes[i] + (mesh.coords[i]
                                              if mesh.coords else 0)
    return ways, index


def rank_slice(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The calling rank's part of a whole leaf ``x`` under ``spec`` (a
    view): along each dim whose entry names axes of more than one rank,
    the equal part at the rank's coordinates. Outside a world, ``x``."""
    if not mesh.in_world:
        return x
    for d, entry in enumerate(spec):
        ways, index = _part(mesh, _entry_axes(entry))
        if ways == 1:
            continue
        n = x.shape[d]
        if n % ways:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"{ways} ways ({spec})")
        x = x.narrow(d, index * (n // ways), n // ways)
    return x


def local_shape(shape: Tuple[int, ...], spec: Spec,
                mesh: Mesh) -> Tuple[int, ...]:
    """The shape of a rank's part of a leaf of ``shape``."""
    out = list(shape)
    if mesh.in_world:
        for d, entry in enumerate(spec):
            out[d] //= _part(mesh, _entry_axes(entry))[0]
    return tuple(out)


def to_shardings(mesh: Mesh, tree: Any, specs: Optional[Specs] = None
                 ) -> Any:
    """``tree`` on the mesh's device; with ``specs`` ({path: spec} over
    its tensor leaves) on a rank's mesh, each leaf of the whole tree cut
    to the rank's part (``rank_slice``, a copy of its own). On one device
    every spec holds trivially: the tree is placed there, tensors already
    there returned as they are. Raises for an abstract mesh and for more
    than one device outside a world (``check_runnable``)."""
    dev = check_runnable(mesh)
    if not (specs is not None and mesh.in_world):
        return tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                        else x, tree)
    flat = [rank_slice(x, specs[p], mesh).to(dev).clone()
            if isinstance(x, torch.Tensor) else x
            for p, x in leaves_with_paths(tree)]
    return unflatten(tree, flat)


def shard_params(params: Any, specs: Specs, mesh: Mesh) -> Any:
    """Whole parameters (any device) → the rank's slices on the mesh's
    device, each a tensor of its own (the whole leaves can be freed)."""
    return to_shardings(mesh, params, specs)


class param_keeper:
    """``model.init_params``' ``keep``: a leaf drawn at ``path`` (one
    layer of a stacked group's leaf, or a whole top-level leaf) → a copy
    of the rank's slice of it under ``specs[path]`` (a stacked leaf's spec
    less its leading layer entry). A stacked leaf whose spec splits the
    layer axis (ZeRO-3 weights) keeps the rank's block of layers
    (``layer_slot``, ``layers_kept``)."""

    def __init__(self, specs: Specs, mesh: Mesh):
        self.specs, self.mesh = specs, mesh

    def __call__(self, path: str, x: torch.Tensor) -> torch.Tensor:
        spec = self.specs[path]
        if len(spec) == x.dim() + 1:
            spec = spec[1:]
        part = rank_slice(x, spec, self.mesh)
        return part.clone() if part is not x else x

    def _layers(self, path: str) -> Tuple[int, int]:
        spec = self.specs[path]
        if not (spec and self.mesh.in_world):
            return 1, 0
        return _part(self.mesh, _entry_axes(spec[0]))

    def layers_kept(self, path: str, count: int) -> int:
        return count // self._layers(path)[0]

    def layer_slot(self, path: str, i: int, count: int) -> Optional[int]:
        """Where layer ``i`` of ``count`` goes in the rank's stack, or None
        (another rank's block)."""
        ways, index = self._layers(path)
        owner, slot = dist.layer_block(i, count, ways)
        return slot if owner == index else None


def to_rank(mesh: Mesh, tree: Any, abstract: Any, specs: Specs) -> Any:
    """``tree`` on the mesh's device as the rank holds it: on a rank's
    mesh each tensor leaf that has the whole shape of its ``abstract``
    leaf is cut to the rank's part (``rank_slice``, a copy), and a leaf
    already at the rank's shape is kept; any other shape raises. A step's
    arguments may so be given whole (a batch every rank was handed) or as
    the rank's shards (parameters drawn with ``param_keeper``)."""
    dev = check_runnable(mesh)
    if not mesh.in_world:
        return tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                        else x, tree)
    want = dict(named_leaves(abstract))
    flat = []
    for p, x in leaves_with_paths(tree):
        if isinstance(x, torch.Tensor):
            whole = tuple(want[p].shape)
            mine = local_shape(whole, specs[p], mesh)
            if tuple(x.shape) == mine:
                x = x.to(dev)
            elif tuple(x.shape) == whole:
                x = rank_slice(x, specs[p], mesh).to(dev).clone()
            else:
                raise ValueError(f"{p}: {tuple(x.shape)} is neither the "
                                 f"whole {whole} nor the rank's {mine}")
        flat.append(x)
    return unflatten(tree, flat)


def train_layout(mesh: Mesh, params: Any, pspecs: Specs, ospecs: Specs,
                 data_axes: Tuple[str, ...]):
    """The rank's ``optim.Layout`` of a train state under the param specs
    ``pspecs`` and the optimizer specs ``ospecs`` (``opt_pspecs``' keys),
    over the tree ``params`` (for the order of its leaves): a gradient is
    summed over the data plane unless the data axes split the leaf
    (ZeRO-3); its squares over the plane of the axes that split it; the
    moments' data dim where the parameter's spec has none (ZeRO-1). None
    outside a world."""
    from repro_torch.training.optim import Layout
    if not mesh.in_world:
        return None
    dp = mesh.axis_shard(tuple(data_axes)) if data_axes else None
    reduce, norm, zero = [], [], []
    for p, _ in named_leaves(params):
        spec = pspecs[p]
        axes = tuple(a for a in mesh.axis_names
                     if any(a in _entry_axes(e) for e in spec))
        split = dp is not None and any(a in axes for a in data_axes)
        reduce.append(not split)
        norm.append(mesh.axis_shard(axes) if axes else None)
        zero.append(None if split or dp is None
                    else model_dim(ospecs[f"['mu']{p}"], data_axes[0]))
    return Layout(dp, tuple(reduce), tuple(norm), tuple(zero))


def model_dim(spec: Spec, axis: str = "model") -> Optional[int]:
    """The dim that ``spec`` shards over ``axis``, or None."""
    for d, entry in enumerate(spec):
        if axis in _entry_axes(entry):
            return d
    return None


def reshard(x: torch.Tensor, src: Spec, dst: Spec, mesh: Mesh,
            axis: str = "model") -> torch.Tensor:
    """A rank's part of a leaf under ``src`` → its part under ``dst``,
    across ``axis`` (the specs may differ on that axis alone): replicated
    → a slice; sharded → replicated, ``all_gather``; sharded on dim a →
    sharded on dim b, a block exchange (the rank's dim-a columns of every
    other rank's dim-b share go to that rank; one exchange a slice of the
    leading dim when neither is it, which bounds the staging). Every
    block has one shape, so dim b must split evenly (the handoff pads a
    full cache's capacity first; a ring's window of slots splits as it
    is). Any dtype crosses bit for bit, float8 e4m3 included: the
    collectives move each block's bytes."""
    shard = mesh.axis_shard(axis)
    a, b = model_dim(src, axis), model_dim(dst, axis)
    if shard is None or a == b:
        return x
    if a is None:
        return x.narrow(b, *_start_len(shard, x.shape[b])).clone()
    if b is None:
        return C.all_gather(x, a, shard)
    if 0 not in (a, b) and x.dim() > 2:
        shape = list(x.shape)
        shape[a] *= shard.size
        shape[b] //= shard.size
        out = x.new_empty(shape)
        for i in range(x.shape[0]):
            out[i] = _exchange_dims(x[i], a - 1, b - 1, shard)
        return out
    return _exchange_dims(x, a, b, shard)


def _start_len(shard: C.AxisShard, n: int) -> Tuple[int, int]:
    lo, hi = shard.part(n)
    return lo, hi - lo


def _exchange_dims(x: torch.Tensor, a: int, b: int,
                   shard: C.AxisShard) -> torch.Tensor:
    n = x.shape[b]
    k = n // shard.size
    if n % shard.size:
        raise ValueError(f"dim {b} of {tuple(x.shape)} does not split "
                         f"{shard.size} ways")
    got = C.exchange([x.narrow(b, j * k, k) for j in range(shard.size)],
                     shard)
    return torch.cat(got, dim=a)


def local_bytes(tree: Any) -> int:
    """Bytes of a tree's tensor leaves as this process holds them."""
    return sum(x.numel() * x.element_size() for _, x in named_leaves(tree))


def spec_ways(spec: Spec, axis_sizes: Dict[str, int]) -> int:
    """Into how many shards a spec cuts its leaf: the product of the sizes
    of every axis it names."""
    n = 1
    for s in spec:
        for a in (s if isinstance(s, tuple) else (s,) if s else ()):
            n *= axis_sizes[a]
    return n


def per_chip_bytes(tree: Any, specs: Specs, axis_sizes: Dict[str, int],
                   only: Optional[Set[int]] = None) -> int:
    """Bytes a chip holds of ``tree`` under ``specs``: each leaf's bytes
    over the product of its spec's axis sizes (replicated leaves whole);
    with ``only``, of the leaves whose storage is in that set."""
    return sum(x.numel() * x.element_size()
               // spec_ways(specs[p], axis_sizes)
               for p, x in named_leaves(tree)
               if only is None or storage_ids(x) <= only)

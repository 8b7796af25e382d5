"""Collectives that the launch layer's sharding specs force on a model
axis of more than one rank (the reference's are XLA's, inserted by its
partitioner from ``repro.launch.sharding``'s specs, and the explicit
``psum`` of its shard_map MoE):

  * ``psum``       — the partial outputs of a row-parallel product (the
                     attention's ``wo`` over the rank's heads, the MLP's
                     ``w_down`` over its d_ff slice, the expert-TP MoE,
                     the RG-LRU's ``w_out`` over its channels, a
                     vocab-sharded embedding lookup) summed over the axis;
  * ``all_gather`` — the rank's slices along one dim, concatenated in axis
                     order (K/V's head_dim columns before qk-norm and
                     RoPE, decode's query heads, MLA decode's q and
                     ``w_ukv`` heads, the RG-LRU's conv output on the
                     width, the vocab-sharded logits);
  * ``exchange``   — a block from every rank to every other (the handoff's
                     head_dim → capacity reshard of K/V and of rings,
                     float8 e4m3 shards included, decode's partials of
                     each rank's heads).

They are plain functions over an ``AxisShard`` — the calling rank's
coordinate on the axis, the axis' size, its ``torch.distributed`` group
and that group's global ranks in axis order. Two transports carry them:

  * **the group's backend** (NCCL between cards; gloo on the CPU), through
    ``all_reduce`` and ``broadcast`` only. ``all_gather`` and ``exchange``
    are one ``broadcast`` a source rank (an exchange: one a (source,
    destination) pair, which ranks outside the pair receive and drop),
    each tensor sent as its bytes (a ``uint8`` view), so every dtype —
    float8 included — crosses bit for bit;
  * **the card's memory**, when the ranks share one card (a gloo group
    and CUDA tensors: ``launch/ranks.py`` puts gloo ranks of a CUDA world
    all on card 0). gloo would stage every tensor through the host and
    over loopback TCP (0.4–1.0 GB/s on an NVIDIA H100 80GB HBM3 at
    700.00 W, ``chip_smoke.py`` phases 18–19); instead each rank writes
    its operand into a device buffer of its own that every other rank has
    mapped (CUDA IPC, ``kernels/csrc/ipc.cu``), the ranks meet at a gloo
    barrier, each reads what it needs from the others' buffers, and they
    meet again before a buffer is written anew. The bytes read are the
    ones the backend would have carried, so the results are the same
    bits.

Training differentiates through them (``torch.autograd``), each with
the adjoint that the SPMD convention gives it — every rank computes the
same scalar loss, so a replicated tensor's gradient is the same on
every rank and a rank's share of a sharded one is its own:

  * ``psum`` of partials (a row-parallel product, the vocab-sharded
    embedding, the loss's numerator over the data axes): the backward is
    the identity;
  * ``column_entry`` — the identity forward where a replicated
    activation (or a replicated weight such as ``q_norm``) enters work
    split over the ranks (a column-parallel product: ``wq``/``wk``/
    ``wv``, ``w_gate``/``w_up``, a vocab-sharded head): the backward is
    a ``psum``;
  * ``all_gather``: the backward is the rank's slice of the gradient
    when what follows the gather is replicated (``grad="replicated"``:
    the logits before the loss), or a ``psum`` then the slice when what
    follows is split over the ranks (``grad="split"``: K/V, whose
    gathered heads feed only the rank's query heads). A call that
    autograd records must say which;
  * ``gather_weights`` — a ZeRO-3 weight gathered over the data axes
    before a layer runs: its gradient is summed over them and the owner
    keeps its slice.

Each collective that training places goes by a name, and
``skipping(*names)`` leaves the named ones out inside its block — the
controls that show each one is needed: ``"column_entry"`` (every
column-parallel entry's sum over the model axis), ``"moe.router"`` (the
MoE's gate weights, which scale each rank's expert partial: the router's
gradient summed over the model axis), ``"mla.latent"`` (MLA's latent and
shared rope key, whole on every rank, entering the rank's heads),
``"rglru.xb"`` (the RG-LRU's width gather before its gate products: its
split backward), ``"cross.kv"`` (the cross-attention's memory K/V
gather: its split backward), ``"data_grads"`` (every gradient's sum
over the data plane: the train step's per-leaf psum and ZeRO-3's gather
backward), ``"data_grads:<key>"`` (the train step's sum for the leaves
whose path holds the key, e.g. ``"data_grads:ssd"``) and
``"gather_back"`` (ZeRO-1's gather of the updated slices,
``training/optim.py``). A skipped gather's backward takes the rank's
slice alone.

Each forward is the function it wraps, with the same bits and ``STATS``
(``psum`` reduces a copy, since autograd may keep its operand). The
backward's collectives count in ``STATS`` too. Outside autograd (serving,
``torch.no_grad``) the plain functions run, reducing in place.

``psum`` sums in the tensor's own dtype, as the reference's ``psum``
does, in axis order (bfloat16 included: gloo and the card both add
bfloat16 through float32 and round to nearest even; with two ranks one
addition, rounded once, whichever operand is first). With no axis
(``shard`` None: a model axis of one rank, the one-card mesh) each is the
identity, so one program serves both.

Every call adds its host-clock seconds, its bytes (of the local tensor)
and one call to ``STATS`` under its name; ``reset_stats`` zeroes them.
The timing is on the host clock around a blocking call, started after the
card has finished the work queued before the call (a CUDA operand is
synchronized first), so it times the collective alone: gloo returns once
the data have crossed (its CUDA path waits for the staging copies), so
the seconds include the device→host and host→device copies; on a shared
card the call returns after its copies and sums have finished on the
card and both barriers. The shared buffers are outside the framework's
allocator, so a rank's ``max_memory_allocated`` does not count them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as tdist


@dataclasses.dataclass(frozen=True)
class AxisShard:
    """The calling rank's place on one mesh axis of more than one rank."""
    index: int                 # coordinate on the axis
    size: int                  # ranks on the axis
    group: Any                 # the axis line's process group
    ranks: Tuple[int, ...]     # the line's global ranks, in axis order

    def part(self, n: int) -> Tuple[int, int]:
        """[start, stop) of this rank's equal share of ``n`` (n divisible
        by the axis size)."""
        if n % self.size:
            raise ValueError(f"{n} does not split over {self.size} ranks")
        k = n // self.size
        return self.index * k, (self.index + 1) * k


STATS: Dict[str, Dict[str, float]] = {
    name: {"calls": 0, "seconds": 0.0, "bytes": 0}
    for name in ("psum", "all_gather", "exchange", "broadcast")}


def reset_stats() -> None:
    for rec in STATS.values():
        rec.update(calls=0, seconds=0.0, bytes=0)


def stats() -> Dict[str, Dict[str, float]]:
    """A copy of ``STATS``."""
    return {k: dict(v) for k, v in STATS.items()}


def transport(shard: Optional[AxisShard], device) -> str:
    """What carries the axis' collectives of tensors on ``device``:
    ``"none"`` (no axis), ``"card"`` (ranks sharing the card: the shared
    buffers) or the group's backend."""
    if shard is None:
        return "none"
    backend = tdist.get_backend(shard.group)
    if torch.device(device).type == "cuda" and backend == "gloo":
        return "card"
    return str(backend)


def _clock(x: torch.Tensor) -> float:
    """The start of a collective's time: after the card has run the work
    queued before it (a CUDA operand), so that the call's seconds are the
    collective's own."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return time.perf_counter()


def _note(name: str, t0: float, nbytes: int) -> None:
    rec = STATS[name]
    rec["calls"] += 1
    rec["seconds"] += time.perf_counter() - t0
    rec["bytes"] += nbytes


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat ``uint8`` view."""
    return t.reshape(-1).view(torch.uint8)


def psum(x: torch.Tensor, shard: Optional[AxisShard]) -> torch.Tensor:
    """The sum of ``x`` over the axis (``jax.lax.psum``): every rank gets
    the same bits. Reduces in place when ``x`` is contiguous."""
    if shard is None:
        return x
    if _recorded(x):
        return _Reduce.apply(x, shard)
    t0 = _clock(x)
    x = x.contiguous()
    card = _on_card(x, shard)
    if card is None:
        tdist.all_reduce(x, op=tdist.ReduceOp.SUM, group=shard.group)
    elif x.numel():
        views = card.publish([x])
        torch.add(views[0], views[1], out=x)
        for v in views[2:]:
            x.add_(v)
        card.done()
    _note("psum", t0, x.numel() * x.element_size())
    return x


def all_gather(x: torch.Tensor, dim: int, shard: Optional[AxisShard],
               grad: Optional[str] = None, name: Optional[str] = None
               ) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in
    axis order: one broadcast from each rank. Under autograd ``grad``
    names the backward: ``"replicated"`` (what follows is the same on
    every rank: the rank's slice of the gradient) or ``"split"`` (what
    follows is split over the ranks: the gradient summed over the axis,
    then the slice, unless ``name`` is skipped); a recorded call without
    it raises."""
    if shard is None:
        return x
    if _recorded(x):
        if grad not in ("replicated", "split"):
            raise ValueError("all_gather under autograd needs grad="
                             "'replicated' or 'split' (its backward)")
        return _Gather.apply(x, dim, shard,
                             grad == "split" and not skipped(name))
    t0 = _clock(x)
    x = x.contiguous()
    card = _on_card(x, shard)
    if card is not None:
        out = torch.cat(card.publish([x]), dim=dim)
        card.done()
        _note("all_gather", t0, x.numel() * x.element_size())
        return out
    parts = []
    for i, src in enumerate(shard.ranks):
        buf = x if i == shard.index else torch.empty_like(x)
        tdist.broadcast(_bytes(buf), src=src, group=shard.group)
        parts.append(buf)
    out = torch.cat(parts, dim=dim)
    _note("all_gather", t0, x.numel() * x.element_size())
    return out


def exchange(blocks: List[torch.Tensor], shard: Optional[AxisShard]
             ) -> List[torch.Tensor]:
    """All-to-all of equal blocks: ``blocks[j]`` goes to axis member j
    (``blocks[index]`` stays); returns ``got`` with ``got[i]`` the block
    member i sent here. Every block on every rank has one shape and
    dtype. One broadcast a (source, destination) pair."""
    if shard is None:
        return list(blocks)
    t0 = _clock(blocks[shard.index])
    me = shard.index
    got: List[torch.Tensor] = [None] * shard.size
    got[me] = blocks[me]
    card = _on_card(blocks[me], shard)
    if card is not None:
        views = card.publish([b.contiguous() for b in blocks], slot=me)
        for i, v in enumerate(views):
            if i != me:
                got[i] = v.clone()
        card.done()
        sent = sum(b.numel() * b.element_size()
                   for j, b in enumerate(blocks) if j != me)
        _note("exchange", t0, sent)
        return got
    sent = 0
    for i, src in enumerate(shard.ranks):
        for j in range(shard.size):
            if j == i:
                continue
            if me == i:
                buf = blocks[j].contiguous()
                sent += buf.numel() * buf.element_size()
            else:
                buf = torch.empty_like(blocks[me],
                                       memory_format=torch.contiguous_format)
            tdist.broadcast(_bytes(buf), src=src, group=shard.group)
            if me == j:
                got[i] = buf
    _note("exchange", t0, sent)
    return got


def column_entry(x: torch.Tensor, shard: Optional[AxisShard],
                 name: Optional[str] = None) -> torch.Tensor:
    """``x`` — a replicated tensor entering work split over the axis —
    as it is; under autograd its gradient is summed over the axis (each
    rank's share of the split work adds its term), unless ``name`` is
    skipped (``skipping``)."""
    if shard is None or not _recorded(x) or skipped("column_entry") or \
            skipped(name):
        return x
    return _ColumnEntry.apply(x, shard)


_SKIPPED: set = set()


@contextlib.contextmanager
def skipping(*names: str):
    """A control: the collectives named ``names`` (see the module's
    docstring) left out of what runs inside the block."""
    saved = set(_SKIPPED)
    _SKIPPED.update(names)
    try:
        yield
    finally:
        _SKIPPED.clear()
        _SKIPPED.update(saved)


def any_skipped() -> bool:
    """Whether a control is on (``skipping``)."""
    return bool(_SKIPPED)


def skipped(name: Optional[str], path: str = "") -> bool:
    """Whether the collective ``name`` is skipped — for a leaf at
    ``path``, also by ``"name:<key>"`` with ``['<key>']`` in the path."""
    if name is None or not _SKIPPED:
        return False
    return name in _SKIPPED or any(
        s.startswith(name + ":") and f"['{s[len(name) + 1:]}']" in path
        for s in _SKIPPED)


def gather_weights(x: torch.Tensor, dim: Optional[int], owner: int,
                   shard: Optional[AxisShard]) -> torch.Tensor:
    """A ZeRO-3 weight of one layer, whole over the data plane ``shard``:
    with ``dim`` the rank's slices of the layer gathered on that dim;
    with ``dim`` None the layer lies whole on member ``owner`` (the data
    axes split the layer axis), which broadcasts it and every other rank
    passes a tensor of its shape (its own layer at the same place, an
    anchor that autograd reaches the collective through, which gets no
    gradient). Under autograd the gradient is summed over the plane and
    the rank keeps its slice, the owner the layer's."""
    if shard is None:
        return x
    return _WeightGather.apply(x, dim, owner, shard)


def _recorded(x: torch.Tensor) -> bool:
    """Whether autograd records an operation on ``x``."""
    return torch.is_grad_enabled() and x.requires_grad


def _summed(g: torch.Tensor, shard: AxisShard) -> torch.Tensor:
    """``g`` summed over the axis, on a copy (autograd may share ``g``)."""
    return psum(g.clone(memory_format=torch.contiguous_format), shard)


class _Reduce(torch.autograd.Function):
    """``psum`` of partials: the backward is the identity."""

    @staticmethod
    def forward(ctx, x, shard):
        return psum(x.clone(memory_format=torch.contiguous_format), shard)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ColumnEntry(torch.autograd.Function):
    """The identity; the backward sums the gradient over the axis."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.shard), None


class _Gather(torch.autograd.Function):
    """``all_gather``; the backward takes the rank's slice of the
    gradient, summed over the axis first when ``split``."""

    @staticmethod
    def forward(ctx, x, dim, shard, split):
        ctx.dim, ctx.shard, ctx.split = dim % x.dim(), shard, split
        return all_gather(x, dim, shard)

    @staticmethod
    def backward(ctx, g):
        if ctx.split:
            g = _summed(g, ctx.shard)
        lo, hi = ctx.shard.part(g.shape[ctx.dim])
        return g.narrow(ctx.dim, lo, hi - lo), None, None, None


class _WeightGather(torch.autograd.Function):
    """``gather_weights``: a gather on ``dim``, or the owner's broadcast;
    the backward sums over the plane and keeps the rank's part."""

    @staticmethod
    def forward(ctx, x, dim, owner, shard):
        ctx.dim, ctx.owner, ctx.shard = dim, owner, shard
        if dim is not None:
            return all_gather(x, dim, shard)
        t0 = _clock(x)
        out = x.clone(memory_format=torch.contiguous_format)
        card = _on_card(out, shard)
        if card is not None:
            views = card.publish([out])
            out.copy_(views[owner])
            card.done()
        else:
            tdist.broadcast(_bytes(out), src=shard.ranks[owner],
                            group=shard.group)
        _note("broadcast", t0, out.numel() * out.element_size())
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone() if skipped("data_grads") else _summed(g, ctx.shard)
        if ctx.dim is not None:
            lo, hi = ctx.shard.part(g.shape[ctx.dim])
            return g.narrow(ctx.dim, lo, hi - lo), None, None, None
        return (g if ctx.shard.index == ctx.owner else None), None, None, \
            None


# --------------------------------------------------------------------------- #
# ranks that share one card
# --------------------------------------------------------------------------- #
class _SharedCard:
    """The device buffers of one axis line whose ranks share a card: this
    rank's own (``kernels/csrc/ipc.cu``: cudaMalloc'd, exported) and every
    other rank's, mapped from its IPC handle; uint8 tensors in axis order.
    Every rank of the line calls ``publish`` and ``done`` together, with
    operands of one shape (a collective's contract), so the buffers grow
    in step."""

    ALIGN = 32 << 20          # buffers grow in steps of 32 MiB

    def __init__(self, shard: AxisShard, device: torch.device):
        self.shard = shard
        self.device = device
        self.capacity = 0
        self.ptrs: List[int] = []          # raw pointers, axis order
        self.bufs: List[torch.Tensor] = []

    def _lib(self):
        import ctypes
        from repro_torch.kernels import _build
        lib = _build.load()
        lib.rt_ipc_alloc.argtypes = [ctypes.c_int, ctypes.c_size_t,
                                     ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.c_void_p]
        lib.rt_ipc_open.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_void_p)]
        lib.rt_ipc_close.argtypes = [ctypes.c_void_p]
        lib.rt_ipc_free.argtypes = [ctypes.c_void_p]
        return lib, _build.check

    def _release(self) -> None:
        if not self.ptrs:
            return
        lib, check = self._lib()
        self.bufs = []
        for i, ptr in enumerate(self.ptrs):      # others' mappings first
            if i != self.shard.index:
                check(lib.rt_ipc_close(ptr), "cudaIpcCloseMemHandle")
        tdist.barrier(group=self.shard.group)    # no rank maps mine now
        check(lib.rt_ipc_free(self.ptrs[self.shard.index]), "cudaFree")
        self.ptrs, self.capacity = [], 0

    def _reserve(self, nbytes: int) -> None:
        if nbytes <= self.capacity:
            return
        import ctypes
        self._release()
        # the framework's cached blocks go back to the card first: the
        # buffer is a cudaMalloc of its own, which they would crowd out
        torch.cuda.empty_cache()
        lib, check = self._lib()
        cap = -(-nbytes // self.ALIGN) * self.ALIGN
        index = self.device.index or 0
        ptr = ctypes.c_void_p()
        handle = torch.zeros(lib.rt_ipc_handle_bytes(), dtype=torch.uint8)
        check(lib.rt_ipc_alloc(index, cap, ctypes.byref(ptr),
                               handle.data_ptr()), "cudaMalloc + IPC handle")
        handles = [torch.empty_like(handle) for _ in self.shard.ranks]
        tdist.all_gather(handles, handle, group=self.shard.group)
        ptrs = []
        for i, h in enumerate(handles):
            if i == self.shard.index:
                ptrs.append(ptr.value)
                continue
            other = ctypes.c_void_p()
            check(lib.rt_ipc_open(index, h.data_ptr(), ctypes.byref(other)),
                  "cudaIpcOpenMemHandle")
            ptrs.append(other.value)
        self.ptrs, self.capacity = ptrs, cap
        self.bufs = [torch.as_tensor(_DeviceBytes(p, cap), device=self.device)
                     for p in ptrs]

    def publish(self, parts: List[torch.Tensor], slot: Optional[int] = None
                ) -> List[torch.Tensor]:
        """Write ``parts`` (contiguous, one shape and dtype; their bytes
        back to back, ``slot``'s left out) into this rank's buffer, meet
        the others, and return each rank's operand as a view of its
        buffer: ``parts[0]``'s shape and dtype from every rank (``slot``
        None), or the block each rank wrote for ``slot`` (an exchange).
        The views are valid until ``done``."""
        like = parts[0]
        n = like.numel() * like.element_size()
        self._reserve(n * len(parts))
        own = self.bufs[self.shard.index]
        for j, p in enumerate(parts):
            if j != slot:
                own[j * n:(j + 1) * n].copy_(_bytes(p))
        torch.cuda.synchronize(self.device)
        tdist.barrier(group=self.shard.group)
        at = 0 if slot is None else slot * n
        return [b[at:at + n].view(like.dtype).view(like.shape)
                for b in self.bufs]

    def done(self) -> None:
        """The reads of ``publish``'s views have finished here; meet the
        others, after which each may write its buffer again."""
        torch.cuda.synchronize(self.device)
        tdist.barrier(group=self.shard.group)


class _DeviceBytes:
    """``nbytes`` of device memory at ``ptr`` as a CUDA array (for
    ``torch.as_tensor``; the memory is ``_SharedCard``'s to free)."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


_CARDS: Dict[Tuple, _SharedCard] = {}


def buffer_bytes() -> int:
    """The bytes of this rank's own shared-card buffers."""
    return sum(c.capacity for c in _CARDS.values())


def release_buffers() -> None:
    """Free this rank's shared-card buffers and unmap the others' (a
    world that goes on to another model: they are grown again at its
    first collectives). Every rank of the world calls it together; the
    lines are released in the order of their ranks, the same on every
    rank."""
    for key in sorted(_CARDS, key=lambda k: k[0]):
        _CARDS.pop(key)._release()


def _on_card(x: torch.Tensor, shard: AxisShard) -> Optional[_SharedCard]:
    """The line's shared buffers when its ranks share a card (a CUDA
    operand over a gloo group), else None: the backend carries it."""
    if not x.is_cuda or tdist.get_backend(shard.group) != "gloo":
        return None
    key = (shard.ranks, id(shard.group))
    if key not in _CARDS:
        _CARDS[key] = _SharedCard(shard, x.device)
    return _CARDS[key]

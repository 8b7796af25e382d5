"""Distribution context — launch-layer knobs consulted by the model code
(PyTorch port of ``repro.models.dist``: the same fields and defaults).

The serving engines and the unit tests run with the default context
(everything off). The launch layer (``repro_torch.launch.steps``) installs
one to switch on:

  * chunk_kv      — on the plain attention route, chunked (online-softmax)
                    attention from this sequence length on
                    (``layers.chunked_sdpa``); it bounds the score buffer
                    of a 32k prefill. The card's kernel route never
                    materialises the scores (flash), so it ignores it.
  * moe_shard_map — with a mesh, the capacity-bounded MoE
                    (``layers._moe_mlp_capacity``) in place of the exact
                    per-expert route; on a mesh whose model axis is 1 (one
                    card) the reference's shard_map body is that function
                    with a sum over one member, on a rank's mesh the
                    rank's expert slices summed over the model axis.
  * moe_capacity_factor, chunk_size, attn_p_bf16 — as in the reference.
  * vocab_parallel — kept for parity; no port code reads it (nor does the
                    reference's model code).
  * unroll, act_spec — inert: kept for parity of the fields, set by
                    nothing and read by nothing. The port's layer loop is
                    Python (there is no scan to unroll, and a FLOP count
                    covers every layer), and one device has no sharding
                    constraint to anchor the residual stream to.

``mesh`` is a ``repro_torch.launch.mesh.Mesh`` or None. On a rank's
mesh in a ``torch.distributed`` world it carries the rank's place on
each axis and the axis lines' groups; ``model_shard()`` gives the model
axis' (an ``AxisShard``), through which the layers hold the rank's
shards and reduce over the axis (``models/collectives.py``). None — a
model axis of 1, a mesh outside a world (one card, or ``meta``'s count of
the whole program), no mesh — means the layers run the whole model.
``data_shard()`` is the plane of the data axes (``dp_axes``): a rank's
batch rows are its share of the batch, and the training loss sums over
the plane (``model.loss_fn``). ``zero3`` — None here; a field of the
port's ``TrainContext``, which the launch layer's train step installs
for a ``zero3`` cell — maps each parameter path (``training.tree``'s)
to the dim of the stacked leaf that the data plane splits, or None:
``model.train_forward`` then gathers each layer's weights as it runs
it. ``layer_block`` is the one rule of which data rank holds which
layer when that dim is a group's layer axis.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DistContext:
    mesh: Any = None
    dp_axes: Tuple[str, ...] = ()
    model_axis: Optional[str] = None
    chunk_kv: int = 0            # 0 = never chunk
    chunk_size: int = 1024
    vocab_parallel: bool = False
    moe_shard_map: bool = False
    moe_capacity_factor: float = 1.25
    attn_p_bf16: bool = False    # bf16 probabilities into the PV product
    unroll: bool = False
    act_spec: Any = None         # spec of the (B, S, d) residuals
    zero3 = None                 # not a field: TrainContext's

    def model_shard(self):
        """The calling rank's ``AxisShard`` on the model axis, or None
        when the layers run unsharded."""
        if self.mesh is None or self.model_axis is None \
                or not hasattr(self.mesh, "axis_shard"):
            return None
        return self.mesh.axis_shard(self.model_axis)

    def data_shard(self):
        """The calling rank's ``AxisShard`` on the plane of the data axes,
        or None (one data rank, or the layers run the whole batch)."""
        if self.mesh is None or not self.dp_axes \
                or not hasattr(self.mesh, "axis_shard"):
            return None
        return self.mesh.axis_shard(tuple(self.dp_axes))


@dataclasses.dataclass(frozen=True)
class TrainContext(DistContext):
    """The reference's fields and ZeRO-3 weights' placement: {parameter
    path: the dim of the stacked leaf that the data plane splits, or
    None}."""
    zero3: Any = None


def layer_block(i: int, count: int, ways: int) -> Tuple[int, int]:
    """A stacked group's layer axis of ``count`` layers split over
    ``ways`` data ranks (ZeRO-3 weights) — whole blocks of ``count //
    ways`` layers, in order: (the data rank that holds layer ``i``, its
    slot in that rank's block)."""
    per = count // ways
    return i // per, i % per


_DEFAULT = DistContext()
_CURRENT = _DEFAULT


def ctx() -> DistContext:
    return _CURRENT


@contextlib.contextmanager
def use(context: DistContext):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = context
    try:
        yield context
    finally:
        _CURRENT = prev

"""Training step: loss → gradients → AdamW — PyTorch port of
``repro.training.train_step``.

``make_train_step(cfg, opt)`` returns
  step(state, batch) -> (state, metrics)
with metrics {"loss", "grad_norm", "lr"} (0-d tensors on the device). The
gradients come from ``torch.autograd.grad`` over the flattened parameter
leaves; the parameters and the optimizer state are updated in place (the
returned state holds the same tensors). Remat is inside the model
(``torch.utils.checkpoint`` around each layer). The reference's
``accum_shardings`` (ZeRO-2 placement of the accumulator over a data axis)
has no counterpart: the accumulator is the rank's whole (model-local)
gradient.

On a rank's mesh (``layout``, an ``optim.Layout``; the launch layer's
``make_train_artifacts`` runs the step under its distribution context)
each rank holds its batch rows and its shards of the state. The loss is
the whole batch's mean (``model.loss_fn`` sums over the data axes), so
the data-parallel gradient of a leaf is the sum of the ranks' gradients:
each leaf that the data axes do not split is summed over the data plane
(a ``psum``), in slices of at most ``optim.SLICE_ELEMS`` elements along
its first axis — never as one flat copy of the model, since the shared
card's buffers grow to the largest operand. With ``n_micro`` > 1 the sum
runs after each micro-batch's backward, before its gradient is divided
and cast into the bfloat16 accumulator: the reference's micro-batch
gradient is the whole micro-batch's, summed over its data shards in the
parameter dtype before the cast (its partitioner places the reduction;
summing after the accumulation would add the shards' bf16-rounded
partials instead). A rank's micro-batch j is its own j-th block of rows,
which the launch layer makes its share of the whole batch's j-th block
(``sharding.micro_major``), so the mesh's micro-batches are the
reference's.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _dev
from repro_torch.configs.base import ModelConfig
from repro_torch.models import collectives as C
from repro_torch.models import model as M
from repro_torch.training.optim import (SLICE_ELEMS, AdamWConfig, Layout,
                                        adamw_init, adamw_update)
from repro_torch.training.tree import (leaves, leaves_with_paths, tree_map,
                                      unflatten)

Params = Any


@dataclasses.dataclass
class TrainState:
    params: Params
    opt: dict


def train_state_init(cfg: ModelConfig, seed: int = 0,
                     device: _dev.DeviceLike = None) -> TrainState:
    """Parameters drawn from ``seed`` (``M.init_params``) and zero AdamW
    moments, on the card unless ``device="cpu"``."""
    params = M.init_params(cfg, seed=seed, device=device)
    return TrainState(params=params, opt=adamw_init(params))


def abstract_train_state(cfg: ModelConfig) -> TrainState:
    """The train state's shapes and dtypes on the ``meta`` device (the
    dry-run path: nothing is allocated)."""
    params = M.abstract_params(cfg)
    return TrainState(params=params, opt=adamw_init(params))


def device_batch(batch: Dict[str, np.ndarray],
                 device: _dev.DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A host batch (``SyntheticTokens``' numpy arrays) as tensors on the
    card unless ``device="cpu"``."""
    dev = _dev.resolve(device)
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def loss_and_grads(cfg: ModelConfig, params: Params,
                   batch: Dict[str, torch.Tensor], remat: bool = True
                   ) -> Tuple[torch.Tensor, Params]:
    """``M.loss_fn`` and its gradient with respect to every parameter leaf
    (``torch.autograd.grad`` over the flattened leaves; a leaf the loss
    does not reach gets zeros, as ``jax.grad`` gives). Returns (loss, a
    tree of gradients shaped like ``params``)."""
    flat = leaves(params)
    live = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss = M.loss_fn(unflatten(params, live), cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(params, grads)


@torch.no_grad()
def reduce_grads(grads: Params, layout: Optional[Layout]) -> Params:
    """Each gradient leaf that ``layout`` marks summed over its data
    plane, in place, in slices along its first axis (no reduction with
    no layout or no data plane; a leaf whose sum a control skips,
    ``collectives.skipping("data_grads")`` or ``("data_grads:<key>")``,
    keeps the rank's own)."""
    if layout is None or layout.dp is None:
        return grads
    paths = ([p for p, _ in leaves_with_paths(grads)] if C.any_skipped()
             else itertools.repeat(""))
    for g, on, path in zip(leaves(grads), layout.reduce, paths):
        if on and not C.skipped("data_grads", path):
            rows = max(1, SLICE_ELEMS // max(1, g[0].numel())) \
                if g.ndim else 1
            for part in (torch.split(g, rows) if g.ndim else (g,)):
                summed = C.psum(part, layout.dp)
                if summed is not part:          # not contiguous
                    part.copy_(summed)
    return grads


class TrainStep:
    """``step(state, batch) -> (state, metrics)``; ``step.grads(params,
    batch) -> (loss, grads)`` is its loss and reduced (accumulated)
    gradients alone, the state untouched."""

    def __init__(self, cfg: ModelConfig, opt: AdamWConfig, remat: bool,
                 n_micro: int, layout: Optional[Layout]):
        self.cfg, self.opt, self.remat = cfg, opt, remat
        self.n_micro, self.layout = n_micro, layout

    def grads(self, params: Params, batch: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, Params]:
        cfg, remat, n_micro = self.cfg, self.remat, self.n_micro
        if n_micro == 1:
            loss, grads = loss_and_grads(cfg, params, batch, remat)
            return loss, reduce_grads(grads, self.layout)
        micro = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                              + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        grads = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.bfloat16, device=p.device), params)
        loss = 0
        for i in range(n_micro):
            l, g = loss_and_grads(cfg, params,
                                  {k: v[i] for k, v in micro.items()}, remat)
            g = reduce_grads(g, self.layout)
            with torch.no_grad():
                for acc, gi in zip(leaves(grads), leaves(g)):
                    acc.add_((gi / n_micro).to(torch.bfloat16))
            del g
            loss = loss + l
        return loss / n_micro, grads

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, grads = self.grads(state.params, batch)
        extra = {} if self.layout is None else {"layout": self.layout}
        params, opt_state, om = adamw_update(self.opt, state.params, grads,
                                             state.opt, **extra)
        return TrainState(params=params, opt=opt_state), {"loss": loss, **om}


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, *,
                    remat: bool = True, n_micro: int = 1,
                    layout: Optional[Layout] = None) -> TrainStep:
    """``n_micro > 1``: gradient accumulation — the batch is split into
    ``n_micro`` micro-batches run in turn, and each one's gradients, divided
    by ``n_micro``, are added into a bfloat16 accumulator whatever the
    parameter dtype (so AdamW receives bfloat16 gradients), as in the
    reference. ``layout``: the rank's placement on a mesh (see the module
    docstring)."""
    return TrainStep(cfg, opt, remat, n_micro, layout)

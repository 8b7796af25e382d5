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
has no counterpart on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import device as _dev
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.training.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.training.tree import leaves, tree_map, unflatten

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


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, *,
                    remat: bool = True, n_micro: int = 1):
    """``n_micro > 1``: gradient accumulation — the batch is split into
    ``n_micro`` micro-batches run in turn, and each one's gradients, divided
    by ``n_micro``, are added into a bfloat16 accumulator whatever the
    parameter dtype (so AdamW receives bfloat16 gradients), as in the
    reference."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if n_micro == 1:
            loss, grads = loss_and_grads(cfg, state.params, batch, remat)
        else:
            micro = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.bfloat16, device=p.device), state.params)
            loss = 0
            for i in range(n_micro):
                l, g = loss_and_grads(cfg, state.params,
                                      {k: v[i] for k, v in micro.items()},
                                      remat)
                with torch.no_grad():
                    for acc, gi in zip(leaves(grads), leaves(g)):
                        acc.add_((gi / n_micro).to(torch.bfloat16))
                del g
                loss = loss + l
            loss = loss / n_micro
        params, opt_state, om = adamw_update(opt, state.params, grads,
                                             state.opt)
        return TrainState(params=params, opt=opt_state), {"loss": loss, **om}

    return step

"""AdamW with linear warmup and cosine decay — PyTorch port of
``repro.training.optim``.

State mirrors the parameters: {"mu": tree, "nu": tree, "step": 0-d int32}.
The moments are float32 whatever the parameter dtype; there are no float32
master weights: each new parameter is computed in float32 and cast back to
its dtype. Decoupled weight decay applies to every leaf with ``ndim >= 2``
of the tree as it is stacked, so a group's stacked norm vectors (count, d)
decay as in the reference.

The update runs in place (the returned trees are the given ones) and in
slices of at most ``SLICE_ELEMS`` elements along each leaf's first axis, so
its float32 temporaries stay a slice's size: at Qwen3-4B a stacked MLP
leaf holds 896.6 M elements, whose unsliced float32 temporaries would come
to about 17 GiB. The arithmetic is the reference's, in its order, element
by element.

On a rank's mesh a ``Layout`` says how the rank holds each leaf (the
launch layer's specs, ``launch.sharding.train_layout``): the gradient
norm sums each leaf's squares over the plane of the axes that split it
(a leaf replicated on an axis counts once), and with ZeRO-1 moments —
the rank's slice on the data axes of a dim the parameter holds whole —
the rank updates the matching slice of the parameter with its slice of
the (data-reduced) gradient, then the slices are gathered back over the
data axes, so every rank holds the whole updated parameter (its model
shard of it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.models import collectives as C
from repro_torch.training.tree import leaves, tree_map

Params = Any

SLICE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio·lr (float32)."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decayed)


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a rank of a mesh holds the train state, one entry a parameter
    leaf (flattening order): ``reduce`` — its gradient is summed over the
    data plane ``dp`` (a leaf the data axes do not split; a ZeRO-3 leaf's
    gradient arrives summed); ``norm`` — the plane of the axes that split
    it, over which its squares are summed (None: held whole); ``zero``
    — the dim of the parameter that its moments split over ``dp``
    (ZeRO-1), or None."""
    dp: Optional[C.AxisShard]
    reduce: Tuple[bool, ...]
    norm: Tuple[Optional[C.AxisShard], ...]
    zero: Tuple[Optional[int], ...]


def adamw_init(params: Params) -> dict:
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    return {"mu": tree_map(zeros32, params), "nu": tree_map(zeros32, params),
            "step": step}


def _slices(t: torch.Tensor):
    """``t`` split along its first axis into views of at most
    ``SLICE_ELEMS`` elements (the whole of a 0-d or 1-d leaf)."""
    if t.ndim < 2:
        return (t,)
    rows = max(1, SLICE_ELEMS // max(1, t[0].numel()))
    return torch.split(t, rows)


def global_norm(tree: Params, layout: Optional[Layout] = None
                ) -> torch.Tensor:
    """The gradient norm of the whole model: with ``layout``, each leaf's
    squares (as the rank holds it) summed with those of the leaves split
    over the same plane, each plane's sum over its ranks, then added."""
    parts = {}                    # plane (None: held whole) -> sum
    for i, x in enumerate(leaves(tree)):
        key = None if layout is None else layout.norm[i]
        parts[key] = parts.get(key, 0) + sum(
            torch.sum(torch.square(s.float())) for s in _slices(x))
    total = 0
    for plane, part in parts.items():
        total = total + C.psum(part, plane)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Params, grads: Params,
                 state: dict, layout: Optional[Layout] = None
                 ) -> Tuple[Params, dict, dict]:
    """One AdamW step, in place. Returns (params, state, metrics) with
    metrics {"grad_norm", "lr"} (0-d float32 tensors on the device). With
    ``layout`` (a rank's mesh) the norm is the whole model's and ZeRO-1
    moments update their slice of each parameter, gathered back over the
    data axes."""
    step = state["step"] + 1
    gnorm = global_norm(grads, layout)
    if cfg.grad_clip > 0:
        scale = torch.where(gnorm > cfg.grad_clip, cfg.grad_clip / gnorm,
                            torch.ones_like(gnorm))
    else:
        scale = torch.ones_like(gnorm)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, mu, nu, decay: bool):
        g32 = g.float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        if decay:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)

    for i, (p, g, mu, nu) in enumerate(zip(
            leaves(params), leaves(grads), leaves(state["mu"]),
            leaves(state["nu"]))):
        d = None if layout is None else layout.zero[i]
        whole = p
        if d is not None:                 # ZeRO-1: the rank's slice
            lo, hi = layout.dp.part(p.shape[d])
            p, g = p.narrow(d, lo, hi - lo), g.narrow(d, lo, hi - lo)
        for sl in zip(*map(_slices, (p, g, mu, nu))):
            upd(*sl, decay=p.ndim >= 2)
        if d is not None:
            gather_back(whole, p, d, layout.dp)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def gather_back(whole: torch.Tensor, part: torch.Tensor, dim: int,
                dp: C.AxisShard) -> None:
    """ZeRO-1's last move: the parameter ``whole``, whose slice ``part``
    on ``dim`` the rank has updated, overwritten by every data rank's
    updated slice, gathered over ``dp`` (left out under the control
    ``collectives.skipping("gather_back")``)."""
    if not C.skipped("gather_back"):
        whole.copy_(C.all_gather(part.contiguous(), dim, dp))

"""Heterogeneous parallel-strategy alignment component (paper §III-B-3,
Fig. 4) — PyTorch port of ``repro.core.compat.parallel_align``.

Each TP rank of P holds a KV shard of kv_heads/tp_p heads; D ranks need
kv_heads/tp_d heads:

  tp_p > tp_d  → each D rank COMBINES tp_p/tp_d P shards   (Fig. 4 left)
  tp_p < tp_d  → each P shard SPLITS into tp_d/tp_p slices (Fig. 4 right)
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Read plan for one D rank: list of (p_rank, head_lo, head_hi) slices
    in P-shard-local head coordinates."""
    d_rank: int
    reads: Tuple[Tuple[int, int, int], ...]


def plan_realign(kv_heads: int, tp_p: int, tp_d: int) -> List[ShardPlan]:
    """Static read plan (control-plane): which P shard slices feed each D rank."""
    assert kv_heads % tp_p == 0, (kv_heads, tp_p)
    assert kv_heads % tp_d == 0, (kv_heads, tp_d)
    per_p = kv_heads // tp_p
    per_d = kv_heads // tp_d
    plans = []
    for d in range(tp_d):
        lo, hi = d * per_d, (d + 1) * per_d
        reads = []
        for p in range(tp_p):
            plo, phi = p * per_p, (p + 1) * per_p
            s, e = max(lo, plo), min(hi, phi)
            if s < e:
                reads.append((p, s - plo, e - plo))
        plans.append(ShardPlan(d_rank=d, reads=tuple(reads)))
    return plans


def realign_shards(shards_p: Sequence[torch.Tensor],
                   tp_d: int) -> List[torch.Tensor]:
    """tp_p tensors of (S, kv_heads/tp_p, hd) → tp_d tensors of
    (S, kv_heads/tp_d, hd). Combine = concat, split = slice (Fig. 4)."""
    tp_p = len(shards_p)
    kv_heads = sum(s.shape[1] for s in shards_p)
    out = []
    for plan in plan_realign(kv_heads, tp_p, tp_d):
        parts = [shards_p[p][:, lo:hi] for (p, lo, hi) in plan.reads]
        out.append(parts[0] if len(parts) == 1 else torch.cat(parts, 1))
    return out

"""Load-aware P/D routing policy for the multi-instance cluster runtime —
PyTorch port of ``repro.serving.router`` (pure Python).

The cluster parent cannot call ``Engine.load()`` / ``Engine.can_admit()``
— the engines live in other OS processes — so routing runs on *snapshots*:
the parent's own dispatch bookkeeping (authoritative for admission, since
heartbeats lag) refreshed by the measured load each worker reports in its
heartbeats. The policy mirrors the single-process ``GlobalScheduler``:

  * a prompt goes to the P with the least outstanding prefill work —
    queue depth weighted by estimated prefill tokens per request, i.e.
    the sum of estimated tokens still queued on that instance;
  * a stream's D is picked among instances that can admit it (a free
    slot, enough free paged blocks, the sequence fits) by decode queue
    depth first and free KV-pool bytes second — the TetriInfer-style
    per-request instance selection by load.

The module also holds the *admission-control* policy for open-loop
(heavy-traffic) serving: :class:`AdmissionConfig` + :func:`should_admit`
decide, per arriving request, whether the cluster still has SLO headroom
— measured queue depth below the shed watermark and the TTFT EMA inside
the SLO budget — or whether the request must be shed at the door.
Shedding happens only at submit: a request that was admitted is never
dropped mid-stream.

Pure functions over frozen snapshots so the policy is unit-testable
without processes and reusable by benchmarks and the autoscaler.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.serving.engine import VendorProfile
from repro_torch.serving.prefix_cache import hashing


@dataclasses.dataclass(frozen=True)
class PSnapshot:
    """One prefill instance's routable state."""
    iid: str
    queue_reqs: int                 # dispatched prefills not yet done
    queue_tokens: int               # estimated prompt tokens among them


@dataclasses.dataclass(frozen=True)
class DSnapshot:
    """One decode instance's routable state."""
    iid: str
    active: int                     # slots reserved or decoding
    max_batch: int
    free_blocks: int                # unreserved paged blocks (parent view)
    block_size: int
    max_blocks_per_seq: int
    max_seq_len: int
    block_bytes: int                # KV bytes per paged block (estimate)
    # chained prefix-block digests this instance's prefix store holds
    # (heartbeat-reported; empty when the cache is off or cold). Chained
    # hashing makes set membership sufficient: a prompt's leading chain
    # run inside this set IS its longest cached prefix on that instance.
    prefix_hashes: frozenset = frozenset()


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """SLO-aware admission control for open-loop load.

    A request is shed at submit when either headroom signal is exhausted:

      * ``max_queue_depth`` — measured undispatched queue depth (parent
        pending + dispatched-but-unprefilled P backlog) at or above this
        watermark means arrivals outpace drain; more queueing only adds
        latency to every queued request.
      * ``slo_ttft_s`` × ``headroom`` — the measured TTFT EMA crossing
        this budget means requests already admitted are blowing the SLO;
        admitting more cannot end well.

    Either signal may be disabled with ``None``. ``ema_alpha`` weights the
    newest TTFT sample (higher = faster reaction)."""
    max_queue_depth: Optional[int] = None
    slo_ttft_s: Optional[float] = None
    headroom: float = 1.0
    ema_alpha: float = 0.3


def update_ttft_ema(ema: Optional[float], sample: float,
                    alpha: float) -> float:
    """Fold one measured TTFT into the admission EMA."""
    return sample if ema is None else alpha * sample + (1 - alpha) * ema


def should_admit(cfg: Optional[AdmissionConfig], queue_depth: int,
                 ttft_ema: Optional[float]) -> bool:
    """Pure shed decision: False when measured queue depth or TTFT-EMA
    headroom is exhausted. No config (or no signal yet) always admits.

    The TTFT gate only fires while work is actually queued: the EMA is
    *history*, and it only refreshes when admitted requests produce first
    tokens — shedding on a stale high EMA over an empty cluster would
    lock every future request out (no admits → no fresh samples → shed
    forever). An idle queue means the congestion the EMA recorded has
    drained, so the next arrival is the probe that updates it."""
    if cfg is None:
        return True
    if cfg.max_queue_depth is not None and queue_depth >= cfg.max_queue_depth:
        return False
    if cfg.slo_ttft_s is not None and ttft_ema is not None \
            and queue_depth > 0 \
            and ttft_ema > cfg.slo_ttft_s * cfg.headroom:
        return False
    return True


def kv_block_bytes(cfg: ModelConfig, vendor: VendorProfile) -> int:
    """Estimated KV-pool bytes behind one paged block of this instance —
    enough to compare *free KV-pool bytes* across heterogeneous vendors
    (different block sizes / dtypes) without touching device pools."""
    itemsize = torch_dtype(vendor.kv_dtype).itemsize
    if cfg.prefill_capabilities().latent_kv:
        per_token = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    else:
        per_token = 2 * max(cfg.num_kv_heads, 1) * cfg.hd
    return per_token * vendor.block_size * max(cfg.num_layers, 1) * itemsize


def blocks_needed(seq_total: int, block_size: int,
                  max_blocks_per_seq: int) -> int:
    """Paged blocks a sequence of ``seq_total`` tokens reserves — must
    mirror ``Engine.reserve_sequence`` or parent admission drifts from the
    worker's allocator."""
    return min(-(-seq_total // block_size), max_blocks_per_seq)


def pick_p(snaps: List[PSnapshot]) -> Optional[str]:
    """Least-loaded prefill instance: minimal outstanding estimated
    prefill tokens (queue depth × estimated tokens per queued request),
    request count breaking ties, instance id making it deterministic."""
    if not snaps:
        return None
    return min(snaps, key=lambda s: (s.queue_tokens, s.queue_reqs, s.iid)).iid


def pick_d(snaps: List[DSnapshot], seq_len: int, max_new_tokens: int,
           prompt=None) -> Optional[Tuple[str, int]]:
    """Decode instance for a stream of ``seq_len`` prompt tokens +
    ``max_new_tokens`` budget. Returns ``(iid, blocks_reserved)`` or
    ``None`` when no instance can admit (caller keeps the request queued).

    Admission mirrors ``Engine.can_admit``; among admissible instances
    prefix affinity wins first (when ``prompt`` is given and an instance
    advertises cached prefix digests: tokens of the prompt's longest
    chain run inside the instance's digest set — those tokens skip the
    wire entirely, which beats any load delta), then the least-occupied
    (decode queue depth), free KV-pool bytes breaking ties — an idle
    instance with a fuller pool still beats a busy one with an emptier
    pool, matching the single-process router's slot-load primary key.
    With no prompt or all-cold stores every affinity is 0 and the legacy
    ordering is preserved bit-for-bit."""
    seq_total = seq_len + max_new_tokens
    chains = {}     # block_size -> prompt digest chain (computed lazily)
    best = None
    for s in snaps:
        if seq_total > s.max_seq_len or s.active >= s.max_batch:
            continue
        need = blocks_needed(seq_total, s.block_size, s.max_blocks_per_seq)
        if s.free_blocks < need:
            continue
        affinity = 0
        if prompt is not None and s.prefix_hashes:
            chain = chains.get(s.block_size)
            if chain is None:
                chain = hashing.chain_hashes(prompt, s.block_size,
                                             limit=max(seq_len - 1, 0))
                chains[s.block_size] = chain
            affinity = hashing.matched_prefix_tokens(
                chain, s.prefix_hashes, s.block_size)
        key = (-affinity, s.active / s.max_batch,
               -s.free_blocks * s.block_bytes, s.iid)
        if best is None or key < best[0]:
            best = (key, s.iid, need)
    return None if best is None else (best[1], best[2])

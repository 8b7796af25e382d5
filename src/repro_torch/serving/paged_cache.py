"""Paged KV cache — block pools, block tables, and a host-side allocator.

PyTorch port of ``repro.serving.paged_cache``. Different vendors
(instances) run different ``block_size`` and page *layout*:

  "nbhd": (num_blocks, block_size, kv_heads, head_dim)   token-major
  "nhbd": (num_blocks, kv_heads, block_size, head_dim)   head-major
  "nhdb": (num_blocks, kv_heads, head_dim, block_size)   dim-major

Where the JAX functions return a new pool, the functions here update
``pool`` in place (and return it, so call sites read the same): a pool
holds gigabytes at serving widths and is never copied.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import torch_dtype

LAYOUTS = ("nbhd", "nhbd", "nhdb")

# permutation from canonical page (block, kv, hd) to each layout
_FROM_CANON = {"nbhd": (0, 1, 2), "nhbd": (1, 0, 2), "nhdb": (1, 2, 0)}

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class KVPageSpec:
    """Vendor-specific VRAM management description of one instance."""
    block_size: int
    layout: str = "nbhd"
    dtype: str = "bfloat16"
    kv_heads: int = 1
    head_dim: int = 1

    def __post_init__(self):
        assert self.layout in LAYOUTS, self.layout

    @property
    def tdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def page_shape(self) -> Tuple[int, ...]:
        canon = (self.block_size, self.kv_heads, self.head_dim)
        perm = _FROM_CANON[self.layout]
        return tuple(canon[i] for i in perm)

    def pool_shape(self, num_blocks: int) -> Tuple[int, ...]:
        return (num_blocks,) + self.page_shape()

    def blocks_for(self, seq_len: int) -> int:
        return -(-seq_len // self.block_size)


def _to_canon_perm(layout: str) -> Tuple[int, ...]:
    perm = _FROM_CANON[layout]
    inv = [0, 0, 0]
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


def pages_from_canonical(spec: KVPageSpec, canon: torch.Tensor) -> torch.Tensor:
    """(nb, block, kv, hd) canonical pages → layout pages (a view)."""
    perm = _FROM_CANON[spec.layout]
    return canon.permute((0,) + tuple(p + 1 for p in perm))


def pages_to_canonical(spec: KVPageSpec, pages: torch.Tensor) -> torch.Tensor:
    """layout pages → (nb, block, kv, hd) canonical pages (a view)."""
    inv = _to_canon_perm(spec.layout)
    return pages.permute((0,) + tuple(i + 1 for i in inv))


# --------------------------------------------------------------------------- #
# torch pool ops (plain implementations; CUDA kernels in repro_torch.kernels)
# --------------------------------------------------------------------------- #
def scatter_sequence(spec: KVPageSpec, pool: torch.Tensor,
                     block_ids: torch.Tensor,
                     kv_canon: torch.Tensor) -> torch.Tensor:
    """Write canonical (S, kv, hd) into pool pages at ``block_ids``, in
    place. S is zero-padded up to a whole number of blocks."""
    s = kv_canon.shape[0]
    nb = block_ids.shape[0]
    pad = nb * spec.block_size - s
    assert pad >= 0, (s, nb, spec.block_size)
    canon = torch.zeros((nb * spec.block_size, spec.kv_heads, spec.head_dim),
                        dtype=pool.dtype, device=pool.device)
    canon[:s] = kv_canon.to(pool.dtype)
    canon = canon.reshape(nb, spec.block_size, spec.kv_heads, spec.head_dim)
    pool[block_ids.long()] = pages_from_canonical(spec, canon)
    return pool


def scatter_sequence_overlay(spec: KVPageSpec, pool: torch.Tensor,
                             block_ids: torch.Tensor, kv_canon: torch.Tensor,
                             front: int) -> torch.Tensor:
    """Write canonical (S, kv, hd) into pool pages at ``block_ids`` starting
    ``front`` rows into the first block, keeping the rows outside
    ``[front, front + S)``. In place: only the covered rows are written,
    which is what the reference's read-merge-write of the boundary pages
    leaves behind."""
    s = kv_canon.shape[0]
    nb = block_ids.shape[0]
    bs = spec.block_size
    back = nb * bs - front - s
    assert 0 <= front < bs and back >= 0, (front, s, nb, bs)
    ids = block_ids.long()
    canon = pages_to_canonical(spec, pool[ids])          # gathered copy
    flat = canon.reshape(nb * bs, spec.kv_heads, spec.head_dim)
    flat[front:front + s] = kv_canon.to(pool.dtype)
    pool[ids] = pages_from_canonical(
        spec, flat.reshape(nb, bs, spec.kv_heads, spec.head_dim))
    return pool


def append_token(spec: KVPageSpec, pool: torch.Tensor,
                 block_ids: torch.Tensor, slot: torch.Tensor,
                 kv_tok: torch.Tensor) -> torch.Tensor:
    """Write one token's KV per sequence during decode, in place.

    block_ids: (B,) physical block of each seq's current page;
    slot: (B,) offset within the block; kv_tok: (B, kv, hd)."""
    kv_tok = kv_tok.to(pool.dtype)
    b, s = block_ids.long(), slot.long()
    if spec.layout == "nbhd":
        pool[b, s] = kv_tok
    elif spec.layout == "nhbd":
        pool[b, :, s] = kv_tok
    else:                                                  # nhdb
        pool[b, :, :, s] = kv_tok
    return pool


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_table: torch.Tensor,
                        seq_lens: torch.Tensor, spec: KVPageSpec,
                        scale: Optional[float] = None,
                        window: int = 0) -> torch.Tensor:
    """Decode attention against paged KV. Plain (gather) path.

    q: (B, 1, H, hd); block_table: (B, max_blocks); seq_lens: (B,) lengths
    INCLUDING the current token. ``window`` > 0 masks a sliding window.
    Returns (B, 1, H, hd)."""
    b, _, h, hd = q.shape
    max_b = block_table.shape[1]
    kv = spec.kv_heads
    ids = block_table.reshape(-1).long()
    kp = pages_to_canonical(spec, k_pool[ids])
    vp = pages_to_canonical(spec, v_pool[ids])
    s_max = max_b * spec.block_size
    k = kp.reshape(b, s_max, kv, hd)
    v = vp.reshape(b, s_max, kv, hd)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    grp = h // kv
    qg = q.reshape(b, 1, kv, grp, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    pos = torch.arange(s_max, device=q.device)[None]
    lens = seq_lens.to(q.device).long()[:, None]
    ok = pos < lens
    if window > 0:
        ok &= pos >= (lens - window)
    mask = torch.where(ok, 0.0, NEG_INF)
    scores = scores + mask[:, None, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


# --------------------------------------------------------------------------- #
# Host-side block allocator (one per instance): a live block is owned by
# exactly one sequence; free+owned partitions the pool.
# --------------------------------------------------------------------------- #
class BlockAllocator:
    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._owned: Dict[str, List[int]] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def allocate(self, seq_id: str, n: int) -> List[int]:
        if len(self._free) < n:
            raise MemoryError(
                f"paged pool exhausted: want {n}, free {len(self._free)}")
        blocks = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(seq_id, []).extend(blocks)
        return blocks

    def blocks_of(self, seq_id: str) -> List[int]:
        return list(self._owned.get(seq_id, []))

    def free(self, seq_id: str) -> int:
        blocks = self._owned.pop(seq_id, [])
        self._free.extend(reversed(blocks))
        return len(blocks)

    def check_invariants(self) -> None:
        owned = [b for bs in self._owned.values() for b in bs]
        assert len(set(owned)) == len(owned), "double-owned block"
        assert set(owned).isdisjoint(self._free), "owned block in free list"
        assert len(owned) + len(self._free) == self.num_blocks, "leaked block"

"""Paged KV cache — block pools, block tables, and a host-side allocator.

PyTorch port of ``repro.serving.paged_cache``. Different vendors
(instances) run different ``block_size`` and page *layout*:

  "nbhd": (num_blocks, block_size, kv_heads, head_dim)   token-major
  "nhbd": (num_blocks, kv_heads, block_size, head_dim)   head-major
  "nhdb": (num_blocks, kv_heads, head_dim, block_size)   dim-major

Where the JAX functions return a new pool, the functions here update
``pool`` in place (and return it, so call sites read the same): a pool
holds gigabytes at serving widths and is never copied. The canonical
(wire) form of one sequence's KV is (S, kv_heads, head_dim), flattened
to 1-D by ``core.compat.layout``.
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


def init_pool(spec: KVPageSpec, num_blocks: int,
              device=None) -> torch.Tensor:
    """A zeroed pool of ``num_blocks`` pages in the spec's layout and dtype."""
    return torch.zeros(spec.pool_shape(num_blocks), dtype=spec.tdtype,
                       device=device)


# --------------------------------------------------------------------------- #
# torch pool ops (plain implementations; CUDA kernels in repro_torch.kernels)
# --------------------------------------------------------------------------- #
def gather_sequence(spec: KVPageSpec, pool: torch.Tensor,
                    block_ids: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Gather one sequence from a pool (N, *page) → new canonical
    (seq_len, kv, hd) rows: the gather kernel on the card, its plain
    version on the CPU (``ops.gather_pages`` over a one-layer view).
    block_ids: (nb,) int32; seq_len on the host."""
    from repro_torch.kernels import ops
    pages = ops.gather_pages(spec, pool[None], block_ids.to(torch.int32))[0]
    return pages.reshape(-1, spec.kv_heads, spec.head_dim)[:seq_len]


def scatter_sequence(spec: KVPageSpec, pool: torch.Tensor,
                     block_ids: torch.Tensor,
                     kv_canon: torch.Tensor) -> torch.Tensor:
    """Write canonical (S, kv, hd) into pool (N, *page) pages at
    ``block_ids``, in place: the scatter kernel on the card, its plain
    version on the CPU (``ops.scatter_pages`` over a one-layer view). S is
    zero-padded up to a whole number of blocks."""
    from repro_torch.kernels import ops
    s = kv_canon.shape[0]
    nb = block_ids.shape[0]
    bs = spec.block_size
    pad = nb * bs - s
    assert pad >= 0, (s, nb, bs)
    rows = torch.nn.functional.pad(kv_canon.to(pool.dtype),
                                   (0, 0, 0, 0, 0, pad))
    ops.scatter_pages(spec, pool[None], block_ids.to(torch.int32),
                      rows.reshape(1, nb, bs, spec.kv_heads, spec.head_dim))
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
    The mask selects (scores of hidden rows become NEG_INF, their values
    0), so a stale row below the window floor never reaches the output
    whatever it holds — on finite rows the reference's additive mask
    gives the same bits. Returns (B, 1, H, hd)."""
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
    scores = torch.where(ok[:, None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    v = torch.where(ok[:, :, None, None], v.float(), 0.0)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
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

    def transfer_block(self, from_id: str, to_id: str, block_id: int) -> None:
        """Move one block's ownership between owners without touching the
        free list (prefix-cache adoption of a sequence's prompt blocks)."""
        owned = self._owned.get(from_id)
        if owned is None or block_id not in owned:
            raise ValueError(f"block {block_id} is not owned by {from_id!r}")
        owned.remove(block_id)
        if not owned:
            self._owned.pop(from_id, None)
        self._owned.setdefault(to_id, []).append(block_id)

    def free_block(self, seq_id: str, block_id: int) -> None:
        """Return a single owned block to the free list (prefix-cache
        eviction frees blocks one at a time, LRU order)."""
        owned = self._owned.get(seq_id)
        if owned is None or block_id not in owned:
            raise ValueError(f"block {block_id} is not owned by {seq_id!r}")
        owned.remove(block_id)
        if not owned:
            self._owned.pop(seq_id, None)
        self._free.append(block_id)

    def check_invariants(self) -> None:
        owned = [b for bs in self._owned.values() for b in bs]
        assert len(set(owned)) == len(owned), "double-owned block"
        assert set(owned).isdisjoint(self._free), "owned block in free list"
        assert len(owned) + len(self._free) == self.num_blocks, "leaked block"

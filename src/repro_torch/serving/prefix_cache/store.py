"""Shared-prefix KV stores — port of ``repro.serving.prefix_cache.store``.

Two stores, one per role:

* :class:`PrefixStore` (D-side) indexes *physical pages* of a decode
  engine's paged KV pool by chained block hash. Blocks are adopted from
  a sequence at activation (ownership moves to ``__prefix_cache__`` in
  the :class:`~repro_torch.serving.paged_cache.BlockAllocator`), pinned
  via refcounts while any sequence's block table points at them, and
  LRU-evicted back to the allocator's free list only at zero refs. A
  lookup returns the longest cached prefix as a chain of full blocks
  plus an optional mid-block copy-on-write extension (the sequence gets
  a private copy of the divergence block, valid up to the split point).
  A reservation that reuses N prefix tokens needs N fewer tokens over
  the connector wire — the handoff skips those chunks entirely.

* :class:`HostPrefixStore` (P-side) is a byte-capacity LRU of
  *host-side wire entries* — the exact per-block canonical KV a
  completed ``PrefillStream`` produced. A later prompt sharing the
  prefix replays those entries instead of recomputing them, and
  preloads the dense chunked-prefill cache so compute resumes at the
  divergence point. The reference keeps numpy arrays; the port keeps
  CPU tensors, copied off the card when a block is inserted, so the
  store never holds a view of a stream's dense cache on the device.

Both stores key blocks with :mod:`repro_torch.serving.prefix_cache.hashing`
chained digests, so a digest matches iff the *entire* prefix up to and
including that block matches.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.serving.prefix_cache import hashing

STORE_OWNER = "__prefix_cache__"


def _common_prefix_len(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    eq = np.asarray(a[:n]) == np.asarray(b[:n])
    return n if eq.all() else int(np.argmax(~eq))


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Longest cached prefix for one prompt.

    ``block_ids[i]`` holds the KV for prompt block ``i`` (digest
    ``hashes[i]``). ``tokens`` includes the copy-on-write extension:
    ``cow_src`` (when set) is a physical page whose first ``cow_len``
    rows match the prompt past the last full matched block — the caller
    copies it into the sequence's first private block.
    """
    hashes: Tuple[str, ...]
    block_ids: Tuple[int, ...]
    tokens: int
    cow_src: Optional[int] = None
    cow_len: int = 0

    def truncated(self, max_blocks: int, block_size: int) -> "PrefixMatch":
        """Drop blocks (and any COW extension) beyond ``max_blocks`` —
        used when a reservation's table is shorter than the match."""
        if len(self.block_ids) <= max_blocks:
            return self
        return PrefixMatch(self.hashes[:max_blocks],
                           self.block_ids[:max_blocks],
                           tokens=max_blocks * block_size)


@dataclasses.dataclass
class _CachedBlock:
    digest: str
    parent: str
    block_id: int
    tokens: np.ndarray  # the block_size tokens this page's KV covers
    refs: int = 0
    tick: int = 0


class PrefixStore:
    """Ref-counted, LRU-evicted index of cached prefix blocks in a
    decode engine's paged KV pool."""

    def __init__(self, allocator, block_size: int):
        self.allocator = allocator
        self.block_size = int(block_size)
        self._blocks: Dict[str, _CachedBlock] = {}
        self._children: Dict[str, Set[str]] = {}
        self._pins: Dict[str, List[str]] = {}  # seq_id -> acquired digests
        self._clock = 0
        self.lookups = 0
        self.hit_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0

    def __len__(self) -> int:
        return len(self._blocks)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- lookup ---------------------------------------------------------

    def match(self, prompt, limit: int, count: bool = True) -> PrefixMatch:
        """Longest cached prefix of ``prompt[:limit]``: walk the digest
        chain over full blocks, then probe the children of the last
        matched block for a mid-block (copy-on-write) extension."""
        toks = np.asarray(prompt)
        limit = max(min(int(limit), len(toks)), 0)
        bs = self.block_size
        hashes: List[str] = []
        bids: List[int] = []
        parent = hashing.ROOT
        b = 0
        while (b + 1) * bs <= limit:
            digest = hashing.block_hash(parent, toks[b * bs:(b + 1) * bs])
            rec = self._blocks.get(digest)
            if rec is None:
                break
            hashes.append(digest)
            bids.append(rec.block_id)
            parent = digest
            b += 1
        cow_src: Optional[int] = None
        cow_len = 0
        rest = toks[b * bs:limit]
        if len(rest):
            for child in self._children.get(parent, ()):
                rec = self._blocks.get(child)
                if rec is None:
                    continue
                common = _common_prefix_len(rec.tokens, rest)
                if common > cow_len:
                    cow_len, cow_src = common, rec.block_id
        if count:
            self.lookups += 1
            self.hit_tokens += b * bs + cow_len
        return PrefixMatch(tuple(hashes), tuple(bids),
                           tokens=b * bs + cow_len,
                           cow_src=cow_src, cow_len=cow_len)

    def match_tokens(self, prompt, limit: int) -> int:
        """Peek the reusable-token count without pinning (affinity
        scoring — no LRU or accounting side effects)."""
        return self.match(prompt, limit, count=False).tokens

    def summary(self) -> Tuple[str, ...]:
        """All cached digests — the compact prefix summary. Chained
        digests make membership sufficient: a prompt's leading chain ∩
        summary *is* its cached prefix."""
        return tuple(self._blocks.keys())

    # -- pinning --------------------------------------------------------

    def acquire(self, match: PrefixMatch, seq_id: str) -> None:
        """Pin every matched block for ``seq_id`` (decode reads them
        until :meth:`release_seq`)."""
        tick = self._tick()
        for digest in match.hashes:
            rec = self._blocks[digest]
            rec.refs += 1
            rec.tick = tick
        self._pins.setdefault(seq_id, []).extend(match.hashes)

    def release_seq(self, seq_id: str) -> None:
        for digest in self._pins.pop(seq_id, []):
            rec = self._blocks.get(digest)
            if rec is not None:
                rec.refs = max(rec.refs - 1, 0)

    # -- insertion ------------------------------------------------------

    def insert(self, seq_id: str, digest: str, parent: str, tokens,
               block_id: int) -> bool:
        """Adopt one full prompt block from ``seq_id`` into the store
        (ownership moves to the store; the block stays pinned for
        ``seq_id`` until it releases). No-op when the digest is already
        cached — the sequence keeps its private copy."""
        rec = self._blocks.get(digest)
        if rec is not None:
            rec.tick = self._tick()
            return False
        self.allocator.transfer_block(seq_id, STORE_OWNER, block_id)
        rec = _CachedBlock(digest, parent, block_id,
                           np.array(tokens, copy=True),
                           refs=1, tick=self._tick())
        self._blocks[digest] = rec
        self._children.setdefault(parent, set()).add(digest)
        self._pins.setdefault(seq_id, []).append(digest)
        self.inserted_blocks += 1
        return True

    # -- eviction -------------------------------------------------------

    def evictable_blocks(self) -> int:
        return sum(1 for r in self._blocks.values() if r.refs == 0)

    def evict(self, n: int) -> int:
        """Free up to ``n`` zero-ref blocks back to the allocator, least
        recently used first. Pinned blocks are never freed."""
        cands = sorted((r for r in self._blocks.values() if r.refs == 0),
                       key=lambda r: r.tick)
        freed = 0
        for rec in cands[:n]:
            self._remove(rec)
            freed += 1
        self.evicted_blocks += freed
        return freed

    def _remove(self, rec: _CachedBlock) -> None:
        del self._blocks[rec.digest]
        kids = self._children.get(rec.parent)
        if kids is not None:
            kids.discard(rec.digest)
            if not kids:
                self._children.pop(rec.parent, None)
        # orphaned descendants keep their pages but can no longer be
        # matched (the chain walk starts at the root) — they drain out
        # of the LRU at zero refs like any other block
        self.allocator.free_block(STORE_OWNER, rec.block_id)

    def reset(self) -> None:
        """Forget everything (engine recovery rebuilds the allocator,
        so the pages this store indexed no longer exist)."""
        self._blocks.clear()
        self._children.clear()
        self._pins.clear()


# -- P-side host store ---------------------------------------------------

Entry = Tuple[str, int, int, Dict[str, Any]]  # (kind, gi, pi, tensors)


def _entry_nbytes(entries: Sequence[Entry]) -> int:
    total = 0
    for _, _, _, ent in entries:
        for name, t in ent.items():
            if name != "start":
                total += t.numel() * t.element_size()
    return total


def _host_cat(pieces: List[torch.Tensor]) -> torch.Tensor:
    """Join token-axis pieces into one new CPU tensor. ``torch.cat``
    always allocates, so the result never aliases a stream's cache."""
    if len({p.device for p in pieces}) > 1:
        pieces = [p.cpu() for p in pieces]
    return torch.cat(pieces, dim=1).cpu()


def assemble_entries(entries: Sequence[Entry], w0: int, w1: int
                     ) -> Optional[List[Entry]]:
    """Merge (possibly chunk-fragmented) wire entries into one entry per
    (kind, gi, pi) covering exactly ``[w0, w1)``, as new CPU tensors.
    Returns None when the window is not fully covered."""
    groups: Dict[Tuple[str, int, int], List[Dict[str, Any]]] = {}
    for kind, gi, pi, ent in entries:
        start = int(ent["start"])
        names = [n for n in ent if n != "start"]
        length = int(ent[names[0]].shape[1])
        lo, hi = max(w0, start), min(w1, start + length)
        if lo >= hi:
            continue
        piece = {n: ent[n][:, lo - start:hi - start] for n in names}
        piece["start"] = lo
        groups.setdefault((kind, gi, pi), []).append(piece)
    out: List[Entry] = []
    for (kind, gi, pi), pieces in groups.items():
        pieces.sort(key=lambda p: p["start"])
        pos = w0
        for p in pieces:
            if p["start"] != pos:
                return None  # gap
            pos += int(next(v for n, v in p.items()
                            if n != "start").shape[1])
        if pos != w1:
            return None
        names = [n for n in pieces[0] if n != "start"]
        merged: Dict[str, Any] = {n: _host_cat([p[n] for p in pieces])
                                  for n in names}
        merged["start"] = w0
        out.append((kind, gi, pi, merged))
    return out or None


@dataclasses.dataclass
class _HostBlock:
    digest: str
    parent: str
    tokens: np.ndarray
    entries: List[Entry]  # one merged entry per (kind, gi, pi), block-local
    nbytes: int
    tick: int = 0


class HostPrefixStore:
    """Byte-capacity LRU of host-side per-block wire entries, keyed by
    the same chained digests as the D-side store. Entries are CPU
    tensors owned by the store — eviction mid-use is safe (a live
    ``PrefillStream`` holds its own references)."""

    def __init__(self, block_size: int, capacity_bytes: int = 256 << 20):
        self.block_size = int(block_size)
        self.capacity_bytes = int(capacity_bytes)
        self._blocks: Dict[str, _HostBlock] = {}
        self._children: Dict[str, Set[str]] = {}
        self._bytes = 0
        self._clock = 0
        self.lookups = 0
        self.hit_tokens = 0

    def __len__(self) -> int:
        return len(self._blocks)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, prompt, limit: int) -> Tuple[int, List[Entry]]:
        """Longest cached prefix of ``prompt[:limit]``; returns the hit
        token count and flat wire entries (with absolute ``start``)
        covering ``[0, hit)`` — directly replayable as stream chunks."""
        toks = np.asarray(prompt)
        limit = max(min(int(limit), len(toks)), 0)
        bs = self.block_size
        out: List[Entry] = []
        parent = hashing.ROOT
        b = 0
        tick = self._tick()
        while (b + 1) * bs <= limit:
            digest = hashing.block_hash(parent, toks[b * bs:(b + 1) * bs])
            rec = self._blocks.get(digest)
            if rec is None:
                break
            rec.tick = tick
            for kind, gi, pi, ent in rec.entries:
                shifted = dict(ent)
                shifted["start"] = b * bs
                out.append((kind, gi, pi, shifted))
            parent = digest
            b += 1
        hit = b * bs
        rest = toks[b * bs:limit]
        if len(rest):
            best_len, best = 0, None
            for child in self._children.get(parent, ()):
                rec = self._blocks.get(child)
                if rec is None:
                    continue
                common = _common_prefix_len(rec.tokens, rest)
                if common > best_len:
                    best_len, best = common, rec
            if best is not None:
                for kind, gi, pi, ent in best.entries:
                    part = {n: (v if n == "start" else v[:, :best_len])
                            for n, v in ent.items()}
                    part["start"] = hit
                    out.append((kind, gi, pi, part))
                hit += best_len
        self.lookups += 1
        self.hit_tokens += hit
        return hit, out

    def insert_prompt(self, prompt, entries: Sequence[Entry],
                      seq_len: int) -> int:
        """Cache every full prompt block a finished stream produced.
        ``entries`` are the stream's accumulated wire entries (absolute
        starts; views of its dense cache, on any device). Each new block
        is copied into CPU tensors of its own. Returns the number of
        newly cached blocks."""
        toks = np.asarray(prompt)
        bs = self.block_size
        full = min(int(seq_len), len(toks)) // bs
        parent = hashing.ROOT
        added = 0
        for b in range(full):
            blk = toks[b * bs:(b + 1) * bs]
            digest = hashing.block_hash(parent, blk)
            if digest not in self._blocks:
                merged = assemble_entries(entries, b * bs, (b + 1) * bs)
                if merged is None:
                    break  # incomplete coverage — stop at the gap
                nbytes = _entry_nbytes(merged)
                self._reserve(nbytes)
                rec = _HostBlock(digest, parent, np.array(blk, copy=True),
                                 merged, nbytes, tick=self._tick())
                self._blocks[digest] = rec
                self._children.setdefault(parent, set()).add(digest)
                self._bytes += nbytes
                added += 1
            parent = digest
        return added

    def _reserve(self, nbytes: int) -> None:
        while self._bytes + nbytes > self.capacity_bytes and self._blocks:
            lru = min(self._blocks.values(), key=lambda r: r.tick)
            del self._blocks[lru.digest]
            kids = self._children.get(lru.parent)
            if kids is not None:
                kids.discard(lru.digest)
                if not kids:
                    self._children.pop(lru.parent, None)
            self._bytes -= lru.nbytes

    def reset(self) -> None:
        self._blocks.clear()
        self._children.clear()
        self._bytes = 0

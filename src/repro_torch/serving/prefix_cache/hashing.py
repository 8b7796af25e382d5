"""Chained block hashes over token prefixes — port of
``repro.serving.prefix_cache.hashing`` (hashlib and numpy only; the
digests are byte-identical to the reference's).

One digest per *full* ``block_size`` tokens, each chained on its
parent's digest — so two prompts share the k-th digest iff they share
the entire first ``k * block_size`` tokens. That makes a flat digest
set a complete prefix summary: the number of leading digests of a
prompt's chain present in an instance's set *is* its longest cached
prefix (in full blocks).

Digests use hashlib (not Python's salted ``hash()``) so they are stable
across processes.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Union

import numpy as np

Tokens = Union[Sequence[int], np.ndarray]

ROOT = ""  # parent digest of the first block

_DIGEST_HEX = 24  # 96 bits — collision-safe at any plausible store size


def block_hash(parent: str, tokens: Tokens) -> str:
    """Digest of one block of tokens chained on its parent digest."""
    h = hashlib.sha256()
    h.update(parent.encode("ascii"))
    h.update(np.ascontiguousarray(tokens, dtype=np.int64).tobytes())
    return h.hexdigest()[:_DIGEST_HEX]


def chain_hashes(tokens: Tokens, block_size: int,
                 limit: Optional[int] = None) -> List[str]:
    """Chained digests for every full ``block_size`` block of
    ``tokens[:limit]`` (a trailing partial block contributes nothing)."""
    toks = np.asarray(tokens)
    n = len(toks) if limit is None else max(min(int(limit), len(toks)), 0)
    out: List[str] = []
    parent = ROOT
    for b in range(n // block_size):
        parent = block_hash(parent, toks[b * block_size:(b + 1) * block_size])
        out.append(parent)
    return out


def matched_prefix_tokens(chain: Sequence[str], cached: "frozenset[str] | set",
                          block_size: int) -> int:
    """Tokens covered by the longest leading run of ``chain`` present in
    ``cached`` — the router-side affinity score."""
    n = 0
    for digest in chain:
        if digest not in cached:
            break
        n += 1
    return n * block_size

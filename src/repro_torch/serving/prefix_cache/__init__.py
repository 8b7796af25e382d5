"""Shared-prefix KV cache — port of ``repro.serving.prefix_cache``:
block-aligned, hash-chained prefix reuse across prefill compute (P-side
host store), the connector wire, and decode-side paged KV (D-side device
store)."""
from repro_torch.serving.prefix_cache.hashing import (ROOT, block_hash,
                                                      chain_hashes,
                                                      matched_prefix_tokens)
from repro_torch.serving.prefix_cache.store import (STORE_OWNER,
                                                    HostPrefixStore,
                                                    PrefixMatch, PrefixStore,
                                                    assemble_entries)

__all__ = [
    "ROOT", "block_hash", "chain_hashes", "matched_prefix_tokens",
    "STORE_OWNER", "HostPrefixStore", "PrefixMatch", "PrefixStore",
    "assemble_entries",
]

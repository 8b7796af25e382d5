"""In-process connector: the wire is host process memory (default
backend) — PyTorch port of ``repro.core.transport.inprocess``.

Zero-copy staging — the staged pytree *is* what the read returns — with
byte and modeled-latency accounting, exactly the semantics of the original
monolithic ``TransferEngine``. Reads complete at issue time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from repro_torch.core.transport import wirefmt
from repro_torch.core.transport.base import KVConnector, tree_bytes


class InProcessConnector(KVConnector):
    transport = "inproc"

    def __init__(self, bandwidth_gbps: float = 25.0,
                 buffer_capacity_bytes: int = 1 << 32,
                 max_inflight: int = 32):
        super().__init__(bandwidth_gbps=bandwidth_gbps,
                         buffer_capacity_bytes=buffer_capacity_bytes,
                         fixed_latency_s=0.0, max_inflight=max_inflight)
        self._staged: Dict[str, Tuple[Any, Dict[str, Any]]] = {}

    def capabilities(self):
        return dataclasses.replace(super().capabilities(),
                                   cross_process=False, zero_copy=True,
                                   wire_codec="fixed",
                                   header_bytes=wirefmt.nominal_header_bytes())

    # -- storage hooks ---------------------------------------------------- #
    def _put(self, key: str, payload, meta: Dict[str, Any]) -> int:
        nbytes = tree_bytes(payload)
        self.pool.acquire(nbytes)
        self._staged[key] = (payload, meta)
        return nbytes

    def _get(self, key: str) -> Tuple[Any, Dict[str, Any]]:
        return self._staged[key]

    def _evict(self, key: str) -> None:
        self._staged.pop(key, None)

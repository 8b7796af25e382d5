"""Pluggable KV-transport connectors (paper §III-B wire seam) — PyTorch
port of ``repro.core.transport``.

Only the in-process backend is ported so far; ``shm`` and ``rdma`` are
ROADMAP queue 1 item 5 (cross-process runtime).
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Type

from repro_torch.core.transport.base import (ConnectorCapabilities,  # noqa: F401
                                             KVConnector, PinnedBufferPool,
                                             TransferError, TransferHandle,
                                             TransferStats, tree_bytes)
from repro_torch.core.transport.inprocess import InProcessConnector  # noqa: F401
from repro_torch.core.transport.wirefmt import WireChunk  # noqa: F401

CONNECTORS: Dict[str, Type[KVConnector]] = {
    InProcessConnector.transport: InProcessConnector,
}
_NOT_PORTED = ("shm", "rdma")


def make_connector(kind: str = "inproc", **kwargs: Any) -> KVConnector:
    """Build a connector by registry name. Keyword arguments the chosen
    backend does not accept are dropped, so one config drives any
    backend."""
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"KV connector {kind!r} is not ported yet (ROADMAP queue 1 "
            "item 5: cross-process runtime)")
    if kind not in CONNECTORS:
        raise KeyError(
            f"unknown KV connector {kind!r}; known: {sorted(CONNECTORS)}")
    cls = CONNECTORS[kind]
    accepted = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in kwargs.items() if k in accepted})


__all__ = [
    "ConnectorCapabilities", "KVConnector", "PinnedBufferPool",
    "TransferError", "TransferHandle", "TransferStats", "tree_bytes",
    "InProcessConnector", "WireChunk", "CONNECTORS", "make_connector",
]

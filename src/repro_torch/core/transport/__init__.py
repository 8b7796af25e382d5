"""Pluggable KV-transport connectors (paper §III-B wire seam) — PyTorch
port of ``repro.core.transport``.

Backends register here by name:

  inproc  — process memory, zero-copy, instant completion (default)
  shm     — real cross-process staging via multiprocessing.shared_memory
            (fixed-layout wire segments, readable by the JAX package too)
  rdma    — modeled per-read latency on a virtual clock; handles complete
            over multiple scheduler ticks
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Type

from repro_torch.core.transport.base import (ConnectorCapabilities,  # noqa: F401
                                             KVConnector, PinnedBufferPool,
                                             TransferError, TransferHandle,
                                             TransferStats, tree_bytes)
from repro_torch.core.transport.inprocess import InProcessConnector  # noqa: F401
from repro_torch.core.transport.modeled_rdma import ModeledRDMAConnector  # noqa: F401
from repro_torch.core.transport.shared_memory import SharedMemoryConnector  # noqa: F401
from repro_torch.core.transport.wirefmt import WireChunk  # noqa: F401

CONNECTORS: Dict[str, Type[KVConnector]] = {
    InProcessConnector.transport: InProcessConnector,
    SharedMemoryConnector.transport: SharedMemoryConnector,
    ModeledRDMAConnector.transport: ModeledRDMAConnector,
}


def make_connector(kind: str = "inproc", **kwargs: Any) -> KVConnector:
    """Build a connector by registry name. Keyword arguments the chosen
    backend does not accept are dropped, so one config drives any
    backend."""
    if kind not in CONNECTORS:
        raise KeyError(
            f"unknown KV connector {kind!r}; known: {sorted(CONNECTORS)}")
    cls = CONNECTORS[kind]
    accepted = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in kwargs.items() if k in accepted})


__all__ = [
    "ConnectorCapabilities", "KVConnector", "PinnedBufferPool",
    "TransferError", "TransferHandle", "TransferStats", "tree_bytes",
    "InProcessConnector", "SharedMemoryConnector", "ModeledRDMAConnector",
    "WireChunk", "CONNECTORS", "make_connector",
]

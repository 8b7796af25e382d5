"""``TransferEngine``: the default KV connector under its original name
(port of ``repro.core.kv_transfer``)."""
from __future__ import annotations

from repro_torch.core.transport import (ConnectorCapabilities,  # noqa: F401
                                        InProcessConnector, KVConnector,
                                        PinnedBufferPool, TransferError,
                                        TransferHandle, TransferStats,
                                        make_connector, tree_bytes)

TransferEngine = InProcessConnector

__all__ = [
    "ConnectorCapabilities", "KVConnector", "TransferEngine",
    "InProcessConnector", "PinnedBufferPool", "TransferError",
    "TransferHandle", "TransferStats", "make_connector", "tree_bytes",
]

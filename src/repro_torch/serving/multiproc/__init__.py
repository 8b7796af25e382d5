"""Multi-instance disaggregated P/D serving runtime — PyTorch port of
``repro.serving.multiproc``.

A parent launcher spawns N prefill + M decode worker processes
(``multiprocessing`` spawn context), each running its own ``Engine``
event loop; the parent routes each request to the least-loaded P and an
admitting D (``repro_torch.serving.router``), the control plane rides
``multiprocessing`` queues with instance-addressed messages, and the KV
data plane rides ``SharedMemoryConnector`` segments (staged by the
chosen P process, adopted + read by the chosen D process). See
``launcher.py`` for the protocol diagram; ``TwoProcessRuntime`` is the
degenerate 1P+1D cluster kept as the compatibility entry point.
"""
from repro_torch.serving.multiproc.launcher import (  # noqa: F401
    ClusterRuntime, TwoProcessRuntime, serve_cluster, serve_two_process)
from repro_torch.serving.multiproc.messages import (  # noqa: F401
    ClusterSpec, EngineSpec, WorkerSpec)

__all__ = ["ClusterRuntime", "TwoProcessRuntime", "serve_cluster",
           "serve_two_process", "ClusterSpec", "EngineSpec", "WorkerSpec"]

"""Pluggable KV-transport connector API (paper §III-B wire seam) —
PyTorch port of ``repro.core.transport.base``.

The paper's heterogeneous compatible transmission module assumes an
RDMA-style stage/read wire between the P and D instances. This package
makes that wire a *pluggable* connector — the shape SGLang's PD
disaggregation uses for its transfer backends (Mooncake, NIXL) and vLLM's
production stack uses for its ``kv_connector`` — so the serving stack,
planner, and scheduler program against one interface:

  control-plane  ``register(peer)`` / ``stage(key, payload, meta)``
  data-plane     ``issue_read(key)`` → :class:`TransferHandle` with
                 ``poll()`` / ``wait()`` async completion, then
                 ``complete(key)`` (D consumed it) or ``drop(key)``
                 (P-side failure)
  descriptor     ``capabilities()`` — bandwidth, fixed latency, max
                 in-flight reads, chunk granularity — consumed by the
                 planner's communication operator library and the global
                 scheduler instead of hard-coded constants.

Completion is asynchronous: a read may stay in flight across scheduler
ticks (``tick()`` advances connector-internal time), which is what lets a
D instance run decode steps while a chunk's wire transfer is still on the
wire — the "true async transfer engine" split of wire time and D-side
re-page into separate tick budgets.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def tree_bytes(tree) -> int:
    """Total array bytes in a staged tree (numpy arrays, tensors, chunks)."""
    total = 0
    for x in _leaves(tree):
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif hasattr(x, "nbytes"):
            total += x.nbytes
    return total


class TransferError(RuntimeError):
    """Wire-level failure: key lost mid-stream, dropped payload, or an
    over-subscribed channel. Subclasses RuntimeError so the scheduler's
    dispatch-failure sweep requeues the request."""


@dataclasses.dataclass
class TransferStats:
    transfers: int = 0
    bytes_moved: int = 0            # wire bytes (what actually crossed)
    payload_bytes: int = 0          # raw canonical KV bytes those carried —
    #                                 bytes_moved/payload_bytes < 1 means the
    #                                 wire compressed (int8), > 1 means
    #                                 format overhead (headers) dominated
    chunks: int = 0                 # streamed KV chunks (overlapped handoff)
    stage_seconds: float = 0.0      # wall time spent staging (P side)
    read_seconds: float = 0.0       # wall time spent reading (D side)
    modeled_seconds: float = 0.0    # fixed latency + bytes / modeled bandwidth
    overlap_modeled_seconds: float = 0.0  # modeled wire time hidden under
    #                                       the next chunk's prefill compute
    # wall-clock (measured, not modeled) handoff timings. In one process a
    # chunk on an instant wire re-pages in the tick it was sent, so measured
    # overlap is ~0; across real P/D processes the wire interval genuinely
    # runs concurrent with the next chunk's prefill compute and these fields
    # report what was actually hidden.
    wall_handoff_seconds: float = 0.0   # first stage → last re-page, per flight
    wall_overlap_seconds: float = 0.0   # measured wire time under prefill compute
    peak_buffer_bytes: int = 0
    retries: int = 0                # scheduler requeues charged to the wire
    # shared-prefix cache: tokens whose KV never touched the wire because
    # the decode side already held them, and the wire bytes that saved
    # (estimated from the flight's measured bytes/token)
    prefix_hit_tokens: int = 0
    bytes_saved: int = 0
    # link congestion: modeled extra wire time concurrent flights cost each
    # other on a shared link (fair-share arbitration), plus the measured
    # attribution — read wall time delivered while other reads were still
    # in flight, and the peak number of simultaneous in-flight reads
    congested_seconds: float = 0.0
    contended_read_seconds: float = 0.0
    concurrent_reads_peak: int = 0

    @property
    def exposed_modeled_seconds(self) -> float:
        """Modeled wire time left on the critical path after overlap."""
        return self.modeled_seconds - self.overlap_modeled_seconds

    @property
    def wire_compression(self) -> float:
        """Measured wire/payload byte ratio (< 1: compressed; > 1:
        format overhead). 1.0 until anything moved."""
        if not self.payload_bytes:
            return 1.0
        return self.bytes_moved / self.payload_bytes


class PinnedBufferPool:
    """Fixed-capacity staging pool with high-water accounting.

    Registered-once semantics: acquire/release only move a watermark — no
    per-transfer allocation, mirroring the paper's pre-registered RDMA
    buffers (zero-copy)."""

    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        self.in_use = 0
        self.high_water = 0

    def acquire(self, nbytes: int) -> None:
        if self.in_use + nbytes > self.capacity:
            raise MemoryError(
                f"pinned pool exhausted: {self.in_use + nbytes} > {self.capacity}")
        self.in_use += nbytes
        self.high_water = max(self.high_water, self.in_use)

    def release(self, nbytes: int) -> None:
        if nbytes > self.in_use:
            raise ValueError(
                f"pinned pool over-release: {nbytes} > in_use {self.in_use} "
                "(double release?)")
        self.in_use -= nbytes


@dataclasses.dataclass(frozen=True)
class ConnectorCapabilities:
    """What the wire can do — consumed by the planner (communication
    operator library) and the global scheduler instead of constants."""
    transport: str                  # registry name of the backend
    bandwidth_gbps: float           # modeled wire bandwidth
    fixed_latency_s: float = 0.0    # per-read setup latency (handshake/DMA)
    max_inflight: int = 32          # concurrent issued-but-unread reads
    chunk_bytes: int = 0            # preferred wire granularity (0 = any)
    cross_process: bool = False     # payloads survive a process boundary
    zero_copy: bool = True          # reads return the staged buffers
    # how concurrent in-flight reads share the link: "exclusive" reads
    # serialize (one at a time at full bandwidth); "fair" reads progress
    # simultaneously at bandwidth/n (processor-sharing arbitration)
    link_sharing: str = "exclusive"
    # wire encoding of staged KV chunks ("fixed" = zero-copy fixed-layout
    # segments, "pickle" = legacy blob) and its fixed per-chunk overhead
    wire_codec: str = "pickle"
    header_bytes: int = 0

    @property
    def bandwidth_bytes_s(self) -> float:
        return self.bandwidth_gbps * 1e9

    def wire_seconds(self, nbytes: float) -> float:
        """Modeled time for one read of ``nbytes`` on this wire."""
        if nbytes <= 0:
            return 0.0
        return self.fixed_latency_s + nbytes / self.bandwidth_bytes_s


class TransferHandle:
    """Async completion handle for one issued read.

    ``poll()`` is non-blocking: True once the modeled wire time has elapsed
    (connector time advances via ``tick()``). ``wait()`` force-completes —
    it fast-forwards the connector clock to the handle's ready time and
    returns ``(payload, meta)``; the skipped wire time is fully exposed.
    ``wait()`` after the staged payload was dropped raises
    :class:`TransferError`."""

    def __init__(self, connector: "KVConnector", key: str, nbytes: int,
                 ready_at: float):
        self.connector = connector
        self.key = key
        self.nbytes = nbytes
        self.ready_at = ready_at
        self._result: Optional[Tuple[Any, Dict[str, Any]]] = None
        self._settled = False

    @property
    def in_flight(self) -> bool:
        return not self._settled

    def poll(self) -> bool:
        """Non-blocking: has the wire delivered this read?"""
        if self._settled:
            return True
        return self.connector._handle_ready(self)

    def wait(self) -> Tuple[Any, Dict[str, Any]]:
        """Complete the read (fast-forwarding modeled wire time if it is
        still in flight) and return ``(payload, meta)``."""
        if self._result is not None:
            return self._result
        if self._settled:                      # settled with an error before
            raise TransferError(
                f"transfer {self.key!r} already failed")
        t0 = time.perf_counter()
        contended = self.connector._inflight > 1   # others also in flight
        self.connector._advance_for(self)
        try:
            payload, meta = self.connector._fetch(self.key)
        except KeyError:
            self._settle()
            raise TransferError(
                f"transfer key {self.key!r} lost mid-stream "
                "(staged payload dropped — P failure?)") from None
        self._settle()
        self._result = (payload, meta)
        # stats account *delivered* reads, not issued ones — an aborted
        # flight's cancelled handles never inflate the wire counters
        stats = self.connector.stats
        stats.transfers += 1
        stats.bytes_moved += self.nbytes
        stats.payload_bytes += self.connector._payload_sizes.get(
            self.key, self.nbytes)
        stats.modeled_seconds += self.connector.modeled_latency(self.nbytes)
        elapsed = time.perf_counter() - t0
        stats.read_seconds += elapsed
        if contended:                  # measured attribution: this read's
            #                            wall time ran under link concurrency
            stats.contended_read_seconds += elapsed
        return self._result

    def cancel(self) -> None:
        """Abandon the read (flight aborted) — frees its channel slot.
        A later ``wait()`` raises :class:`TransferError`."""
        self._settle()

    def _settle(self) -> None:
        if not self._settled:
            self._settled = True
            self.connector._inflight = max(self.connector._inflight - 1, 0)
            self.connector._on_settle(self)


class KVConnector:
    """Base class for KV-transport backends.

    Subclasses override the storage hooks ``_put`` / ``_get`` / ``_evict``
    (and optionally ``_ready_time`` / ``tick`` for modeled-latency wires).
    The base class owns the pinned staging pool, stats, peer registry, and
    handle bookkeeping shared by every backend.
    """

    transport = "base"

    def __init__(self, bandwidth_gbps: float = 25.0,
                 buffer_capacity_bytes: int = 1 << 32,
                 fixed_latency_s: float = 0.0,
                 max_inflight: int = 32):
        self.bandwidth = bandwidth_gbps * 1e9
        self.bandwidth_gbps = bandwidth_gbps
        self.fixed_latency_s = fixed_latency_s
        self.max_inflight = max(max_inflight, 1)   # 0 would deadlock sends
        self.pool = PinnedBufferPool(buffer_capacity_bytes)
        self.stats = TransferStats()
        self._peers: Dict[str, Dict[str, Any]] = {}
        self._sizes: Dict[str, int] = {}
        self._payload_sizes: Dict[str, int] = {}   # raw bytes behind each key
        self._now = 0.0                # connector-internal (modeled) clock
        self._inflight = 0

    # -- descriptor ------------------------------------------------------- #
    def capabilities(self) -> ConnectorCapabilities:
        return ConnectorCapabilities(
            transport=self.transport,
            bandwidth_gbps=self.bandwidth_gbps,
            fixed_latency_s=self.fixed_latency_s,
            max_inflight=self.max_inflight)

    # -- control plane ---------------------------------------------------- #
    def register(self, peer: str, **meta: Any) -> None:
        """Announce an endpoint (a P or D instance). Idempotent — the
        RDMA analogue of registering a memory region with the NIC."""
        self._peers.setdefault(peer, {}).update(meta)

    def peers(self) -> List[str]:
        return sorted(self._peers)

    def stage(self, key: str, payload, meta: Optional[Dict[str, Any]] = None
              ) -> int:
        """Register a payload (pytree) for remote read. Returns the bytes
        it occupies in the staging pool."""
        if key in self._sizes:
            raise ValueError(f"transfer key {key!r} already staged")
        t0 = time.perf_counter()
        if hasattr(payload, "write_into"):     # WireChunk: already planned
            payload_bytes = payload.payload_nbytes
        else:                                  # host copy of a plain tree
            payload = _map(lambda x: x.detach().cpu()
                           if isinstance(x, torch.Tensor) else x, payload)
            payload_bytes = tree_bytes(payload)
        nbytes = self._put(key, payload, meta or {})
        self._sizes[key] = nbytes
        self._payload_sizes[key] = payload_bytes
        self.stats.stage_seconds += time.perf_counter() - t0
        self.stats.peak_buffer_bytes = self.pool.high_water
        return nbytes

    # -- data plane ------------------------------------------------------- #
    def issue_read(self, key: str) -> TransferHandle:
        """Start an RDMA-read of a staged key. Returns a handle that
        completes asynchronously (``poll()`` / ``wait()``)."""
        if key not in self._sizes:
            raise KeyError(f"transfer key {key!r} not staged (P lost?)")
        if self._inflight >= self.max_inflight:
            raise TransferError(
                f"connector channel full: {self._inflight} reads in flight "
                f"(max_inflight={self.max_inflight})")
        nbytes = self._sizes[key]
        self._inflight += 1
        self.stats.concurrent_reads_peak = max(
            self.stats.concurrent_reads_peak, self._inflight)
        handle = TransferHandle(self, key, nbytes, self._ready_time(nbytes))
        self._on_issue(handle)
        return handle

    def complete(self, key: str) -> None:
        """D finished materializing — free the staging buffer."""
        nbytes = self._sizes.pop(key, None)
        self._payload_sizes.pop(key, None)
        if nbytes is None:
            return                     # idempotent: already completed/dropped
        self._evict(key)
        self.pool.release(nbytes)

    def drop(self, key: str) -> None:
        """P-side failure path: drop a staged payload. Handles still in
        flight for it fail with :class:`TransferError` on ``wait()``."""
        self.complete(key)

    def staged_keys(self) -> List[str]:
        return sorted(self._sizes)

    def inflight_reads(self) -> int:
        return self._inflight

    # -- modeled time ----------------------------------------------------- #
    def modeled_latency(self, nbytes: int) -> float:
        return self.capabilities().wire_seconds(nbytes)

    def tick(self, dt: Optional[float] = None) -> None:
        """Advance connector-internal time by one scheduler tick. Instant
        backends complete at issue time, so this is a no-op."""

    def _ready_time(self, nbytes: int) -> float:
        """Connector time at which a read issued now completes. Instant
        backends deliver at issue time."""
        return self._now

    def _advance_to(self, t: float) -> None:
        self._now = max(self._now, t)

    # -- handle hooks (overridden by link-sharing backends) ---------------- #
    def _handle_ready(self, handle: "TransferHandle") -> bool:
        """Has the wire delivered ``handle``? Default: static ready time."""
        return self._now >= handle.ready_at

    def _advance_for(self, handle: "TransferHandle") -> None:
        """Fast-forward the modeled clock until ``handle`` completes."""
        self._advance_to(handle.ready_at)

    def _on_issue(self, handle: "TransferHandle") -> None:
        """A read was just issued (link-sharing backends register flows)."""

    def _on_settle(self, handle: "TransferHandle") -> None:
        """A handle settled (delivered or cancelled) — release link state."""

    # -- storage hooks (backend-specific) --------------------------------- #
    def _put(self, key: str, payload, meta: Dict[str, Any]) -> int:
        raise NotImplementedError

    def _get(self, key: str) -> Tuple[Any, Dict[str, Any]]:
        raise NotImplementedError

    def _evict(self, key: str) -> None:
        """Remove a staged entry's backing storage (bookkeeping is done)."""
        raise NotImplementedError

    def _fetch(self, key: str) -> Tuple[Any, Dict[str, Any]]:
        if key not in self._sizes:
            raise KeyError(key)
        return self._get(key)

    # -- lifecycle -------------------------------------------------------- #
    def close(self) -> None:
        """Release every staged buffer (and any OS-level resources)."""
        for key in list(self._sizes):
            self.drop(key)

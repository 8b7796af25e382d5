"""Modeled-RDMA connector: async completion over multiple scheduler ticks
— PyTorch port of ``repro.core.transport.modeled_rdma`` (pure Python).

Storage is in-process (no NIC is involved), but every read carries
the modeled wire cost of an RDMA read — a fixed per-read setup latency
plus ``bytes / bandwidth`` — on a connector-internal virtual clock. The
global scheduler advances that clock by ``tick_seconds`` per tick
(``tick()``), so a chunk's handle stays in flight across ticks and decode
steps run *while the wire is busy*; ``wait()`` force-completes by
fast-forwarding the clock (the forced-sync path, fully exposed wire time).

Concurrent reads contend for the one link. Two arbitration modes:

  * ``link_sharing="fair"`` (default) — processor sharing: the ``n``
    active flows each drain at ``bandwidth / n``; completion times are
    found event-driven (a flow finishing or activating changes the rate).
    The extra time a flow spent beyond its alone-on-the-link cost is
    accounted to ``TransferStats.congested_seconds``.
  * ``link_sharing="serial"`` — the legacy exclusive link: reads queue and
    run one at a time at full bandwidth.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.transport import wirefmt
from repro_torch.core.transport.base import (KVConnector, TransferHandle,
                                             tree_bytes)

_EPS = 1e-12


class _Flow:
    """One in-flight read on the shared link (fair-share mode)."""
    __slots__ = ("remaining", "active_at", "issued_at", "alone", "done_at")

    def __init__(self, nbytes: float, active_at: float, issued_at: float,
                 alone: float):
        self.remaining = float(nbytes)
        self.active_at = active_at     # setup latency elapsed, on the link
        self.issued_at = issued_at
        self.alone = alone             # latency + bytes/bw, uncontended
        self.done_at: Optional[float] = None


class ModeledRDMAConnector(KVConnector):
    transport = "rdma"

    def __init__(self, bandwidth_gbps: float = 25.0,
                 buffer_capacity_bytes: int = 1 << 32,
                 fixed_latency_s: float = 5e-6,
                 max_inflight: int = 32,
                 tick_seconds: float = 1e-4,
                 chunk_bytes: int = 256 << 10,
                 link_sharing: str = "fair"):
        super().__init__(bandwidth_gbps=bandwidth_gbps,
                         buffer_capacity_bytes=buffer_capacity_bytes,
                         fixed_latency_s=fixed_latency_s,
                         max_inflight=max_inflight)
        assert link_sharing in ("fair", "serial"), link_sharing
        self.tick_seconds = tick_seconds
        self.chunk_bytes = chunk_bytes
        self.link_sharing = link_sharing
        self._staged: Dict[str, Tuple[Any, Dict[str, Any]]] = {}
        self._wire_free_at = 0.0       # serial mode: exclusive link queue
        self._flows: List[_Flow] = []  # fair mode: active processor-sharing
        self._pending_flow: Optional[_Flow] = None

    def capabilities(self):
        return dataclasses.replace(
            super().capabilities(),
            chunk_bytes=self.chunk_bytes, cross_process=False,
            zero_copy=False, wire_codec="fixed",
            header_bytes=wirefmt.nominal_header_bytes(),
            link_sharing="fair" if self.link_sharing == "fair"
            else "exclusive")

    # -- modeled async completion ----------------------------------------- #
    def tick(self, dt: Optional[float] = None) -> None:
        """One scheduler tick of wire progress on the virtual clock."""
        target = self._now + (self.tick_seconds if dt is None else dt)
        if self.link_sharing == "fair":
            self._drain(t_target=target)
        else:
            self._now = target

    def _ready_time(self, nbytes: int) -> float:
        if self.link_sharing == "serial":
            # serialize reads on the link: a read starts when it frees up
            start = max(self._now, self._wire_free_at)
            ready = start + self.fixed_latency_s + nbytes / self.bandwidth
            self._wire_free_at = ready
            return ready
        flow = _Flow(nbytes, self._now + self.fixed_latency_s, self._now,
                     self.fixed_latency_s + nbytes / self.bandwidth)
        self._flows.append(flow)
        self._pending_flow = flow
        # optimistic (uncontended) estimate; actual readiness comes from
        # the flow via _handle_ready — contention only pushes it later
        return self._now + flow.alone

    def _on_issue(self, handle: TransferHandle) -> None:
        if self._pending_flow is not None:
            handle._flow = self._pending_flow
            self._pending_flow = None

    def _on_settle(self, handle: TransferHandle) -> None:
        # a cancelled read leaves the link: stop charging its bandwidth
        flow = getattr(handle, "_flow", None)
        if flow is not None and flow.done_at is None and flow in self._flows:
            self._flows.remove(flow)

    def _handle_ready(self, handle: TransferHandle) -> bool:
        flow = getattr(handle, "_flow", None)
        if flow is None:
            return self._now >= handle.ready_at
        return flow.done_at is not None

    def _advance_for(self, handle: TransferHandle) -> None:
        flow = getattr(handle, "_flow", None)
        if flow is None:
            self._advance_to(handle.ready_at)
            return
        self._drain(until_flow=flow)

    # -- processor-sharing link simulation -------------------------------- #
    def _drain(self, t_target: Optional[float] = None,
               until_flow: Optional[_Flow] = None) -> None:
        """Advance the fair-share link event by event: between events the
        ``n`` active flows each drain at ``bandwidth / n``; events are a
        flow activating (its setup latency elapsing) or completing."""
        t = self._now
        while True:
            if until_flow is not None and until_flow.done_at is not None:
                break
            if until_flow is None and (t_target is None
                                       or t >= t_target - _EPS):
                break
            pending = [f for f in self._flows if f.done_at is None]
            # settle zero-byte flows whose setup latency has elapsed
            for f in pending:
                if f.remaining <= 0 and f.active_at <= t + _EPS:
                    f.done_at = max(f.active_at, t)
            pending = [f for f in self._flows if f.done_at is None]
            if until_flow is not None and until_flow.done_at is not None:
                break
            if until_flow is not None and until_flow not in pending:
                break                    # cancelled out from under us
            active = [f for f in pending if f.active_at <= t + _EPS]
            waiting = [f.active_at for f in pending if f.active_at > t + _EPS]
            if not active:
                if waiting:
                    nxt = min(waiting)
                    if t_target is not None and nxt > t_target:
                        t = t_target
                        break
                    t = nxt
                    continue
                t = t_target if t_target is not None else t
                break                    # idle link: jump to the target
            rate = self.bandwidth / len(active)
            t_done = t + min(f.remaining for f in active) / rate
            step = [t_done] + waiting
            if t_target is not None:
                step.append(t_target)
            t_step = min(step)
            dt = t_step - t
            for f in active:
                f.remaining -= dt * rate
            if t_step >= t_done - _EPS:   # at least one flow completed
                # the minimum-remaining flow is done by construction — even
                # when ``dt * rate`` underflows (transfer time below float
                # resolution at t, e.g. tiny payload on a fast link), so
                # the event always retires a flow and the loop progresses
                m = min(f.remaining for f in active)
                for f in active:
                    if f.remaining - m <= 1e-6 or f.remaining <= 1e-6:
                        f.remaining = 0.0
                        f.done_at = t_step
            t = t_step
        self._now = max(self._now, t)
        # account congestion for completed flows and prune them off the link
        for f in self._flows:
            if f.done_at is not None:
                extra = (f.done_at - f.issued_at) - f.alone
                if extra > 1e-12:
                    self.stats.congested_seconds += extra
        self._flows = [f for f in self._flows if f.done_at is None]

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

"""P-instance worker process: one prefill member of the cluster runtime —
PyTorch port of ``repro.serving.multiproc.p_worker``.

Runs the same protocol as the in-process ``PrefillFlightLoop``, but as a
real OS event loop: receive a request, drive its ``PrefillStream`` chunk
by chunk, encode each chunk through the ``DisaggPipeline`` and *stage* it
into this process's ``SharedMemoryConnector``, then post the segment
descriptor on the control plane. A D process adopts the segment and
reads it; staging is freed only when the parent relays D's consumption
(``ReleaseStaged``) — which is also the staging pool's backpressure: when
the pinned pool is full, the P loop blocks on release messages instead of
overrunning the pool.

All messages home carry this worker's instance id (``src``), and every
heartbeat carries the measured backlog (queued prefills + their estimated
prompt tokens) — the load signal the parent's router balances on. The
worker runs its engine in its own CUDA context on the card its spec names
(or on the CPU when the spec says ``device="cpu"``), and at shutdown ships
home the hand kernels it launched (``WorkerStats.launches``).
"""
from __future__ import annotations

import collections
import os
import queue
import time
from typing import Any, Deque

from repro_torch.serving.multiproc.messages import (ChunkStaged, Heartbeat,
                                                    Hello, PrefillDone,
                                                    PrefillFailed,
                                                    ReleaseStaged, Shutdown,
                                                    SubmitPrefill, WorkerSpec,
                                                    setup_worker,
                                                    worker_stats)


class _ShutdownRequested(Exception):
    pass


def _est_tokens(req) -> int:
    return req.prompt_len


class PWorker:
    """Event loop state of one prefill worker."""

    def __init__(self, spec: WorkerSpec, cmd_q, evt_q):
        setup_worker(spec)

        from repro_torch.core.disagg import DisaggPipeline
        from repro_torch.core.transport import SharedMemoryConnector
        self.spec = spec
        self.iid = spec.iid
        self.cmd_q = cmd_q
        self.evt_q = evt_q
        self.engine = spec.engine.build()
        self.connector = SharedMemoryConnector(**spec.connector_kwargs)
        self.pipeline = DisaggPipeline(self.connector, spec.wire)
        self.backlog: Deque[SubmitPrefill] = collections.deque()
        self.staged_chunks = 0
        self.release_ack = 0              # highest ReleaseStaged.seq done
        self.stop = False

    # -- control plane ---------------------------------------------------- #
    def _handle(self, msg: Any) -> None:
        if isinstance(msg, Shutdown):
            self.stop = True
            raise _ShutdownRequested
        if isinstance(msg, ReleaseStaged):
            self.connector.complete(msg.key)     # unlink: D consumed it
            self.release_ack = max(self.release_ack, msg.seq)
            return
        if isinstance(msg, SubmitPrefill):
            self.backlog.append(msg)
            return

    def _pump_cmds(self, timeout: float) -> bool:
        """Process one waiting command; True if one arrived."""
        try:
            msg = self.cmd_q.get(timeout=timeout)
        except queue.Empty:
            return False
        self._handle(msg)
        return True

    def _drain_cmds_nowait(self, limit: int = 64) -> None:
        """Process whatever commands are already queued. Called between
        chunks so ReleaseStaged (freeing consumed segments) and Shutdown
        don't starve while the backlog keeps this loop busy."""
        for _ in range(limit):
            try:
                msg = self.cmd_q.get_nowait()
            except queue.Empty:
                return
            self._handle(msg)

    def _load(self) -> dict:
        """Measured backlog snapshot for the heartbeat."""
        return {"backlog": float(len(self.backlog)),
                "backlog_tokens": float(sum(_est_tokens(m.req)
                                            for m in self.backlog))}

    # -- data plane -------------------------------------------------------- #
    def _stage_with_backpressure(self, key: str, wire_chunk, meta,
                                 stall_s: float = 30.0) -> int:
        """Stage a chunk; when the pinned pool is full, block on the
        control plane for ``ReleaseStaged`` (D consumed earlier chunks)
        until there is room — the cross-process flow-control loop."""
        deadline = time.monotonic() + stall_s
        while True:
            try:
                return self.connector.stage(key, wire_chunk, meta)
            except MemoryError:
                if time.monotonic() > deadline:
                    raise
                if self._pump_cmds(timeout=0.05):
                    deadline = time.monotonic() + stall_s

    def _run_flight(self, req, wire_skip: int = 0) -> None:
        """Stream one request's prefill: compute chunk → encode → stage →
        announce, then PrefillDone. ``wire_skip`` leading
        tokens (already resident on the stream's D via its prefix store)
        are computed/replayed but never encoded or staged."""
        from repro_torch.serving.engine import PrefillMode, slice_kv_entries
        spec, eng = self.spec, self.engine
        attempt = req.retries
        meta = {"seq_len": 0, "tp_p": eng.vendor.tp, "wire": self.pipeline.wire}
        skipped_tokens = sent_tokens = sent_bytes = 0
        try:
            stream = eng.prefill_stream(req, spec.prefill_chunk,
                                        mode=PrefillMode(spec.prefill_mode))
            meta["seq_len"] = stream.seq_len
            index = 0
            while True:
                t_c0 = time.monotonic()
                chunk = stream.next_chunk()
                t_c1 = time.monotonic()
                if chunk is None:
                    break
                if not chunk["kv"] and chunk["length"] == 0:
                    # progress marker: a compute chunk that produced no
                    # wire rows (states-only family, or a sliding chunk
                    # below the window floor) — nothing to stage
                    self._drain_cmds_nowait()
                    continue
                start, length = chunk["start"], chunk["length"]
                if wire_skip > start:
                    cut = min(wire_skip, start + length) - start
                    skipped_tokens += cut
                    self.connector.stats.prefix_hit_tokens += cut
                    if start + length <= wire_skip:
                        # fully resident on D: nothing for the wire
                        self._maybe_fault_exit()
                        self._drain_cmds_nowait()
                        continue
                    chunk = dict(chunk,
                                 kv=slice_kv_entries(chunk["kv"], wire_skip,
                                                     start + length),
                                 start=wire_skip,
                                 length=start + length - wire_skip)
                sent_tokens += chunk["length"]
                wire_chunk = self.pipeline.encode_chunk(eng, chunk)
                key = f"{req.req_id}@{eng.name}#t{attempt}c{index}"
                t_s0 = time.monotonic()
                nbytes = self._stage_with_backpressure(key, wire_chunk, meta)
                t_s1 = time.monotonic()
                self.evt_q.put(ChunkStaged(
                    req.req_id, attempt, index, key,
                    self.connector.segment_name(key), nbytes,
                    (t_s0, t_s1), (t_c0, t_c1),
                    ack_seq=self.release_ack, src=self.iid))
                index += 1
                self.staged_chunks += 1
                sent_bytes += nbytes
                self._maybe_fault_exit()
                self._drain_cmds_nowait()
            if skipped_tokens and sent_tokens and sent_bytes:
                # price the skipped tokens at this flight's measured
                # bytes/token on this wire format
                self.connector.stats.bytes_saved += int(
                    sent_bytes / sent_tokens * skipped_tokens)
            # the ported (dense) families carry no state or cross tail
            self.evt_q.put(PrefillDone(req.req_id, attempt,
                                       int(stream.first_token),
                                       stream.seq_len, index, None,
                                       ack_seq=self.release_ack,
                                       src=self.iid))
        except _ShutdownRequested:
            raise
        except Exception as e:                    # noqa: BLE001 — report home
            self.evt_q.put(PrefillFailed(req.req_id, attempt, repr(e),
                                         src=self.iid))

    def _maybe_fault_exit(self) -> None:
        fault = self.spec.fault_exit_after_chunks
        if fault is not None and self.staged_chunks >= fault:
            # die *hard*, mid-stream: no atexit, no finalizers — the staged
            # segments are stranded exactly as a SIGKILL'd node strands its
            # registered RDMA buffers. Flush the event queue first so the
            # parent's view matches what really got staged.
            self.evt_q.close()
            self.evt_q.join_thread()
            os._exit(3)

    # -- main loop ---------------------------------------------------------- #
    def run(self) -> None:
        self.evt_q.put(Hello(self.iid, os.getpid(), self.engine.name,
                             role="P"))
        try:
            while not self.stop:
                if self.backlog:
                    m = self.backlog.popleft()
                    self._run_flight(m.req, m.wire_skip_tokens)
                    continue
                if not self._pump_cmds(timeout=self.spec.heartbeat_s):
                    self.evt_q.put(Heartbeat(self.iid,
                                             ack_seq=self.release_ack,
                                             load=self._load()))
        except _ShutdownRequested:
            pass
        self.evt_q.put(worker_stats(self.iid, self.connector,
                                    self.engine))
        self.connector.close()


def p_main(spec: WorkerSpec, cmd_q, evt_q) -> None:
    """Process entry point (must be importable for spawn)."""
    PWorker(spec, cmd_q, evt_q).run()

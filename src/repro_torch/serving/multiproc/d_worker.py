"""D-instance worker process: one decode member of the cluster runtime —
PyTorch port of ``repro.serving.multiproc.d_worker``.

Runs the in-process ``DecodeLoop`` protocol as a real OS event loop, with
the re-page half of ``StreamedHandoff`` folded in: adopt each announced
shared-memory segment into this process's ``SharedMemoryConnector``,
``issue_read`` it, re-page completed reads into the paged pools (RMW so
chunk boundaries may straddle blocks), and — once the stream finalizes —
adopt the stream's tail segment (recurrent or SSD states, an enc-dec
model's memory rows) and place it into the slot, then activate the slot and join continuous batching. Decode steps interleave
with re-paging: a request already decoding never waits on another
request's chunks.

Failures are *surfaced*, not swallowed: a lost segment (the P process
died and its staging vanished), an adopt/read error, or an ``AbortStream``
for an in-flight handoff all post :class:`StreamFailed` home so the
scheduler side requeues — the cross-process analogue of the
``TransferError`` → requeue path in the single-process scheduler.

All messages home carry this worker's instance id (``src``), and every
heartbeat carries measured load — occupied slots, free paged blocks, free
KV-pool bytes — the signal the parent's router picks decode instances by.
The re-page copies each chunk out of the shared-memory segment before the
host→device move (``DisaggPipeline.materialize``) and releases the
chunk's views before ``complete(key)`` detaches the segment.
"""
from __future__ import annotations

import collections
import os
import queue
import time
from typing import Any, Deque, Dict, Optional, Tuple

from repro_torch.kernels import ops
from repro_torch.serving.multiproc.messages import (AbortStream, BeginStream,
                                                    ChunkReady, ChunkRepaged,
                                                    FinalizeStream, Heartbeat,
                                                    Hello, RequestDone,
                                                    ResetLaunchCounts,
                                                    Shutdown, StreamAccepted,
                                                    StreamFailed,
                                                    TokenEmitted, WorkerSpec,
                                                    setup_worker,
                                                    worker_stats)


class _DStream:
    """One in-flight inbound handoff on the D side."""

    def __init__(self, req, attempt: int, slot: int, block_ids):
        self.req = req
        self.attempt = attempt
        self.slot = slot
        self.block_ids = block_ids
        self.pending: Deque[Tuple[str, Any]] = collections.deque()
        self.finalize: Optional[FinalizeStream] = None


class DWorker:
    """Event loop state of one decode worker."""

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
        self.streams: Dict[str, _DStream] = {}
        self.emitted_tokens = 0
        # measured KV-pool footprint per paged block (exact: taken from the
        # pools this engine actually allocated) — free_bytes in heartbeats
        pool_bytes = sum(pool.untyped_storage().nbytes()
                         for pools in self.engine.paged_pools()
                         for pool in pools.values())
        self._block_bytes = pool_bytes // max(spec.engine.num_blocks, 1)
        self.stop = False

    # -- stream lifecycle -------------------------------------------------- #
    def _fail_stream(self, st: _DStream, error: str) -> None:
        """Surface a transfer failure: drop adopted segments, free the
        reservation, tell the scheduler side to requeue."""
        while st.pending:
            key, handle = st.pending.popleft()
            if handle is not None:               # None: adopted, not issued
                handle.cancel()
            self.connector.drop(key)             # adopted: detach only
        self.engine.abort_reservation(st.slot)
        self.streams.pop(st.req.req_id, None)
        self.evt_q.put(StreamFailed(st.req.req_id, st.attempt, error,
                                    src=self.iid))

    def _begin(self, msg: BeginStream) -> None:
        try:
            slot, block_ids = self.engine.reserve_sequence(
                msg.req, msg.seq_len, use_prefix_cache=True)
        except Exception as e:                    # noqa: BLE001
            self.evt_q.put(StreamFailed(msg.req.req_id, msg.attempt, repr(e),
                                        src=self.iid))
            return
        self.streams[msg.req.req_id] = _DStream(msg.req, msg.attempt, slot,
                                                block_ids)
        # report the resident prefix so the parent can tell the P worker
        # which leading chunks to keep off the wire entirely (the P side
        # accounts prefix_hit_tokens/bytes_saved when it actually skips)
        self.evt_q.put(StreamAccepted(msg.req.req_id, msg.attempt,
                                      self.engine.slot_prefix_tokens[slot],
                                      src=self.iid))

    def _adopt_chunk(self, msg: ChunkReady) -> None:
        st = self.streams.get(msg.req_id)
        if st is None or st.attempt != msg.attempt:
            return                                # stale attempt: ignore
        try:
            self.connector.adopt_segment(msg.key, msg.segment, msg.nbytes)
        except Exception as e:                    # noqa: BLE001
            self._fail_stream(st, f"adopt failed: {e!r}")
            return
        # the read is issued lazily in _pump_repage, gated on the
        # connector's max_inflight — a burst of queued ChunkReady must
        # back-pressure, not overrun the channel and fail the stream
        st.pending.append((msg.key, None))

    def _abort(self, msg: AbortStream) -> None:
        st = self.streams.get(msg.req_id)
        if st is None or st.attempt != msg.attempt:
            return
        self._fail_stream(st, msg.reason or "stream aborted mid-handoff")

    # -- re-page / finalize ------------------------------------------------- #
    def _pump_repage(self) -> bool:
        progressed = False
        for st in list(self.streams.values()):
            while st.pending:
                key, handle = st.pending[0]
                if handle is None:                # issue within channel cap
                    if self.connector.inflight_reads() >= \
                            self.connector.max_inflight:
                        break                     # full: retry next pump
                    try:
                        handle = self.connector.issue_read(key)
                    except Exception as e:        # noqa: BLE001
                        self._fail_stream(st, f"issue_read failed: {e!r}")
                        progressed = True
                        break
                    st.pending[0] = (key, handle)
                if not handle.poll():
                    break
                t0 = time.monotonic()
                try:
                    payload, meta = handle.wait()
                    self.pipeline.materialize(self.engine, st.slot,
                                              st.block_ids, payload, meta,
                                              rmw=True)
                except Exception as e:            # noqa: BLE001 — lost wire
                    self._fail_stream(st, f"transfer failed: {e!r}")
                    progressed = True
                    break
                payload.release()      # drop views before the segment closes
                self.connector.complete(key)      # detach the adoption
                self.connector.stats.chunks += 1
                st.pending.popleft()
                self.evt_q.put(ChunkRepaged(st.req.req_id, st.attempt, key,
                                            (t0, time.monotonic()),
                                            src=self.iid))
                progressed = True
            if st.req.req_id in self.streams and st.finalize is not None \
                    and not st.pending:
                self._finalize(st)
                progressed = True
        return progressed

    def _finalize(self, st: _DStream) -> None:
        fin = st.finalize
        if fin.tail is not None:        # states, memory rows: adopt, place
            t0 = time.monotonic()
            tkey = fin.tail["key"]
            try:
                self.connector.adopt_segment(tkey, fin.tail["segment"],
                                             fin.tail["nbytes"])
            except Exception as e:                # noqa: BLE001
                self._fail_stream(st, f"tail adopt failed: {e!r}")
                return
            try:
                payload, meta = self.connector.issue_read(tkey).wait()
                self.pipeline.materialize(self.engine, st.slot, st.block_ids,
                                          payload, meta)
            except Exception as e:                # noqa: BLE001
                self.connector.drop(tkey)         # adopted: free pool+detach
                self._fail_stream(st, f"tail transfer failed: {e!r}")
                return
            self.connector.complete(tkey)
            self.evt_q.put(ChunkRepaged(st.req.req_id, st.attempt, tkey,
                                        (t0, time.monotonic()),
                                        src=self.iid))
        self.engine.activate_sequence(st.slot, fin.first_token, fin.seq_len)
        self.streams.pop(st.req.req_id)
        # the prefill's token starts the stream (scheduler's
        # _emit_first_token, relocated into the D process)
        st.req.output_tokens.append(fin.first_token)
        self.evt_q.put(TokenEmitted(st.req.req_id, fin.first_token,
                                    st.attempt, first=True, src=self.iid))
        self.emitted_tokens += 1
        if st.req.done:
            self.engine.release(st.slot)
            self.evt_q.put(RequestDone(st.req.req_id, st.attempt,
                                       src=self.iid))
        self._maybe_fault_exit()

    # -- decode ------------------------------------------------------------- #
    def _pump_decode(self) -> bool:
        eng = self.engine
        if not any(r is not None and eng.slot_ready[i]
                   for i, r in enumerate(eng.slot_req)):
            return False
        for slot, req, tok in eng.decode_step():
            req.output_tokens.append(tok)
            # this side's req copy froze `retries` at dispatch == the attempt
            self.evt_q.put(TokenEmitted(req.req_id, tok, req.retries,
                                        src=self.iid))
            self.emitted_tokens += 1
            if req.done:
                eng.release(slot)
                self.evt_q.put(RequestDone(req.req_id, req.retries,
                                           src=self.iid))
            self._maybe_fault_exit()
        return True

    def _maybe_fault_exit(self) -> None:
        fault = self.spec.fault_exit_after_tokens
        if fault is not None and self.emitted_tokens >= fault:
            # die *hard*, mid-decode: the volatile KV dies with this
            # process, exactly as a decode node loss. Flush the event
            # queue first so the parent sees the tokens that really left.
            self.evt_q.close()
            self.evt_q.join_thread()
            os._exit(3)

    # -- control plane ------------------------------------------------------ #
    def _drain_cmds(self, limit: int = 64) -> bool:
        progressed = False
        for _ in range(limit):
            try:
                msg = self.cmd_q.get_nowait()
            except queue.Empty:
                break
            progressed = True
            if isinstance(msg, Shutdown):
                self.stop = True
                break
            if isinstance(msg, BeginStream):
                self._begin(msg)
            elif isinstance(msg, ChunkReady):
                self._adopt_chunk(msg)
            elif isinstance(msg, FinalizeStream):
                st = self.streams.get(msg.req_id)
                if st is not None and st.attempt == msg.attempt:
                    st.finalize = msg
            elif isinstance(msg, AbortStream):
                self._abort(msg)
            elif isinstance(msg, ResetLaunchCounts):
                ops.reset_launch_counts()
        return progressed

    def _load(self) -> dict:
        """Measured load snapshot for the heartbeat: what the router and
        autoscaler steer by."""
        eng = self.engine
        active = sum(1 for r in eng.slot_req if r is not None)
        free_blocks = eng.allocator.free_blocks
        return {"active": float(active),
                "free_slots": float(eng.max_batch - active),
                "free_blocks": float(free_blocks),
                "free_bytes": float(free_blocks * self._block_bytes),
                "pending_repage": float(sum(len(s.pending)
                                            for s in self.streams.values()))}

    # -- main loop ----------------------------------------------------------- #
    def run(self) -> None:
        self.evt_q.put(Hello(self.iid, os.getpid(), self.engine.name,
                             role="D"))
        last_beat = time.monotonic()
        while not self.stop:
            progressed = self._drain_cmds()
            progressed |= self._pump_repage()
            progressed |= self._pump_decode()
            now = time.monotonic()
            if now - last_beat >= self.spec.heartbeat_s:
                store = self.engine.prefix_store
                self.evt_q.put(Heartbeat(
                    self.iid, load=self._load(),
                    prefix_hashes=None if store is None else store.summary()))
                last_beat = now
            if not progressed:
                time.sleep(0.002)                 # idle: don't spin a core
        self.evt_q.put(worker_stats(self.iid, self.connector,
                                    self.engine))
        self.connector.close()


def d_main(spec: WorkerSpec, cmd_q, evt_q) -> None:
    """Process entry point (must be importable for spawn)."""
    DWorker(spec, cmd_q, evt_q).run()

"""Shared-memory connector: real cross-process staging — PyTorch port of
``repro.core.transport.shared_memory``.

KV chunks (:class:`~repro_torch.core.transport.wirefmt.WireChunk`) are
staged *zero-copy*: the chunk's fixed-layout plan is executed straight
into a ``multiprocessing.shared_memory`` segment (the device→host copy and
the cast or quantize write through typed views of the segment: no pickle,
no intermediate blob), and a reader gets a bound ``WireChunk`` whose entry
arrays are views over the segment itself. The segment bytes are the JAX
package's layout (same magic, ``RKVWIRE1``), so a segment staged by either
package reads in the other. Other payloads (plain trees of arrays or CPU
tensors) keep the pickled wire: serialized into the segment, deserialized
on read. The two are told apart by the segment's leading magic bytes. The
pinned pool accounts the segment footprint either way.

Two-process protocol (the multiproc serving runtime): the P side stages
and ships ``export_descriptor(key)`` over the control plane; the D side
``adopt_segment``\\ s the descriptor into *its own* connector — attaching
the OS segment by name, charging its pinned receive pool — after which
``issue_read``/``wait``/``complete`` behave exactly as for locally staged
keys. D's ``complete`` only detaches (the creator owns the segment and
unlinks on its own ``complete``, once told the chunk was consumed). A
zero-copy reader must drop its views (``WireChunk.release``) before
``complete(key)``; ``_evict`` tolerates stragglers by deferring the close
until the buffer is unpinned.

Segments this package creates are named ``rtsm_<16 hex digits>``
(``SEGMENT_PREFIX``); a segment of either package is adopted by the name
its descriptor carries.

Segment lifetime is guarded by a ``weakref.finalize`` cleanup: a process
that drops its connector without calling ``drop()``/``close()`` — or exits
normally mid-stream — unlinks every segment it created (and detaches every
segment it adopted) at GC/atexit time. Only a hard kill
(``os._exit``/SIGKILL) can skip this; the cluster launcher covers that
path by unlinking a crashed worker's outstanding segments from the parent.
"""
from __future__ import annotations

import dataclasses
import pickle
import secrets
import weakref
from multiprocessing import shared_memory
from typing import Any, Dict, Set, Tuple

from repro_torch.core.transport import wirefmt
from repro_torch.core.transport.base import KVConnector

# the segments this package creates: its own name prefix (CPython's
# default is ``psm_``), so that a process that watches ``psm_*`` segments
# never sees them; a reader attaches by the name in the descriptor
SEGMENT_PREFIX = "rtsm_"


def _cleanup_segments(segments: Dict[str, shared_memory.SharedMemory],
                      adopted: Set[str]) -> None:
    """Finalizer body (must not reference the connector): close every
    segment, unlink the ones this process created."""
    for key, seg in list(segments.items()):
        try:
            if key not in adopted:
                seg.unlink()
        except Exception:
            pass
        try:
            seg.close()
        except Exception:
            pass                      # BufferError: a view still pins it
    segments.clear()
    adopted.clear()


class SharedMemoryConnector(KVConnector):
    transport = "shm"

    def __init__(self, bandwidth_gbps: float = 25.0,
                 buffer_capacity_bytes: int = 1 << 32,
                 max_inflight: int = 32):
        super().__init__(bandwidth_gbps=bandwidth_gbps,
                         buffer_capacity_bytes=buffer_capacity_bytes,
                         fixed_latency_s=0.0, max_inflight=max_inflight)
        self._segments: Dict[str, shared_memory.SharedMemory] = {}
        self._adopted: Set[str] = set()
        # segments whose close() hit BufferError (a reader's view was still
        # alive) — retried on later evictions and at close()
        self._deferred_close: list = []
        # leak guard: runs at GC *and* interpreter exit, whichever first
        self._finalizer = weakref.finalize(
            self, _cleanup_segments, self._segments, self._adopted)

    def capabilities(self):
        return dataclasses.replace(super().capabilities(),
                                   cross_process=True, zero_copy=True,
                                   wire_codec="fixed",
                                   header_bytes=wirefmt.nominal_header_bytes())

    def segment_name(self, key: str) -> str:
        """OS-level name of a staged key's segment — what a reader in
        another process attaches to."""
        return self._segments[key].name

    # -- cross-process descriptor plane ----------------------------------- #
    def export_descriptor(self, key: str) -> Dict[str, Any]:
        """Control-plane handle for a staged key: everything a connector in
        another process needs to ``adopt_segment`` and read it, and the
        staged payload's array bytes (``payload_nbytes``: a pickled
        tree's segment holds these plus the pickle's framing)."""
        return {"key": key, "segment": self._segments[key].name,
                "nbytes": self._sizes[key],
                "payload_nbytes": self._payload_sizes.get(key)}

    def adopt_segment(self, key: str, segment: str, nbytes: int) -> int:
        """Attach a segment staged by a connector in *another* process so
        ``issue_read(key)`` works locally. Charges this side's pinned pool
        (the receive buffer); ``complete(key)`` detaches without unlinking —
        the creating process owns the segment's lifetime."""
        if key in self._sizes:
            raise ValueError(f"transfer key {key!r} already staged")
        # attaching re-registers the name with the resource tracker, which
        # spawned children share with the launcher — a set, so the
        # creator's eventual unlink unregisters it exactly once
        seg = shared_memory.SharedMemory(name=segment)
        try:
            self.pool.acquire(nbytes)
        except Exception:
            seg.close()
            raise
        self._segments[key] = seg
        self._adopted.add(key)
        self._sizes[key] = nbytes
        self.stats.peak_buffer_bytes = self.pool.high_water
        return nbytes

    # -- storage hooks ---------------------------------------------------- #
    def _put(self, key: str, payload, meta: Dict[str, Any]) -> int:
        if hasattr(payload, "write_into"):     # WireChunk: zero-copy stage
            nbytes = payload.nbytes
            seg = self._new_segment(nbytes)
            try:
                payload.write_into(seg.buf)    # D2H + cast into the shm
            except Exception:
                self._discard(seg, nbytes)
                raise
            self._segments[key] = seg
            return nbytes
        blob = pickle.dumps((payload, meta), protocol=pickle.HIGHEST_PROTOCOL)
        nbytes = len(blob)
        seg = self._new_segment(nbytes)
        seg.buf[:nbytes] = blob
        self._segments[key] = seg
        return nbytes

    def _new_segment(self, nbytes: int) -> shared_memory.SharedMemory:
        self.pool.acquire(nbytes)
        try:
            while True:
                try:
                    return shared_memory.SharedMemory(
                        name=SEGMENT_PREFIX + secrets.token_hex(8),
                        create=True, size=nbytes)
                except FileExistsError:
                    continue                 # a name taken: draw another
        except Exception:
            self.pool.release(nbytes)
            raise

    def _discard(self, seg: shared_memory.SharedMemory, nbytes: int) -> None:
        """A segment whose staging failed: unlink it and free its pool."""
        seg.unlink()
        seg.close()
        self.pool.release(nbytes)

    def _get(self, key: str) -> Tuple[Any, Dict[str, Any]]:
        # reuse the mapping this connector already holds — staging (P side)
        # and adoption (D side) both attached the segment once
        seg = self._segments[key]
        nbytes = self._sizes[key]
        if nbytes >= len(wirefmt.MAGIC) \
                and bytes(seg.buf[:len(wirefmt.MAGIC)]) == wirefmt.MAGIC:
            chunk = wirefmt.WireChunk.from_buffer(seg.buf)
            return chunk, chunk.meta()         # zero-copy views over the shm
        payload, meta = pickle.loads(bytes(seg.buf[:nbytes]))
        return payload, meta

    def _evict(self, key: str) -> None:
        seg = self._segments.pop(key, None)
        if seg is None:
            return
        adopted = key in self._adopted
        self._adopted.discard(key)
        if not adopted:                        # creator owns the OS name
            try:
                seg.unlink()
            except FileNotFoundError:
                pass
        try:
            seg.close()
        except BufferError:
            # a zero-copy view over this segment is still alive somewhere —
            # defer the munmap; retried on later evictions / close()
            self._deferred_close.append(seg)
        self._retry_deferred()

    def _retry_deferred(self) -> None:
        still = []
        for seg in self._deferred_close:
            try:
                seg.close()
            except BufferError:
                still.append(seg)
        self._deferred_close = still

    def close(self) -> None:
        super().close()
        self._retry_deferred()
        self._finalizer()          # idempotent: nothing left, detach atexit

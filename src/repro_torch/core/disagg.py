"""P/D disaggregation orchestrator (paper §III) — PyTorch port of
``repro.core.disagg`` with the fixed wire codec.

``DisaggPipeline`` moves prefill KV from a P instance to a D instance
through the alignment components: precision (wire dtype or int8), TP
shard realignment, and the re-page into the D vendor's block size and
layout. Two handoff shapes share one encode/re-page core:

  * ``handoff`` — monolithic: whole-prompt prefill, one wire chunk, one
    re-page that zero-fills the tail of the last page (``rmw=False``).
  * ``begin_handoff`` / ``StreamedHandoff`` — chunked streaming: the D
    slot is reserved up front, each prefill chunk's KV is staged while the
    next chunk computes, and D re-pages chunks as they land, keeping the
    rows of partly covered pages that other chunks wrote (``rmw=True``).
    The reservation consults D's prefix store: tokens already resident on
    D never cross the wire (``TransferStats.prefix_hit_tokens``,
    ``bytes_saved``).

The wire stays in host memory as in the reference: the P side copies KV
device→host when a chunk is encoded, the D side copies it out of the wire
buffer and host→device when it re-pages. Both re-page paths go through
the overlay scatter (``kernels.ops.scatter_pages_overlay``): one launch
per pool covers every layer of a block group, and the pools are updated
in place.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.compat import parallel_align, precision
from repro_torch.core.compat.precision import WireFormat
from repro_torch.core.transport import KVConnector, TransferHandle, WireChunk
from repro_torch.kernels import ops as kops
from repro_torch.serving import paged_cache as PC
from repro_torch.serving.engine import (Engine, kv_entries_with_start,
                                        slice_kv_entries)
from repro_torch.serving.request import Request


def _repage_pool(spec: PC.KVPageSpec, pool: torch.Tensor,
                 block_ids: torch.Tensor, canon: torch.Tensor, lo_block: int,
                 *, front: int, rmw: bool) -> torch.Tensor:
    """Re-page canon (count, S, kv, hd) landing ``front`` rows into block
    ``lo_block``'s first page, for all ``count`` layers in one launch; the
    kernel casts to the pool dtype.

    ``rmw`` hands the rows to the kernel as they are and keeps the rest of
    the boundary pages. Without it every row of every touched page is
    written: the canon is laid into zero-padded whole pages first, as the
    reference's ``scatter_sequence`` on the monolithic path writes them."""
    bs = spec.block_size
    count, s = canon.shape[0], canon.shape[1]
    nb = -(-(front + s) // bs)
    use = block_ids[lo_block:lo_block + nb]
    if rmw:
        return kops.scatter_pages_overlay(spec, pool, use, canon,
                                          front=front, seq_len=s)
    padded = torch.zeros((count, nb * bs, spec.kv_heads, spec.head_dim),
                         dtype=canon.dtype, device=pool.device)
    padded[:, front:front + s] = canon
    return kops.scatter_pages_overlay(
        spec, pool, use, padded.view(count, nb, bs, spec.kv_heads,
                                     spec.head_dim), front=0, seq_len=nb * bs)


def _repage_kv_entry(spec: PC.KVPageSpec, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_ids: torch.Tensor,
                     pay: torch.Tensor, sc: Optional[torch.Tensor],
                     lo_block: int, *, wire: WireFormat, tp_p: int,
                     tp_d: int, count: int, front: int, rmw: bool) -> None:
    """Dequantize the whole shard-major slab (2·tp_p, count, S, kvs, hd) in
    one pass, realign TP shards, overlay-scatter both pools in place. A raw
    wire keeps its dtype and int8 decodes to float32: the overlay kernel
    makes the one cast to the pool dtype, rounding as the reference's
    ``decode_wire`` does."""
    sc_t = None if sc is None else sc.reshape(tuple(pay.shape[:-1]) + (1,))
    dec = precision.decode_wire(pay, sc_t, wire, pay.dtype
                                if wire.kind == "raw" else torch.float32)
    s = pay.shape[2]
    hd = spec.head_dim
    dec = dec.reshape(2 * tp_p, count * s, -1, hd)
    k_d = torch.cat(parallel_align.realign_shards(list(dec[:tp_p]), tp_d),
                    dim=1).reshape(count, s, -1, hd)
    v_d = torch.cat(parallel_align.realign_shards(list(dec[tp_p:]), tp_d),
                    dim=1).reshape(count, s, -1, hd)
    _repage_pool(spec, k_pool, block_ids, k_d, lo_block, front=front, rmw=rmw)
    _repage_pool(spec, v_pool, block_ids, v_d, lo_block, front=front, rmw=rmw)


class DisaggPipeline:
    def __init__(self, transfer: KVConnector,
                 wire: Optional[WireFormat] = None):
        self.transfer = transfer
        self.wire = wire or WireFormat(kind="raw", dtype="bfloat16")

    # ------------------------------------------------------------------ #
    # P side: chunk → wire
    # ------------------------------------------------------------------ #
    def encode_chunk(self, p_engine: Engine, chunk: Dict[str, Any]
                     ) -> WireChunk:
        """One prefill chunk ({"kv": normalized entries}) → a *planned*
        :class:`WireChunk`. No KV bytes move here: the device→host copy and
        cast happen when the connector materializes the chunk."""
        return WireChunk.from_entries(chunk["kv"], self.wire,
                                      p_engine.vendor.tp,
                                      seq_len=chunk.get("length", 0))

    # ------------------------------------------------------------------ #
    # D side: wire → pools
    # ------------------------------------------------------------------ #
    def materialize(self, d_engine: Engine, slot: int, block_ids: np.ndarray,
                    payload: WireChunk, meta: Dict[str, Any], *,
                    rmw: bool = False) -> None:
        """Re-page a wire chunk into the D instance's pools (in place).
        ``rmw`` keeps the untouched rows of partly covered pages — required
        when streamed chunk boundaries do not align with D's block size."""
        if not isinstance(payload, WireChunk):
            raise NotImplementedError(
                "only fixed-codec wire chunks re-page in the port (dense "
                "handoffs carry no state or cross-attention tail)")
        dev = d_engine.device
        spec = d_engine.specs["kv"]
        bids = torch.from_numpy(np.asarray(block_ids, np.int32)).to(dev)
        for entry in payload.entries():
            count, start = entry["count"], entry["start"]
            # copy out of the wire buffer before the host→device move
            pay = precision.host_tensor(np.array(entry["payload"]),
                                        entry["dtype"]).to(dev)
            sc = entry["scales"]
            sc = None if sc is None else torch.from_numpy(np.array(sc)).to(dev)
            pools = d_engine.caches[entry["gi"]][entry["pi"]]
            _repage_kv_entry(spec, pools["k_pool"], pools["v_pool"], bids,
                             pay, sc, start // spec.block_size,
                             wire=payload.wire, tp_p=entry["tp_p"],
                             tp_d=d_engine.vendor.tp, count=count,
                             front=start % spec.block_size, rmw=rmw)

    # ------------------------------------------------------------------ #
    # Monolithic handoff (baseline transmission)
    # ------------------------------------------------------------------ #
    def handoff(self, req: Request, p_engine: Engine, d_engine: Engine
                ) -> Dict[str, Any]:
        """prefill-package → stage → issue_read → wait → re-page. Returns
        meta."""
        self.transfer.register(p_engine.name, role="prefill")
        self.transfer.register(d_engine.name, role="decode")
        package = p_engine.prefill(req)
        chunk = WireChunk.from_entries(kv_entries_with_start(package["kv"]),
                                       self.wire, p_engine.vendor.tp,
                                       seq_len=package["seq_len"])
        meta = {"first_token": package["first_token"],
                "seq_len": package["seq_len"], "tp_p": p_engine.vendor.tp,
                "wire": self.wire}
        key = f"{req.req_id}@{p_engine.name}#t{req.retries}"
        nbytes = self.transfer.stage(key, chunk, meta)
        try:
            # a cross-process connector reads back only the chunk's own
            # meta (wire, tp_p, seq_len); first_token stays on this side
            payload, _ = self.transfer.issue_read(key).wait()

            def materialize_fn(engine, slot, bids, _pkg):
                self.materialize(engine, slot, bids, payload, meta)

            d_engine.add_sequence(req, {"first_token": meta["first_token"],
                                        "seq_len": meta["seq_len"]},
                                  materialize_fn)
        except Exception:
            self.transfer.drop(key)    # free the pinned staging on failure
            raise
        payload.release()              # drop views before the segment closes
        self.transfer.complete(key)
        meta["bytes"] = nbytes
        return meta

    # ------------------------------------------------------------------ #
    # Streamed chunked handoff (overlapped transmission)
    # ------------------------------------------------------------------ #
    def begin_handoff(self, req: Request, p_engine: Engine, d_engine: Engine,
                      seq_len: int,
                      compute_overlapped: bool = False) -> "StreamedHandoff":
        """Reserve the D slot/blocks and open a chunk stream for ``req``."""
        return StreamedHandoff(self, req, p_engine, d_engine, seq_len,
                               compute_overlapped=compute_overlapped)

    def handoff_streamed(self, req: Request, p_engine: Engine,
                         d_engine: Engine,
                         chunk_tokens: Optional[int] = None,
                         chunked_compute: Optional[bool] = None,
                         mode=None) -> Dict[str, Any]:
        """Drive a full streamed handoff synchronously (tests, benches; the
        global scheduler advances the same protocol tick by tick)."""
        stream = p_engine.prefill_stream(req, chunk_tokens,
                                         chunked_compute=chunked_compute,
                                         mode=mode)
        h = self.begin_handoff(req, p_engine, d_engine, stream.seq_len,
                               compute_overlapped=stream.chunked_compute)
        try:
            while True:
                chunk = stream.next_chunk()
                if chunk is None:
                    break
                if not chunk["kv"] and chunk["length"] == 0:
                    continue            # compute-only progress marker
                h.send_chunk(chunk)
                h.poll_reads()          # re-page whatever the wire delivered
            return h.finalize(stream.first_token, stream.tail_package())
        except Exception:
            h.abort()
            raise


class StreamedHandoff:
    """State of one in-flight chunked P→D handoff.

    Lifecycle: reserve (ctor) → (``send_chunk`` | ``poll_reads``)×N →
    ``finalize`` | ``abort``. Chunks re-page in issue order (the wire is an
    ordered channel), so a later chunk never lands before an earlier one
    that shares a block."""

    def __init__(self, pipeline: DisaggPipeline, req: Request,
                 p_engine: Engine, d_engine: Engine, seq_len: int, *,
                 compute_overlapped: bool = False):
        self.pipeline = pipeline
        self.req = req
        self.p_engine = p_engine
        self.d_engine = d_engine
        self.seq_len = seq_len
        self.compute_overlapped = compute_overlapped
        pipeline.transfer.register(p_engine.name, role="prefill")
        pipeline.transfer.register(d_engine.name, role="decode")
        self.slot, self.block_ids = d_engine.reserve_sequence(
            req, seq_len, use_prefix_cache=True)
        # prefix tokens already resident on D: chunks below this position
        # never touch the wire (send_chunk slices / drops them)
        self.wire_skip = d_engine.slot_prefix_tokens[self.slot]
        self.meta = {"seq_len": seq_len, "tp_p": p_engine.vendor.tp,
                     "wire": pipeline.wire}
        self.chunks_sent = 0
        self.chunks_repaged = 0
        self.bytes = 0
        self._skipped_tokens = 0
        self._sent_tokens = 0
        self._pending: Deque[Tuple[str, TransferHandle, float, float]] = \
            collections.deque()
        self._chunk_modeled: List[float] = []
        self._chunk_compute: List[float] = []
        self._t_first_stage: Optional[float] = None
        self._t_last_repage: Optional[float] = None
        self._chunk_wall_pending: List[float] = []
        self._closed = False

    # -- wire side -------------------------------------------------------- #
    def can_send(self) -> bool:
        """Channel has room for another issued-but-unread chunk."""
        caps = self.pipeline.transfer.capabilities()
        return self.pipeline.transfer.inflight_reads() < caps.max_inflight

    def pending_reads(self) -> int:
        return len(self._pending)

    def send_chunk(self, chunk: Dict[str, Any]) -> int:
        """Encode → stage → issue the wire read for one chunk. Returns its
        staged bytes (0 for a chunk wholly resident on D)."""
        assert not self._closed, "send_chunk on a closed handoff"
        if self.d_engine.failed:
            raise RuntimeError(f"instance {self.d_engine.name} is down")
        start, length = chunk["start"], chunk["length"]
        if self.wire_skip > start:
            skipped = min(self.wire_skip, start + length) - start
            self._skipped_tokens += skipped
            self.pipeline.transfer.stats.prefix_hit_tokens += skipped
            if start + length <= self.wire_skip:
                return 0               # fully resident on D: skip the wire
            chunk = dict(chunk,
                         kv=slice_kv_entries(chunk["kv"], self.wire_skip,
                                             start + length),
                         start=self.wire_skip,
                         length=start + length - self.wire_skip)
        self._sent_tokens += chunk["length"]
        while not self.can_send():
            if not self._repage_head(force=True):
                break
        tr = self.pipeline.transfer
        wire_chunk = self.pipeline.encode_chunk(self.p_engine, chunk)
        key = f"{self.req.req_id}@{self.p_engine.name}" \
              f"#t{self.req.retries}c{self.chunks_sent}"
        if self._t_first_stage is None:
            self._t_first_stage = time.monotonic()
        nbytes = tr.stage(key, wire_chunk, self.meta)
        try:
            handle = tr.issue_read(key)
        except Exception:
            tr.drop(key)
            raise
        self._pending.append((key, handle,
                              chunk.get("compute_seconds", 0.0),
                              time.monotonic()))
        self.chunks_sent += 1
        self.bytes += nbytes
        return nbytes

    # -- D side ----------------------------------------------------------- #
    def _repage_head(self, force: bool = False) -> bool:
        """Re-page the oldest pending chunk if its read completed (or
        unconditionally when ``force``). Returns True if it re-paged."""
        if not self._pending:
            return False
        key, handle, compute_s, t_issue = self._pending[0]
        if not force and not handle.poll():
            return False
        if self.d_engine.failed:
            raise RuntimeError(f"instance {self.d_engine.name} is down")
        tr = self.pipeline.transfer
        payload, meta = handle.wait()
        self.pipeline.materialize(self.d_engine, self.slot, self.block_ids,
                                  payload, meta, rmw=True)
        payload.release()
        tr.complete(key)
        tr.stats.chunks += 1
        self._chunk_modeled.append(tr.modeled_latency(handle.nbytes))
        self._chunk_compute.append(compute_s)
        self._t_last_repage = time.monotonic()
        self._chunk_wall_pending.append(self._t_last_repage - t_issue)
        self._pending.popleft()
        self.chunks_repaged += 1
        return True

    def poll_reads(self, budget: Optional[int] = None) -> int:
        """Re-page up to ``budget`` completed chunks (None = all)."""
        done = 0
        while (budget is None or done < budget) and self._repage_head():
            done += 1
        return done

    def drain(self) -> int:
        """Force-complete and re-page every pending read."""
        done = 0
        while self._repage_head(force=True):
            done += 1
        return done

    def finalize(self, first_token: int, tail_package: Dict[str, Any]
                 ) -> Dict[str, Any]:
        """Activate the D slot and account overlap (dense handoffs have no
        state tail)."""
        assert not self._closed
        assert not tail_package.get("states") and \
            not tail_package.get("cross"), "state tails are not ported"
        self.drain()
        tr = self.pipeline.transfer
        self.d_engine.activate_sequence(self.slot, first_token, self.seq_len)
        if self.compute_overlapped:
            tr.stats.overlap_modeled_seconds += sum(
                min(xfer, comp) for xfer, comp in
                zip(self._chunk_modeled[:-1], self._chunk_compute[1:]))
            tr.stats.wall_overlap_seconds += sum(
                min(pend, comp) for pend, comp in
                zip(self._chunk_wall_pending[:-1], self._chunk_compute[1:]))
        if self._t_first_stage is not None and self._t_last_repage is not None:
            tr.stats.wall_handoff_seconds += \
                self._t_last_repage - self._t_first_stage
        if self._skipped_tokens and self._sent_tokens and self.bytes:
            # the flight's own measured bytes/token prices what the
            # skipped tokens would have cost on this wire format
            tr.stats.bytes_saved += int(
                self.bytes / self._sent_tokens * self._skipped_tokens)
        self._closed = True
        return {"first_token": first_token, "seq_len": self.seq_len,
                "tp_p": self.meta["tp_p"], "wire": self.pipeline.wire,
                "bytes": self.bytes, "chunks": self.chunks_sent}

    def abort(self) -> None:
        """Failure path: drop staged-but-unread chunks and free the D
        reservation."""
        if self._closed:
            return
        self._closed = True
        tr = self.pipeline.transfer
        while self._pending:
            key, handle, _comp, _t = self._pending.popleft()
            handle.cancel()
            tr.drop(key)
        self.d_engine.abort_reservation(self.slot)

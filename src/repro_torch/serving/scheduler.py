"""Global scheduler (paper Fig. 1-2): request routing across P and D pools
— PyTorch port of ``repro.serving.scheduler`` (autoscaling hooks are not
ported yet).

Responsibilities beyond the paper's workflow (required for 1000-node scale):
  * load-aware routing (least outstanding work, straggler-penalized)
  * fault tolerance: failed P → re-dispatch prefill; failed D → KV is lost,
    re-prefill with the already-generated prefix appended (the standard
    recovery in disaggregated serving)
  * straggler mitigation: per-instance decode-latency EMA feeds a routing
    penalty
  * elastic scaling: instances join/leave at runtime (leave = drain first)

Structure: the work is split into two *event loops* — the P-side
:class:`PrefillFlightLoop` (dispatch requests, pump each flight's chunk
stream) and the D-side :class:`DecodeLoop` (re-page landed chunks is part
of flight pumping; decode-step every D engine). In single-process serving
``GlobalScheduler.step()`` pumps both loops in turn; the two-process
runtime (``repro_torch.serving.multiproc``) runs the same two loops as real OS
processes, with the control plane over queues instead of direct calls.
The scheduler itself holds no tensors; ``device`` names where its engines
must live (the card unless ``device="cpu"``).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import device as _dev
from repro_torch.serving.engine import Engine, PrefillMode
from repro_torch.serving.request import Request, State

if TYPE_CHECKING:                      # avoid core <-> serving import cycle
    from repro_torch.core.disagg import DisaggPipeline


@dataclasses.dataclass
class SchedulerStats:
    submitted: int = 0
    finished: int = 0
    failed: int = 0
    # requests rejected by admission control before entering the runtime
    # (open-loop overload shedding — never counts a request mid-stream)
    shed: int = 0
    requeues: int = 0
    chunks_streamed: int = 0
    p_dispatches: Dict[str, int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))
    d_dispatches: Dict[str, int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))


# both runtimes (in-process GlobalScheduler, multi-process ClusterRuntime)
# account into the same stats block; the cluster-facing name
RuntimeStats = SchedulerStats


# failures that void a dispatch/flight and requeue the request: a dead
# engine (RuntimeError) or pinned-pool exhaustion (MemoryError from stage).
# Requeues are capped by max_retries so a permanent failure surfaces as a
# FAILED request instead of an infinite dispatch loop.
_DISPATCH_ERRORS = (RuntimeError, MemoryError)


def requeue_for_retry(req: Request, stats: SchedulerStats,
                      transfer_stats, max_retries: int) -> bool:
    """Shared failure/straggler recovery semantics (single-process
    GlobalScheduler AND the two-process launcher — both runtimes must
    requeue identically or the parity gate breaks): re-prefill with the
    generated prefix appended to the prompt. ``output_tokens`` keeps the
    already-streamed tokens (and ``max_new_tokens`` stays put, so ``done``
    still fires at the original budget); the re-prefill's first token is
    the continuation after the prefix. Returns True if the request should
    rejoin the queue, False once it is FAILED past ``max_retries``."""
    if req.retries >= max_retries:
        req.state = State.FAILED
        stats.failed += 1
        return False
    if req.output_tokens:
        req.prompt = np.concatenate(
            [req.prompt, np.asarray(req.output_tokens, req.prompt.dtype)])
    req.retries += 1
    req.state = State.QUEUED
    stats.requeues += 1
    # failure accounting is wire-visible: a requeue retries the transfer
    transfer_stats.retries += 1
    return True


@dataclasses.dataclass
class _Flight:
    """One in-flight chunked prefill+handoff: occupies a P instance and a
    reserved D slot across scheduler ticks."""
    req: Request
    p: Engine
    d: Engine
    stream: Any                     # serving.engine.PrefillStream
    handoff: Any                    # core.disagg.StreamedHandoff


class PrefillFlightLoop:
    """P-side event loop: dispatch pending requests into prefill flights,
    then pump every flight — re-page chunks whose wire reads completed,
    stream new chunks onto the wire, finalize exhausted streams.

    One ``pump()`` call is one tick of P-side progress. The two-process
    runtime's P worker runs the same dispatch→chunk→stage protocol as its
    process main loop (``repro_torch.serving.multiproc.p_worker``)."""

    def __init__(self, sched: "GlobalScheduler"):
        self.sched = sched
        self.inflight: List[_Flight] = []
        # engines that ran prefill compute this tick — integrated
        # (role="both") engines in this set defer their decode step
        # (prefill-priority interleaving; the stall is measured in
        # EngineStats.contention_stall_seconds)
        self.prefilled: set = set()

    def pump(self, emitted: List[Tuple[Request, int]]) -> None:
        self.prefilled.clear()
        self._dispatch(emitted)
        self._advance_all(emitted)

    # -- dispatch --------------------------------------------------------- #
    def _dispatch(self, emitted: List[Tuple[Request, int]]) -> None:
        """Start a prefill flight on a free P with a reserved slot on a D.
        Monolithic mode (prefill_chunk None) drives the flight to completion
        inside this tick; chunked mode leaves it in flight so the tick stays
        short."""
        s = self.sched
        busy_p = {fl.p.name for fl in self.inflight}
        still_pending: collections.deque = collections.deque()
        while s.pending:
            req = s.pending.popleft()
            p_eng = s._pick_p(busy_p)
            d_eng = s._pick_d(req, req.prompt_len)
            if p_eng is None or d_eng is None:
                still_pending.append(req)
                continue
            req.state = State.PREFILLING
            req.prefill_instance = p_eng.name
            req.decode_instance = d_eng.name
            if s.prefill_chunk is None:
                # monolithic: whole prefill + single-payload handoff in-tick
                try:
                    meta = s.pipeline.handoff(req, p_eng, d_eng)
                except _DISPATCH_ERRORS:
                    s._requeue(req, p_eng)
                    continue
                self.prefilled.add(p_eng.name)
                s._emit_first_token(req, p_eng, d_eng,
                                    meta["first_token"], emitted)
                continue
            try:
                stream = p_eng.prefill_stream(req, s.prefill_chunk,
                                              mode=s.prefill_mode)
                handoff = s.pipeline.begin_handoff(
                    req, p_eng, d_eng, stream.seq_len,
                    compute_overlapped=stream.chunked_compute)
            except _DISPATCH_ERRORS:
                s._requeue(req, p_eng)
                continue
            self.inflight.append(_Flight(req, p_eng, d_eng, stream, handoff))
            busy_p.add(p_eng.name)
        s.pending = still_pending

    # -- flight pumping --------------------------------------------------- #
    def _advance_all(self, emitted: List[Tuple[Request, int]]) -> None:
        """Advance in-flight chunked prefills by the per-tick budget; each
        chunk's wire transfer overlaps the next chunk's compute."""
        s = self.sched
        for fl in list(self.inflight):
            try:
                tok = self._advance(fl, s.chunk_budget)
            except _DISPATCH_ERRORS:
                s._abort_flight(fl)
                continue
            if tok is not None:
                self.inflight.remove(fl)
                s._emit_first_token(fl.req, fl.p, fl.d, tok, emitted)

    def _advance(self, fl: _Flight, budget: Optional[int]) -> Optional[int]:
        """One tick of flight progress: re-page chunks whose wire reads
        completed (``repage_budget``), then stream up to ``budget`` new
        chunks (None = to completion) while the connector channel has room.
        The flight finalizes only when the prefill stream is exhausted AND
        every issued read has been re-paged — with a modeled-latency
        connector the tail chunks complete in later ticks, and decode steps
        run in between. Returns the first token on finalize, else None."""
        s = self.sched
        repaged = fl.handoff.poll_reads(s.repage_budget)
        sent = 0
        while (budget is None or sent < budget) and fl.handoff.can_send():
            chunk = fl.stream.next_chunk()
            if chunk is None:
                break
            if chunk.get("compute_seconds", 0.0) > 0.0:
                self.prefilled.add(fl.p.name)
            if not chunk["kv"] and chunk["length"] == 0:
                sent += 1        # compute-only progress marker: consumes
                continue         # the tick budget, never hits the wire
            fl.handoff.send_chunk(chunk)
            fl.req.chunks_streamed += 1
            s.stats.chunks_streamed += 1
            sent += 1
        # instant backends complete at issue time — spend what is left of
        # the re-page budget on the chunks just sent
        if s.repage_budget is None:
            fl.handoff.poll_reads(None)
        elif repaged < s.repage_budget:
            fl.handoff.poll_reads(s.repage_budget - repaged)
        if not fl.stream.done or fl.handoff.pending_reads():
            return None
        meta = fl.handoff.finalize(fl.stream.first_token,
                                   fl.stream.tail_package())
        return meta["first_token"]


class DecodeLoop:
    """D-side event loop: one continuous-batching decode step on every
    routable D engine per ``pump()``, with the per-instance latency EMA
    that feeds straggler-penalized routing. The two-process runtime's D
    worker runs the same re-page→decode protocol as its process main loop
    (``repro_torch.serving.multiproc.d_worker``)."""

    def __init__(self, sched: "GlobalScheduler"):
        self.sched = sched
        self.ema: Dict[str, float] = {}        # decode step latency EMA

    def pump(self, emitted: List[Tuple[Request, int]]) -> None:
        s = self.sched
        prefilled = s.prefill_loop.prefilled
        for e in s._routable(s.d_pool) + \
                [s.d_pool[n] for n in list(s._draining)
                 if n in s.d_pool and not s.d_pool[n].failed]:
            # prefill-priority interleaving: an integrated engine that
            # spent this tick on prefill compute defers its decode step —
            # the paper's P/D interference, measured (not modeled) in
            # EngineStats.contention_stall_seconds
            if e.role == "both" and e.name in prefilled:
                continue
            # reserved-but-not-ready flight slots don't decode — timing a
            # no-op step would pollute the straggler-latency EMA
            active = any(r is not None and e.slot_ready[i]
                         for i, r in enumerate(e.slot_req))
            if not active:
                continue
            t0 = time.perf_counter()
            try:
                results = e.decode_step()
            except RuntimeError:
                continue            # picked up by _handle_failures next tick
            dt = time.perf_counter() - t0
            prev = self.ema.get(e.name, dt)
            self.ema[e.name] = 0.8 * prev + 0.2 * dt
            for slot, req, tok in results:
                req.output_tokens.append(tok)
                emitted.append((req, tok))
                if req.done:
                    s._finish(req, e, slot)


class GlobalScheduler:
    def __init__(self, pipeline: "DisaggPipeline",
                 clock: Callable[[], float] = time.monotonic,
                 straggler_factor: float = 8.0,
                 prefill_chunk: Optional[int] = None,
                 chunk_budget: int = 1,
                 repage_budget: Optional[int] = None,
                 max_retries: int = 8,
                 prefill_mode: PrefillMode = PrefillMode.AUTO,
                 device: _dev.DeviceLike = None):
        """``prefill_chunk``: tokens per streamed prefill chunk. ``None``
        keeps the monolithic single-tick handoff; set it to stream long
        prefills across ticks (``chunk_budget`` chunks per flight per tick)
        so decode steps interleave with a long prompt's prefill.

        ``prefill_mode``: explicit compute mode for streamed prefills —
        AUTO picks incremental when the family supports it and the chunk
        subdivides the prompt; INCREMENTAL/MONOLITHIC force it (an
        unsupported combination raises ``PrefillModeError`` at dispatch).

        ``repage_budget``: D-side re-pages per flight per tick — a budget
        *separate* from ``chunk_budget``, so wire time (chunks in flight on
        the connector) and D-side re-page pipeline independently. ``None``
        re-pages every chunk whose read handle reports complete.

        ``straggler_factor``: stored as in the reference, which keeps it
        for a straggler re-dispatch after this many times the pool-median
        step time; neither scheduler reads it yet.

        ``max_retries``: dispatch/flight failures requeue the request up to
        this many times, then mark it FAILED (permanent failures must not
        spin the dispatch loop forever).

        ``device``: where the engines live (the card unless "cpu")."""
        self.device = _dev.resolve(device)
        self.pipeline = pipeline
        self.clock = clock
        self.straggler_factor = straggler_factor
        self.max_retries = max_retries
        # 0/negative = monolithic, same as None
        self.prefill_chunk = prefill_chunk \
            if prefill_chunk is not None and prefill_chunk > 0 else None
        self.prefill_mode = prefill_mode
        self.chunk_budget = max(chunk_budget, 1)
        self.repage_budget = repage_budget \
            if repage_budget is None else max(repage_budget, 1)
        self.p_pool: Dict[str, Engine] = {}
        self.d_pool: Dict[str, Engine] = {}
        self.pending: collections.deque[Request] = collections.deque()
        self.finished: List[Request] = []
        self.stats = SchedulerStats()
        self.prefill_loop = PrefillFlightLoop(self)
        self.decode_loop = DecodeLoop(self)
        self._draining: set = set()

    # back-compat views onto the event loops' state
    @property
    def inflight(self) -> List[_Flight]:
        return self.prefill_loop.inflight

    @property
    def _ema(self) -> Dict[str, float]:
        return self.decode_loop.ema

    # -- elastic pool management ----------------------------------------- #
    def add_instance(self, engine: Engine, role: Optional[str] = None) -> None:
        if engine.device != self.device:
            raise ValueError(f"engine {engine.name} lives on {engine.device}"
                             f", the scheduler on {self.device}")
        role = role or engine.role
        if role in ("prefill", "both"):
            self.p_pool[engine.name] = engine
        if role in ("decode", "both"):
            self.d_pool[engine.name] = engine

    def remove_instance(self, name: str) -> None:
        """Elastic scale-down: stop routing to it; it drains naturally."""
        self._draining.add(name)

    def _routable(self, pool: Dict[str, Engine]) -> List[Engine]:
        return [e for n, e in pool.items()
                if not e.failed and n not in self._draining]

    # -- routing ----------------------------------------------------------- #
    def _penalty(self, e: Engine) -> float:
        base = self._ema.get(e.name, 0.0)
        emas = [v for v in self._ema.values() if v > 0]
        med = float(np.median(emas)) if emas else 0.0
        straggler = base / med if med > 0 else 1.0
        return e.load() + max(straggler - 1.0, 0.0)

    def _pick_p(self, busy: Optional[set] = None) -> Optional[Engine]:
        cands = [e for e in self._routable(self.p_pool)
                 if not busy or e.name not in busy]
        return min(cands, key=self._penalty) if cands else None

    def _pick_d(self, req: Request, seq_len: int) -> Optional[Engine]:
        cands = [e for e in self._routable(self.d_pool)
                 if e.can_admit(seq_len, req.max_new_tokens)]

        def key(e: Engine):
            # prefix affinity first: the D already holding the longest
            # cached prefix of this prompt saves wire bytes and decode
            # pool pages — load/straggler penalty breaks ties (and wins
            # outright when no D holds anything)
            hit = 0
            if e.prefix_store is not None and e._prefix_eligible(req):
                hit = e.prefix_store.match_tokens(
                    req.prompt, min(seq_len, req.prompt_len) - 1)
            return (-hit, self._penalty(e))

        return min(cands, key=key) if cands else None

    # -- lifecycle ---------------------------------------------------------- #
    def submit(self, req: Request) -> None:
        # `is None`, not falsy: an explicit 0.0 arrival (virtual-clock or
        # epoch-relative schedule) is a legitimate timestamp to keep
        if req.arrival_time is None:
            req.arrival_time = self.clock()
        self.pending.append(req)
        self.stats.submitted += 1

    def _requeue(self, req: Request, engine: Engine) -> None:
        if requeue_for_retry(req, self.stats, self.pipeline.transfer.stats,
                             self.max_retries):
            self.pending.appendleft(req)

    def _handle_failures(self) -> None:
        # flights first: a failed P or D voids the stream — drop the D
        # reservation and requeue from scratch
        for fl in list(self.inflight):
            if fl.p.failed or fl.d.failed:
                self._abort_flight(fl)
        inflight_reqs = {id(fl.req) for fl in self.inflight}
        for e in list(self.d_pool.values()):
            if e.failed:
                for slot, req in enumerate(e.slot_req):
                    if req is not None and id(req) not in inflight_reqs:
                        e.slot_req[slot] = None      # KV is gone with the node
                        self._requeue(req, e)
                e.recover()

    def _abort_flight(self, fl: _Flight) -> None:
        fl.handoff.abort()
        self.prefill_loop.inflight.remove(fl)
        self._requeue(fl.req, fl.p)

    def _emit_first_token(self, req: Request, p_eng: Engine, d_eng: Engine,
                          first_token: int,
                          emitted: List[Tuple[Request, int]]) -> None:
        """Handoff succeeded: the prefill's token starts the stream."""
        self.stats.p_dispatches[p_eng.name] += 1
        self.stats.d_dispatches[d_eng.name] += 1
        req.state = State.DECODING
        req.output_tokens.append(first_token)
        if req.first_token_time is None:
            req.first_token_time = self.clock()
        emitted.append((req, first_token))
        req.decode_steps_at_dispatch = 0
        if req.done:
            self._finish(req, d_eng)

    def step(self) -> List[Tuple[Request, int]]:
        """One scheduler tick: pump the P-side flight loop, then the D-side
        decode loop. Returns emitted (request, token) pairs."""
        self._handle_failures()
        # advance the wire: async connectors progress in-flight reads here
        self.pipeline.transfer.tick()
        emitted: List[Tuple[Request, int]] = []
        self.prefill_loop.pump(emitted)
        self.decode_loop.pump(emitted)
        return emitted

    def _finish(self, req: Request, engine: Engine,
                slot: Optional[int] = None) -> None:
        if slot is None:
            try:
                slot = engine.slot_req.index(req)
            except ValueError:
                slot = None
        if slot is not None:
            engine.release(slot)
        req.state = State.FINISHED
        req.finish_time = self.clock()
        self.finished.append(req)
        self.stats.finished += 1

    def run(self, requests: List[Request], max_ticks: int = 10_000
            ) -> List[Request]:
        """Drive to completion (synchronous loop). Terminates when every
        request reached a terminal state (FINISHED or FAILED)."""
        for r in requests:
            self.submit(r)
        for _ in range(max_ticks):
            if self.stats.finished + self.stats.failed >= len(requests):
                break
            self.step()
        return self.finished

"""Multi-instance disaggregated serving runtime (parent/router side) —
PyTorch port of ``repro.serving.multiproc.launcher``.

``ClusterRuntime`` spawns N prefill + M decode worker processes
(``multiprocessing.get_context("spawn")``) from a :class:`ClusterSpec` —
heterogeneous ``EngineSpec``s allowed, per the paper's multi-vendor
setting — each running its own ``Engine`` event loop (:mod:`p_worker`,
:mod:`d_worker`), each in its own CUDA context (or on the CPU when its
spec says so). The parent is the control plane *and the router*:
every prompt goes to the least-loaded P (outstanding estimated prefill
tokens), every stream's D is picked among instances that can admit it by
decode queue depth and free KV-pool bytes (:mod:`repro_torch.serving.router`);
the KV data plane is ``SharedMemoryConnector`` segments staged by the
chosen P and adopted + read by the chosen D, so model bytes never
transit a queue.

    parent (router + control plane, this module)
      │ SubmitPrefill ──▶ P_i        │ Begin/ChunkReady/Finalize ──▶ D_j
      ▼                              ▼
    ┌────────────┐  shm segments  ┌────────────┐
    │ P_0 … P_N  │ ──────────────▶│ D_0 … D_M  │
    │ prefill +  │  (data plane)  │ repage +   │
    │ stage      │                │ decode     │
    └────────────┘                └────────────┘
      │ ChunkStaged/PrefillDone      │ ChunkRepaged/Token/Done/Failed
      └──────────────▶ parent ◀──────┘      (all instance-addressed)

Fault handling generalizes the single-process ``GlobalScheduler``: a P
crash aborts only *that instance's* prefill-phase flights (stranding →
unlinking the dead attempt's segments, requeueing via the shared
``requeue_for_retry``); a D crash loses only that instance's volatile
KV, so its unfinished streams re-prefill with their generated prefix
appended. When the pool has a *surviving* member of the crashed role,
the requeued flights simply re-route to it — no respawn, no global
stall; only a pool left empty respawns (up to ``max_respawns``).
Release-seq/ack bookkeeping is per-P-instance: each P has its own
monotone release counter and piggybacked ack horizon, so one instance's
crash cleanup never touches another's staged segments.

The parent also *measures* the handoff: every ``ChunkStaged`` /
``ChunkRepaged`` carries ``time.monotonic`` intervals (comparable across
processes on one host), from which it computes true wall-clock
wire/compute overlap per flight — ``TransferStats.wall_overlap_seconds``
— and per-instance dispatch counts / heartbeat load snapshots feed the
plan-vs-measured report (:mod:`report`) and the cluster-backed
autoscaler source.

The kernels are built once: when any worker runs on the card, ``start()``
builds the CUDA kernel library into ``_build.build_dir()`` before it
spawns, and every worker loads it from there (``WorkerSpec.build_dir``).
Each worker reports the hand kernels it launched at shutdown
(``worker_launches``: since its start or the last ``reset_launch_counts``)
and its peak device memory
(``worker_peak_mem_bytes``).
"""
from __future__ import annotations

import collections
import dataclasses
import multiprocessing as mp
import queue
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.transport.base import TransferStats
from repro_torch.kernels import _build
from repro_torch.serving import router
from repro_torch.serving.engine import PrefillMode
from repro_torch.serving.multiproc import d_worker, p_worker
from repro_torch.serving.multiproc.messages import (AbortStream, BeginStream,
                                                    ChunkReady, ChunkRepaged,
                                                    ChunkStaged, ClusterSpec,
                                                    EngineSpec,
                                                    FinalizeStream,
                                                    Heartbeat, Hello,
                                                    PrefillDone,
                                                    PrefillFailed,
                                                    ReleaseStaged,
                                                    RequestDone,
                                                    ResetLaunchCounts,
                                                    Shutdown,
                                                    StreamAccepted,
                                                    StreamFailed,
                                                    SubmitPrefill,
                                                    TokenEmitted, WorkerSpec,
                                                    WorkerStats)
from repro_torch.serving.request import Request, State
from repro_torch.serving.router import (AdmissionConfig, should_admit,
                                        update_ttft_ema)
from repro_torch.serving.scheduler import RuntimeStats, requeue_for_retry


def _on_card(espec: EngineSpec) -> bool:
    """Does this engine run on the card (``device`` None or cuda)?"""
    return espec.device is None or espec.device.startswith("cuda")


def _unlink_segment(name: str) -> None:
    """Best-effort unlink of a stranded segment (crashed P's staging)."""
    from multiprocessing import shared_memory
    try:
        seg = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return
    try:
        seg.close()
        seg.unlink()
    except FileNotFoundError:
        pass


def _interval_overlap(a: Tuple[float, float],
                      spans: List[Tuple[float, float]]) -> float:
    """Length of interval ``a`` covered by the (disjoint) ``spans``."""
    return sum(max(0.0, min(a[1], s1) - max(a[0], s0)) for s0, s1 in spans)


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge intervals into a sorted disjoint union."""
    merged: List[Tuple[float, float]] = []
    for s0, s1 in sorted(spans):
        if merged and s0 <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], s1))
        elif s1 > s0:
            merged.append((s0, s1))
    return merged


@dataclasses.dataclass
class _Instance:
    """Parent-side state of one worker process (a pool member)."""
    iid: str
    role: str                             # "P" | "D"
    spec: WorkerSpec
    proc: Optional[Any] = None
    cmd_q: Optional[Any] = None
    gen: int = 0                          # spawn generation (respawns bump)
    pid: Optional[int] = None
    hello: bool = False                   # worker reported ready (routable)
    last_seen: float = 0.0
    draining: bool = False                # no new work routed here
    stopping: bool = False                # Shutdown sent, awaiting exit
    load: Dict[str, float] = dataclasses.field(default_factory=dict)
    # router counters, parent-authoritative (heartbeats lag dispatch) —
    # P: outstanding dispatched prefills; D: reserved slots/blocks
    queue_reqs: int = 0
    queue_tokens: int = 0
    active: int = 0
    reserved_blocks: int = 0
    block_bytes: int = 0                  # KV bytes per paged block (est.)
    # P only: seq → segment of releases sent but not yet acked. The P
    # piggybacks the highest seq it has processed on its messages home;
    # entries at or below that ack are pruned. On a crash the remainder
    # is unlinked directly — a release queued to a dead process frees
    # nothing.
    released: Dict[int, str] = dataclasses.field(default_factory=dict)
    release_seq: int = 0
    # D only: prefix-store digest summary from the latest heartbeat —
    # the router's affinity signal (empty when the cache is off or cold)
    prefix_hashes: frozenset = frozenset()

    def alive(self) -> bool:
        return self.proc is not None and self.proc.is_alive()


@dataclasses.dataclass
class _FlightRecord:
    """Parent-side view of one dispatched request."""
    req: Request
    attempt: int
    p_id: str                             # prefill instance serving it
    d_id: str                             # decode instance serving it
    p_gen: int = 0                        # P spawn generation at dispatch
    est_tokens: int = 0                   # router's P-load contribution
    need_blocks: int = 0                  # router's D-pool contribution
    p_settled: bool = False               # P counters decremented
    d_settled: bool = False               # D counters decremented
    phase: str = "prefill"                # prefill → decode
    prefill_done: bool = False
    # prefix-cache mode: SubmitPrefill is deferred until the D posts
    # StreamAccepted (carrying the resident-prefix wire skip); True when
    # the P has been told to start (immediately so with the cache off)
    submitted: bool = True
    # key → segment of chunks staged but not yet released back to P
    outstanding: Dict[str, str] = dataclasses.field(default_factory=dict)
    # key → segment of EVERY chunk this attempt ever staged (never popped;
    # crash cleanup unlinks from here, since a release sent to a dead P is
    # lost and `outstanding` alone under-counts)
    segments: Dict[str, str] = dataclasses.field(default_factory=dict)
    # measured wall-clock intervals (monotonic), per chunk index order
    stage_spans: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)
    compute_spans: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)
    repage_spans: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    chunk_keys: List[str] = dataclasses.field(default_factory=list)


class ClusterRuntime:
    """N P-processes × M D-processes disaggregated serving loop."""

    def __init__(self, cluster: ClusterSpec, *,
                 wire=None,
                 connector_kwargs: Optional[Dict[str, Any]] = None,
                 prefill_chunk: Optional[int] = 16,
                 prefill_mode: str = "auto",
                 max_retries: int = 3,
                 stall_timeout_s: float = 120.0,
                 max_respawns: int = 4,
                 admission: Optional[AdmissionConfig] = None,
                 fault_exit_after_chunks: Optional[int] = None,
                 fault_exit_after_tokens: Optional[int] = None):
        from repro_torch.core.compat.precision import WireFormat
        self.cluster = cluster
        self._prefix = any(e.prefix_cache for e in cluster.p + cluster.d)
        self._wire = wire or WireFormat("raw", "float32")
        self._ck = dict(connector_kwargs or {})
        self._prefill_chunk = prefill_chunk
        self._prefill_mode = PrefillMode(prefill_mode).value
        self.max_retries = max_retries
        self.stall_timeout_s = stall_timeout_s
        self.max_respawns = max_respawns
        self.admission = admission
        # measured TTFT EMA (arrival → first token), the admission signal
        self.ttft_ema: Optional[float] = None
        # the kernel library's directory, shared by every worker
        self._build_dir = str(_build.build_dir())
        self.stats = RuntimeStats()
        self.transfer_stats = TransferStats()     # parent-measured + merged
        self.worker_stats: Dict[str, Dict[str, float]] = {}
        self.worker_launches: Dict[str, Dict[str, int]] = {}
        self.worker_peak_mem_bytes: Dict[str, int] = {}
        # every shared-memory segment a worker announced: what shutdown()
        # must leave unlinked
        self.segments_seen: set = set()
        self.worker_pids: Dict[str, int] = {}
        self.stream_failures: List[Tuple[str, str]] = []
        self.crashes: Dict[str, int] = {"P": 0, "D": 0}
        self.respawns: Dict[str, int] = {"P": 0, "D": 0}
        self.instance_crashes: Dict[str, int] = {}
        self._ctx = mp.get_context("spawn")
        self._evt_q = None
        self._instances: Dict[str, _Instance] = {}
        self._used_iids: set = set()
        self._pending: collections.deque = collections.deque()
        self._active: Dict[str, _FlightRecord] = {}
        self._requests: Dict[str, Request] = {}
        self._final_stats_expected = 0
        for i, espec in enumerate(cluster.p):
            # fault injection (tests) lands on the first member of a pool
            fault = fault_exit_after_chunks if i == 0 else None
            self._add_member(espec, "P", fault_exit_after_chunks=fault)
        for i, espec in enumerate(cluster.d):
            fault = fault_exit_after_tokens if i == 0 else None
            self._add_member(espec, "D", fault_exit_after_tokens=fault)

    def _add_member(self, espec: EngineSpec, role: str,
                    fault_exit_after_chunks: Optional[int] = None,
                    fault_exit_after_tokens: Optional[int] = None) -> str:
        n = 0
        while f"{role}{n}" in self._used_iids:
            n += 1
        iid = f"{role}{n}"
        self._used_iids.add(iid)
        spec = WorkerSpec(engine=espec, wire=self._wire,
                          connector_kwargs=self._ck,
                          prefill_chunk=self._prefill_chunk,
                          prefill_mode=self._prefill_mode,
                          instance_id=iid,
                          build_dir=self._build_dir,
                          fault_exit_after_chunks=fault_exit_after_chunks,
                          fault_exit_after_tokens=fault_exit_after_tokens)
        self._instances[iid] = _Instance(
            iid=iid, role=role, spec=spec,
            block_bytes=router.kv_block_bytes(espec.cfg, espec.vendor))
        return iid

    # -- process lifecycle ------------------------------------------------- #
    def start(self, spawn_timeout_s: float = 120.0) -> None:
        if any(_on_card(i.spec.engine) for i in self._instances.values()):
            # one build before any worker exists: the workers load the
            # hashed library instead of compiling it each
            _build.build()
        self._evt_q = self._ctx.Queue()
        for inst in self._instances.values():
            self._spawn(inst)
        self._await_hello(set(self._instances), spawn_timeout_s)

    def _spawn(self, inst: _Instance) -> None:
        inst.gen += 1
        inst.hello = False
        if inst.gen > 1:
            # a respawn never re-runs the injected fault: one crash only
            inst.spec = dataclasses.replace(inst.spec,
                                            fault_exit_after_chunks=None,
                                            fault_exit_after_tokens=None)
        inst.cmd_q = self._ctx.Queue()
        target = p_worker.p_main if inst.role == "P" else d_worker.d_main
        proc = self._ctx.Process(target=target,
                                 args=(inst.spec, inst.cmd_q, self._evt_q),
                                 daemon=True,
                                 name=f"repro-torch-{inst.iid.lower()}")
        proc.start()
        inst.proc = proc
        inst.last_seen = time.monotonic()

    def _await_hello(self, iids: set, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        waiting = set(iids)
        while waiting:
            if time.monotonic() > deadline:
                raise RuntimeError(f"worker(s) {sorted(waiting)} did not "
                                   f"start within {timeout_s:.0f}s")
            dead = {iid: self._instances[iid].proc.exitcode
                    for iid in waiting if not self._instances[iid].alive()}
            if dead:                      # died building its engine: fatal
                raise RuntimeError(f"worker(s) exited before reporting "
                                   f"ready (exit codes {dead})")
            msg = self._next_event(timeout=0.2)
            if msg is None:
                continue
            self._handle(msg)
            if isinstance(msg, Hello):
                waiting.discard(msg.src)

    def __enter__(self) -> "ClusterRuntime":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- elasticity (autoscaler-facing) ------------------------------------- #
    def add_instance(self, espec: EngineSpec, role: str,
                     wait: bool = True) -> str:
        """Grow the pool by one member; spawns immediately when running.
        ``wait=False`` returns as soon as the process is launched — the
        member becomes routable when its Hello lands (the live-autoscaling
        path: serving must not stall while a new worker imports and
        builds its engine)."""
        if role not in ("P", "D"):
            raise ValueError(f"role must be 'P' or 'D', got {role!r}")
        iid = self._add_member(espec, role)
        if self._evt_q is not None:
            self._spawn(self._instances[iid])
            if wait:
                self._await_hello({iid}, timeout_s=120.0)
        return iid

    def remove_instance(self, iid: str) -> None:
        """Drain a member: stop routing to it; it shuts down once every
        flight referencing it has settled."""
        inst = self._instances.get(iid)
        if inst is None:
            return
        live_same_role = [i for i in self._instances.values()
                          if i.role == inst.role and not i.draining
                          and not i.stopping]
        if len(live_same_role) <= 1:
            raise ValueError(f"cannot drain {iid}: last {inst.role} instance")
        inst.draining = True

    # -- serving ------------------------------------------------------------ #
    def queue_depth(self) -> int:
        """Measured undispatched work: the parent's pending queue plus
        every P's dispatched-but-unprefilled backlog (parent-authoritative
        counters; heartbeats lag the dispatch edge)."""
        return len(self._pending) + sum(i.queue_reqs for i in
                                        self._instances.values()
                                        if i.role == "P")

    def submit(self, req: Request) -> None:
        """Non-blocking enqueue. `is None`, not falsy: an explicit 0.0
        arrival (virtual-clock / epoch-relative schedule) is a legitimate
        timestamp that must survive submit."""
        if req.arrival_time is None:
            req.arrival_time = time.monotonic()
        self._requests[req.req_id] = req
        self._pending.append(req)
        self.stats.submitted += 1

    def reset_latency_measurements(self) -> None:
        """Forget warmup-era latency samples: clear the admission TTFT
        EMA and drop terminal requests from the measured-sample window
        (which feeds the autoscaler's ``recent_ttfts``/``recent_tpots``).
        Call between a warmup pass and a measured run — warmup TTFTs
        include first-use costs (kernel loading, allocator growth) and
        would otherwise bias both admission and scaling for the whole
        run."""
        self.ttft_ema = None
        for rid in [rid for rid, r in self._requests.items()
                    if r.state in (State.FINISHED, State.FAILED,
                                   State.SHED)]:
            del self._requests[rid]

    def reset_launch_counts(self) -> None:
        """Zero every live worker's hand-kernel launch counts, so that
        ``worker_launches`` covers only the work submitted after this call
        (a worker spawned later starts at 0). Call while the workers are
        idle, e.g. between a warmup pass and a measured run: the command
        queue orders it before any later dispatch."""
        for inst in self._instances.values():
            if inst.alive() and not inst.stopping:
                inst.cmd_q.put(ResetLaunchCounts())

    def try_submit(self, req: Request) -> bool:
        """Admission-controlled non-blocking submit: shed at the door when
        measured queue depth or TTFT-EMA headroom is exhausted
        (``AdmissionConfig``). Shedding happens only here — an admitted
        request is never dropped mid-stream. Returns False (request
        terminal in ``State.SHED``, counted in ``stats.shed``) on shed."""
        if not should_admit(self.admission, self.queue_depth(),
                            self.ttft_ema):
            req.state = State.SHED
            self.stats.shed += 1
            return False
        self.submit(req)
        return True

    def serve(self, requests: List[Request],
              max_wall_s: float = 900.0) -> Dict[str, List[int]]:
        """Drive every request to a terminal state; returns req_id → tokens.

        Closed-loop batch replay: everything is enqueued *now*, so each
        request's TTFT measures from this call (queueing included). For
        arrival-process-driven (open-loop) serving with scheduled arrival
        timestamps, drive ``submit``/``step`` from a load generator
        instead."""
        for r in requests:
            self.submit(r)
        deadline = time.monotonic() + max_wall_s
        while self._unresolved():
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"cluster serve exceeded {max_wall_s:.0f}s with "
                    f"{self._unresolved()} request(s) unresolved")
            self.step(timeout=0.05)
        return {r.req_id: list(r.output_tokens) for r in requests}

    def step(self, timeout: float = 0.05) -> None:
        """One parent-loop iteration: route, police workers, pump events."""
        self._dispatch()
        self._check_workers()
        msg = self._next_event(timeout=timeout)
        if msg is not None:
            self._handle(msg)

    def _unresolved(self) -> int:
        return sum(1 for r in self._requests.values()
                   if r.state not in (State.FINISHED, State.FAILED))

    # -- routing ------------------------------------------------------------- #
    def _routable(self, role: str) -> List[_Instance]:
        # hello gates routing: an instance spawned without waiting
        # (live autoscaling) joins the pool once its worker reports ready
        return [i for i in self._instances.values()
                if i.role == role and i.alive() and i.hello
                and not i.draining and not i.stopping]

    def _p_snapshots(self) -> List[router.PSnapshot]:
        return [router.PSnapshot(i.iid, i.queue_reqs, i.queue_tokens)
                for i in self._routable("P")]

    def _d_snapshots(self, idle: bool = False) -> List[router.DSnapshot]:
        snaps = []
        for i in self._routable("D"):
            e = i.spec.engine
            usable = max(e.num_blocks - 1, 0)     # 1 scratch block reserved
            snaps.append(router.DSnapshot(
                iid=i.iid,
                active=0 if idle else i.active,
                max_batch=e.max_batch,
                free_blocks=usable if idle else usable - i.reserved_blocks,
                block_size=e.vendor.block_size,
                max_blocks_per_seq=-(-e.max_seq_len // e.vendor.block_size),
                max_seq_len=e.max_seq_len,
                block_bytes=i.block_bytes,
                prefix_hashes=i.prefix_hashes))
        return snaps

    def _dispatch(self) -> None:
        """Route as many queued requests as the pools can admit. FIFO with
        head-of-line blocking on D admission — a requeued retry keeps its
        place at the front rather than being starved by fresh arrivals."""
        while self._pending:
            req = self._pending[0]
            if req.state == State.FAILED:
                self._pending.popleft()
                continue
            seq_len = req.prompt_len + req.num_patches
            p_snaps = self._p_snapshots()
            d_pick = router.pick_d(
                self._d_snapshots(), seq_len, req.max_new_tokens,
                prompt=req.prompt if self._prefix else None)
            if d_pick is None or not p_snaps:
                # nothing can take it *now*; if no D could admit it even
                # idle, it never fits — fail instead of wedging the queue
                if p_snaps and self._routable("D") and router.pick_d(
                        self._d_snapshots(idle=True), seq_len,
                        req.max_new_tokens) is None:
                    self._pending.popleft()
                    req.state = State.FAILED
                    self.stats.failed += 1
                    continue
                return
            self._pending.popleft()
            d_id, need = d_pick
            p_id = router.pick_p(p_snaps)
            p, d = self._instances[p_id], self._instances[d_id]
            req.state = State.PREFILLING
            rec = _FlightRecord(req=req, attempt=req.retries,
                                p_id=p_id, d_id=d_id, p_gen=p.gen,
                                est_tokens=seq_len, need_blocks=need)
            self._active[req.req_id] = rec
            p.queue_reqs += 1
            p.queue_tokens += seq_len
            d.active += 1
            d.reserved_blocks += need
            # FIFO per queue: BeginStream always precedes its ChunkReady
            d.cmd_q.put(BeginStream(req, req.retries, seq_len))
            if self._prefix:
                # hold the prefill until the D reports its resident prefix
                # (StreamAccepted → SubmitPrefill with the wire skip)
                rec.submitted = False
            else:
                p.cmd_q.put(SubmitPrefill(req))

    def _settle_p(self, rec: _FlightRecord) -> None:
        """Drop this flight's contribution to its P's router load (once)."""
        if rec.p_settled:
            return
        rec.p_settled = True
        inst = self._instances.get(rec.p_id)
        if inst is not None:
            inst.queue_reqs = max(inst.queue_reqs - 1, 0)
            inst.queue_tokens = max(inst.queue_tokens - rec.est_tokens, 0)

    def _settle_d(self, rec: _FlightRecord) -> None:
        """Return this flight's slot + paged blocks to its D's router view
        (once)."""
        if rec.d_settled:
            return
        rec.d_settled = True
        inst = self._instances.get(rec.d_id)
        if inst is not None:
            inst.active = max(inst.active - 1, 0)
            inst.reserved_blocks = max(inst.reserved_blocks -
                                       rec.need_blocks, 0)

    # -- event pump ---------------------------------------------------------- #
    def _next_event(self, timeout: float):
        try:
            return self._evt_q.get(timeout=timeout)
        except queue.Empty:
            return None

    def _handle(self, msg: Any) -> None:
        inst = self._instances.get(getattr(msg, "src", ""))
        if inst is not None:
            inst.last_seen = time.monotonic()
        if isinstance(msg, Hello):
            if inst is not None:
                inst.pid = msg.pid
                inst.hello = True
            self.worker_pids[msg.src] = msg.pid
            return
        if isinstance(msg, Heartbeat):
            if inst is not None:
                if inst.role == "P":
                    self._prune_released(inst, msg.ack_seq)
                if msg.load:
                    inst.load = dict(msg.load)
                if msg.prefix_hashes is not None:
                    inst.prefix_hashes = frozenset(msg.prefix_hashes)
            return
        if isinstance(msg, WorkerStats):
            self.transfer_stats.merge(msg.transfer)
            self.worker_stats[msg.src] = msg.engine
            self.worker_launches[msg.src] = dict(msg.launches)
            self.worker_peak_mem_bytes[msg.src] = msg.peak_mem_bytes
            self._final_stats_expected -= 1
            return
        if isinstance(msg, (ChunkStaged, PrefillDone, PrefillFailed)):
            self._handle_p(msg, inst)
            return
        self._handle_d(msg, inst)

    def _rec_for(self, req_id: str, attempt: int) -> Optional[_FlightRecord]:
        rec = self._active.get(req_id)
        if rec is None or rec.attempt != attempt:
            return None
        return rec

    def _prune_released(self, inst: _Instance, ack_seq: int) -> None:
        """Drop the crash-cleanup record of releases this P confirmed."""
        if ack_seq and inst.released:
            inst.released = {s: seg for s, seg in inst.released.items()
                             if s > ack_seq}

    def _release_on(self, inst: Optional[_Instance], key: str,
                    segment: Optional[str] = None) -> None:
        """Tell a P instance it may free a staged key — or, if that
        instance is gone, unlink the OS segment directly (when known)."""
        if inst is not None and inst.alive():
            inst.release_seq += 1
            if segment is not None:
                inst.released[inst.release_seq] = segment
            inst.cmd_q.put(ReleaseStaged(key, inst.release_seq))
        elif segment is not None:
            _unlink_segment(segment)

    def _forward_to_d(self, rec: _FlightRecord, msg: Any) -> None:
        d = self._instances.get(rec.d_id)
        if d is not None and d.alive():
            d.cmd_q.put(msg)
        # a dead D is handled by _on_crash (flight aborted there); dropping
        # the forward here just avoids writing into a dead queue

    def _handle_p(self, msg: Any, inst: Optional[_Instance]) -> None:
        if isinstance(msg, (ChunkStaged, PrefillDone)) and inst is not None:
            self._prune_released(inst, msg.ack_seq)
        if isinstance(msg, ChunkStaged):
            self.segments_seen.add(msg.segment)
            rec = self._rec_for(msg.req_id, msg.attempt)
            if rec is None:                       # stale attempt: free it
                self._release_on(inst, msg.key, msg.segment)
                return
            rec.outstanding[msg.key] = msg.segment
            rec.segments[msg.key] = msg.segment
            rec.chunk_keys.append(msg.key)
            rec.stage_spans.append(msg.t_stage)
            rec.compute_spans.append(msg.t_compute)
            rec.req.chunks_streamed += 1
            self.stats.chunks_streamed += 1
            self._forward_to_d(rec, ChunkReady(msg.req_id, msg.attempt,
                                               msg.key, msg.segment,
                                               msg.nbytes))
            return
        if isinstance(msg, PrefillDone):
            if msg.tail is not None:
                self.segments_seen.add(msg.tail["segment"])
            rec = self._rec_for(msg.req_id, msg.attempt)
            if rec is None:
                if msg.tail is not None:
                    self._release_on(inst, msg.tail["key"],
                                     msg.tail["segment"])
                return
            rec.prefill_done = True
            self._settle_p(rec)                   # P's queue work is done
            if msg.tail is not None:
                rec.outstanding[msg.tail["key"]] = msg.tail["segment"]
                rec.segments[msg.tail["key"]] = msg.tail["segment"]
            self._forward_to_d(rec, FinalizeStream(msg.req_id, msg.attempt,
                                                   msg.first_token,
                                                   msg.seq_len, msg.tail))
            return
        if isinstance(msg, PrefillFailed):
            rec = self._rec_for(msg.req_id, msg.attempt)
            if rec is None:
                return
            self._abort_flight(rec, f"P-side dispatch failure: {msg.error}")

    def _handle_d(self, msg: Any, inst: Optional[_Instance]) -> None:
        if isinstance(msg, StreamAccepted):
            rec = self._rec_for(msg.req_id, msg.attempt)
            if rec is None or rec.submitted:
                return                            # stale, or cache-off mode
            rec.submitted = True
            p = self._instances.get(rec.p_id)
            if p is not None and p.alive() and p.gen == rec.p_gen:
                p.cmd_q.put(SubmitPrefill(rec.req, msg.wire_skip_tokens))
            else:                                 # P died while we waited
                self._abort_flight(
                    rec, f"P instance {rec.p_id} died before prefill start")
            return
        if isinstance(msg, ChunkRepaged):
            rec = self._rec_for(msg.req_id, msg.attempt)
            if rec is None:
                # stale attempt: its abort already released/unlinked every
                # segment it ever staged (complete() is idempotent)
                return
            rec.outstanding.pop(msg.key, None)
            rec.repage_spans[msg.key] = msg.t_repage
            creator = self._instances.get(rec.p_id)
            if creator is not None and creator.gen == rec.p_gen:
                self._release_on(creator, msg.key, rec.segments.get(msg.key))
            else:           # creator died: a release would go to the wrong
                segment = rec.segments.get(msg.key)   # process — unlink
                if segment is not None:
                    _unlink_segment(segment)
            return
        if isinstance(msg, TokenEmitted):
            req = self._requests.get(msg.req_id)
            rec = self._rec_for(msg.req_id, msg.attempt)
            if req is None or rec is None:        # stale attempt's token
                return
            req.output_tokens.append(msg.token)
            req.last_token_time = time.monotonic()
            if msg.first:
                rec.phase = "decode"
                req.state = State.DECODING
                if req.first_token_time is None:
                    req.first_token_time = req.last_token_time
                    ttft = req.ttft()
                    if ttft is not None and self.admission is not None:
                        self.ttft_ema = update_ttft_ema(
                            self.ttft_ema, ttft, self.admission.ema_alpha)
                self.stats.p_dispatches[rec.p_id] += 1
                self.stats.d_dispatches[rec.d_id] += 1
                self._account_flight(rec)
            return
        if isinstance(msg, RequestDone):
            req = self._requests.get(msg.req_id)
            rec = self._rec_for(msg.req_id, msg.attempt)
            if req is None or rec is None:        # stale attempt finishing
                return
            self._active.pop(msg.req_id, None)
            self._settle_p(rec)
            self._settle_d(rec)
            req.state = State.FINISHED
            req.finish_time = time.monotonic()
            self.stats.finished += 1
            return
        if isinstance(msg, StreamFailed):
            self.stream_failures.append((msg.req_id, msg.error))
            rec = self._rec_for(msg.req_id, msg.attempt)
            if rec is None:
                return
            self._abort_flight(rec, msg.error, abort_d=False)

    # -- measured overlap ---------------------------------------------------- #
    def _account_flight(self, rec: _FlightRecord) -> None:
        """Wall-clock handoff accounting for one completed stream: the wire
        interval of chunk *i* is [stage-end_i, repage-start_i]; whatever
        part of it lies under this flight's prefill-compute spans was
        *measured* overlap — true cross-process concurrency, not a model."""
        repaged = [rec.repage_spans.get(k) for k in rec.chunk_keys]
        pairs = [(st, rp) for st, rp in zip(rec.stage_spans, repaged)
                 if rp is not None]
        if not pairs:
            return
        t0 = min(st[0] for st, _ in pairs)
        t1 = max(rp[1] for _, rp in pairs)
        self.transfer_stats.wall_handoff_seconds += t1 - t0
        # chunks can be concurrently in flight, so intersect the *unions*
        # (wire-busy time ∩ compute-busy time) — bounded by the handoff span
        wire = _union([(st[1], max(rp[0], st[1])) for st, rp in pairs])
        compute = _union(rec.compute_spans)
        self.transfer_stats.wall_overlap_seconds += \
            sum(_interval_overlap(w, compute) for w in wire)

    # -- failure handling ----------------------------------------------------- #
    def _abort_flight(self, rec: _FlightRecord, reason: str,
                      abort_d: bool = True) -> None:
        self._active.pop(rec.req.req_id, None)
        self._settle_p(rec)
        self._settle_d(rec)
        if abort_d:
            self._forward_to_d(rec, AbortStream(rec.req.req_id, rec.attempt,
                                                reason))
        p = self._instances.get(rec.p_id)
        if p is not None and p.alive() and p.gen == rec.p_gen:
            for key, segment in rec.outstanding.items():
                self._release_on(p, key, segment)
        else:
            # the staging process is gone (or already replaced): releases
            # would go nowhere — unlink every segment this attempt ever
            # staged (idempotent for the ones P freed before dying)
            for segment in rec.segments.values():
                _unlink_segment(segment)
        rec.outstanding.clear()
        self._requeue(rec.req)

    def _requeue(self, req: Request) -> None:
        if requeue_for_retry(req, self.stats, self.transfer_stats,
                             self.max_retries):
            self._pending.appendleft(req)

    def _check_workers(self) -> None:
        now = time.monotonic()
        for inst in list(self._instances.values()):
            if inst.proc is None:
                continue
            if inst.draining and not inst.stopping and inst.alive() \
                    and not self._references(inst):
                inst.cmd_q.put(Shutdown())
                inst.stopping = True
                continue
            if not inst.alive():
                if inst.stopping:                 # drained: a clean exit
                    inst.proc.join(timeout=5.0)
                    self._instances.pop(inst.iid, None)
                    continue
                self._on_crash(inst, f"exited with code {inst.proc.exitcode}")
                continue
            if now - inst.last_seen > self.stall_timeout_s:
                inst.proc.terminate()             # hung, not dead: make it dead
                inst.proc.join(timeout=5.0)
                self._on_crash(inst, "stalled past watchdog timeout")

    def _references(self, inst: _Instance) -> bool:
        """Does any live flight (or unconfirmed release) still need this
        instance? Gates draining shutdown."""
        if inst.role == "P":
            return bool(inst.released) or any(
                r.p_id == inst.iid for r in self._active.values())
        return any(r.d_id == inst.iid for r in self._active.values())

    def _drain_backlog(self) -> None:
        while True:
            msg = self._next_event(timeout=0.1)
            if msg is None:
                break
            self._handle(msg)

    def _on_crash(self, inst: _Instance, why: str) -> None:
        self.crashes[inst.role] += 1
        self.instance_crashes[inst.iid] = \
            self.instance_crashes.get(inst.iid, 0) + 1
        inst.proc.join(timeout=5.0)
        if inst.role == "P":
            # prefill-phase flights whose stream never fully left this P
            # are void: abort the D reservation, unlink the dead attempt's
            # stranded segments, requeue. Flights past PrefillDone are
            # wholly on D's side — let them finish (a lost segment there
            # surfaces as StreamFailed → requeue) rather than requeue a
            # stream D may already be decoding, which would double-serve.
            # Abort BEFORE draining the dying worker's flushed backlog, so
            # its ChunkStaged events hit the stale path (unlinking their
            # stranded segments) instead of being recorded as live chunks.
            for rec in [r for r in self._active.values()
                        if r.p_id == inst.iid and r.phase == "prefill"
                        and not r.prefill_done]:
                self._abort_flight(
                    rec, f"P instance {inst.iid} died mid-stream ({why})")
            # releases queued to the dead P were never processed: unlink
            # those segments directly (no-op for any it freed in time)
            for segment in inst.released.values():
                _unlink_segment(segment)
            inst.released.clear()
            inst.queue_reqs = inst.queue_tokens = 0
            self._drain_backlog()
        else:
            # drain the dying D's flushed backlog FIRST: tokens and
            # completions it emitted before exiting are real — a stream
            # whose RequestDone is sitting in the backlog must finish,
            # not be requeued (which would decode past max_new_tokens)
            self._drain_backlog()
            # this instance's volatile KV died with it: every non-terminal
            # request it was serving restarts from prefill with its
            # generated prefix appended — other D's streams are untouched
            for rec in [r for r in self._active.values()
                        if r.d_id == inst.iid]:
                self._abort_flight(rec, f"D instance {inst.iid} died ({why})",
                                   abort_d=False)
            inst.active = inst.reserved_blocks = 0
        survivors = [i for i in self._instances.values()
                     if i.role == inst.role and i.iid != inst.iid
                     and i.alive() and not i.draining and not i.stopping]
        if survivors:
            # the pool still has live members: the aborted flights simply
            # re-route there on the next dispatch — no respawn, no stall
            self._instances.pop(inst.iid, None)
            return
        if self._unresolved() == 0:
            self._instances.pop(inst.iid, None)
            return
        if self.crashes[inst.role] > self.max_respawns:
            self._instances.pop(inst.iid, None)
            for r in self._requests.values():
                if r.state not in (State.FINISHED, State.FAILED):
                    r.state = State.FAILED
                    self.stats.failed += 1
            return
        # pool emptied: only now does serving block on a respawn
        self.respawns[inst.role] += 1
        self._spawn(inst)
        self._await_hello({inst.iid}, timeout_s=120.0)

    # -- shutdown -------------------------------------------------------------- #
    def shutdown(self, timeout_s: float = 15.0) -> None:
        """Stop every worker, escalating join → terminate → kill on a
        bounded timeout, then unlink any segment the parent ever learned
        about — a hung worker can leave neither zombies nor stranded
        /dev/shm segments behind this call."""
        if self._evt_q is None:
            return                                # never started / already down
        self._final_stats_expected = 0
        for inst in self._instances.values():
            if inst.alive():
                inst.cmd_q.put(Shutdown())
                self._final_stats_expected += 1
        deadline = time.monotonic() + timeout_s
        while self._final_stats_expected > 0 and time.monotonic() < deadline:
            msg = self._next_event(timeout=0.2)
            if msg is not None:
                self._handle(msg)
        for inst in self._instances.values():
            proc = inst.proc
            if proc is None:
                continue
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5.0)
            if proc.is_alive():
                proc.kill()                       # SIGKILL: cannot be ignored
                proc.join(timeout=5.0)
        # workers that exited cleanly unlinked their own staging
        # (connector.close()); for any that had to be terminated/killed,
        # unlink everything the parent knows about (idempotent elsewhere)
        for inst in self._instances.values():
            for segment in inst.released.values():
                _unlink_segment(segment)
            inst.released.clear()
        for rec in self._active.values():
            for segment in rec.segments.values():
                _unlink_segment(segment)
        # drain stragglers (late WorkerStats still merge), then close the
        # queues so no feeder thread outlives the runtime
        while True:
            msg = self._next_event(timeout=0.05)
            if msg is None:
                break
            if isinstance(msg, WorkerStats):
                self._handle(msg)
        for inst in self._instances.values():
            if inst.cmd_q is not None:
                inst.cmd_q.close()
                inst.cmd_q.cancel_join_thread()
                inst.cmd_q = None
            inst.proc = None
        self._evt_q.close()
        self._evt_q.cancel_join_thread()
        self._evt_q = None


class TwoProcessRuntime(ClusterRuntime):
    """1 P-process + 1 D-process: the degenerate cluster, kept as the
    compatibility entry point (instance ids ``P0`` / ``D0``)."""

    def __init__(self, p_spec: EngineSpec, d_spec: EngineSpec, **kw):
        super().__init__(ClusterSpec(p=(p_spec,), d=(d_spec,)), **kw)


def serve_cluster(cluster: ClusterSpec, requests: List[Request], **kw
                  ) -> Tuple[Dict[str, List[int]], ClusterRuntime]:
    """One-shot convenience: start → serve → shutdown. Returns the token
    streams and the (shut-down) runtime for stats inspection."""
    max_wall_s = kw.pop("max_wall_s", 900.0)
    rt = ClusterRuntime(cluster, **kw)
    try:
        rt.start()
        tokens = rt.serve(requests, max_wall_s=max_wall_s)
    finally:
        rt.shutdown()
    return tokens, rt


def serve_two_process(p_spec: EngineSpec, d_spec: EngineSpec,
                      requests: List[Request], **kw
                      ) -> Tuple[Dict[str, List[int]], TwoProcessRuntime]:
    """One-shot convenience for the 1P+1D degenerate cluster."""
    max_wall_s = kw.pop("max_wall_s", 900.0)
    rt = TwoProcessRuntime(p_spec, d_spec, **kw)
    try:
        rt.start()
        tokens = rt.serve(requests, max_wall_s=max_wall_s)
    finally:
        rt.shutdown()
    return tokens, rt

"""Control-plane protocol of the multi-process P/D serving runtime —
PyTorch port of ``repro.serving.multiproc.messages``.

Everything here crosses an OS process boundary through
``multiprocessing`` queues, so it is all plain picklable data:

  * :class:`EngineSpec` — how a worker process rebuilds its model
    instance (config + vendor profile + a parameter seed or a saved
    parameter file, and the device it runs on; parameters are made in the
    worker instead of being shipped over the wire).
  * :class:`ClusterSpec` — an executable N×M topology: the planner's
    instance allocation (``DeploymentPlan.to_cluster_spec``) in
    launchable form.
  * :class:`WorkerSpec` — one worker's full recipe: engine, wire format,
    KV-connector kwargs, chunking, heartbeat cadence, fault injection.
  * message dataclasses — the control plane proper. The *data* plane
    (KV bytes) never rides these queues: chunks move through
    ``SharedMemoryConnector`` segments, and the control plane only carries
    the segment descriptors (:func:`SharedMemoryConnector.export_descriptor`).
Nothing that crosses a queue holds a tensor: prompts are numpy, stats are
plain dataclasses and dicts.

Wire protocol (parent = launcher/router, P = a prefill worker, D = a
decode worker — N of the former, M of the latter):

  parent→P   SubmitPrefill · ReleaseStaged · Shutdown
  P→parent   Hello · ChunkStaged · PrefillDone · PrefillFailed ·
             Heartbeat · WorkerStats
  parent→D   BeginStream · ChunkReady · FinalizeStream · AbortStream ·
             Shutdown
  D→parent   Hello · StreamAccepted · ChunkRepaged · TokenEmitted ·
             RequestDone · StreamFailed · Heartbeat · WorkerStats

Every worker→parent message is *instance-addressed*: ``src`` carries the
instance id (``"P0"``, ``"D1"``, …) so the parent's router can attribute
it to the right member of the pool — and every per-request message
carries ``attempt`` (the request's retry counter at dispatch) so a
crashed attempt's stale messages can never be attributed to its requeued
successor. Heartbeats additionally carry a ``load`` snapshot (P: backlog
depth / estimated queued prefill tokens; D: occupied slots / free paged
blocks / free KV-pool bytes) — the measured feed for the router and the
autoscaler.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compat.precision import WireFormat
from repro_torch.serving.engine import VendorProfile
from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Recipe for building one Engine inside a worker process."""
    name: str
    cfg: ModelConfig
    vendor: VendorProfile
    params_seed: int = 0
    num_blocks: int = 256
    max_batch: int = 8
    max_seq_len: int = 512
    role: str = "both"
    prefix_cache: bool = False
    # where the engine runs: None is the card (cuda), "cpu" the plain path
    device: Optional[str] = None
    # a torch.save'd parameter tree to load instead of drawing params from
    # params_seed (the CPU parity tests write the JAX package's params)
    params_path: Optional[str] = None

    def build(self):
        """Materialize the engine (worker-side only: builds the weights)."""
        import torch

        from repro_torch import device as _dev
        from repro_torch.models import model as M
        from repro_torch.serving.engine import Engine
        dev = _dev.resolve(self.device)
        if self.params_path is not None:
            params = torch.load(self.params_path, map_location=dev)
        else:
            params = M.init_params(self.cfg, seed=self.params_seed,
                                   device=dev)
        return Engine(self.name, self.cfg, params, self.vendor,
                      num_blocks=self.num_blocks, max_batch=self.max_batch,
                      max_seq_len=self.max_seq_len, role=self.role,
                      prefix_cache=self.prefix_cache, device=dev)


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """An executable N×M deployment: N prefill + M decode EngineSpecs
    (heterogeneous vendors allowed — the paper's multi-vendor setting).
    This is what ``DeploymentPlan.to_cluster_spec()`` emits and what
    ``ClusterRuntime`` launches."""
    p: Tuple[EngineSpec, ...]
    d: Tuple[EngineSpec, ...]

    def __post_init__(self):
        object.__setattr__(self, "p", tuple(self.p))
        object.__setattr__(self, "d", tuple(self.d))
        if not self.p or not self.d:
            raise ValueError("ClusterSpec needs at least one prefill and "
                             "one decode instance")
        names = [e.name for e in self.p + self.d]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate instance names in cluster: {names}")

    def ratio(self) -> str:
        return f"{len(self.p)}P{len(self.d)}D"


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """Everything one worker process needs, shipped through spawn()."""
    engine: EngineSpec
    wire: WireFormat
    connector_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    prefill_chunk: Optional[int] = 16
    # prefill mode name ("auto" | "incremental" | "monolithic") resolved to
    # repro_torch.serving.engine.PrefillMode inside the worker process — shipped
    # as a string so the spec stays picklable without an engine import
    prefill_mode: str = "auto"
    heartbeat_s: float = 0.5
    # the CUDA kernel library's directory, exported to the worker as
    # REPRO_TORCH_BUILD_DIR; the launcher builds the library there once
    # before it spawns (None: the default build directory)
    build_dir: Optional[str] = None
    # instance id on the control plane (defaults to the engine name; the
    # launcher keeps them unique across the pool)
    instance_id: str = ""
    # fault injection (tests): P exits hard (os._exit) after staging this
    # many chunks — the "process dies without drop()" conformance path
    fault_exit_after_chunks: Optional[int] = None
    # fault injection (tests): D exits hard after emitting this many
    # tokens — the "decode node dies mid-stream, volatile KV lost" path
    fault_exit_after_tokens: Optional[int] = None

    @property
    def iid(self) -> str:
        return self.instance_id or self.engine.name


# --------------------------------------------------------------------- #
# parent → P
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SubmitPrefill:
    req: Request
    # tokens already resident on the stream's D (prefix cache): the P
    # worker computes/replays them but never stages them on the wire
    wire_skip_tokens: int = 0


@dataclasses.dataclass(frozen=True)
class ReleaseStaged:
    """D consumed a chunk: the staging segment's creator may free it.
    ``seq`` is the parent's monotone per-instance release counter; the P
    instance piggybacks the highest seq it has *processed* on its next
    message home (``ack_seq``), letting the parent prune its
    crash-cleanup record of unconfirmed releases without any
    clear-on-heartbeat race."""
    key: str
    seq: int = 0


@dataclasses.dataclass(frozen=True)
class Shutdown:
    pass


# --------------------------------------------------------------------- #
# parent → D
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class BeginStream:
    """Reserve a decode slot + paged blocks for an incoming handoff."""
    req: Request
    attempt: int
    seq_len: int


@dataclasses.dataclass(frozen=True)
class ChunkReady:
    """A staged chunk's shared-memory descriptor: adopt + issue_read."""
    req_id: str
    attempt: int
    key: str
    segment: str
    nbytes: int


@dataclasses.dataclass(frozen=True)
class FinalizeStream:
    """All chunks staged: once every pending read re-paged, ship the tail
    (states/cross, if any), activate the slot, emit the first token."""
    req_id: str
    attempt: int
    first_token: int
    seq_len: int
    tail: Optional[Dict[str, Any]]       # export_descriptor of the tail key


@dataclasses.dataclass(frozen=True)
class AbortStream:
    """P-side failure: drop pending reads and free the reservation."""
    req_id: str
    attempt: int
    reason: str = ""


# --------------------------------------------------------------------- #
# workers → parent (all instance-addressed via ``src``)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Hello:
    src: str                              # instance id ("P0", "D1", …)
    pid: int
    engine_name: str
    role: str = ""                        # "P" | "D"


@dataclasses.dataclass(frozen=True)
class Heartbeat:
    """Liveness + measured load. ``load`` is the worker's own view:

      P: ``backlog`` (queued prefills), ``backlog_tokens`` (estimated
         prompt tokens waiting)
      D: ``active`` (occupied slots), ``free_slots``, ``free_blocks``,
         ``free_bytes`` (free KV-pool bytes), ``pending_repage``
    """
    src: str
    ack_seq: int = 0                      # P only: highest release processed
    load: Optional[Dict[str, float]] = None
    # D only: the prefix store's digest summary (chained block hashes) —
    # the parent router scores prefix affinity against it. None when the
    # cache is disabled; a tuple (possibly empty) when enabled.
    prefix_hashes: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class ChunkStaged:
    """P staged one chunk. Carries the shared-memory descriptor (for the
    parent to forward to the stream's D) plus wall-clock stage/compute
    intervals (time.monotonic — comparable across processes on one host)
    for the launcher's measured-overlap accounting."""
    req_id: str
    attempt: int
    index: int
    key: str
    segment: str
    nbytes: int
    t_stage: Tuple[float, float]
    t_compute: Tuple[float, float]
    ack_seq: int = 0                      # highest ReleaseStaged processed
    src: str = ""


@dataclasses.dataclass(frozen=True)
class PrefillDone:
    req_id: str
    attempt: int
    first_token: int
    seq_len: int
    chunks: int
    tail: Optional[Dict[str, Any]]
    ack_seq: int = 0                      # highest ReleaseStaged processed
    src: str = ""


@dataclasses.dataclass(frozen=True)
class PrefillFailed:
    req_id: str
    attempt: int
    error: str
    src: str = ""


@dataclasses.dataclass(frozen=True)
class StreamAccepted:
    """D reserved the stream and reports how many leading prompt tokens
    its prefix store already holds. In prefix-cache mode the parent
    defers ``SubmitPrefill`` until this arrives so the P worker knows
    exactly which chunks to keep off the wire."""
    req_id: str
    attempt: int
    wire_skip_tokens: int = 0
    src: str = ""


@dataclasses.dataclass(frozen=True)
class ChunkRepaged:
    """D re-paged one chunk (or the tail) into its pools."""
    req_id: str
    attempt: int
    key: str
    t_repage: Tuple[float, float]
    src: str = ""


@dataclasses.dataclass(frozen=True)
class TokenEmitted:
    req_id: str
    token: int
    attempt: int
    first: bool = False
    src: str = ""


@dataclasses.dataclass(frozen=True)
class RequestDone:
    req_id: str
    attempt: int
    src: str = ""


@dataclasses.dataclass(frozen=True)
class StreamFailed:
    """D surfaced a transfer failure (lost segment, adopt failure, abort
    of an in-flight stream) — the scheduler side must requeue."""
    req_id: str
    attempt: int
    error: str
    src: str = ""


@dataclasses.dataclass(frozen=True)
class WorkerStats:
    """Final accounting a worker ships home at shutdown."""
    src: str
    transfer: Any                         # core.transport.TransferStats
    engine: Dict[str, float]              # EngineStats.as_dict()
    # the worker's kernels.ops.launch_counts() at shutdown: which hand
    # kernels its path launched, and how often (0 everywhere on the CPU)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


def setup_worker(spec: WorkerSpec) -> None:
    """Before the engine is built: point the kernel loader at the
    launcher's build directory and make the spec's card current."""
    if spec.build_dir:
        os.environ["REPRO_TORCH_BUILD_DIR"] = spec.build_dir
    if spec.engine.device != "cpu":
        import torch

        from repro_torch import device as _dev
        torch.cuda.set_device(_dev.resolve(spec.engine.device))


def worker_stats(iid: str, connector, engine) -> WorkerStats:
    """The final accounting a worker ships home: plain data only."""
    from repro_torch.kernels import ops
    return WorkerStats(iid, connector.stats, engine.stats.as_dict(),
                       launches=ops.launch_counts())

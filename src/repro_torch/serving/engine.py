"""Model-instance engine: prefill, continuous-batching paged decode —
PyTorch port of ``repro.serving.engine`` for the dense family.

One Engine == one "model instance" in the paper's sense (a P instance, a D
instance, or an integrated instance). Vendor-specific VRAM management is
the engine's ``KVPageSpec`` (block size / layout / dtype); the logical TP
degree used for KV sharding completes the vendor profile.

The engine lives on one device: the card unless ``device="cpu"`` is
passed. Its paged pools are updated in place by decode appends, by the
D-side re-page and by the prefix cache's copy-on-write page copy (the
repack kernel). With ``prefix_cache=True`` a decode engine indexes its
pool pages in a ``PrefixStore`` and a prefill engine keeps finished
prompts' KV in a ``HostPrefixStore`` of CPU tensors. Not ported yet:
snapshot/resume (refused when asked for), and encoder or vision prompts
(ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
import enum
import logging
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _dev
from repro_torch.configs.base import ModelConfig, PrefillCapabilities
from repro_torch.kernels import ops as kops
from repro_torch.models import model as M
from repro_torch.serving.paged_cache import BlockAllocator, KVPageSpec
from repro_torch.serving.prefix_cache import (HostPrefixStore, PrefixStore,
                                              hashing)
from repro_torch.serving.request import Request

log = logging.getLogger(__name__)


class PrefillMode(enum.Enum):
    """Explicit prefill compute mode.

      INCREMENTAL  chunk-at-a-time compute; requires positive chunk_tokens
      MONOLITHIC   whole-prompt compute in one pass (the wire may still
                   stream in chunk_tokens slices)
      AUTO         incremental when the family supports it and
                   chunk_tokens subdivides the prompt, else monolithic
    """
    INCREMENTAL = "incremental"
    MONOLITHIC = "monolithic"
    AUTO = "auto"


class PrefillModeError(ValueError):
    """A requested prefill mode is unsupported for this engine/request."""


# families already warned about prefix replay they cannot do (log once
# per family, count every occurrence in EngineStats)
_RESUME_WARNED: set = set()


def page_specs_for(cfg: ModelConfig, block_size: int, layout: str,
                   dtype: str) -> Dict[str, KVPageSpec]:
    _dev.check_family(cfg)
    return {"kv": KVPageSpec(block_size, layout, dtype,
                             max(cfg.num_kv_heads, 1), cfg.hd)}


@dataclasses.dataclass(frozen=True)
class VendorProfile:
    """The 'vendor' of an instance — everything the heterogeneous compat
    module must align across instances."""
    name: str
    block_size: int = 16
    layout: str = "nbhd"
    kv_dtype: str = "float32"
    tp: int = 1                 # logical TP degree of stored KV shards
    hardware: str = "h100-sxm"  # planner HardwareSpec key


@dataclasses.dataclass
class EngineStats:
    prefill_tokens: int = 0
    prefill_chunks: int = 0         # compute chunks (1 per monolithic prefill)
    decode_steps: int = 0
    decode_tokens: int = 0
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    failures_injected: int = 0
    prefix_cached_tokens: int = 0   # prompt tokens replayed from the P-side
    #                                 host prefix store instead of recomputed
    # prefill compute seconds spent on an integrated (role="both") engine
    # while decode-ready sequences sat waiting
    contention_stall_seconds: float = 0.0
    # requests that wanted prefix-cache replay but the stream or family
    # cannot do it (a full recompute), or a refused mid-stream resume
    resume_unsupported: int = 0

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def kv_entries_with_start(package_kv: List[Tuple]) -> List[Tuple]:
    """A prefill package's KV entries with an absolute ``start``: the
    canonical pre-wire form. Dense caches hold positions in order from 0,
    so every entry starts at 0. Returns [(kind, gi, pi, entry)] with
    entry tensors (count, S', kv, hd)."""
    return [(kind, gi, pi, {"k": ent["k"], "v": ent["v"], "start": 0})
            for kind, gi, pi, ent in package_kv]


def slice_kv_entries(entries: List[Tuple], w0: int, w1: int) -> List[Tuple]:
    """Restrict normalized entries to the absolute token window [w0, w1)."""
    out = []
    for kind, gi, pi, ent in entries:
        start = ent["start"]
        arrs = {n: a for n, a in ent.items() if n != "start"}
        length = next(iter(arrs.values())).shape[1]
        lo = max(w0, start)
        hi = min(w1, start + length)
        if hi <= lo:
            continue
        sl = {n: a[:, lo - start:hi - start] for n, a in arrs.items()}
        sl["start"] = lo
        out.append((kind, gi, pi, sl))
    return out


class PrefillStream:
    """Chunked prefill on one P engine (paper §III-B overlap).

    ``next_chunk()`` yields KV chunk packages ``{"kv": entries, "start",
    "length", "compute_seconds"}`` until exhausted (then returns ``None``):

      * *incremental* — the prompt runs through the decode path over a
        dense full-capacity cache (slot == position), one chunk of tokens
        per call, so each chunk's KV can hit the wire while the next chunk
        computes. On the card each chunk's attention is one flash-kernel
        launch per layer at ``q_offset`` = the chunk's start.
      * *monolithic* — whole-prompt compute in one pass on the first call;
        the wire still streams in ``chunk_tokens`` slices.

    ``first_token`` is known once the final chunk has been produced.

    With a host prefix store on the engine, an incremental stream replays
    the longest cached prefix of its prompt as chunks with no compute,
    seeds its dense cache with those rows, and computes from the
    divergence point; when it ends, its full prompt blocks go into the
    store."""

    def __init__(self, engine: "Engine", req: Request,
                 chunk_tokens: Optional[int] = None, *,
                 chunked_compute: Optional[bool] = None,
                 mode: Optional[PrefillMode] = None,
                 resume: Optional[Dict[str, Any]] = None):
        self.engine = engine
        self.req = req
        self.caps: PrefillCapabilities = engine.prefill_capabilities()
        self.seq_len = req.prompt_len
        if chunk_tokens is not None and chunk_tokens <= 0:
            warnings.warn(
                "chunk_tokens <= 0 as a monolithic sentinel is deprecated; "
                "pass mode=PrefillMode.MONOLITHIC", DeprecationWarning,
                stacklevel=3)
            chunk_tokens = None
        self.chunk_tokens = chunk_tokens
        if mode is None:
            # the reference's bool keyword: True/False force the mode,
            # None keeps the automatic choice
            if chunked_compute is None:
                mode = PrefillMode.AUTO
            else:
                mode = PrefillMode.INCREMENTAL if chunked_compute \
                    else PrefillMode.MONOLITHIC
        if not isinstance(mode, PrefillMode):
            raise PrefillModeError(f"unknown prefill mode {mode!r}")
        if mode is PrefillMode.INCREMENTAL:
            if chunk_tokens is None:
                raise PrefillModeError(
                    f"{engine.cfg.name}: PrefillMode.INCREMENTAL requires "
                    "positive chunk_tokens")
            self.chunked_compute = True
        elif mode is PrefillMode.MONOLITHIC:
            self.chunked_compute = False
        else:
            self.chunked_compute = (self.caps.incremental
                                    and chunk_tokens is not None
                                    and chunk_tokens < self.seq_len)
        if resume is not None:
            if not self.caps.resumable:
                engine._note_resume_unsupported()
                raise PrefillModeError(
                    f"{engine.cfg.name}: mid-stream resume is not supported "
                    f"for family {self.caps.family!r}")
            raise NotImplementedError(
                "mid-stream snapshot resume is not ported (ROADMAP queue 1 "
                "item 7: state-carrying families)")
        self.first_token: Optional[int] = None
        self.chunks_emitted = 0
        self._next_start = 0
        self._wire_sent = 0                           # wire progress (abs pos)
        self._entries: Optional[List[Tuple]] = None   # monolithic mode
        self._caches = None                           # incremental mode
        # P-side shared-prefix reuse: replay cached chunks instead of
        # recomputing them, and seed the dense cache so compute resumes
        # at the divergence point. The final token is always computed
        # (first_token).
        self.prefix_tokens = 0
        self._p_store: Optional[HostPrefixStore] = None
        self._cached_entries: Optional[List[Tuple]] = None
        self._collect: Optional[List[Tuple]] = None
        store = engine.host_prefix_store
        if store is not None:
            if self.chunked_compute and self.caps.prefix_cache:
                self._p_store = store
                self._collect = []
                hit, entries = store.match(req.prompt, self.seq_len - 1)
                if hit > 0:
                    self.prefix_tokens = hit
                    self._cached_entries = entries
            else:
                # a prefix store exists but this stream cannot replay
                # from it: a full recompute, counted
                engine._note_resume_unsupported()

    @property
    def done(self) -> bool:
        return self._next_start >= self.seq_len and self.chunks_emitted > 0

    def tail_package(self) -> Dict[str, Any]:
        assert self.done, "tail_package before stream exhausted"
        return {"states": [], "cross": []}

    def next_chunk(self) -> Optional[Dict[str, Any]]:
        if self.done:
            return None
        if self._next_start < self.prefix_tokens:
            chunk = self._next_cached()
        elif self.chunked_compute:
            chunk = self._next_incremental()
        else:
            chunk = self._next_monolithic()
        self.chunks_emitted += 1
        if self._collect is not None:
            self._collect.extend(chunk["kv"])
            if self._next_start >= self.seq_len:
                self._p_store.insert_prompt(self.req.prompt, self._collect,
                                            self.seq_len)
        return chunk

    # -- replay from the host prefix store ------------------------------- #
    def _next_cached(self) -> Dict[str, Any]:
        eng = self.engine
        if eng.failed:
            raise RuntimeError(f"instance {eng.name} is down")
        c0 = self._next_start
        c1 = min(c0 + self.chunk_tokens, self.prefix_tokens)
        self._next_start = c1
        self._wire_sent = c1
        eng.stats.prefix_cached_tokens += c1 - c0
        return {"kv": slice_kv_entries(self._cached_entries, c0, c1),
                "start": c0, "length": c1 - c0, "compute_seconds": 0.0}

    # -- monolithic compute, chunked wire ------------------------------- #
    def _next_monolithic(self) -> Dict[str, Any]:
        compute_s = 0.0
        if self._entries is None:
            t0 = time.perf_counter()
            package = self.engine.prefill(self.req)
            compute_s = time.perf_counter() - t0
            self.first_token = package["first_token"]
            self._entries = kv_entries_with_start(package["kv"])
        w0 = self._next_start
        if self.chunk_tokens is None:
            w1 = self.seq_len
        else:
            w1 = min(w0 + self.chunk_tokens, self.seq_len)
        self._next_start = w1
        return {"kv": slice_kv_entries(self._entries, w0, w1),
                "start": w0, "length": w1 - w0,
                "compute_seconds": compute_s}

    # -- incremental compute --------------------------------------------- #
    def _next_incremental(self) -> Dict[str, Any]:
        """Compute exactly ONE chunk per call (one unit of per-tick P work)."""
        eng, req = self.engine, self.req
        if eng.failed:
            raise RuntimeError(f"instance {eng.name} is down")
        t0 = time.perf_counter()
        if self._caches is None:
            # capacity rounded to a chunk multiple; full_capacity: slot ==
            # position, entries past seq_len stay pos=-1 and masked
            cap = -(-self.seq_len // self.chunk_tokens) * self.chunk_tokens
            self._caches = M.init_caches(eng.cfg, 1, cap, eng.cfg.cdtype,
                                         full_capacity=True,
                                         device=eng.device)
            if self.prefix_tokens:
                self._preload_caches()
        c0 = self._next_start
        c1 = min(c0 + self.chunk_tokens, self.seq_len)
        positions = torch.arange(c0, c1, dtype=torch.int32,
                                 device=eng.device)[None]
        tokens = torch.as_tensor(np.asarray(req.prompt[c0:c1], np.int32),
                                 device=eng.device)[None]
        logits, self._caches = M.decode_step(eng.params, eng.cfg, tokens,
                                             positions, self._caches,
                                             q_offset=c0)
        self._next_start = c1
        eng.stats.prefill_tokens += c1 - c0
        eng.stats.prefill_chunks += 1
        if c1 == self.seq_len:
            self.first_token = int(eng._sample(
                logits[:, -1].float().cpu().numpy(), req)[0])
        dt = time.perf_counter() - t0
        eng._note_prefill_compute(dt)
        w0 = self._wire_sent
        entries = self._extract_entries(w0, c1)
        self._wire_sent = c1
        return {"kv": entries, "start": w0, "length": c1 - w0,
                "compute_seconds": dt}

    def _extract_entries(self, w0: int, w1: int) -> List[Tuple]:
        """Wire entries for absolute positions [w0, w1) — slot == position
        because incremental caches are full-capacity. Views of the cache:
        later chunks write only later slots."""
        entries = []
        for gi, g in enumerate(M.block_groups(self.engine.cfg)):
            for pi, _kind in enumerate(g.kinds):
                c = self._caches[gi][pi]
                entries.append(("kv", gi, pi, {
                    "k": c.k[:, 0, w0:w1], "v": c.v[:, 0, w0:w1],
                    "start": w0}))
        return entries

    def _preload_caches(self) -> None:
        """Seed the dense chunked-prefill cache with the replayed prefix
        KV (host tensors, copied onto the engine's device) so computed
        chunks resume at ``prefix_tokens`` with the bits a cold run would
        have produced. ``pos`` rows carry the real absolute positions —
        attention masks on them."""
        for _kind, gi, pi, ent in self._cached_entries:
            c = self._caches[gi][pi]
            s0 = int(ent["start"])
            n = int(ent["k"].shape[1])
            c.k[:, 0, s0:s0 + n] = ent["k"].to(c.k.device, c.k.dtype)
            c.v[:, 0, s0:s0 + n] = ent["v"].to(c.v.device, c.v.dtype)
            c.pos[:, 0, s0:s0 + n] = torch.arange(
                s0, s0 + n, dtype=c.pos.dtype, device=c.pos.device)


class Engine:
    """One model instance with paged KV and slot-based continuous batching."""

    def __init__(self, name: str, cfg: ModelConfig, params,
                 vendor: VendorProfile, *, num_blocks: int = 256,
                 max_batch: int = 8, max_seq_len: int = 512,
                 role: str = "both", prefix_cache: bool = False,
                 device: _dev.DeviceLike = None, sample_seed: int = 0):
        _dev.check_family(cfg)
        self.device = _dev.resolve(device)
        if params["embed"].device != self.device:
            raise ValueError(f"{name}: params live on {params['embed'].device}"
                             f", engine on {self.device}")
        self.name = name
        self.cfg = cfg
        self.params = params
        self.vendor = vendor
        self.role = role
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.specs = page_specs_for(cfg, vendor.block_size, vendor.layout,
                                    vendor.kv_dtype)
        self.block_size = vendor.block_size
        self.max_blocks_per_seq = -(-max_seq_len // vendor.block_size)
        self.allocator = BlockAllocator(num_blocks)
        self.allocator.allocate("__scratch__", 1)   # trash page for idle slots
        self._scratch_block = self.allocator.blocks_of("__scratch__")[0]
        self.caches = M.init_paged_caches(cfg, self.specs, num_blocks,
                                          device=self.device)
        # slot bookkeeping (host side)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        # a slot is reserved when slot_req is set; ready once its KV has
        # fully landed (streamed chunks materialized + first token known)
        self.slot_ready: List[bool] = [False] * max_batch
        self.block_tables = np.full((max_batch, self.max_blocks_per_seq),
                                    self._scratch_block, np.int32)
        self.seq_lens = np.zeros((max_batch,), np.int32)
        self.last_token = np.zeros((max_batch,), np.int32)
        self.stats = EngineStats()
        self.failed = False
        # shared-prefix KV cache (opt-in): the decode role indexes pool
        # pages by hash chain; the prefill role keeps host-side wire
        # entries to replay instead of recomputing
        self.prefix_store: Optional[PrefixStore] = None
        self.host_prefix_store: Optional[HostPrefixStore] = None
        if prefix_cache and role in ("decode", "both"):
            self.prefix_store = PrefixStore(self.allocator, self.block_size)
        if prefix_cache and role in ("prefill", "both"):
            self.host_prefix_store = HostPrefixStore(self.block_size)
        # per-slot prefix tokens already resident at reservation time —
        # the handoff skips exactly this many tokens on the wire
        self.slot_prefix_tokens: List[int] = [0] * max_batch
        # sampling stream: seeded, so temperature > 0 replays across runs
        self._rng = np.random.default_rng(sample_seed)

    def prefill_capabilities(self) -> PrefillCapabilities:
        return self.cfg.prefill_capabilities()

    def prefill_stream(self, req: Request,
                       chunk_tokens: Optional[int] = None, *,
                       chunked_compute: Optional[bool] = None,
                       mode: Optional[PrefillMode] = None,
                       resume: Optional[Dict[str, Any]] = None
                       ) -> PrefillStream:
        """Start a chunked prefill for ``req``. ``chunked_compute`` has the
        reference's meaning when ``mode`` is None: True forces incremental
        compute, False monolithic, None the automatic choice. A mid-stream
        ``resume`` is refused: no ported family carries state."""
        return PrefillStream(self, req, chunk_tokens,
                             chunked_compute=chunked_compute, mode=mode,
                             resume=resume)

    # ------------------------------------------------------------------ #
    # Prefill (P role)
    # ------------------------------------------------------------------ #
    def prefill(self, req: Request) -> Dict[str, Any]:
        """Run prefill for one request; returns the handoff package:
        {"first_token", "kv": per-group list, "states", "cross", "seq_len"}.
        The KV stays on this engine's device in canonical per-layer form;
        the transfer module converts it to the wire."""
        if self.failed:
            raise RuntimeError(f"instance {self.name} is down")
        t0 = time.perf_counter()
        cfg = self.cfg
        plen = req.prompt_len
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                 device=self.device)[None]
        caches = M.init_caches(cfg, 1, plen, cfg.cdtype, device=self.device)
        last_logits, caches = M.prefill(self.params, cfg, {"tokens": tokens},
                                        caches)
        first_token = self._sample(last_logits.float().cpu().numpy(), req)[0]
        kv = []
        for gi, g in enumerate(M.block_groups(cfg)):
            for pi, _kind in enumerate(g.kinds):
                c = caches[gi][pi]
                kv.append(("kv", gi, pi, {"k": c.k[:, 0, :plen],
                                          "v": c.v[:, 0, :plen]}))
        self.stats.prefill_tokens += plen
        self.stats.prefill_chunks += 1
        self._note_prefill_compute(time.perf_counter() - t0)
        return {"kv": kv, "states": [], "cross": [],
                "first_token": int(first_token), "seq_len": plen}

    def _note_prefill_compute(self, dt: float) -> None:
        """Account prefill compute time; on an integrated engine, time
        spent while decode-ready sequences waited is decode stall."""
        self.stats.prefill_seconds += dt
        if self.role == "both" and any(
                r is not None and self.slot_ready[i]
                for i, r in enumerate(self.slot_req)):
            self.stats.contention_stall_seconds += dt

    def _note_resume_unsupported(self) -> None:
        """A request wanted prefix-cache replay but this stream or family
        cannot do it — count every occurrence, log once per family."""
        self.stats.resume_unsupported += 1
        key = (self.cfg.family, self.cfg.attention_kind)
        if key not in _RESUME_WARNED:
            _RESUME_WARNED.add(key)
            log.warning(
                "family %s (attention=%s): prefix-cache replay unsupported "
                "— falling back to full recompute", *key)

    # ------------------------------------------------------------------ #
    # Decode (D role)
    # ------------------------------------------------------------------ #
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def load(self) -> float:
        """Outstanding work (for the global scheduler's load-aware routing)."""
        active = sum(1 for r in self.slot_req if r is not None)
        return active / self.max_batch

    def can_admit(self, seq_len: int, new_tokens: int) -> bool:
        need = -(-(seq_len + new_tokens) // self.block_size)
        free = self.allocator.free_blocks
        if self.prefix_store is not None:
            # zero-ref cached blocks are reclaimable on demand
            free += self.prefix_store.evictable_blocks()
        return (not self.failed and len(self.free_slots()) > 0
                and free >= need
                and seq_len + new_tokens <= self.max_seq_len)

    def _prefix_eligible(self, req: Request) -> bool:
        """Prefix reuse needs every cached row to stay attendable across
        the whole decode (caps.prefix_cache); the port's prompts are
        tokens only."""
        return self.prefill_capabilities().prefix_cache

    def reserve_sequence(self, req: Request, seq_len: int, *,
                         use_prefix_cache: bool = False
                         ) -> Tuple[int, np.ndarray]:
        """Claim a decode slot + paged blocks for an in-flight handoff.
        The slot is occupied but not decoded until ``activate_sequence``.

        With ``use_prefix_cache`` (and a store), the block table's head
        borrows the store's pages for the longest cached prefix — pinned,
        read-shared — plus an optional copy-on-write divergence block;
        ``slot_prefix_tokens[slot]`` records how many leading tokens need
        no wire transfer. All writes (re-page and decode appends) land at
        positions ≥ that count, i.e. strictly in private blocks."""
        if self.failed:
            raise RuntimeError(f"instance {self.name} is down")
        slot = self.free_slots()[0]
        nblocks = -(-(seq_len + req.max_new_tokens) // self.block_size)
        nblocks = min(nblocks, self.max_blocks_per_seq)
        store = self.prefix_store
        prefix_tokens = 0
        if (use_prefix_cache and store is not None
                and self._prefix_eligible(req)):
            # reuse limit seq_len-1: P always computes ≥ 1 trailing token
            # (it must sample first_token from real logits)
            match = store.match(req.prompt, min(seq_len, req.prompt_len) - 1)
            match = match.truncated(max(nblocks - 1, 0), self.block_size)
            store.acquire(match, req.req_id)
            shared = list(match.block_ids)
            need = nblocks - len(shared)
            short = need - self.allocator.free_blocks
            if short > 0:
                store.evict(short)
            try:
                private = self.allocator.allocate(req.req_id, need)
            except MemoryError:
                store.release_seq(req.req_id)
                raise
            if match.cow_src is not None and need > 0:
                # mid-block divergence: private copy of the source page,
                # valid up to match.tokens — later rows are overwritten
                # by the stream's re-page
                self._copy_block(match.cow_src, private[0])
            prefix_tokens = match.tokens
            block_ids = shared + private
        else:
            if (use_prefix_cache and store is not None
                    and not self._prefix_eligible(req)):
                self._note_resume_unsupported()
            short = nblocks - self.allocator.free_blocks
            if store is not None and short > 0:
                store.evict(short)
            block_ids = self.allocator.allocate(req.req_id, nblocks)
        self.block_tables[slot, :] = self._scratch_block
        self.block_tables[slot, :nblocks] = block_ids
        self.seq_lens[slot] = 0
        self.slot_req[slot] = req
        self.slot_ready[slot] = False
        self.slot_prefix_tokens[slot] = prefix_tokens
        return slot, np.asarray(block_ids, np.int32)

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy one physical page across every paged pool (COW), every
        layer: one ``repack`` per pool — on the card a gather kernel
        into a separate buffer, then a scatter kernel, in stream order."""
        spec = self.specs["kv"]
        ids = torch.tensor([src, dst], dtype=torch.int32, device=self.device)
        for g in self.caches:
            for pools in g:
                for name in ("k_pool", "v_pool"):
                    kops.repack(spec, spec, pools[name], ids[:1],
                                pools[name], ids[1:], self.block_size)

    def activate_sequence(self, slot: int, first_token: int,
                          seq_len: int) -> None:
        """All KV landed — the slot joins continuous batching next step.

        With a prefix store, the sequence's full prompt blocks are adopted
        into it here (ownership transfer, still pinned for this sequence):
        every block is fully written by now, and decode appends only at
        positions ≥ seq_len, which live past the last full prompt block."""
        self.seq_lens[slot] = seq_len
        self.last_token[slot] = first_token
        self.slot_ready[slot] = True
        req = self.slot_req[slot]
        if (self.prefix_store is not None and req is not None
                and self._prefix_eligible(req)):
            self._adopt_prompt_blocks(req, min(seq_len, req.prompt_len), slot)

    def _adopt_prompt_blocks(self, req: Request, prompt_len: int,
                             slot: int) -> None:
        store = self.prefix_store
        prompt = np.asarray(req.prompt)
        bs = self.block_size
        parent = hashing.ROOT
        for b in range(min(prompt_len, len(prompt)) // bs):
            blk = prompt[b * bs:(b + 1) * bs]
            digest = hashing.block_hash(parent, blk)
            # blocks borrowed from the store at reservation re-hash to a
            # cached digest → insert() is a refresh no-op; only this
            # sequence's own (private) blocks transfer ownership
            store.insert(req.req_id, digest, parent, blk,
                         int(self.block_tables[slot, b]))
            parent = digest

    def abort_reservation(self, slot: int) -> None:
        """Handoff failed mid-stream: free the slot and its blocks."""
        if self.failed:
            # recover() rebuilds the allocator; drop the request now so the
            # failure sweep does not requeue it a second time
            self.slot_req[slot] = None
            self.slot_ready[slot] = False
            self.slot_prefix_tokens[slot] = 0
            return
        self.release(slot)

    def add_sequence(self, req: Request, package: Dict[str, Any],
                     materialize_fn) -> int:
        """Admit a fully-transferred request into a decode slot;
        ``materialize_fn(engine, slot, block_ids, package)`` re-pages it."""
        if self.failed:
            raise RuntimeError(f"instance {self.name} is down")
        seq_len = package["seq_len"]
        slot, block_ids = self.reserve_sequence(req, seq_len)
        materialize_fn(self, slot, block_ids, package)
        self.activate_sequence(slot, package["first_token"], seq_len)
        return slot

    def release(self, slot: int) -> None:
        req = self.slot_req[slot]
        if req is not None:
            if self.prefix_store is not None:
                # unpin borrowed/adopted prefix blocks (they stay cached
                # at zero refs until LRU eviction), then free whatever
                # this sequence still owns privately
                self.prefix_store.release_seq(req.req_id)
            self.allocator.free(req.req_id)
        self.slot_req[slot] = None
        self.slot_ready[slot] = False
        self.seq_lens[slot] = 0
        self.slot_prefix_tokens[slot] = 0
        self.block_tables[slot, :] = self._scratch_block

    def decode_step(self) -> List[Tuple[int, Request, int]]:
        """One continuous-batching step. Returns [(slot, request, token)]."""
        if self.failed:
            raise RuntimeError(f"instance {self.name} is down")
        active = [i for i, r in enumerate(self.slot_req)
                  if r is not None and self.slot_ready[i]]
        if not active:
            return []
        t0 = time.perf_counter()
        write_slots = self.seq_lens % self.block_size
        write_block_idx = self.seq_lens // self.block_size
        write_blocks = self.block_tables[np.arange(self.max_batch),
                                         np.minimum(write_block_idx,
                                                    self.max_blocks_per_seq - 1)]
        idle = np.asarray([r is None or not self.slot_ready[i]
                           for i, r in enumerate(self.slot_req)])
        write_blocks = np.where(idle, self._scratch_block, write_blocks)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                self.device)

        logits, self.caches = M.decode_step_paged(
            self.params, self.cfg, dev(self.last_token[:, None]),
            dev(self.seq_lens), dev(self.block_tables), dev(write_blocks),
            dev(write_slots), self.caches, self.specs)
        logits = logits[:, 0].float().cpu().numpy()
        out = []
        for slot in active:
            req = self.slot_req[slot]
            tok = self._sample(logits[slot:slot + 1], req)[0]
            self.seq_lens[slot] += 1
            self.last_token[slot] = tok
            out.append((slot, req, int(tok)))
        self.stats.decode_steps += 1
        self.stats.decode_tokens += len(active)
        self.stats.decode_seconds += time.perf_counter() - t0
        return out

    # ------------------------------------------------------------------ #
    def _sample(self, logits: np.ndarray, req: Request) -> np.ndarray:
        if req.temperature <= 0.0:
            return np.argmax(logits, axis=-1).astype(np.int32)
        z = logits.astype(np.float64) / req.temperature
        z -= z.max(axis=-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=-1, keepdims=True)
        return np.asarray([self._rng.choice(p.shape[-1], p=p[i])
                           for i in range(p.shape[0])], np.int32)

    # -- fault injection ------------------------------------------------ #
    def fail(self) -> None:
        self.failed = True
        self.stats.failures_injected += 1

    def recover(self) -> None:
        """Restart: all volatile KV state is lost (as on a real node)."""
        self.failed = False
        for slot in range(self.max_batch):
            self.release(slot)
        self.allocator = BlockAllocator(self.allocator.num_blocks)
        self.allocator.allocate("__scratch__", 1)
        self._scratch_block = self.allocator.blocks_of("__scratch__")[0]
        if self.prefix_store is not None:
            # the pages the store indexed died with the pool
            self.prefix_store = PrefixStore(self.allocator, self.block_size)
        self.slot_prefix_tokens = [0] * self.max_batch

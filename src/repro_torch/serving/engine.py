"""Model-instance engine: prefill, continuous-batching paged decode —
PyTorch port of ``repro.serving.engine`` for the dense, sliding-window,
MoE, MLA, hybrid RG-LRU, Mamba-2 SSD and encoder-decoder families and
the vision frontend.

One Engine == one "model instance" in the paper's sense (a P instance, a D
instance, or an integrated instance). Vendor-specific VRAM management is
the engine's ``KVPageSpec`` (block size / layout / dtype); the logical TP
degree used for KV sharding completes the vendor profile.

The engine lives on one device: the card unless ``device="cpu"`` is
passed. Its paged pools are updated in place by decode appends, by the
D-side re-page and by the prefix cache's copy-on-write page copy (the
repack kernel). With ``prefix_cache=True`` a decode engine indexes its
pool pages in a ``PrefixStore`` and a prefill engine keeps finished
prompts' KV in a ``HostPrefixStore`` of CPU tensors. A sliding-window
stream ships only the positions at or above its window floor, and can
snapshot its window of KV rows mid-stream so that a retry on the same P
resumes instead of recomputing. An MLA engine keeps latent pools
(``ckv_pool``, ``kpe_pool``: one KV "head" of the latent and of the rope
key) and its wire entries are ``"mla"`` entries of ``ckv``/``kpe`` rows.
A hybrid (RG-LRU) engine carries its recurrent layer states across a
stream's chunks; they leave P in the stream's *tail* (``tail_package``:
``("state", gi, pi, {"h", "conv"})`` rows of one sequence), ride the
mid-stream snapshot beside the window's KV rows, and are placed into a D
slot's rows by ``place_states``. An SSM engine (Mamba-2) has no KV at
all: no pools on D, and its streams ship zero-length progress markers,
then one package that declares the whole length with no entries; the SSD
states ride the tail as a hybrid's do. A vision request's patch
embeddings come before its prompt: the sequence, the positions and the
KV cover both, and such a request never takes the prefix cache. An
encoder-decoder request carries audio frame embeddings: its stream runs
the encoder on P once, as a preamble that cannot be resumed, seeds every
decoder layer's cross-attention rows from the memory, and ships those
rows in its tail (``(gi, pi, {"cross_k", "cross_v", "mem_len"})``, no
states); D places them into the slot's rows (``place_cross``). The
family has no prefix cache: a request with frames bypasses it, counted.
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
from repro_torch.configs.base import RECURRENT, SSD, ModelConfig, \
    PrefillCapabilities
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving.paged_cache import BlockAllocator, KVPageSpec
from repro_torch.serving.prefix_cache import (HostPrefixStore, PrefixStore,
                                              hashing)
from repro_torch.serving.request import Request

log = logging.getLogger(__name__)

# layer kinds that carry a state instead of KV
STATE_KINDS = (RECURRENT, SSD)


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
    """{"kv": spec}, or for MLA {"ckv": ..., "kpe": ...}: one KV "head"
    of width kv_lora_rank and one of width qk_rope_head_dim."""
    _dev.check_family(cfg)
    if cfg.attention_kind == "mla":
        m = cfg.mla
        return {"ckv": KVPageSpec(block_size, layout, dtype, 1,
                                  m.kv_lora_rank),
                "kpe": KVPageSpec(block_size, layout, dtype, 1,
                                  m.qk_rope_head_dim)}
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
    # prompt tokens whose compute was skipped via a mid-stream snapshot
    # resume after a failure
    resumed_tokens: int = 0

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def _chronological(arr: torch.Tensor, pos: torch.Tensor
                   ) -> Tuple[torch.Tensor, int]:
    """Ring-buffer shard (count, cap, ...) + pos (count, cap) →
    chronological (count, cap, ...) and the absolute start position. The
    order is the same across layers, so layer 0's positions (read back
    to the host) sort them all."""
    p0 = pos[0].cpu()
    order = torch.argsort(p0)
    return arr[:, order.to(arr.device)], int(p0[order[0]])


def state_rows(state, fn) -> Dict[str, torch.Tensor]:
    """A layer state's fields as a plain dict (what the wire and the
    snapshot carry), each passed through ``fn``."""
    return {name: fn(t) for name, t in vars(state).items()}


def cross_rows(cfg: ModelConfig, caches) -> List[Tuple]:
    """(gi, pi, {"cross_k", "cross_v", "mem_len"}) of every enc-dec decoder
    position of one sequence's dense ``caches`` (views, batch row 0);
    empty for the other families."""
    return [(gi, pi, {"cross_k": c.cross_k[:, 0], "cross_v": c.cross_v[:, 0],
                      "mem_len": c.mem_len[:, 0]})
            for gi, g in enumerate(M.block_groups(cfg)) if g.cross
            for pi, c in enumerate(caches[gi])]


def kv_entries_with_start(package_kv: List[Tuple]) -> List[Tuple]:
    """A prefill package's KV entries in chronological order with an
    absolute ``start``: the canonical pre-wire form that both the
    monolithic encoder and the chunk splitter consume. An entry that
    carries ``pos`` is a ring buffer (a sliding layer's last window) and
    is put in position order; any other holds positions 0.. in order.
    Returns [(kind, gi, pi, entry)] with entry tensors (count, S', kv, hd)
    — ``"mla"`` entries: ``ckv``/``kpe`` (count, S', dim) — covering
    absolute positions [start, start+S')."""
    out = []
    for kind, gi, pi, ent in package_kv:
        if kind == "mla":
            out.append((kind, gi, pi, {"ckv": ent["ckv"], "kpe": ent["kpe"],
                                       "start": 0}))
            continue
        k, v, start = ent["k"], ent["v"], 0
        if "pos" in ent:
            k, start = _chronological(k, ent["pos"])
            v, _ = _chronological(v, ent["pos"])
        out.append((kind, gi, pi, {"k": k, "v": v, "start": start}))
    return out


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
        launch per layer at ``q_offset`` = the chunk's start (a chunk of
        one row: one flash_decode launch). A sliding
        window masks in attention and ships only positions at or above
        the window floor; a chunk wholly below it returns a zero-length
        *progress marker* that callers account but never send.
      * *monolithic* — whole-prompt compute in one pass on the first call;
        the wire still streams in ``chunk_tokens`` slices, from the first
        position the package holds (a sliding layer keeps only its last
        window).

    A family with no KV on the wire (SSM) returns zero-length progress
    markers for every chunk but the last, and for the last one package
    of no entries that declares the whole length (``start`` 0,
    ``length`` = ``seq_len``). A vision request's stream runs the merged
    patch + token sequence: its chunks are slices of it.

    An enc-dec request's stream first runs the encoder over its frames
    (the preamble) and seeds every decoder layer's memory rows; each chunk
    then cross-attends to them.

    ``first_token`` and ``tail_package()`` (the recurrent or SSD states,
    or an enc-dec model's memory rows) are known once the final chunk has
    been produced.

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
        self.seq_len = req.prompt_len + req.num_patches
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
        # mid-stream snapshot resume (layer states and/or a sliding
        # window): skip the already computed prefix, re-ship the wire from
        # the window floor
        self._resume: Optional[Dict[str, Any]] = None
        if resume is not None:
            if not self.caps.resumable:
                engine._note_resume_unsupported()
                raise PrefillModeError(
                    f"{engine.cfg.name}: mid-stream resume is not supported "
                    f"for family {self.caps.family!r}")
            if not self.chunked_compute:
                raise PrefillModeError(
                    "resume requires incremental chunked compute")
            if int(resume.get("seq_len", -1)) != self.seq_len:
                raise PrefillModeError(
                    "resume snapshot does not match this request")
            self._resume = resume
        self.first_token: Optional[int] = None
        self.chunks_emitted = 0
        self._next_start = 0
        self._wire_sent = 0                           # wire progress (abs pos)
        self._tail: Optional[Dict[str, Any]] = None
        self._entries: Optional[List[Tuple]] = None   # monolithic mode
        self._caches = None                           # incremental mode
        self._emb: Optional[torch.Tensor] = None      # vision: merged embeds
        self._mem: Optional[int] = None               # enc-dec: memory rows
        # P-side shared-prefix reuse: replay cached chunks instead of
        # recomputing them, and seed the dense cache so compute resumes
        # at the divergence point. The final token is always computed
        # (first_token).
        self.prefix_tokens = 0
        self._p_store: Optional[HostPrefixStore] = None
        self._cached_entries: Optional[List[Tuple]] = None
        self._collect: Optional[List[Tuple]] = None
        store = engine.host_prefix_store
        if store is not None and self._resume is None:
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
        """What rides with finalize: ``{"states": [("state", gi, pi, {"h",
        "conv"})], "cross": [(gi, pi, {"cross_k", "cross_v",
        "mem_len"})]}`` — RG-LRU or SSD states, an enc-dec model's memory
        rows of one sequence (every decoder layer, (count, mem_len, KV,
        hd) and (count,)); both empty for the other families."""
        assert self.done, "tail_package before stream exhausted"
        return self._tail if self._tail is not None \
            else {"states": [], "cross": []}

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
            self._tail = {"states": package["states"],
                          "cross": package["cross"]}
            self._entries = kv_entries_with_start(package["kv"])
            if self._entries:
                # ring-buffer (sliding) entries cover only the last window
                # of the prompt: stream from the first position on the
                # wire, no empty chunks for the evicted prefix
                self._next_start = min(
                    min(e[3]["start"] for e in self._entries), self.seq_len)
        w0 = self._next_start
        if not self._entries or self.chunk_tokens is None:
            w1 = self.seq_len        # states only: nothing to chunk
        else:
            w1 = min(w0 + self.chunk_tokens, self.seq_len)
        self._next_start = w1
        return {"kv": slice_kv_entries(self._entries, w0, w1),
                "start": w0, "length": w1 - w0,
                "compute_seconds": compute_s}

    # -- incremental compute --------------------------------------------- #
    @property
    def _wire_floor(self) -> int:
        """First absolute position the D side can still attend. Sliding-
        window KV below ``seq_len - window`` is dead weight — never ship."""
        if self.caps.window:
            return max(0, self.seq_len - self.caps.window)
        return 0

    def _next_incremental(self) -> Dict[str, Any]:
        """Compute exactly ONE chunk per call (one unit of per-tick P
        work). A chunk that produced nothing for the wire — every chunk
        but the last of a family with no KV on the wire, or one wholly
        below the window floor — returns a zero-length progress marker."""
        eng, req = self.engine, self.req
        if eng.failed:
            raise RuntimeError(f"instance {eng.name} is down")
        t0 = time.perf_counter()
        if self._caches is None:
            self._setup_incremental()
        c0 = self._next_start
        c1 = min(c0 + self.chunk_tokens, self.seq_len)
        logits = self._compute_chunk(c0, c1)
        self._next_start = c1
        eng.stats.prefill_tokens += c1 - c0
        eng.stats.prefill_chunks += 1
        if c1 == self.seq_len:
            self.first_token = int(eng._sample(
                logits[:, -1].float().cpu().numpy(), req)[0])
            self._tail = {"states": self._states(lambda t: t[:, 0]),
                          "cross": cross_rows(eng.cfg, self._caches)}
        dt = time.perf_counter() - t0
        eng._note_prefill_compute(dt)
        if not self.caps.kv_on_wire:
            # no KV ever lands on the wire: the one final package declares
            # the whole length, the states ride the tail
            if c1 < self.seq_len:
                return {"kv": [], "start": c0, "length": 0,
                        "compute_seconds": dt}
            return {"kv": [], "start": 0, "length": self.seq_len,
                    "compute_seconds": dt}
        w0 = max(self._wire_sent, self._wire_floor)
        if c1 <= w0:
            return {"kv": [], "start": c0, "length": 0,
                    "compute_seconds": dt}
        entries = self._extract_entries(w0, c1)
        self._wire_sent = c1
        return {"kv": entries, "start": w0, "length": c1 - w0,
                "compute_seconds": dt}

    def _setup_incremental(self) -> None:
        """The dense cache of an incremental stream: capacity rounded to a
        chunk multiple, full_capacity (slot == position, even for a
        sliding layer); entries past seq_len stay pos=-1 and masked. An
        enc-dec request's encoder runs here, once (the preamble), and its
        memory seeds every decoder layer's cross rows. A vision request's
        patch and token embeddings are merged once here. Then the
        replayed prefix or a resume snapshot, if any."""
        eng, req = self.engine, self.req
        cap = -(-self.seq_len // self.chunk_tokens) * self.chunk_tokens
        self._caches = M.init_caches(eng.cfg, 1, cap, eng.cfg.cdtype,
                                     full_capacity=True, device=eng.device,
                                     mem_len=eng.mem_len)
        if req.frames is not None:
            memory = M.encode(eng.params, eng.cfg, torch.as_tensor(
                np.asarray(req.frames), device=eng.device)[None])
            self._mem = memory.shape[1]
            M.seed_cross(self._caches,
                         M.encoder_cross_kv(eng.params, eng.cfg, memory),
                         self._mem)
        if req.patches is not None:
            self._emb = M.merged_embeds(
                eng.params, eng.cfg,
                torch.as_tensor(np.asarray(req.patches))[None],
                torch.as_tensor(np.asarray(req.prompt, np.int32),
                                device=eng.device)[None])
        if self.prefix_tokens:
            self._preload_caches()
        if self._resume is not None:
            self._apply_resume(self._resume)

    def _compute_chunk(self, c0: int, c1: int) -> torch.Tensor:
        """Positions [c0, c1) through the decode path: a slice of the
        merged embeddings for a vision request, else the prompt's
        tokens. Returns the chunk's logits."""
        eng = self.engine
        positions = torch.arange(c0, c1, dtype=torch.int32,
                                 device=eng.device)[None]
        if self._emb is not None:
            logits, self._caches = M.decode_step_embeds(
                eng.params, eng.cfg, self._emb[:, c0:c1], positions,
                self._caches, q_offset=c0)
            return logits
        tokens = torch.as_tensor(np.asarray(self.req.prompt[c0:c1], np.int32),
                                 device=eng.device)[None]
        logits, self._caches = M.decode_step(eng.params, eng.cfg, tokens,
                                             positions, self._caches,
                                             q_offset=c0, mem_len=self._mem)
        return logits

    def _states(self, fn) -> List[Tuple]:
        """("state", gi, pi, rows) of every recurrent or SSD position of
        the stream's caches, each field passed through ``fn``."""
        return [("state", gi, pi, state_rows(self._caches[gi][pi], fn))
                for gi, g in enumerate(M.block_groups(self.engine.cfg))
                for pi, kind in enumerate(g.kinds) if kind in STATE_KINDS]

    def _extract_entries(self, w0: int, w1: int) -> List[Tuple]:
        """Wire entries for absolute positions [w0, w1) — slot == position
        because incremental caches are full-capacity. Views of the cache:
        later chunks write only later slots."""
        entries = []
        for gi, g in enumerate(M.block_groups(self.engine.cfg)):
            for pi, kind in enumerate(g.kinds):
                if kind in STATE_KINDS:
                    continue
                c = self._caches[gi][pi]
                if self.caps.latent_kv:
                    entries.append(("mla", gi, pi, {
                        "ckv": c.ckv[:, 0, w0:w1], "kpe": c.kpe[:, 0, w0:w1],
                        "start": w0}))
                else:
                    entries.append(("kv", gi, pi, {
                        "k": c.k[:, 0, w0:w1], "v": c.v[:, 0, w0:w1],
                        "start": w0}))
        return entries

    # -- mid-stream snapshot resume ------------------------------------- #
    def snapshot(self) -> Optional[Dict[str, Any]]:
        """Portable mid-stream progress: the recurrent or SSD layer states
        and the KV rows still inside the sliding window below ``next_start``,
        copied to the host. Replaying it on a fresh stream (same request,
        same params) skips recomputing the first ``next_start`` prompt
        tokens after a failure."""
        if not (self.caps.resumable and self.chunked_compute):
            return None
        if self._caches is None or self._next_start <= 0 or self.done:
            return None
        ns = self._next_start
        lo = max(0, ns - self.caps.window) if self.caps.window else ns
        states, kv = [], []
        for gi, g in enumerate(M.block_groups(self.engine.cfg)):
            for pi, kind in enumerate(g.kinds):
                c = self._caches[gi][pi]
                if kind in STATE_KINDS:
                    # a copy: later chunks step the live state in place
                    states.append((gi, pi, state_rows(
                        c, lambda t: t.to("cpu", copy=True))))
                else:
                    kv.append((gi, pi, {"k": c.k[:, :, lo:ns].cpu(),
                                        "v": c.v[:, :, lo:ns].cpu()}))
        return {"seq_len": self.seq_len, "next_start": ns,
                "row_start": lo, "states": states, "kv": kv}

    def _apply_resume(self, snap: Dict[str, Any]) -> None:
        ns = int(snap["next_start"])
        s0 = int(snap["row_start"])
        for gi, pi, rows in snap["states"]:
            L.state_put(self._caches[gi][pi], rows)
        for gi, pi, ent in snap["kv"]:
            c = self._caches[gi][pi]
            c.k[:, :, s0:ns] = ent["k"].to(c.k.device, c.k.dtype)
            c.v[:, :, s0:ns] = ent["v"].to(c.v.device, c.v.dtype)
            c.pos[:, :, s0:ns] = torch.arange(s0, ns, dtype=c.pos.dtype,
                                              device=c.pos.device)
        self._next_start = ns
        self.engine.stats.resumed_tokens += ns

    def _preload_caches(self) -> None:
        """Seed the dense chunked-prefill cache with the replayed prefix
        KV (host tensors, copied onto the engine's device) so computed
        chunks resume at ``prefix_tokens`` with the bits a cold run would
        have produced. ``pos`` rows carry the real absolute positions —
        attention masks on them."""
        for _kind, gi, pi, ent in self._cached_entries:
            c = self._caches[gi][pi]
            s0 = int(ent["start"])
            for name, t in ent.items():        # k, v or the latent ckv, kpe
                if name != "start":
                    n = int(t.shape[1])
                    dst = getattr(c, name)
                    dst[:, 0, s0:s0 + n] = t.to(dst.device, dst.dtype)
            c.pos[:, 0, s0:s0 + n] = torch.arange(
                s0, s0 + n, dtype=c.pos.dtype, device=c.pos.device)


class Engine:
    """One model instance with paged KV and slot-based continuous batching."""

    def __init__(self, name: str, cfg: ModelConfig, params,
                 vendor: VendorProfile, *, num_blocks: int = 256,
                 max_batch: int = 8, max_seq_len: int = 512,
                 mem_len: int = 0, role: str = "both",
                 prefix_cache: bool = False,
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
        # encoder memory rows a sequence may hold (enc-dec): the cross rows
        # of D's slots and of P's caches
        self.mem_len = mem_len or (cfg.max_source_len if cfg.is_enc_dec
                                   else 0)
        self.specs = page_specs_for(cfg, vendor.block_size, vendor.layout,
                                    vendor.kv_dtype)
        self.block_size = vendor.block_size
        self.max_blocks_per_seq = -(-max_seq_len // vendor.block_size)
        self.allocator = BlockAllocator(num_blocks)
        self.allocator.allocate("__scratch__", 1)   # trash page for idle slots
        self._scratch_block = self.allocator.blocks_of("__scratch__")[0]
        self.caches = M.init_paged_caches(cfg, self.specs, num_blocks,
                                          batch=max_batch, device=self.device,
                                          mem_len=self.mem_len)
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
        compute, False monolithic, None the automatic choice. ``resume``:
        a ``PrefillStream.snapshot()`` of an aborted stream of the same
        request on this engine (the families that carry layer states or a
        sliding window; the others refuse it with ``PrefillModeError``)."""
        return PrefillStream(self, req, chunk_tokens,
                             chunked_compute=chunked_compute, mode=mode,
                             resume=resume)

    # ------------------------------------------------------------------ #
    # Prefill (P role)
    # ------------------------------------------------------------------ #
    def prefill(self, req: Request) -> Dict[str, Any]:
        """Run prefill for one request; returns the handoff package:
        {"first_token", "kv": per-group list, "states", "cross", "seq_len"}.
        A vision request's patches come before its tokens, and
        ``seq_len`` counts both; an enc-dec request's frames go through
        the encoder, and ``cross`` holds every decoder layer's memory
        rows. The KV, the layer states and the memory rows stay on this
        engine's device in canonical per-layer form; the transfer module
        converts them to the wire."""
        if self.failed:
            raise RuntimeError(f"instance {self.name} is down")
        t0 = time.perf_counter()
        cfg = self.cfg
        plen = req.prompt_len + req.num_patches
        inputs = {"tokens": torch.as_tensor(np.asarray(req.prompt, np.int32),
                                            device=self.device)[None]}
        if req.patches is not None:
            inputs["patches"] = torch.as_tensor(
                np.asarray(req.patches), device=self.device)[None]
        if req.frames is not None:
            inputs["frames"] = torch.as_tensor(
                np.asarray(req.frames), device=self.device)[None]
        caches = M.init_caches(cfg, 1, plen, cfg.cdtype, device=self.device,
                               mem_len=self.mem_len)
        last_logits, caches = M.prefill(self.params, cfg, inputs, caches)
        first_token = self._sample(last_logits.float().cpu().numpy(), req)[0]
        kv, states = [], []
        for gi, g in enumerate(M.block_groups(cfg)):
            for pi, kind in enumerate(g.kinds):
                c = caches[gi][pi]
                if kind in STATE_KINDS:
                    states.append(("state", gi, pi,
                                   state_rows(c, lambda t: t[:, 0])))
                elif cfg.attention_kind == "mla":
                    kv.append(("mla", gi, pi, {"ckv": c.ckv[:, 0, :plen],
                                               "kpe": c.kpe[:, 0, :plen]}))
                elif c.capacity >= plen:
                    kv.append(("kv", gi, pi, {"k": c.k[:, 0, :plen],
                                              "v": c.v[:, 0, :plen]}))
                else:
                    # a sliding layer's ring: its last window, slots in
                    # ring order, with their positions
                    kv.append(("kv", gi, pi, {"k": c.k[:, 0],
                                              "v": c.v[:, 0],
                                              "pos": c.pos[:, 0]}))
        self.stats.prefill_tokens += plen
        self.stats.prefill_chunks += 1
        self._note_prefill_compute(time.perf_counter() - t0)
        return {"kv": kv, "states": states,
                "cross": cross_rows(cfg, caches),
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
        the whole decode (caps.prefix_cache) and a pure-token prompt, as
        the reference's gate. The only families that take patches (vlm)
        or frames (enc-dec) have no prefix cache in their capability row,
        so that row decides; the patches and frames tests guard the gate,
        they change no outcome."""
        return (self.prefill_capabilities().prefix_cache
                and req.patches is None and req.frames is None)

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

    def _pool_spec(self, name: str) -> KVPageSpec:
        """The page spec of pool ``name``: ``ckv_pool`` → specs["ckv"],
        ``kpe_pool`` → specs["kpe"], ``k_pool``/``v_pool`` → specs["kv"]."""
        return self.specs.get(name[:-len("_pool")], self.specs.get("kv"))

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy one physical page across every paged pool (COW), every
        layer: one ``repack`` per pool with the pool's own spec — on the
        card a gather kernel into a separate buffer, then a scatter
        kernel, in stream order."""
        ids = torch.tensor([src, dst], dtype=torch.int32, device=self.device)
        for pools in self.paged_pools():
            for name, pool in pools.items():
                spec = self._pool_spec(name)
                kops.repack(spec, spec, pool, ids[:1], pool, ids[1:],
                            self.block_size)

    def paged_pools(self) -> List[Dict[str, torch.Tensor]]:
        """The {name: pool} dicts of every attention position, pools only
        (recurrent and SSD positions hold per-slot states, not pages; an
        SSM model has none; an enc-dec position's per-slot memory rows
        are not pages either)."""
        return [{n: t for n, t in c.items() if n.endswith("_pool")}
                for g in self.caches for c in g if isinstance(c, dict)]

    def place_states(self, slot: int, states: List[Tuple]) -> None:
        """Write one sequence's recurrent or SSD state rows (``("state", gi,
        pi, {"h", "conv"})``, any device) into decode slot ``slot``, in place,
        cast to the states' dtypes (the reference's ``_place``)."""
        for _tag, gi, pi, rows in states:
            state = self.caches[gi][pi]
            L.state_put(type(state)(**{name: t[:, slot] for name, t
                                       in vars(state).items()}), rows)

    def place_cross(self, slot: int, cross: List[Tuple]) -> None:
        """Write one sequence's memory rows (``(gi, pi, {"cross_k",
        "cross_v", "mem_len"})``, any device) into decode slot ``slot`` of
        every decoder layer, in place, cast to the rows' dtypes (the
        reference's placement in ``materialize``)."""
        for gi, pi, rows in cross:
            c = self.caches[gi][pi]
            for name in ("cross_k", "cross_v", "mem_len"):
                dst = c[name][:, slot]
                dst.copy_(torch.as_tensor(rows[name]).to(dst.device,
                                                         dst.dtype))

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
            dev(write_slots), self.caches, self.specs,
            max_len=int(self.seq_lens[active].max()) + 1)
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

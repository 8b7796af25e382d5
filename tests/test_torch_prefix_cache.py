"""The port's shared-prefix KV cache against the JAX package's
(``repro.serving.prefix_cache`` and its engine/handoff/scheduler hooks).

Mirrors the in-process cases of tests/test_prefix_cache.py on the tiny
``dense`` config in float32, on the CPU, with the same parameters and
requests on both sides:

* digests byte-identical; ``PrefixStore`` / ``HostPrefixStore`` make the
  same matches, copy-on-write decisions, evictions and byte counts under
  the same operations;
* serving with the cache gives the reference scheduler's tokens and its
  ``prefix_hit_tokens``, ``bytes_saved`` and ``prefix_cached_tokens``,
  over raw-f32, raw-bf16 and int8 wires, through the mid-block COW path,
  under pool pressure, after a D failure, and with affinity routing;
* fed the same KV, cached handoffs leave D pools bit-identical to the
  reference's, the COW page included, in every layout.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.compat.precision import WireFormat as JWire
from repro.core.disagg import DisaggPipeline as JPipe
from repro.core.kv_transfer import TransferEngine as JTransfer
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import VendorProfile as JVendor
from repro.serving.paged_cache import BlockAllocator as JAlloc
from repro.serving.prefix_cache import HostPrefixStore as JHostStore
from repro.serving.prefix_cache import PrefixStore as JStore
from repro.serving.prefix_cache import hashing as jhash
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import GlobalScheduler as JSched
from repro_torch.configs.base import config_from_dict
from repro_torch.core.compat.precision import WireFormat as TWire
from repro_torch.core.disagg import DisaggPipeline as TPipe
from repro_torch.core.kv_transfer import TransferEngine as TTransfer
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import VendorProfile as TVendor
from repro_torch.serving.paged_cache import BlockAllocator as TAlloc
from repro_torch.serving.prefix_cache import STORE_OWNER
from repro_torch.serving.prefix_cache import HostPrefixStore as THostStore
from repro_torch.serving.prefix_cache import PrefixStore as TStore
from repro_torch.serving.prefix_cache import hashing as thash
from repro_torch.serving.request import Request as TRequest
from repro_torch.serving.scheduler import GlobalScheduler as TSched
from tests.conftest import TINY_FAMILIES

CFG = TINY_FAMILIES["dense"]
TCFG = config_from_dict(dataclasses.asdict(CFG))
VENDOR_P = dict(block_size=8, layout="nhbd", kv_dtype="float32", tp=2)
VENDOR_D = dict(block_size=4, layout="nbhd", kv_dtype="float32", tp=1)
CHUNK = 8
WIRES = {"raw-f32": ("raw", "float32"), "raw-bf16": ("raw", "bfloat16"),
         "int8": ("int8", "bfloat16")}


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.key(0), CFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


# --------------------------------------------------------------------- #
# 1. chained hashing
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("block_size", [1, 4, 8, 16])
def test_digests_identical_to_reference(block_size):
    rng = np.random.default_rng(block_size)
    toks = rng.integers(0, 32000, 70).astype(np.int32)
    for limit in (None, 0, 13, 64):
        chain = thash.chain_hashes(toks, block_size, limit)
        assert chain == jhash.chain_hashes(toks, block_size, limit)
    assert thash.block_hash("ab12", toks[:5]) == jhash.block_hash("ab12",
                                                                  toks[:5])
    chain = thash.chain_hashes(toks, block_size)
    for cached in (set(chain), set(chain[:3]), {chain[0], chain[2]}, set()):
        assert thash.matched_prefix_tokens(chain, cached, block_size) == \
            jhash.matched_prefix_tokens(chain, cached, block_size)


# --------------------------------------------------------------------- #
# 2. the stores under the same operations
# --------------------------------------------------------------------- #
def _store_script(alloc_cls, store_cls, hashing):
    """Adopt, pin, match (with COW), refresh, release and evict on a small
    pool; return every observation."""
    alloc = alloc_cls(12)
    store = store_cls(alloc, block_size=4)
    rng = np.random.default_rng(5)
    head = rng.integers(0, 100, 8).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(0, 100, n).astype(np.int32)])
               for n in (4, 6, 8)]
    prompts.append(np.concatenate([head[:6], [99, 98, 97, 96, 95]]))
    log = []
    for i, prompt in enumerate(prompts):
        sid = f"s{i}"
        m = store.match(prompt, len(prompt) - 1)
        log.append(("match", m.tokens, m.block_ids, m.cow_src, m.cow_len))
        store.acquire(m, sid)
        need = len(prompt) // 4 - len(m.block_ids)
        short = need - alloc.free_blocks
        if short > 0:
            log.append(("evict", store.evict(short)))
        blocks = list(m.block_ids) + alloc.allocate(sid, need)
        parent = hashing.ROOT
        for b in range(len(prompt) // 4):
            blk = prompt[b * 4:(b + 1) * 4]
            digest = hashing.block_hash(parent, blk)
            log.append(("insert", store.insert(sid, digest, parent, blk,
                                               blocks[b])))
            parent = digest
        if i % 2:
            store.release_seq(sid)
            alloc.free(sid)
        log.append(("state", len(store), store.evictable_blocks(),
                    alloc.free_blocks, sorted(alloc.blocks_of(STORE_OWNER)),
                    sorted(store.summary())))
        alloc.check_invariants()
    log.append(("peek", store.match_tokens(prompts[0], 11),
                store.lookups, store.hit_tokens))
    for sid in ("s0", "s2"):
        store.release_seq(sid)
        alloc.free(sid)
    log.append(("evict", store.evict(3), store.evicted_blocks,
                store.inserted_blocks, alloc.free_blocks))
    m = store.match(prompts[2], 15).truncated(1, 4)
    log.append(("truncated", m.tokens, m.block_ids, m.cow_src))
    return log


def test_prefix_store_same_decisions_as_reference():
    want = _store_script(JAlloc, JStore, jhash)
    got = _store_script(TAlloc, TStore, thash)
    assert got == want
    assert any(e[0] == "match" and e[3] is not None for e in got)  # a COW
    assert any(e[0] == "evict" and e[1] > 0 for e in got)


def _host_script(store_cls, as_array):
    """Insert, match (full blocks and a mid-block extension) and evict in
    a byte-capacity store; return every observation."""
    one = 2 * 2 * 8 * 4 * 4 * 4             # k+v, 2 layers, 8 tokens, f32
    store = store_cls(block_size=8, capacity_bytes=5 * one)
    rng = np.random.default_rng(2)
    log = []

    def entries(n, seed):
        k, v = np.random.default_rng(seed).standard_normal(
            (2, 2, n, 4, 4)).astype(np.float32)
        # two chunks, split off the block grid: assembly must merge them
        return [("kv", 0, 0, {"k": as_array(k[:, :11]),
                              "v": as_array(v[:, :11]), "start": 0}),
                ("kv", 0, 0, {"k": as_array(k[:, 11:]),
                              "v": as_array(v[:, 11:]), "start": 11})]

    head = rng.integers(0, 50, 16).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(0, 50, 9).astype(np.int32)]),
               np.concatenate([head[:12], rng.integers(50, 99, 12)
                               .astype(np.int32)]),
               rng.integers(0, 50, 24).astype(np.int32),
               rng.integers(0, 50, 17).astype(np.int32)]
    for i, p in enumerate(prompts):
        hit, ents = store.match(p, len(p) - 1)
        log.append(("match", hit, [(e[0], e[1], e[2], e[3]["start"],
                                    np.asarray(e[3]["k"]).tolist())
                                   for e in ents]))
        log.append(("insert", store.insert_prompt(p, entries(len(p), i),
                                                  len(p)),
                    store.nbytes, len(store)))
    hit, _ = store.match(prompts[0], 24)
    log.append(("final", hit, store.lookups, store.hit_tokens, store.nbytes))
    return log


def test_host_store_same_decisions_as_reference():
    want = _host_script(JHostStore, lambda a: a)
    got = _host_script(THostStore, torch.from_numpy)
    assert got == want
    assert any(e[0] == "match" and e[1] % 8 for e in got)       # mid-block
    assert any(e[0] == "match" and e[1] == 0 for e in got[4:])  # evicted


def test_host_store_copies_entries_into_its_own_cpu_tensors():
    """Inserted blocks are new CPU tensors: the store never keeps a view
    of the stream's cache (on the card that would pin the whole cache)."""
    store = THostStore(block_size=4)
    cache = torch.randn(2, 1, 12, 2, 3)                  # (L, B, cap, kv, hd)
    ents = [("kv", 0, 0, {"k": cache[:, 0, :12], "v": cache[:, 0, :12],
                          "start": 0})]
    assert store.insert_prompt(np.arange(12), ents, 12) == 3
    hit, got = store.match(np.arange(12), 11)
    assert hit == 8 + 3
    for _, _, _, ent in got:
        assert ent["k"].device.type == "cpu"
        assert ent["k"].untyped_storage().data_ptr() != \
            cache.untyped_storage().data_ptr()
        s0 = ent["start"]
        assert torch.equal(ent["k"], cache[:, 0, s0:s0 + ent["k"].shape[1]])
    cache.zero_()                                        # stream reuses it
    assert not torch.equal(got[0][3]["k"], cache[:, 0, :4])


# --------------------------------------------------------------------- #
# 3. serving: tokens and skip accounting equal to the reference
# --------------------------------------------------------------------- #
def _sched(params, torch_side, prefix_cache, wire, num_blocks=64,
           n_d=1, d_layout="nbhd"):
    jp, tp = params
    kw = dict(num_blocks=num_blocks, max_batch=4, max_seq_len=64,
              prefix_cache=prefix_cache)
    dv = dict(VENDOR_D, layout=d_layout)
    if torch_side:
        sched = TSched(TPipe(TTransfer(), TWire(*wire)), prefill_chunk=CHUNK,
                       device="cpu")
        mk = lambda n, v, role: TEngine(n, TCFG, tp, TVendor(n, **v),
                                        role=role, device="cpu", **kw)
    else:
        sched = JSched(JPipe(JTransfer(), JWire(*wire)), prefill_chunk=CHUNK)
        mk = lambda n, v, role: JEngine(n, CFG, jp, JVendor(n, **v),
                                        role=role, **kw)
    sched.add_instance(mk("P0", VENDOR_P, "prefill"))
    for i in range(n_d):
        sched.add_instance(mk(f"D{i}", dv, "decode"))
    return sched


def _requests(torch_side, prompts, max_new=4):
    cls = TRequest if torch_side else JRequest
    return [cls(f"q{i}", p.copy(), max_new) for i, p in enumerate(prompts)]


def _serve_sequentially(sched, reqs, max_ticks=400):
    for r in reqs:
        sched.submit(r)
        for _ in range(max_ticks):
            if r.state.name in ("FINISHED", "FAILED"):
                break
            sched.step()
        assert r.state.name == "FINISHED"
    return [list(r.output_tokens) for r in reqs]


def _shared_prefix_prompts(n=3, shared=40, tail=4, seed=11):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, CFG.vocab_size, shared).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, CFG.vocab_size, tail)
                            .astype(np.int32)]) for _ in range(n)]


def _stats(sched):
    tr = sched.pipeline.transfer.stats
    d = sched.d_pool["D0"].prefix_store
    return {"prefix_hit_tokens": tr.prefix_hit_tokens,
            "bytes_saved": tr.bytes_saved, "bytes_moved": tr.bytes_moved,
            "prefix_cached_tokens":
                sched.p_pool["P0"].stats.prefix_cached_tokens,
            "d_hit_tokens": d.hit_tokens, "d_lookups": d.lookups,
            "d_inserted": d.inserted_blocks, "d_evicted": d.evicted_blocks}


@pytest.mark.parametrize("wire", list(WIRES), ids=list(WIRES))
def test_cached_serving_identical_to_reference(params, wire):
    prompts = _shared_prefix_prompts()
    j = _sched(params, False, True, WIRES[wire])
    want = _serve_sequentially(j, _requests(False, prompts))
    t = _sched(params, True, True, WIRES[wire])
    got = _serve_sequentially(t, _requests(True, prompts))
    assert got == want
    assert _stats(t) == _stats(j)
    # the shared 40 tokens of requests 2 and 3 skipped the wire, and the
    # P engine skipped their forward pass
    assert _stats(t)["prefix_hit_tokens"] >= 2 * 40
    assert _stats(t)["bytes_saved"] > 0
    assert _stats(t)["prefix_cached_tokens"] >= 2 * 40
    cold = _sched(params, True, False, WIRES[wire])
    assert _serve_sequentially(cold, _requests(True, prompts)) == got


def test_mid_block_divergence_takes_cow_path(params):
    """Prompts sharing 18 tokens — D block 4 holds 16 of them in full
    blocks, the 2 more in a copy-on-write copy of block 4."""
    head = np.random.default_rng(3).integers(0, CFG.vocab_size,
                                             16).astype(np.int32)
    prompts = [np.concatenate([head, np.array(t, np.int32)])
               for t in ([7, 9, 11, 13], [7, 9, 20, 21])]
    wire = WIRES["raw-f32"]
    j = _sched(params, False, True, wire)
    want = _serve_sequentially(j, _requests(False, prompts))
    t = _sched(params, True, True, wire)
    got = _serve_sequentially(t, _requests(True, prompts))
    assert got == want
    assert _stats(t) == _stats(j)
    assert _stats(t)["prefix_hit_tokens"] == 18
    assert _stats(t)["d_hit_tokens"] == 18


def test_eviction_under_pressure_matches_reference(params):
    """A pool barely larger than one sequence evicts on every
    reservation; all requests finish, the evictions match the
    reference's, and the pool stays partitioned."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, CFG.vocab_size, 44).astype(np.int32)
               for _ in range(4)]
    wire = WIRES["raw-f32"]
    j = _sched(params, False, True, wire, num_blocks=16)
    want = _serve_sequentially(j, _requests(False, prompts))
    t = _sched(params, True, True, wire, num_blocks=16)
    got = _serve_sequentially(t, _requests(True, prompts))
    assert got == want
    assert _stats(t) == _stats(j)
    d = t.d_pool["D0"]
    assert d.prefix_store.evicted_blocks > 0
    owned = len(d.allocator.blocks_of(STORE_OWNER))
    assert d.allocator.free_blocks + owned == 16 - 1     # + scratch
    d.allocator.check_invariants()


def test_requeue_resumes_from_cached_prefix(params):
    """The retry of a failed D stream extends the original prompt, so the
    P host store replays the original prefill instead of recomputing
    it; greedy tokens come out as in a run without the failure."""
    prompts = _shared_prefix_prompts(n=2)
    wire = WIRES["raw-f32"]
    want = _serve_sequentially(_sched(params, True, False, wire),
                               _requests(True, prompts, max_new=6))
    sched = _sched(params, True, True, wire)
    reqs = _requests(True, prompts, max_new=6)
    _serve_sequentially(sched, reqs[:1])
    p, d = sched.p_pool["P0"], sched.d_pool["D0"]
    replayed_before = p.stats.prefix_cached_tokens
    sched.submit(reqs[1])
    for _ in range(3):
        sched.step()
    d.fail()                                   # volatile KV gone mid-flight
    for _ in range(400):
        if sched.stats.finished >= 2:
            break
        sched.step()
    assert sched.stats.finished == 2 and sched.stats.requeues >= 1
    assert p.stats.prefix_cached_tokens > replayed_before
    assert [r.output_tokens for r in reqs] == want


def test_pick_d_prefers_the_cached_prefix_like_the_reference(params):
    """Once D0 holds a prefix, a request sharing it goes to D0 although
    D0 is busier; a foreign prompt goes by load to D1."""
    prompts = _shared_prefix_prompts(n=2)
    foreign = np.random.default_rng(99).integers(
        0, CFG.vocab_size, 44).astype(np.int32)
    picks = []
    for torch_side in (False, True):
        sched = _sched(params, torch_side, True, WIRES["raw-f32"], n_d=2)
        first, second, other = _requests(torch_side, prompts + [foreign])
        _serve_sequentially(sched, [first])
        d0, d1 = sched.d_pool["D0"], sched.d_pool["D1"]
        assert d0.prefix_store.inserted_blocks > 0 and len(d1.prefix_store) \
            == 0
        busy = (TRequest if torch_side else JRequest)("busy", foreign[:8], 2)
        d0.reserve_sequence(busy, 8)                  # D0 now more loaded
        assert d0.load() > d1.load()
        picks.append((sched._pick_d(second, second.prompt_len).name,
                      sched._pick_d(other, other.prompt_len).name))
    assert picks[1] == picks[0] == ("D0", "D1")


# --------------------------------------------------------------------- #
# 4. cached handoffs on identical KV: bit-identical D pools
# --------------------------------------------------------------------- #
SEQ = 23


def _handoff_engines(params, layout):
    jp, tp = params
    kw = dict(num_blocks=24, max_batch=2, max_seq_len=40, prefix_cache=True)
    dv = dict(VENDOR_D, layout=layout)
    return ((JEngine("P", CFG, jp, JVendor("p", **VENDOR_P), role="prefill",
                     **kw),
             JEngine("D", CFG, jp, JVendor("d", **dv), role="decode", **kw)),
            (TEngine("P", TCFG, tp, TVendor("p", **VENDOR_P), role="prefill",
                     device="cpu", **kw),
             TEngine("D", TCFG, tp, TVendor("d", **dv), role="decode",
                     device="cpu", **kw)))


def _stream(pipe, req, p, d, k, v, chunk=7):
    h = pipe.begin_handoff(req, p, d, SEQ)
    for c0 in range(0, SEQ, chunk):
        c1 = min(c0 + chunk, SEQ)
        ent = {"k": k[:, c0:c1], "v": v[:, c0:c1], "start": c0}
        if isinstance(pipe, TPipe):
            ent = {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                   for n, a in ent.items()}
        h.send_chunk({"kv": [("kv", 0, 0, ent)], "start": c0,
                      "length": c1 - c0})
        h.poll_reads()
    h.finalize(1, {"states": [], "cross": []})
    return h


@pytest.mark.parametrize("layout", ["nbhd", "nhbd", "nhdb"])
def test_d_pools_bit_identical_after_cached_handoffs(params, layout):
    """A first handoff fills D's store; a second prompt sharing 18 tokens
    (16 in full D blocks, 2 more copied on write) streams only its tail.
    Both pipelines, fed the same KV, leave the same pool bits."""
    rng = np.random.default_rng(8)
    shape = (CFG.num_layers, SEQ, CFG.num_kv_heads, CFG.hd)
    k1, v1, k2, v2 = (rng.standard_normal(shape).astype(np.float32)
                      for _ in range(4))
    k2[:, :18], v2[:, :18] = k1[:, :18], v1[:, :18]   # same prefix, same KV
    p1 = rng.integers(0, CFG.vocab_size, SEQ).astype(np.int32)
    p2 = np.concatenate([p1[:18], rng.integers(0, CFG.vocab_size, SEQ - 18)
                         .astype(np.int32)])
    p2[18] = (p1[18] + 1) % CFG.vocab_size
    (jp_, jd), (tp_, td) = _handoff_engines(params, layout)
    skips = []
    for pipe, p, d, cls in ((JPipe(JTransfer(), JWire("raw", "float32")),
                             jp_, jd, JRequest),
                            (TPipe(TTransfer(), TWire("raw", "float32")),
                             tp_, td, TRequest)):
        h1 = _stream(pipe, cls("a", p1, 4), p, d, k1, v1)
        d.release(h1.slot)
        h2 = _stream(pipe, cls("b", p2, 4), p, d, k2, v2)
        skips.append((h1.wire_skip, h2.wire_skip,
                      pipe.transfer.stats.prefix_hit_tokens,
                      list(h2.block_ids)))
    assert skips[1] == skips[0] and skips[0][1] == 18
    for name in ("k_pool", "v_pool"):
        want = np.asarray(jd.caches[0][0][name])
        got = td.caches[0][0][name].numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), name
    assert td.prefix_store.summary() == jd.prefix_store.summary()

"""The port's sliding-window, MoE and MLA families against the JAX
package's, on the CPU in float32.

Configs: the tiny ``sliding`` (window 8), ``moe`` (4 experts, top 2, one
shared expert, one dense first layer) and ``mla`` (latent 32, nope 16,
rope 8, v 16) of ``tests/conftest.py``, ``MIXTRAL_TINY`` below (MoE over
sliding attention, as Mixtral: window 8, 4 experts, top 2, no shared
expert, no dense layer, 2 KV heads) and ``DEEPSEEK_TINY`` (MoE over MLA,
as DeepSeek-V2-Lite: tiny ``mla``'s attention, ``moe``'s experts, one
dense first layer). MLA's own cases are in tests/test_torch_mla.py. Every
case runs the reference's parameters carried across
(``params_from_numpy``) and holds the port to ``repro``: logits within
atol 1e-4 (XLA's CPU einsum and torch's matmul sum in different orders);
tokens, wire bytes, chunk starts, pools and snapshots identical.

Mirrors the family cases of tests/test_layers.py (ring cache),
tests/test_prefill_families.py (wire sweep, resume, cross-process),
tests/test_chunked_handoff.py (capabilities, no empty chunks, chunked =
monolithic) and tests/test_disagg.py (disagg = integrated), plus D pools
whose rows below the window floor hold NaN.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compat.precision import WireFormat as JWire
from repro.core.disagg import DisaggPipeline as JPipe
from repro.core.kv_transfer import TransferEngine as JTransfer
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import PrefillMode as JMode
from repro.serving.engine import VendorProfile as JVendor
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import GlobalScheduler as JSched
from repro.configs.base import MLAConfig, MoEConfig
from repro_torch.configs.base import config_from_dict
from repro_torch.core.compat.precision import WireFormat
from repro_torch.core.disagg import DisaggPipeline
from repro_torch.core.kv_transfer import TransferEngine
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine, PrefillMode, VendorProfile
from repro_torch.serving.request import Request, State
from repro_torch.serving.scheduler import GlobalScheduler

from conftest import TINY_FAMILIES, tiny

ATOL = 1e-4
MIXTRAL_TINY = tiny("mixtral-tiny", family="moe", attention_kind="sliding",
                    sliding_window=8, num_kv_heads=2,
                    moe=MoEConfig(num_experts=4, num_shared_experts=0,
                                  top_k=2, d_ff_expert=32,
                                  first_dense_layers=0))
DEEPSEEK_TINY = tiny("deepseek-tiny", family="moe", attention_kind="mla",
                     mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                                   qk_rope_head_dim=8, v_head_dim=16),
                     moe=MoEConfig(num_experts=4, num_shared_experts=1,
                                   top_k=2, d_ff_expert=32,
                                   first_dense_layers=1))
CONFIGS = dict(TINY_FAMILIES, **{MIXTRAL_TINY.name: MIXTRAL_TINY,
                                 DEEPSEEK_TINY.name: DEEPSEEK_TINY})
WIRES = [("raw", "float32"), ("raw", "bfloat16"), ("int8", "bfloat16")]
P_VENDOR = dict(block_size=8, layout="nhbd", kv_dtype="float32", tp=2)
D_VENDOR = dict(block_size=4, layout="nbhd", kv_dtype="float32", tp=1)
ENGINE = dict(num_blocks=64, max_batch=4, max_seq_len=64)


@functools.lru_cache(maxsize=None)
def _params(name):
    """(repro cfg, port cfg, repro params, port params), the reference's
    ``init_params(key(1))`` carried across."""
    jcfg = CONFIGS[name]
    jp = JM.init_params(jax.random.key(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, config_from_dict(dataclasses.asdict(jcfg)), jp, tp


def _prompt(cfg, plen, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, plen).astype(np.int32)


def _reqs(cfg, plens, max_new=6, torch_side=True):
    cls = Request if torch_side else JRequest
    return [cls(f"q{i}", _prompt(cfg, n, i), max_new)
            for i, n in enumerate(plens)]


def _pair(name, torch_side=True, vp=P_VENDOR, vd=D_VENDOR):
    jcfg, tcfg, jp, tp = _params(name)
    if torch_side:
        return (Engine("P0", tcfg, tp, VendorProfile("B", **vp),
                       role="prefill", device="cpu", **ENGINE),
                Engine("D0", tcfg, tp, VendorProfile("A", **vd),
                       role="decode", device="cpu", **ENGINE))
    return (JEngine("P0", jcfg, jp, JVendor("B", **vp), role="prefill",
                    **ENGINE),
            JEngine("D0", jcfg, jp, JVendor("A", **vd), role="decode",
                    **ENGINE))


def _serve(name, chunk, plens=(21, 9, 14), torch_side=True, max_ticks=500):
    """Tokens of ``plens`` requests through a P/D pair behind the
    scheduler (``chunk`` None: the monolithic single-tick handoff)."""
    p, d = _pair(name, torch_side)
    if torch_side:
        pipe = DisaggPipeline(TransferEngine(), WireFormat("raw", "float32"))
        sched = GlobalScheduler(pipe, prefill_chunk=chunk, device="cpu")
    else:
        pipe = JPipe(JTransfer(), JWire("raw", "float32"))
        sched = JSched(pipe, prefill_chunk=chunk)
    sched.add_instance(p)
    sched.add_instance(d)
    reqs = _reqs(CONFIGS[name], plens, torch_side=torch_side)
    done = sched.run(reqs, max_ticks=max_ticks)
    assert len(done) == len(reqs)
    return {r.req_id: list(r.output_tokens) for r in reqs}, sched, p


@functools.lru_cache(maxsize=None)
def _ref_tokens(name, chunk=None):
    return _serve(name, chunk, torch_side=False)[0]


# --------------------------------------------------------------------- #
# layers: MoE and the ring cache
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["moe", MIXTRAL_TINY.name,
                                  DEEPSEEK_TINY.name])
def test_moe_route_and_mlp_match_reference(name):
    """Router weights and choices, and the whole MoE MLP (shared expert
    included), on the same tokens and the second group's first layer."""
    jcfg, tcfg, jp, tp = _params(name)
    jm = jax.tree.map(lambda a: a[0], jp["groups"][-1][0]["mlp"])
    tm = jax.tree.map(lambda a: a[0], tp["groups"][-1][0]["mlp"])
    x = np.random.default_rng(4).standard_normal(
        (2, 7, jcfg.d_model)).astype(np.float32)
    jw, ji = JL.moe_route(jm, jcfg, jnp.asarray(x.reshape(-1, jcfg.d_model)))
    tw, ti = TL.moe_route(tm, tcfg, torch.from_numpy(x.reshape(-1,
                                                               jcfg.d_model)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    assert tw.dtype == torch.float32
    ty = TL.moe_mlp(tm, tcfg, torch.from_numpy(x))
    jy = jax.jit(JL.moe_mlp, static_argnums=1)(jm, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    # deterministic combine: the same call gives the same bits
    assert torch.equal(ty, TL.moe_mlp(tm, tcfg, torch.from_numpy(x)))


def test_kv_cache_ring_buffer_sliding_window():
    """Writes past capacity wrap; decode through a window-sized ring
    equals the full forward (and the reference's); a prefill longer than
    the ring keeps its last window at position % capacity, bit for bit as
    the reference's, and -1 positions are dropped."""
    jcfg = tiny("swa", attention_kind="sliding", sliding_window=4,
                num_layers=1)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    jp = JL.init_attention(jax.random.key(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    steps, win = 10, jcfg.sliding_window
    xs = np.array(jax.random.normal(jax.random.key(1),
                                      (1, steps, jcfg.d_model)))
    pos_full = np.arange(steps)[None]
    jref, (jk, jv) = JL.attention_block(jp, jcfg, jnp.asarray(xs),
                                        jnp.asarray(pos_full), causal=True,
                                        window=win)
    tref, (tk, tv) = TL.attention_block(tp, tcfg, torch.from_numpy(xs),
                                        torch.from_numpy(pos_full),
                                        window=win)
    np.testing.assert_allclose(tref.numpy(), np.asarray(jref), atol=ATOL)
    cache = TL.kv_cache_init(1, win, jcfg.num_kv_heads, jcfg.hd,
                             torch.float32, torch.device("cpu"))
    outs = []
    for t in range(steps):
        o, _ = TL.attention_decode(tp, tcfg, torch.from_numpy(xs[:, t:t + 1]),
                                   torch.tensor([[t]]), cache.layer(0),
                                   window=win)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), tref.numpy(),
                               atol=2e-5)
    # the ring from a prefill of 10 positions into 4 slots
    jring = JL.kv_cache_from_prefill(
        JL.kv_cache_init(1, win, jcfg.num_kv_heads, jcfg.hd, jnp.float32),
        jk, jv, jnp.asarray(pos_full))
    tring = TL.kv_cache_from_prefill(
        TL.kv_cache_init(1, win, jcfg.num_kv_heads, jcfg.hd, torch.float32,
                         torch.device("cpu")).layer(0),
        torch.from_numpy(np.asarray(jk)), torch.from_numpy(np.asarray(jv)),
        torch.from_numpy(pos_full))
    np.testing.assert_array_equal(tring.pos.numpy(), np.asarray(jring.pos))
    np.testing.assert_array_equal(tring.k.numpy(), np.asarray(jring.k))
    np.testing.assert_array_equal(tring.v.numpy(), np.asarray(jring.v))
    assert sorted(tring.pos[0].tolist()) == [6, 7, 8, 9]
    # kv_cache_write drops -1 positions (mode="drop")
    before = tring.k.clone()
    TL.kv_cache_write(tring, torch.ones(1, 2, jcfg.num_kv_heads, jcfg.hd),
                      torch.ones(1, 2, jcfg.num_kv_heads, jcfg.hd),
                      torch.tensor([[-1, 10]]))
    assert torch.equal(tring.k[0, [0, 1, 3]], before[0, [0, 1, 3]])
    assert tring.pos[0, 2] == 10 and bool((tring.k[0, 2] == 1).all())


@pytest.mark.parametrize("fam,want", [
    ("dense", (True, False, True, False, True, 0)),
    ("moe", (True, False, True, False, True, 0)),
    ("sliding", (True, True, False, False, True, 8)),
    (MIXTRAL_TINY.name, (True, True, False, False, True, 8)),
    ("mla", (True, False, True, False, True, 0)),
    (DEEPSEEK_TINY.name, (True, False, True, False, True, 0)),
])
def test_prefill_capabilities_rows(fam, want):
    """(incremental, resumable, prefix_cache, encoder_preamble,
    kv_on_wire, window), as the reference declares them."""
    jcfg, tcfg, _, _ = _params(fam)
    for caps in (tcfg.prefill_capabilities(), jcfg.prefill_capabilities()):
        assert (caps.incremental, caps.resumable, caps.prefix_cache,
                caps.encoder_preamble, caps.kv_on_wire, caps.window) == want


# --------------------------------------------------------------------- #
# the wire: floors, chunk starts, bytes
# --------------------------------------------------------------------- #
def _streamed(name, mode, wire, torch_side=True, plen=21, chunk=5):
    """handoff_streamed of one request, then 4 decode steps. Returns
    (tokens, P's compute chunks, meta, the streams' chunk (start, length)
    in order, wire bytes, D's pools)."""
    p, d = _pair(name, torch_side)
    if torch_side:
        pipe = DisaggPipeline(TransferEngine(), WireFormat(*wire))
        req = Request("r0", _prompt(CONFIGS[name], plen, 3), 6)
    else:
        pipe = JPipe(JTransfer(), JWire(*wire))
        req = JRequest("r0", _prompt(CONFIGS[name], plen, 3), 6)
        mode = JMode(mode.value)
    starts = []
    orig = p.prefill_stream

    def spy(*a, **kw):
        stream = orig(*a, **kw)
        nxt = stream.next_chunk

        def next_chunk():
            c = nxt()
            if c is not None:
                starts.append((c["start"], c["length"]))
            return c
        stream.next_chunk = next_chunk
        return stream

    p.prefill_stream = spy
    meta = pipe.handoff_streamed(req, p, d, chunk_tokens=chunk, mode=mode)
    pools = jax.tree.map(np.asarray, d.caches) if not torch_side else \
        [[{k: t.numpy().copy() for k, t in c.items()} for c in g]
         for g in d.caches]
    toks = [meta["first_token"]] + [int(d.decode_step()[0][2])
                                    for _ in range(4)]
    return (toks, p.stats.prefill_chunks, meta, starts,
            pipe.transfer.stats.bytes_moved, pools)


@pytest.mark.parametrize("name", ["sliding", MIXTRAL_TINY.name])
@pytest.mark.parametrize("wire", WIRES, ids=lambda w: "-".join(w))
def test_incremental_equals_monolithic_on_same_wire(name, wire):
    """Chunk-at-a-time compute (window masking over a full-capacity cache)
    emits the tokens of the one-pass compute (ring cache) over the same
    wire; both equal the reference's, chunk for chunk and byte for byte,
    with the D pools the reference leaves on the float32 wire."""
    mono = _streamed(name, PrefillMode.MONOLITHIC, wire)
    inc = _streamed(name, PrefillMode.INCREMENTAL, wire)
    assert inc[0] == mono[0]
    assert mono[1] == 1 and inc[1] == 5                # ceil(21/5) vs one
    for got in (mono, inc):
        mode = PrefillMode.MONOLITHIC if got is mono else \
            PrefillMode.INCREMENTAL
        ref = _streamed(name, mode, wire, torch_side=False)
        assert got[0] == ref[0]
        assert got[3] == ref[3]                         # chunk starts
        assert got[2]["chunks"] == ref[2]["chunks"]
        assert got[4] == ref[4]                         # wire bytes
        if wire != ("raw", "float32"):
            continue     # a bf16 or int8 step may flip on float32 noise
        for tg, jg in zip(got[5], ref[5]):
            for tc, jc in zip(tg, jg):
                for k in tc:
                    np.testing.assert_allclose(tc[k], jc[k], atol=ATOL)
    # the window floor: 13 for 21 tokens under window 8; incremental
    # chunks below it are progress markers (length 0)
    assert mono[3] == [(13, 5), (18, 3)]
    assert inc[3] == [(0, 0), (5, 0), (13, 2), (15, 5), (20, 1)]


def test_no_empty_chunks_for_ring_families():
    """A sliding prompt computes every chunk but ships nothing below the
    window floor: floor 13, chunks [13,16) [16,20) [20,21), and the 3 pure
    compute chunks below it are progress markers that never reach the
    wire."""
    toks, computed, meta, starts, nbytes, _ = _streamed(
        "sliding", PrefillMode.AUTO, ("raw", "float32"), chunk=4)
    assert meta["chunks"] == 3 and computed == 6
    assert starts == [(0, 0), (4, 0), (8, 0), (13, 3), (16, 4), (20, 1)]
    ref = _streamed("sliding", PrefillMode.AUTO, ("raw", "float32"),
                    torch_side=False, chunk=4)
    assert (toks, computed, meta["chunks"], starts, nbytes) == \
        (ref[0], ref[1], ref[2]["chunks"], ref[3], ref[4])


def _ring_package(torch_side):
    """A sliding prefill package as a ring buffer of 8 slots holding
    positions 15..22 of a 23-token prompt at slot position % 8, the
    same random KV on both sides."""
    jcfg = CONFIGS["sliding"]
    rng = np.random.default_rng(4)
    shape = (jcfg.num_layers, 8, jcfg.num_kv_heads, jcfg.hd)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    pos = np.zeros((jcfg.num_layers, 8), np.int32)
    for p in range(15, 23):
        pos[:, p % 8] = p
    ent = {"k": k, "v": v, "pos": pos}
    if torch_side:
        ent = {n: torch.from_numpy(a) for n, a in ent.items()}
    return {"kv": [("kv", 0, 0, ent)], "states": [], "cross": [],
            "first_token": 1, "seq_len": 23}


@pytest.mark.parametrize("layout", ["nbhd", "nhdb"])
@pytest.mark.parametrize("how", ["handoff", "stream"])
def test_ring_package_pools_bit_identical(layout, how):
    """The same ring package through the monolithic handoff, or streamed
    in 5-token chunks from its floor (15: row 3 of D's fourth page), lands
    D pools bit-identical to the reference's."""
    vd = dict(D_VENDOR, layout=layout)
    pools = []
    for torch_side in (False, True):
        p, d = _pair("sliding", torch_side, vd=vd)
        pkg = _ring_package(torch_side)
        p.prefill = lambda _req, pkg=pkg: pkg
        if torch_side:
            pipe = DisaggPipeline(TransferEngine(),
                                  WireFormat("raw", "float32"))
            req, mode = Request("r", np.zeros(23, np.int32), 4), \
                PrefillMode.MONOLITHIC
        else:
            pipe = JPipe(JTransfer(), JWire("raw", "float32"))
            req, mode = JRequest("r", np.zeros(23, np.int32), 4), \
                JMode.MONOLITHIC
        if how == "handoff":
            pipe.handoff(req, p, d)
        else:
            meta = pipe.handoff_streamed(req, p, d, chunk_tokens=5,
                                         mode=mode)
            assert meta["chunks"] == 2                 # [15,20) [20,23)
        pools.append([np.asarray(d.caches[0][0][n]) for n in
                      ("k_pool", "v_pool")])
    for want, got in zip(*pools):
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# --------------------------------------------------------------------- #
# serving: chunked = monolithic, disagg = integrated
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["moe", "sliding", MIXTRAL_TINY.name, "mla",
                                  DEEPSEEK_TINY.name])
def test_chunked_streaming_token_exact_vs_monolithic(name):
    """prefill_chunk=4 (incremental compute, chunked wire) emits the
    monolithic scheduler's tokens, which are the reference's; the wire
    time of non-final chunks hides under the next chunk's compute."""
    out_mono, _, _ = _serve(name, None)
    out_chunk, sched, p = _serve(name, 4)
    assert out_chunk == out_mono == _ref_tokens(name)
    assert sched.stats.chunks_streamed >= 3
    assert p.stats.prefill_chunks > 3
    st = sched.pipeline.transfer.stats
    assert 0 < st.overlap_modeled_seconds < st.modeled_seconds


@pytest.mark.parametrize("name,vp,vd", [
    ("sliding", dict(block_size=4, layout="nhdb", kv_dtype="float32", tp=2),
     dict(block_size=8, layout="nbhd", kv_dtype="float32", tp=4)),
    ("moe", dict(block_size=8, layout="nhbd", kv_dtype="float32", tp=2),
     dict(block_size=4, layout="nbhd", kv_dtype="float32", tp=1)),
    (MIXTRAL_TINY.name,
     dict(block_size=8, layout="nhbd", kv_dtype="float32", tp=2),
     dict(block_size=4, layout="nhdb", kv_dtype="float32", tp=1)),
    ("mla", dict(block_size=4, layout="nhdb", kv_dtype="float32", tp=2),
     dict(block_size=8, layout="nbhd", kv_dtype="float32", tp=1)),
    (DEEPSEEK_TINY.name,
     dict(block_size=8, layout="nhbd", kv_dtype="float32", tp=2),
     dict(block_size=4, layout="nhdb", kv_dtype="float32", tp=1)),
])
def test_disagg_equals_integrated(name, vp, vd):
    """Monolithic handoffs across vendor mismatches (block, layout, TP)
    give an integrated engine's tokens, and the reference's."""
    jcfg, tcfg, jp, tp = _params(name)
    rng = np.random.default_rng(7)
    plens = [int(rng.integers(5, 12)) for _ in range(3)]

    def run(instances, torch_side):
        if torch_side:
            sched = GlobalScheduler(DisaggPipeline(
                TransferEngine(), WireFormat("raw", "float32")), device="cpu")
        else:
            sched = JSched(JPipe(JTransfer(), JWire("raw", "float32")))
        for e in instances:
            sched.add_instance(e)
        reqs = _reqs(jcfg, plens, torch_side=torch_side)
        sched.run(reqs, max_ticks=300)
        assert all(r.done for r in reqs)
        return [list(r.output_tokens) for r in reqs], sched

    out_d, sched = run(_pair(name, True, vp, vd), True)
    assert sched.pipeline.transfer.stats.transfers == 3
    both = Engine("I0", tcfg, tp, VendorProfile("A", block_size=8,
                                                layout="nbhd",
                                                kv_dtype="float32"),
                  role="both", device="cpu", **ENGINE)
    out_i, _ = run([both], True)
    out_j, _ = run(_pair(name, False, vp, vd), False)
    assert out_d == out_i == out_j


# --------------------------------------------------------------------- #
# resume, and stale rows below the floor
# --------------------------------------------------------------------- #
def _d_failure(name, torch_side):
    """Kill the D after two 4-token chunks of a 24-token prompt; the retry
    on the other D resumes from the flight's snapshot."""
    jcfg, tcfg, jp, tp = _params(name)
    vp, vd = P_VENDOR, D_VENDOR
    if torch_side:
        mk = lambda n, v, role: Engine(n, tcfg, tp, VendorProfile(n, **v),
                                       role=role, device="cpu", **ENGINE)
        sched = GlobalScheduler(DisaggPipeline(
            TransferEngine(), WireFormat("raw", "float32")),
            prefill_chunk=4, chunk_budget=1, device="cpu")
        req = Request("rq", _prompt(jcfg, 24, 5), 4)
    else:
        mk = lambda n, v, role: JEngine(n, jcfg, jp, JVendor(n, **v),
                                        role=role, **ENGINE)
        sched = JSched(JPipe(JTransfer(), JWire("raw", "float32")),
                       prefill_chunk=4, chunk_budget=1)
        req = JRequest("rq", _prompt(jcfg, 24, 5), 4)
    p = mk("P0", vp, "prefill")
    for e in (p, mk("D0", vd, "decode"), mk("D1", vd, "decode")):
        sched.add_instance(e)
    sched.submit(req)
    sched.step()
    sched.step()                        # two 4-token chunks computed
    assert len(sched.inflight) == 1
    snap = sched.inflight[0].stream.snapshot()
    sched.inflight[0].d.fail()          # the decode node dies mid-stream
    for _ in range(100):
        if sched.stats.finished >= 1:
            break
        sched.step()
    assert sched.stats.finished == 1 and sched.stats.requeues == 1
    return list(req.output_tokens), p.stats, snap, req.state


@pytest.mark.parametrize("name", ["sliding", MIXTRAL_TINY.name])
def test_d_failure_resumes_from_snapshot(name):
    """The retry reuses the aborted flight's window snapshot: the resumed
    tokens, the snapshot's rows and the output equal the reference's."""
    toks, stats, snap, state = _d_failure(name, True)
    jtoks, jstats, jsnap, _ = _d_failure(name, False)
    assert state == State.FINISHED and toks == jtoks
    assert stats.resumed_tokens == jstats.resumed_tokens > 0
    assert stats.prefill_tokens == jstats.prefill_tokens < 2 * 24
    assert (snap["seq_len"], snap["next_start"], snap["row_start"]) == \
        (jsnap["seq_len"], jsnap["next_start"], jsnap["row_start"])
    assert snap["states"] == [] and len(snap["kv"]) == len(jsnap["kv"])
    for (gi, pi, ent), (jgi, jpi, jent) in zip(snap["kv"], jsnap["kv"]):
        assert (gi, pi) == (jgi, jpi)
        for k in ("k", "v"):
            np.testing.assert_allclose(ent[k].numpy(), jent[k], atol=ATOL)


@pytest.mark.parametrize("name", ["sliding", MIXTRAL_TINY.name])
def test_nan_rows_below_the_floor_decode_finite(name):
    """D pools filled with NaN before a streamed handoff: every row below
    the window floor (whole pages, and the floor's own page up to it)
    stays NaN, and decode still gives finite logits equal to those of a
    zero-filled D."""
    def run(fill):
        p, d = _pair(name)
        for g in d.caches:
            for pools in g:
                for t in pools.values():
                    t.fill_(fill)
        logits = []
        sample = d._sample

        def spy(lg, req):
            logits.append(np.array(lg))
            return sample(lg, req)
        d._sample = spy
        pipe = DisaggPipeline(TransferEngine(), WireFormat("raw", "float32"))
        meta = pipe.handoff_streamed(
            Request("r0", _prompt(CONFIGS[name], 21, 3), 6), p, d,
            chunk_tokens=5)
        toks = [meta["first_token"]] + [int(d.decode_step()[0][2])
                                        for _ in range(4)]
        return toks, np.concatenate(logits), d

    toks_nan, lg_nan, d = run(float("nan"))
    toks_zero, lg_zero, _ = run(0.0)
    bs = d.block_size
    table = d.block_tables[0]
    k0 = d.caches[0][0]["k_pool"][0]                 # layer 0, nbhd
    assert bool(torch.isnan(k0[table[0]]).all())     # a page below the floor
    assert bool(torch.isnan(k0[table[13 // bs], 13 % bs - 1]).all())
    assert np.isfinite(lg_nan).all()
    np.testing.assert_array_equal(lg_nan, lg_zero)
    assert toks_nan == toks_zero


# --------------------------------------------------------------------- #
# the process boundary
# --------------------------------------------------------------------- #
def test_multiproc_chunked_parity_sliding(tmp_path):
    """The sliding family through two spawned CPU worker processes
    (chunked compute, floors, progress markers skipped by P, shm wire)
    gives the reference's single-process tokens."""
    from repro_torch.serving.multiproc import EngineSpec, serve_two_process
    jcfg, tcfg, jp, tp = _params("sliding")
    path = tmp_path / "sliding.pt"
    torch.save(tp, path)
    plens = (21, 9, 14)
    ref = _serve("sliding", 4, plens, torch_side=False)[0]
    common = dict(cfg=tcfg, params_seed=1, device="cpu",
                  params_path=str(path), **ENGINE)
    reqs = _reqs(tcfg, plens)
    tokens, rt = serve_two_process(
        EngineSpec(name="P0", vendor=VendorProfile("B", **P_VENDOR),
                   role="prefill", **common),
        EngineSpec(name="D0", vendor=VendorProfile("A", **D_VENDOR),
                   role="decode", **common),
        reqs, prefill_chunk=4, max_wall_s=300.0)
    assert rt.stats.finished == len(reqs)
    assert tokens == ref

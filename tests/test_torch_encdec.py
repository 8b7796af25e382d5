"""The port's encoder-decoder family (the audio frontend: an encoder over
frame embeddings, decoder layers that cross-attend to its memory) against
the JAX package's, on the CPU in float32.

Config: the tiny ``encdec`` of ``tests/conftest.py`` (2 encoder + 3
decoder layers, d 64, 4 heads of 16), the reference's
``init_params(key(1))`` carried across (``params_from_numpy``). Frames
are drawn from a numpy seed (the frontend is a stub in both packages),
10 a request, and the engines hold ``mem_len`` 10 memory rows, as the
reference's tests do. Tolerances: the cross-attention layer within 1e-5;
the encoder's memory, the memory's cross K/V and the logits within 1e-4;
greedy tokens identical. The tail's bytes and the memory rows D places
from the same package are bit-identical to the reference's.

Mirrors tests/test_chunked_handoff.py (the capability row),
tests/test_prefill_families.py (incremental = monolithic on every wire;
the cross-process pair) and tests/test_disagg.py (enc-dec disagg =
integrated).
"""
import dataclasses
import functools
import os

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
from repro.serving import paged_cache as JPC
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import PrefillMode as JMode
from repro.serving.engine import VendorProfile as JVendor
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import GlobalScheduler as JSched
from repro_torch.configs.base import config_from_dict
from repro_torch.core.compat.precision import WireFormat
from repro_torch.core.disagg import DisaggPipeline
from repro_torch.core.kv_transfer import TransferEngine
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import paged_cache as TPC
from repro_torch.serving.engine import Engine, PrefillMode, VendorProfile
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import GlobalScheduler

from conftest import TINY_FAMILIES

J_INIT = jax.jit(JM.init_params, static_argnums=1)
LAYER_ATOL = 1e-5
ATOL = 1e-4
NAME = "encdec"
MEM = 10                                     # frames a request, mem_len
P_VENDOR = dict(block_size=8, layout="nhbd", kv_dtype="float32", tp=2)
D_VENDOR = dict(block_size=4, layout="nbhd", kv_dtype="float32", tp=1)
ENGINE = dict(num_blocks=64, max_batch=4, max_seq_len=64, mem_len=MEM)
WIRES = [("raw", "float32"), ("raw", "bfloat16"), ("int8", "bfloat16")]
CROSS = ("cross_k", "cross_v", "mem_len")


@functools.lru_cache(maxsize=None)
def _params():
    """(repro cfg, port cfg, repro params, port params). The reference's
    init is jitted (eager, it compiles op by op: twice the time)."""
    jcfg = TINY_FAMILIES[NAME]
    jp = J_INIT(jax.random.key(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, config_from_dict(dataclasses.asdict(jcfg)), jp, tp


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _inputs(plen, seed, mem=MEM):
    """A prompt and its frame embeddings (mem, d), from a numpy seed."""
    rng = np.random.default_rng(seed)
    cfg = TINY_FAMILIES[NAME]
    return (rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            rng.normal(size=(mem, cfg.d_model)).astype(np.float32))


def _req(torch_side, rid, plen, seed, max_new=6):
    prompt, frames = _inputs(plen, seed)
    r = (Request if torch_side else JRequest)(rid, prompt, max_new)
    r.frames = frames
    return r


def _pair(torch_side=True, vp=P_VENDOR, vd=D_VENDOR, prefix_cache=False):
    jcfg, tcfg, jp, tp = _params()
    if torch_side:
        return (Engine("P0", tcfg, tp, VendorProfile("B", **vp),
                       role="prefill", device="cpu",
                       prefix_cache=prefix_cache, **ENGINE),
                Engine("D0", tcfg, tp, VendorProfile("A", **vd),
                       role="decode", device="cpu",
                       prefix_cache=prefix_cache, **ENGINE))
    return (JEngine("P0", jcfg, jp, JVendor("B", **vp), role="prefill",
                    prefix_cache=prefix_cache, **ENGINE),
            JEngine("D0", jcfg, jp, JVendor("A", **vd), role="decode",
                    prefix_cache=prefix_cache, **ENGINE))


def _d_cross(d, slot):
    """D's memory rows of one slot, per (gi, pi), as numpy."""
    return {(gi, pi): {n: np.asarray(c[n])[:, slot] for n in CROSS}
            for gi, g in enumerate(d.caches) for pi, c in enumerate(g)}


def _tail_bytes(cfg, mem, itemsize):
    """Every decoder layer's cross K and V rows and its memory length."""
    return cfg.num_layers * (2 * mem * cfg.num_kv_heads * cfg.hd * itemsize
                             + 4)


def _seed_reference(jp, jcfg, caches, frames):
    """The reference stream's preamble (``PrefillStream._seed_cross``) on
    dense caches: encode, every layer's cross K/V into the memory rows."""
    memory = JM.encode(jp, jcfg, jnp.asarray(frames)[None])
    caches = [list(g) for g in caches]
    for (gi, pi), (mk, mv) in JM.encoder_cross_kv(jp, jcfg, memory).items():
        c = dict(caches[gi][pi])
        n = memory.shape[1]
        c["cross_k"] = c["cross_k"].at[:, :, :n].set(mk)
        c["cross_v"] = c["cross_v"].at[:, :, :n].set(mv)
        c["mem_len"] = jnp.full_like(c["mem_len"], n)
        caches[gi][pi] = c
    return tuple(tuple(g) for g in caches)


# --------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------- #
def _cross_layer():
    jcfg = TINY_FAMILIES[NAME]
    jp = JL.init_cross_attention(jax.random.key(2), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, config_from_dict(dataclasses.asdict(jcfg)), jp, tp


def test_cross_attention_kv_matches_reference():
    """The memory's K and V (no RoPE, no bias), and the cross params'
    names and shapes (no qkv bias, no qk-norm)."""
    jcfg, tcfg, jp, tp = _cross_layer()
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()} == {
            "wq": (64, 4, 16), "wk": (64, 4, 16), "wv": (64, 4, 16),
            "wo": (4, 16, 64)}
    mem = _rand((2, MEM, 64), 1)
    tk, tv = TL.cross_attention_kv(tp, tcfg, torch.from_numpy(mem))
    jk, jv = JL.cross_attention_kv(jp, jcfg, jnp.asarray(mem))
    assert tuple(tk.shape) == jk.shape == (2, MEM, 4, 16)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=LAYER_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=LAYER_ATOL)


@pytest.mark.parametrize("lengths", [None, (10, 6, 0)],
                         ids=["all-rows", "per-row-with-an-idle-row"])
@pytest.mark.parametrize("sq", [1, 5])
def test_cross_attention_matches_reference(sq, lengths):
    """Queries over the memory rows, all of them or each sequence's own
    length — one of them 0, an idle slot, whose row stays finite as the
    reference's does (a finite NEG_INF) — within 1e-5."""
    jcfg, tcfg, jp, tp = _cross_layer()
    x = _rand((3, sq, 64), sq)
    k, v = _rand((3, MEM, 4, 16), 3), _rand((3, MEM, 4, 16), 4)
    ml = None if lengths is None else np.asarray(lengths, np.int32)
    got = TL.cross_attention(tp, tcfg, torch.from_numpy(x),
                             (torch.from_numpy(k), torch.from_numpy(v)),
                             None if ml is None else torch.from_numpy(ml))
    want = JL.cross_attention(jp, jcfg, jnp.asarray(x),
                              (jnp.asarray(k), jnp.asarray(v)),
                              None if ml is None else jnp.asarray(ml))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL)
    assert TL.NEG_INF == JL.NEG_INF


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #
def test_groups_and_params_mirror_reference():
    """The decoder group (cross) and the encoder group (non-causal); every
    parameter's shape and dtype by name as the reference builds them,
    ``enc_groups``, ``enc_norm``, ``cross`` and ``norm_x`` included;
    Whisper-large-v3 is 32 encoder + 32 decoder layers."""
    jcfg, tcfg, jp, tp = _params()
    for mod, cfg in ((TM, tcfg), (JM, jcfg)):
        assert [(g.kinds, g.count, g.cross, g.causal)
                for g in mod.block_groups(cfg)] == [(("attn",), 3, True,
                                                     True)]
        assert [(g.kinds, g.count, g.cross, g.causal)
                for g in mod.encoder_groups(cfg)] == [(("attn",), 2, False,
                                                       False)]
    own = TM.init_params(tcfg, seed=0, device="cpu")
    flat = lambda t: {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)
                                                .replace("torch.", ""))
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(own) == flat(jax.tree.map(np.asarray, jp))
    from repro.configs.base import get_config
    from repro_torch.configs import get_config as tget
    big, jbig = tget("whisper-large-v3"), get_config("whisper-large-v3")
    assert [(g.count, g.cross) for g in TM.block_groups(big)] == \
        [(g.count, g.cross) for g in JM.block_groups(jbig)] == [(32, True)]
    assert [g.count for g in TM.encoder_groups(big)] == [32]


def test_encode_and_encoder_cross_kv_match_reference():
    """The encoder's memory (non-causal, RoPE at 0..S-1, its final norm)
    and every decoder layer's cross K/V of it, stacked (count, B, S, KV,
    hd), within 1e-4."""
    jcfg, tcfg, jp, tp = _params()
    frames = _rand((2, MEM, 64), 6)
    mem = TM.encode(tp, tcfg, torch.from_numpy(frames))
    jmem = JM.encode(jp, jcfg, jnp.asarray(frames))
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), atol=ATOL)
    got = TM.encoder_cross_kv(tp, tcfg, mem)
    want = JM.encoder_cross_kv(jp, jcfg, jmem)
    assert got.keys() == want.keys() == {(0, 0)}
    for t, j in zip(got[(0, 0)], want[(0, 0)]):
        assert tuple(t.shape) == j.shape == (3, 2, MEM, 4, 16)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    # causal would differ: the encoder sees every frame
    causal = _rand((1, MEM, 64), 7)
    a = TM.encode(tp, tcfg, torch.from_numpy(causal))
    b = TM.encode(tp, tcfg, torch.from_numpy(causal[:, :5]))
    assert not torch.allclose(a[:, :5], b, atol=1e-3)


@pytest.mark.parametrize("plen", [5, 12])
def test_prefill_logits_and_cross_rows_match_reference(plen):
    """Prefill with frames: the last logits within 1e-4, the same greedy
    token, the caches' memory rows and lengths."""
    jcfg, tcfg, jp, tp = _params()
    prompt, frames = _inputs(plen, plen)
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)[None],
                                   "frames": jnp.asarray(frames)[None]},
                        JM.init_caches(jcfg, 1, plen, mem_len=MEM))
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(prompt)[None],
                                   "frames": torch.from_numpy(frames)[None]},
                        TM.init_caches(tcfg, 1, plen, device="cpu",
                                       mem_len=MEM))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert int(tl.argmax()) == int(np.asarray(jl).argmax())
    c, j = tc[0][0], jc[0][0]
    assert isinstance(c, TL.CrossKVCache)
    for name in ("cross_k", "cross_v"):
        np.testing.assert_allclose(getattr(c, name).numpy(),
                                   np.asarray(j[name]), atol=ATOL)
    assert np.array_equal(c.mem_len.numpy(), np.asarray(j["mem_len"]))
    np.testing.assert_allclose(c.k.numpy(), np.asarray(j["self"].k),
                               atol=ATOL)


def test_chunked_prefill_equals_monolithic():
    """The encoder preamble (``encode``, ``encoder_cross_kv``,
    ``seed_cross`` into a cache of 12 memory rows, 10 used), then
    ``decode_step`` over chunks of 5, 8 and 1 tokens: each chunk's logits
    equal the reference's chunked logits, and the last one prefill's."""
    jcfg, tcfg, jp, tp = _params()
    prompt, frames = _inputs(19, 3)
    toks = prompt[None]
    mono, _ = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                    "frames": torch.from_numpy(frames)[None]},
                         TM.init_caches(tcfg, 1, 19, device="cpu",
                                        mem_len=MEM))
    tc = TM.init_caches(tcfg, 1, 20, full_capacity=True, device="cpu",
                        mem_len=12)
    memory = TM.encode(tp, tcfg, torch.from_numpy(frames)[None])
    TM.seed_cross(tc, TM.encoder_cross_kv(tp, tcfg, memory), MEM)
    jc = _seed_reference(jp, jcfg, JM.init_caches(
        jcfg, 1, 20, mem_len=12, full_capacity=True), frames)
    for c0, c1 in [(0, 5), (5, 13), (13, 18), (18, 19)]:
        pos = np.arange(c0, c1, dtype=np.int32)[None]
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(toks[:, c0:c1]),
                                torch.from_numpy(pos), tc, q_offset=c0,
                                mem_len=MEM)
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(toks[:, c0:c1]),
                                jnp.asarray(pos), jc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tl[:, -1].numpy(), mono.numpy(), atol=ATOL)


def test_decode_step_paged_with_cross_rows_and_an_idle_slot():
    """One paged decode step over three slots: two with their own memory
    lengths (10 and 6) and KV, one idle (length 0, writing to the scratch
    page). The logits equal the reference's within 1e-4; the idle slot's
    row is finite; the cross rows are read, never written."""
    jcfg, tcfg, jp, tp = _params()
    spec = TPC.KVPageSpec(4, "nbhd", "float32", 4, 16)
    jspec = JPC.KVPageSpec(4, "nbhd", "float32", 4, 16)
    b, nb = 3, 12
    pools = {"k_pool": _rand((3, nb, 4, 4, 16), 1),
             "v_pool": _rand((3, nb, 4, 4, 16), 2),
             "cross_k": _rand((3, b, 12, 4, 16), 3),
             "cross_v": _rand((3, b, 12, 4, 16), 4),
             "mem_len": np.tile(np.asarray([10, 6, 0], np.int32), (3, 1))}
    seq_lens = np.asarray([9, 5, 0], np.int32)
    table = np.asarray([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)
    wb = np.asarray([3, 5, 0], np.int32)
    ws = seq_lens % 4
    toks = np.asarray([[7], [11], [0]], np.int32)
    tcaches = (({n: torch.from_numpy(a.copy()) for n, a in pools.items()},),)
    jcaches = (({n: jnp.asarray(a) for n, a in pools.items()},),)
    tl, tcaches = TM.decode_step_paged(
        tp, tcfg, torch.from_numpy(toks), torch.from_numpy(seq_lens),
        torch.from_numpy(table), torch.from_numpy(wb), torch.from_numpy(ws),
        tcaches, {"kv": spec})
    jl, _ = JM.decode_step_paged(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(seq_lens),
        jnp.asarray(table), jnp.asarray(wb), jnp.asarray(ws), jcaches,
        {"kv": jspec})
    assert bool(torch.isfinite(tl).all())
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], atol=ATOL)
    np.testing.assert_allclose(tl[2].numpy(), np.asarray(jl)[2], atol=ATOL)
    for n in CROSS:
        assert np.array_equal(tcaches[0][0][n].numpy(), pools[n])


def test_prefill_capabilities_row():
    """(incremental, resumable, prefix_cache, encoder_preamble,
    kv_on_wire, window), as the reference declares them; the family check
    admits the tiny config and Whisper-large-v3."""
    from repro_torch.configs import get_config as tget
    from repro_torch.device import check_family
    jcfg, tcfg, _, _ = _params()
    for caps in (tcfg.prefill_capabilities(), jcfg.prefill_capabilities()):
        assert (caps.incremental, caps.resumable, caps.prefix_cache,
                caps.encoder_preamble, caps.kv_on_wire, caps.window) == \
            (True, False, False, True, True, 0)
    check_family(tcfg)
    check_family(tget("whisper-large-v3"))


def test_mem_len_defaults_and_frames_take_no_kv():
    """``Engine(mem_len=0)`` holds the config's ``max_source_len`` memory
    rows per slot, as the reference; frames count in no length: not in
    ``Request.seq_len`` nor in a stream's ``seq_len``."""
    jcfg, tcfg, jp, tp = _params()
    small = dict(ENGINE, mem_len=0, max_batch=2, num_blocks=8)
    eng = Engine("E", tcfg, tp, VendorProfile("A", **D_VENDOR),
                 device="cpu", **small)
    jeng = JEngine("E", jcfg, jp, JVendor("A", **D_VENDOR), **small)
    assert eng.mem_len == jeng.mem_len == tcfg.max_source_len == 1500
    assert tuple(eng.caches[0][0]["cross_k"].shape) == \
        jeng.caches[0][0]["cross_k"].shape == (3, 2, 1500, 4, 16)
    assert eng.paged_pools()[0].keys() == {"k_pool", "v_pool"}
    req = _req(True, "r", 7, 1)
    assert req.seq_len == req.prompt_len == 7
    p, _ = _pair()
    assert p.prefill_stream(req, 4).seq_len == 7


# --------------------------------------------------------------------- #
# the stream, the wire and the tail
# --------------------------------------------------------------------- #
def _streamed(mode, wire, torch_side=True, package=None, plen=21, chunk=5):
    """handoff_streamed of one request (``package``: P's prefill returns
    it, so both packages ship the same values). Returns (meta, tokens of
    4 decode steps, wire bytes, D's slot-0 memory rows, the tail's staged
    bytes, the chunks' starts)."""
    p, d = _pair(torch_side)
    if package is not None:
        p.prefill = lambda _req: package
    if torch_side:
        pipe = DisaggPipeline(TransferEngine(), WireFormat(*wire))
    else:
        pipe = JPipe(JTransfer(), JWire(*wire))
        mode = JMode(mode.value)
    req = _req(torch_side, "r0", plen, 3)
    staged = {}
    stage = pipe.transfer.stage

    def spy_stage(key, payload, meta=None):
        staged[key] = stage(key, payload, meta)
        return staged[key]

    pipe.transfer.stage = spy_stage
    meta = pipe.handoff_streamed(req, p, d, chunk_tokens=chunk, mode=mode)
    rows = _d_cross(d, 0)
    toks = [meta["first_token"]] + [int(d.decode_step()[0][2])
                                    for _ in range(4)]
    tail = sum(n for k, n in staged.items() if k.endswith("tail"))
    return (meta, toks, pipe.transfer.stats.bytes_moved, rows, tail,
            p.stats.prefill_chunks)


@pytest.mark.parametrize("wire", WIRES, ids=lambda w: "-".join(w))
def test_incremental_equals_monolithic_on_same_wire(wire):
    """tests/test_prefill_families.py's enc-dec case on each wire: the
    encoder preamble then 5-token chunks emit the tokens of the one-pass
    prefill (5 compute chunks against 1), and both emit the reference's;
    the tail carries the memory rows of every decoder layer in float32
    whatever the wire (15,372 bytes), as the reference's does."""
    mono = _streamed(PrefillMode.MONOLITHIC, wire)
    inc = _streamed(PrefillMode.INCREMENTAL, wire)
    ref = _streamed(PrefillMode.INCREMENTAL, wire, torch_side=False)
    assert inc[1] == mono[1] == ref[1]
    assert (mono[5], inc[5]) == (1, 5)
    tail = _tail_bytes(TINY_FAMILIES[NAME], MEM, 4)
    assert inc[4] == mono[4] == ref[4] == tail == 15372
    assert inc[2] == ref[2] == inc[0]["bytes"]
    for key in ref[3]:
        for n in CROSS:
            np.testing.assert_allclose(inc[3][key][n], ref[3][key][n],
                                       atol=ATOL)


def _package(torch_side):
    """An enc-dec prefill package of random KV and memory rows (21
    positions, 10 memory rows), the same on both sides."""
    cfg = TINY_FAMILIES[NAME]
    rng = np.random.default_rng(4)
    kv, cross = [], []
    for gi, g in enumerate(JM.block_groups(cfg)):
        shape = (g.count, 21, cfg.num_kv_heads, cfg.hd)
        ent = {"k": rng.standard_normal(shape).astype(np.float32),
               "v": rng.standard_normal(shape).astype(np.float32)}
        mshape = (g.count, MEM, cfg.num_kv_heads, cfg.hd)
        rows = {"cross_k": rng.standard_normal(mshape).astype(np.float32),
                "cross_v": rng.standard_normal(mshape).astype(np.float32),
                "mem_len": np.full((g.count,), MEM, np.int32)}
        if torch_side:
            ent = {n: torch.from_numpy(a) for n, a in ent.items()}
            rows = {n: torch.from_numpy(a) for n, a in rows.items()}
        else:
            ent["pos"] = np.tile(np.arange(21, dtype=np.int32), (g.count, 1))
            rows = {n: jnp.asarray(a) for n, a in rows.items()}
        kv.append(("kv", gi, 0, ent))
        cross.append((gi, 0, rows))
    return {"kv": kv, "states": [], "cross": cross, "first_token": 1,
            "seq_len": 21}


@pytest.mark.parametrize("wire", WIRES, ids=lambda w: "-".join(w))
def test_same_package_lands_bit_identical_cross_rows(wire):
    """One package through the monolithic-compute stream: the tail's
    staged bytes and the wire's are the reference's, and D's placed
    ``cross_k`` / ``cross_v`` / ``mem_len`` rows are bit-identical to the
    reference's and to the package's (the tail rides as it is, no wire
    format applies to it)."""
    got = _streamed(PrefillMode.MONOLITHIC, wire, package=_package(True))
    ref = _streamed(PrefillMode.MONOLITHIC, wire, torch_side=False,
                    package=_package(False))
    assert got[2] == ref[2] and got[4] == ref[4] == 15372
    sent = _package(True)["cross"][0][2]
    assert got[3].keys() == ref[3].keys() == {(0, 0)}
    for n in CROSS:
        a, b = got[3][(0, 0)][n], ref[3][(0, 0)][n]
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), n
        assert np.array_equal(a.view(np.uint32),
                              sent[n].numpy().view(np.uint32)), n


def test_tail_bytes_formula_at_whisper_large_v3():
    """The tail's cross rows: every decoder layer's K and V of the memory
    (layers x mem x KV heads x hd, compute dtype) and one int32 length a
    layer. The reference's tiny tail (float32) holds to the formula, and
    Whisper-large-v3's rows in bf16 come to 32 x 1500 x 20 x 64 x 2 x 2 =
    245,760,000 bytes (plus 32 x 4 bytes of lengths)."""
    from repro_torch.configs import get_config as tget
    cfg = TINY_FAMILIES[NAME]
    jp = _params()[2]
    stream = JEngine("P0", cfg, jp, JVendor("B", **P_VENDOR),
                     role="prefill", **ENGINE).prefill_stream(
        _req(False, "r", 9, 1), 4)
    while stream.next_chunk() is not None:
        pass
    ref = sum(np.asarray(leaf).nbytes for _, _, rows in
              stream.tail_package()["cross"]
              for leaf in jax.tree.leaves(rows))
    assert ref == _tail_bytes(cfg, MEM, 4)
    big = tget("whisper-large-v3")
    rows = TL.cross_rows_init(1, big.max_source_len, big, big.cdtype,
                              torch.device("meta"), count=big.num_layers)
    kv_bytes = sum(rows[n].numel() * rows[n].element_size()
                   for n in ("cross_k", "cross_v"))
    assert kv_bytes == 245_760_000
    assert kv_bytes + rows["mem_len"].numel() * 4 == \
        _tail_bytes(big, 1500, 2) == 245_760_128


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #
PLENS = (21, 9, 14)


def _serve(chunk, torch_side=True, engines=None, vp=P_VENDOR, vd=D_VENDOR):
    if torch_side:
        sched = GlobalScheduler(DisaggPipeline(
            TransferEngine(), WireFormat("raw", "float32")),
            prefill_chunk=chunk, device="cpu")
    else:
        sched = JSched(JPipe(JTransfer(), JWire("raw", "float32")),
                       prefill_chunk=chunk)
    for e in engines or _pair(torch_side, vp, vd):
        sched.add_instance(e)
    reqs = [_req(torch_side, f"q{i}", n, i) for i, n in enumerate(PLENS)]
    assert len(sched.run(reqs, max_ticks=800)) == len(reqs)
    return {r.req_id: list(r.output_tokens) for r in reqs}, sched


@functools.lru_cache(maxsize=None)
def _ref_tokens():
    """The reference's monolithic tokens (its own tests hold its chunked
    streams to them)."""
    return _serve(None, torch_side=False)[0]


@pytest.mark.parametrize("chunk", [None, 4, 7])
def test_serving_tokens_match_reference(chunk):
    """Monolithic and chunked (4, 7) streaming through the scheduler emit
    the reference's tokens; each request ships its prompt's chunks and
    one tail of memory rows."""
    got, sched = _serve(chunk)
    assert got == _ref_tokens()
    if chunk is not None:
        assert sched.stats.chunks_streamed == sum(-(-n // chunk)
                                                  for n in PLENS)


def test_disagg_equals_integrated():
    """tests/test_disagg.py's enc-dec vendors (P: 8 nhbd TP 2, D: 4 nbhd):
    the monolithic handoffs (KV, then the memory rows' tail) give an
    integrated engine's tokens, and the reference's."""
    jcfg, tcfg, jp, tp = _params()
    out_d, sched = _serve(None)
    st = sched.pipeline.transfer.stats
    assert st.transfers == 2 * len(PLENS)        # the KV chunk + the tail
    both = Engine("I0", tcfg, tp, VendorProfile("A", **dict(
        D_VENDOR, block_size=8)), role="both", device="cpu", **ENGINE)
    out_i, _ = _serve(None, engines=[both])
    assert out_d == out_i == _ref_tokens()


def test_prefix_caches_bypass_requests_with_frames():
    """Prefix caches on P and D: one request served alone, then two more
    with the same prompt and frames: none hits (the family's capability
    row has no prefix cache), both stores count every request as a
    bypass, as the reference's do, and the tokens are the reference's."""
    def run(torch_side):
        p, d = _pair(torch_side, prefix_cache=True)
        if torch_side:
            sched = GlobalScheduler(DisaggPipeline(
                TransferEngine(), WireFormat("raw", "float32")),
                prefill_chunk=8, device="cpu")
        else:
            sched = JSched(JPipe(JTransfer(), JWire("raw", "float32")),
                           prefill_chunk=8)
        for e in (p, d):
            sched.add_instance(e)
        reqs = [_req(torch_side, f"a{i}", 20, 5) for i in range(3)]
        sched.run(reqs[:1], max_ticks=300)
        sched.run(reqs[1:], max_ticks=300)
        for _ in range(300):              # run() counts the earlier finish
            if all(r.done for r in reqs):
                break
            sched.step()
        assert not d._prefix_eligible(reqs[0])
        return [list(r.output_tokens) for r in reqs], p, d, sched

    out, p, d, sched = run(True)
    jout, jp_, jd, _ = run(False)
    assert out == jout and out[0] == out[1] == out[2] and len(out[0]) == 6
    assert sched.pipeline.transfer.stats.prefix_hit_tokens == 0
    assert p.stats.prefix_cached_tokens == 0
    assert d.stats.resume_unsupported == jd.stats.resume_unsupported == 3
    assert p.stats.resume_unsupported == jp_.stats.resume_unsupported == 3
    assert len(d.prefix_store) == 0


def test_multiproc_pair_carries_frames_and_mem_len(tmp_path):
    """Tiny enc-dec through two spawned CPU worker processes (chunked
    compute, each request's KV chunks and one tail segment of memory rows
    over shm): ``Request.frames`` reaches P, ``EngineSpec.mem_len`` sizes
    both engines, the tokens are the reference's single-process
    scheduler's, and every segment the run announced is unlinked."""
    from repro_torch.serving.multiproc import EngineSpec, serve_two_process
    jcfg, tcfg, jp, tp = _params()
    path = tmp_path / "encdec.pt"
    torch.save(tp, path)
    ref = _serve(4, torch_side=False)[0]
    common = dict(cfg=tcfg, params_seed=1, device="cpu",
                  params_path=str(path), **ENGINE)
    spec = EngineSpec(name="D0", vendor=VendorProfile("A", **D_VENDOR),
                      role="decode", **common)
    assert spec.mem_len == MEM and spec.build().mem_len == MEM
    reqs = [_req(True, f"q{i}", n, i) for i, n in enumerate(PLENS)]
    tokens, rt = serve_two_process(
        EngineSpec(name="P0", vendor=VendorProfile("B", **P_VENDOR),
                   role="prefill", **common), spec,
        reqs, prefill_chunk=4, max_wall_s=300.0)
    assert rt.stats.finished == len(reqs)
    assert tokens == ref
    chunks = sum(-(-n // 4) for n in PLENS)
    assert len(rt.segments_seen) == chunks + len(reqs)
    assert [n for n in rt.segments_seen
            if os.path.exists(f"/dev/shm/{n}")] == []

"""The port's MLA family (multi-head latent attention, DeepSeek-V2) against
the JAX package's, on the CPU in float32.

Configs: the tiny ``mla`` of ``tests/conftest.py`` (latent 32, nope 16,
rope 8, v 16: q/k 24 wide, v 16) and ``DEEPSEEK_TINY`` of
``tests/test_torch_families.py`` (the same MLA with an MoE of 4 experts,
top 2, one shared, one dense first layer). Parameters are the
reference's ``init_params`` carried across (``params_from_numpy``).

* layers: ``mla_block``, the chunked ``mla_decode`` (the port: latent
  expanded through ``w_ukv``, ``flash_attention_ref``; the reference:
  absorbed, in the latent space) and ``mla_decode_paged`` within 1e-5;
  decode equals the prefill logits (tests/test_layers.py:100);
* the wire: ``WireChunk`` bytes of mixed ``kv``/``mla`` entries identical
  to ``repro``'s on three wires (tests/test_wire.py:51-70, :202); MLA
  ships fewer bytes than dense (tests/test_disagg.py:120);
* pools: re-paged ``ckv_pool``/``kpe_pool`` bit-identical to the
  reference's, streamed equal to monolithic, P nhbd TP 2 → D nbhd
  (tests/test_chunked_handoff.py:58);
* the prefix cache on MLA: cached equals cold, tokens and D pool bits
  after the copy-on-write page copy;
* one spawned P/D pair, tokens equal to the single-process port's;
* the flash wrapper's head-dim rules (dv ≠ dk), which need no card.

Serving tokens of tiny ``mla`` and tiny DeepSeek, chunked and monolithic,
against ``repro``'s are cases of tests/test_torch_families.py.
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
from repro.core.transport.wirefmt import WireChunk as JChunk
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import paged_cache as JPC
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import VendorProfile as JVendor
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import GlobalScheduler as JSched
from repro_torch.configs.base import config_from_dict
from repro_torch.core.compat.precision import WireFormat
from repro_torch.core.disagg import DisaggPipeline
from repro_torch.core.kv_transfer import TransferEngine
from repro_torch.core.transport.wirefmt import WireChunk
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import paged_cache as TPC
from repro_torch.serving.engine import Engine, VendorProfile, page_specs_for
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import GlobalScheduler

from conftest import TINY_FAMILIES
from test_torch_families import DEEPSEEK_TINY

ATOL = 1e-5
CONFIGS = {"mla": TINY_FAMILIES["mla"], "dense": TINY_FAMILIES["dense"],
           DEEPSEEK_TINY.name: DEEPSEEK_TINY}
MODELS = ["mla", DEEPSEEK_TINY.name]
WIRES = [("raw", "float32"), ("raw", "bfloat16"), ("int8", "bfloat16")]
P_VENDOR = dict(block_size=8, layout="nhbd", kv_dtype="float32", tp=2)
D_VENDOR = dict(block_size=4, layout="nbhd", kv_dtype="float32", tp=1)
ENGINE = dict(num_blocks=64, max_batch=4, max_seq_len=64)


@functools.lru_cache(maxsize=None)
def _params(name):
    jcfg = CONFIGS[name]
    jp = JM.init_params(jax.random.key(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, config_from_dict(dataclasses.asdict(jcfg)), jp, tp


def _attn(name):
    """Layer 0's MLA parameters on both sides, and the configs."""
    jcfg, tcfg, jp, tp = _params(name)
    return (jcfg, tcfg, jax.tree.map(lambda a: a[0], jp["groups"][0][0]["attn"]),
            jax.tree.map(lambda a: a[0], tp["groups"][0][0]["attn"]))


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #
def test_init_mla_shapes_and_family_gate():
    """The port draws the reference's shapes; check_family admits MLA
    (tiny, and DeepSeek-V2-Lite at full size)."""
    from repro_torch import configs
    from repro_torch.device import check_family
    jcfg, tcfg, jp, tp = _attn("mla")
    mine = TL.init_mla(torch.Generator().manual_seed(0), tcfg,
                       torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert tuple(mine["wq"].shape) == (64, 4, 24)
    assert tuple(mine["w_ukv"].shape) == (32, 4, 32)
    check_family(tcfg)
    check_family(configs.get_config("deepseek-v2-lite-16b"))


def test_mla_block_matches_reference():
    jcfg, tcfg, jp, tp = _attn("mla")
    x = _x(jcfg, 2, 11, 0)
    pos = np.broadcast_to(np.arange(11), (2, 11))
    jout, (jckv, jkpe) = JL.mla_block(jp, jcfg, jnp.asarray(x),
                                      jnp.asarray(pos))
    tout, (tckv, tkpe) = TL.mla_block(tp, tcfg, torch.from_numpy(x),
                                      torch.from_numpy(pos.copy()))
    _close(tout, jout)
    _close(tckv, jckv)
    _close(tkpe, jkpe)


def test_chunked_mla_decode_expanded_matches_reference_absorbed():
    """Three chunks of a 13-token prompt: the port's expanded route (flash
    at q_offset over the written latent) against the reference's absorbed
    route, outputs and the latent cache."""
    jcfg, tcfg, jp, tp = _attn("mla")
    x = _x(jcfg, 1, 13, 1)
    jc = JL.mla_cache_init(1, 15, jcfg, jnp.float32)
    tc = TL.mla_cache_init(1, 15, tcfg, torch.float32, torch.device("cpu"),
                           full_capacity=True).layer(0)
    for c0 in range(0, 13, 5):
        c1 = min(c0 + 5, 13)
        pos = np.arange(c0, c1, dtype=np.int32)[None]
        jo, jc = JL.mla_decode(jp, jcfg, jnp.asarray(x[:, c0:c1]),
                               jnp.asarray(pos), jc)
        to, tc = TL.mla_decode(tp, tcfg, torch.from_numpy(x[:, c0:c1]),
                               torch.from_numpy(pos), tc, q_offset=c0)
        _close(to, jo)
    _close(tc.ckv, jc.ckv)
    _close(tc.kpe, jc.kpe)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))


def test_mla_decode_refuses_a_cache_without_slot_equals_position():
    jcfg, tcfg, jp, tp = _attn("mla")
    cache = TL.mla_cache_init(1, 8, tcfg, torch.float32,
                              torch.device("cpu")).layer(0)
    with pytest.raises(AssertionError, match="full-capacity"):
        TL.mla_decode(tp, tcfg, torch.from_numpy(_x(jcfg, 1, 4, 2)),
                      torch.arange(4)[None], cache, q_offset=0)


def test_mla_decode_matches_prefill_logits():
    """Mirror of tests/test_layers.py:100: the last token decoded against
    the first six's latent equals the full prefill's last row."""
    jcfg, tcfg, jp, tp = _attn("mla")
    s = 7
    x = torch.from_numpy(_x(jcfg, 1, s, 3))
    pos = torch.arange(s)[None]
    full, (ckv, kpe) = TL.mla_block(tp, tcfg, x, pos)
    cache = TL.mla_cache_init(1, s, tcfg, torch.float32, torch.device("cpu"),
                              full_capacity=True).layer(0)
    TL.mla_cache_write(cache, ckv[:, :s - 1], kpe[:, :s - 1], pos[:, :s - 1])
    dec, _ = TL.mla_decode(tp, tcfg, x[:, -1:], pos[:, -1:], cache,
                           q_offset=s - 1)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               atol=1e-4)


def test_mla_cache_write_and_prefill_match_reference():
    """-1 positions are dropped (``mode="drop"``); a prefill longer than
    the cache keeps its last positions at position % capacity."""
    jcfg, tcfg, _, _ = _attn("mla")
    rng = np.random.default_rng(4)
    ckv = rng.standard_normal((1, 10, 32)).astype(np.float32)
    kpe = rng.standard_normal((1, 10, 8)).astype(np.float32)
    pos = np.arange(10, dtype=np.int32)[None]
    jc = JL.mla_cache_from_prefill(JL.mla_cache_init(1, 4, jcfg, jnp.float32),
                                   jnp.asarray(ckv), jnp.asarray(kpe),
                                   jnp.asarray(pos))
    tc = TL.mla_cache_from_prefill(
        TL.mla_cache_init(1, 4, tcfg, torch.float32,
                          torch.device("cpu")).layer(0),
        torch.from_numpy(ckv), torch.from_numpy(kpe), torch.from_numpy(pos))
    for name in ("ckv", "kpe", "pos"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    new = np.ones((1, 2, 32), np.float32), np.ones((1, 2, 8), np.float32)
    wpos = np.array([[-1, 10]], np.int32)
    jc = JL.mla_cache_write(jc, *map(jnp.asarray, new), jnp.asarray(wpos))
    TL.mla_cache_write(tc, *map(torch.from_numpy, new),
                       torch.from_numpy(wpos))
    for name in ("ckv", "kpe", "pos"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))


@pytest.mark.parametrize("layout", ["nbhd", "nhbd", "nhdb"])
def test_mla_decode_paged_matches_reference(layout):
    """Three sequences of 5, 9 and 14 tokens in latent pools (block 4,
    shuffled pages, a scratch page in the unused columns), one decode
    step: outputs and the appended rows equal the reference's; gathering
    only the live columns (``max_len``) changes nothing."""
    jcfg, tcfg, jp, tp = _attn("mla")
    bs, n = 4, 24
    rng = np.random.default_rng(5)
    ckv_pool = rng.standard_normal((n,) + TPC.KVPageSpec(
        bs, layout, "float32", 1, 32).page_shape()).astype(np.float32)
    kpe_pool = rng.standard_normal((n,) + TPC.KVPageSpec(
        bs, layout, "float32", 1, 8).page_shape()).astype(np.float32)
    lens = np.array([5, 9, 14], np.int32)
    table = np.zeros((3, 6), np.int32)                 # column 0 = scratch
    pages = rng.permutation(np.arange(1, n))
    for i, ln in enumerate(lens):
        nb = -(-(ln + 1) // bs)
        table[i, :nb], pages = pages[:nb], pages[nb:]
    wb = table[np.arange(3), lens // bs]
    ws = lens % bs
    x = _x(jcfg, 3, 1, 6)
    jspec = {k: JPC.KVPageSpec(bs, layout, "float32", 1, d)
             for k, d in (("ckv", 32), ("kpe", 8))}
    tspec = {k: TPC.KVPageSpec(bs, layout, "float32", 1, d)
             for k, d in (("ckv", 32), ("kpe", 8))}
    jo, jpools = JL.mla_decode_paged(
        jp, jcfg, jnp.asarray(x), jnp.asarray(lens[:, None]),
        {"ckv_pool": jnp.asarray(ckv_pool), "kpe_pool": jnp.asarray(kpe_pool)},
        jnp.asarray(table), jnp.asarray(lens), jnp.asarray(wb),
        jnp.asarray(ws), jspec["ckv"], jspec["kpe"])
    for max_len in (None, int(lens.max()) + 1):
        pools = {"ckv_pool": torch.from_numpy(ckv_pool.copy()),
                 "kpe_pool": torch.from_numpy(kpe_pool.copy())}
        to, _ = TL.mla_decode_paged(
            tp, tcfg, torch.from_numpy(x), torch.from_numpy(lens[:, None]),
            pools, torch.from_numpy(table), torch.from_numpy(lens),
            torch.from_numpy(wb), torch.from_numpy(ws), tspec["ckv"],
            tspec["kpe"], max_len=max_len)
        _close(to, jo)
        for name in pools:               # the appended row: computed, so
            _close(pools[name], jpools[name])     # to float32 noise


@pytest.mark.parametrize("name", MODELS)
def test_model_prefill_chunks_and_paged_greedy_match_reference(name):
    """Whole model: prefill logits and latent caches, chunked decode_step
    logits (chunks of 5 over a full-capacity cache), then 8 greedy paged
    decode steps from pools filled with the prompt's latent, all in both
    packages."""
    jcfg, tcfg, jp, tp = _params(name)
    plen, bs = 13, 4
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size,
                                             (1, plen)).astype(np.int32)
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                        JM.init_caches(jcfg, 1, plen))
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                        TM.init_caches(tcfg, 1, plen, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for tg, jg in zip(tc, jc):
        np.testing.assert_allclose(tg[0].ckv.numpy(), np.asarray(jg[0].ckv),
                                   atol=1e-4)
    jd = JM.init_caches(jcfg, 1, 15, full_capacity=True)
    td = TM.init_caches(tcfg, 1, 15, full_capacity=True, device="cpu")
    for c0 in range(0, plen, 5):
        c1 = min(c0 + 5, plen)
        pos = np.arange(c0, c1, dtype=np.int32)[None]
        jcl, jd = JM.decode_step(jp, jcfg, jnp.asarray(toks[:, c0:c1]),
                                 jnp.asarray(pos), jd)
        tcl, td = TM.decode_step(tp, tcfg, torch.from_numpy(toks[:, c0:c1]),
                                 torch.from_numpy(pos), td, q_offset=c0)
        np.testing.assert_allclose(tcl.numpy(), np.asarray(jcl), atol=1e-4)
    jspec = page_specs_for(tcfg, bs, "nhbd", "float32")
    jspec_j = {k: JPC.KVPageSpec(s.block_size, s.layout, s.dtype, s.kv_heads,
                                 s.head_dim) for k, s in jspec.items()}
    jpool = JM.init_paged_caches(jcfg, jspec_j, 16)
    tpool = TM.init_paged_caches(tcfg, jspec, 16, device="cpu")
    blocks = np.arange(1, 7, dtype=np.int32)
    nb = -(-plen // bs)
    for gi, g in enumerate(TM.block_groups(tcfg)):
        for key in ("ckv", "kpe"):
            for li in range(g.count):
                src = np.array(getattr(jc[gi][0], key)[li, 0])[:, None]
                pool = jpool[gi][0][key + "_pool"]
                jpool[gi][0][key + "_pool"] = pool.at[li].set(
                    JPC.scatter_sequence(jspec_j[key], pool[li],
                                         jnp.asarray(blocks[:nb]),
                                         jnp.asarray(src)))
                TPC.scatter_sequence(jspec[key],
                                     tpool[gi][0][key + "_pool"][li],
                                     torch.from_numpy(blocks[:nb]),
                                     torch.from_numpy(src))
    jdecode = jax.jit(lambda p, *a: JM.decode_step_paged(p, jcfg, *a,
                                                         jspec_j))
    jtok = ttok = int(np.argmax(np.asarray(jl)[0]))
    table = blocks[None]
    for step in range(8):
        sl = np.asarray([plen + step], np.int32)
        wb, ws = blocks[sl // bs], (sl % bs).astype(np.int32)
        jlg, jpool = jdecode(jp, jnp.asarray([[jtok]], jnp.int32),
                             jnp.asarray(sl), jnp.asarray(table),
                             jnp.asarray(wb), jnp.asarray(ws), jpool)
        tlg, tpool = TM.decode_step_paged(
            tp, tcfg, torch.tensor([[ttok]], dtype=torch.int32),
            torch.from_numpy(sl), torch.from_numpy(table),
            torch.from_numpy(wb), torch.from_numpy(ws), tpool, jspec,
            max_len=int(sl[0]) + 1)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=1e-4)
        jtok = int(np.argmax(np.asarray(jlg)[0, 0]))
        ttok = int(np.argmax(tlg.numpy()[0, 0]))
        assert jtok == ttok


# --------------------------------------------------------------------- #
# the wire
# --------------------------------------------------------------------- #
def _bytes(chunk) -> bytes:
    buf = bytearray(chunk.nbytes)
    chunk.write_into(buf)
    return bytes(buf)


def _mixed_entries(seed=0):
    """tests/test_wire.py's synthetic entries: a kv entry and an mla
    entry (two parts), both starting at 5."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(3, 13, 4, 8)).astype(np.float32)
    v = rng.normal(size=(3, 13, 4, 8)).astype(np.float32)
    ckv = rng.normal(size=(2, 13, 16)).astype(np.float32)
    kpe = rng.normal(size=(2, 13, 8)).astype(np.float32)
    return [("kv", 0, 0, {"k": k, "v": v, "start": 5}),
            ("mla", 1, 0, {"ckv": ckv, "kpe": kpe, "start": 5})]


@pytest.mark.parametrize("kind,dtype", WIRES)
def test_mixed_kv_and_mla_chunk_bytes_identical(kind, dtype):
    """The segment of a chunk of kv and mla entries equals the
    reference's byte for byte; parsed back, the mla entry's two parts
    decode to its ckv/kpe rows."""
    ents = _mixed_entries()
    jc = JChunk.from_entries(ents, JWire(kind, dtype), 2, seq_len=13)
    tents = [(kd, gi, pi, {n: (a if n == "start" else torch.from_numpy(a))
                           for n, a in e.items()})
             for kd, gi, pi, e in ents]
    wire = WireFormat(kind, dtype)
    tc = WireChunk.from_entries(tents, wire, 2, seq_len=13)
    assert (tc.nbytes, tc.payload_nbytes, tc.header_nbytes) == \
        (jc.nbytes, jc.payload_nbytes, jc.header_nbytes)
    raw = _bytes(tc)
    assert raw == _bytes(jc)
    bound = WireChunk.from_buffer(bytearray(raw))
    kv_e, mla_e = bound.entries()
    assert (mla_e["kind"], mla_e["gi"], mla_e["start"], mla_e["count"],
            mla_e["seq"]) == ("mla", 1, 5, 2, 13)
    assert [p.shape for p in mla_e["payloads"]] == [(26, 1, 16), (26, 1, 8)]
    from repro_torch.core.compat import precision as TP
    for pay, sc, src in zip(mla_e["payloads"], mla_e["scales"],
                            (ents[1][3]["ckv"], ents[1][3]["kpe"])):
        t = TP.host_tensor(np.array(pay), mla_e["dtype"])
        s = None if sc is None else torch.from_numpy(
            np.array(sc)).reshape(-1, 1, 1)
        dec = TP.decode_wire(t, s, wire, torch.float32)
        tol = TP.cast_error_bound(torch.float32, wire) * 4
        np.testing.assert_allclose(dec.reshape(src.shape).numpy(), src,
                                   atol=tol, rtol=tol)
    bound.release()


def _engines(name, torch_side, vp=P_VENDOR, vd=D_VENDOR, **kw):
    jcfg, tcfg, jp, tp = _params(name)
    kw = dict(ENGINE, **kw)
    if torch_side:
        return (Engine("P0", tcfg, tp, VendorProfile("B", **vp),
                       role="prefill", device="cpu", **kw),
                Engine("D0", tcfg, tp, VendorProfile("A", **vd),
                       role="decode", device="cpu", **kw))
    return (JEngine("P0", jcfg, jp, JVendor("B", **vp), role="prefill", **kw),
            JEngine("D0", jcfg, jp, JVendor("A", **vd), role="decode", **kw))


def _pipe(torch_side, wire=("raw", "float32")):
    if torch_side:
        return DisaggPipeline(TransferEngine(), WireFormat(*wire))
    return JPipe(JTransfer(), JWire(*wire))


def _request(torch_side, prompt, max_new=6, rid="r0"):
    return (Request if torch_side else JRequest)(rid, prompt.copy(), max_new)


def _prompt(plen, seed=3):
    return np.random.default_rng(seed).integers(0, 128, plen).astype(np.int32)


def test_mla_ships_fewer_bytes_than_dense():
    """Mirror of tests/test_disagg.py:120: a 13-token prompt streamed in
    5-token chunks ships the latent (32 + 8 per token and layer) in fewer
    bytes than dense K and V (2 x 4 x 16), the same bytes on both
    packages."""
    got = {}
    for fam in ("dense", "mla"):
        for torch_side in (True, False):
            p, d = _engines(fam, torch_side)
            pipe = _pipe(torch_side)
            pipe.handoff_streamed(_request(torch_side, _prompt(13)), p, d,
                                  chunk_tokens=5, chunked_compute=False)
            got[fam, torch_side] = pipe.transfer.stats.bytes_moved
    assert got["mla", True] == got["mla", False]
    assert got["dense", True] == got["dense", False]
    assert got["mla", True] < got["dense", True]


def _latent_package(torch_side, plen=13, seed=4):
    """A prefill package of random latent rows, the same on both sides."""
    cfg = CONFIGS["mla"]
    rng = np.random.default_rng(seed)
    ent = {"ckv": rng.standard_normal((cfg.num_layers, plen, 32)),
           "kpe": rng.standard_normal((cfg.num_layers, plen, 8))}
    ent = {n: (torch.from_numpy(a.astype(np.float32)) if torch_side
               else a.astype(np.float32)) for n, a in ent.items()}
    return {"kv": [("mla", 0, 0, ent)], "states": [], "cross": [],
            "first_token": 1, "seq_len": plen}


def _pools(d):
    return [[{k: np.array(np.asarray(t)) for k, t in c.items()} for c in g]
            for g in d.caches]


@pytest.mark.parametrize("kind,dtype", WIRES)
def test_latent_pools_streamed_equal_monolithic_and_reference(kind, dtype):
    """Mirror of tests/test_chunked_handoff.py:58 for mla: the same latent
    package from a P (nhbd, TP 2) to a D (nbhd, block 4), shipped in one
    chunk or streamed in 5-token chunks (the re-page merges partly covered
    pages): both leave D pools bit-identical to the reference's streamed
    handoff, with the same wire bytes and the same first decode token."""
    out = {}
    for torch_side, chunk in ((True, None), (True, 5), (False, 5)):
        p, d = _engines("mla", torch_side)
        pkg = _latent_package(torch_side)
        p.prefill = lambda _req, pkg=pkg: pkg
        pipe = _pipe(torch_side, (kind, dtype))
        req = _request(torch_side, np.zeros(13, np.int32))
        if chunk is None:
            meta = pipe.handoff(req, p, d)
        else:
            meta = pipe.handoff_streamed(req, p, d, chunk_tokens=chunk,
                                         chunked_compute=False)
            assert meta["chunks"] == 3
        out[torch_side, chunk] = (_pools(d), pipe.transfer.stats.bytes_moved,
                                  int(d.decode_step()[0][2]))
    ref = out[False, 5]
    assert out[True, 5][1] == ref[1]
    assert out[True, None][2] == out[True, 5][2] == ref[2]
    for got in (out[True, None], out[True, 5]):
        for tg, jg in zip(got[0], ref[0]):
            for tc, jc in zip(tg, jg):
                assert sorted(tc) == ["ckv_pool", "kpe_pool"]
                for n in tc:
                    assert np.array_equal(tc[n].view(np.uint32),
                                          jc[n].view(np.uint32)), n


# --------------------------------------------------------------------- #
# the prefix cache on latent pools
# --------------------------------------------------------------------- #
def _prefix_sched(torch_side, prefix_cache):
    p, d = _engines("mla", torch_side, prefix_cache=prefix_cache)
    if torch_side:
        sched = GlobalScheduler(_pipe(True), prefill_chunk=8, device="cpu")
    else:
        sched = JSched(_pipe(False), prefill_chunk=8)
    sched.add_instance(p)
    sched.add_instance(d)
    return sched


def _serve_one_by_one(sched, prompts, torch_side):
    reqs = [_request(torch_side, p, 4, f"q{i}") for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
        for _ in range(400):
            if r.state.name in ("FINISHED", "FAILED"):
                break
            sched.step()
        assert r.state.name == "FINISHED"
    return [list(r.output_tokens) for r in reqs]


def test_prefix_cache_on_latent_pools_cached_equals_cold():
    """Prompts sharing 18 tokens (D block 4: four full pages and a
    copy-on-write copy of the fifth): cached tokens equal cold ones and
    the reference's, and the hit and byte counts equal the reference's."""
    head = _prompt(16)
    prompts = [np.concatenate([head, np.array(t, np.int32)])
               for t in ([7, 9, 11, 13], [7, 9, 20, 21], [7, 9, 11, 30])]
    t = _prefix_sched(True, True)
    got = _serve_one_by_one(t, prompts, True)
    j = _prefix_sched(False, True)
    assert got == _serve_one_by_one(j, prompts, False)
    assert got == _serve_one_by_one(_prefix_sched(True, False), prompts, True)
    tr, jr = t.pipeline.transfer.stats, j.pipeline.transfer.stats
    assert (tr.prefix_hit_tokens, tr.bytes_saved, tr.bytes_moved) == \
        (jr.prefix_hit_tokens, jr.bytes_saved, jr.bytes_moved)
    assert tr.prefix_hit_tokens >= 2 * 16
    assert t.p_pool["P0"].stats.prefix_cached_tokens == \
        j.p_pool["P0"].stats.prefix_cached_tokens > 0


@pytest.mark.parametrize("layout", ["nbhd", "nhdb"])
def test_latent_pools_bit_identical_after_cached_handoffs(layout):
    """A first streamed handoff fills D's store; a second prompt sharing
    18 tokens (16 in full D pages, 2 more in a copy-on-write copy of the
    fifth page through every ``*_pool``) ships only its tail. Both
    packages, fed the same latent rows, leave the same pool bits."""
    seq = 26
    rng = np.random.default_rng(8)
    lat = [{"ckv": rng.standard_normal((3, seq, 32)).astype(np.float32),
            "kpe": rng.standard_normal((3, seq, 8)).astype(np.float32)}
           for _ in range(2)]
    for n in ("ckv", "kpe"):
        lat[1][n][:, :18] = lat[0][n][:, :18]      # same prefix, same rows
    p1 = _prompt(seq, 9)
    p2 = np.concatenate([p1[:18], _prompt(seq - 18, 10)])
    p2[18] = (p1[18] + 1) % 128
    skips, pools = [], []
    for torch_side in (False, True):
        p, d = _engines("mla", torch_side, vd=dict(D_VENDOR, layout=layout),
                        prefix_cache=True)
        pipe = _pipe(torch_side)
        hs = []
        for rid, prompt, rows in (("a", p1, lat[0]), ("b", p2, lat[1])):
            h = pipe.begin_handoff(_request(torch_side, prompt, 4, rid), p,
                                   d, seq)
            for c0 in range(0, seq, 7):
                c1 = min(c0 + 7, seq)
                ent = {n: a[:, c0:c1] for n, a in rows.items()}
                if torch_side:
                    ent = {n: torch.from_numpy(a.copy())
                           for n, a in ent.items()}
                h.send_chunk({"kv": [("mla", 0, 0, dict(ent, start=c0))],
                              "start": c0, "length": c1 - c0})
                h.poll_reads()
            h.finalize(1, {"states": [], "cross": []})
            hs.append(h)
            if rid == "a":
                d.release(h.slot)
        skips.append((hs[0].wire_skip, hs[1].wire_skip,
                      pipe.transfer.stats.prefix_hit_tokens,
                      list(hs[1].block_ids)))
        pools.append(_pools(d)[0][0])
    assert skips[1] == skips[0] and skips[0][1] == 18
    for n in ("ckv_pool", "kpe_pool"):
        assert np.array_equal(pools[1][n].view(np.uint32),
                              pools[0][n].view(np.uint32)), n


# --------------------------------------------------------------------- #
# the process boundary
# --------------------------------------------------------------------- #
def test_spawned_pair_equals_single_process(tmp_path):
    """Tiny mla through one spawned P/D pair of CPU workers (chunked
    compute, latent chunks over the shm wire) gives the single-process
    port's tokens."""
    from repro_torch.serving.multiproc import EngineSpec, serve_two_process
    jcfg, tcfg, jp, tp = _params("mla")
    path = tmp_path / "mla.pt"
    torch.save(tp, path)
    plens = (21, 9, 14)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, n).astype(np.int32) for n in plens]

    def reqs():
        return [Request(f"q{i}", p.copy(), 6) for i, p in enumerate(prompts)]

    sched = GlobalScheduler(DisaggPipeline(
        TransferEngine(), WireFormat("raw", "float32")), prefill_chunk=4,
        device="cpu")
    sched.add_instance(Engine("P0", tcfg, tp, VendorProfile("B", **P_VENDOR),
                              role="prefill", device="cpu", **ENGINE))
    sched.add_instance(Engine("D0", tcfg, tp, VendorProfile("A", **D_VENDOR),
                              role="decode", device="cpu", **ENGINE))
    single = reqs()
    sched.run(single, max_ticks=500)
    common = dict(cfg=tcfg, params_seed=1, device="cpu",
                  params_path=str(path), **ENGINE)
    tokens, rt = serve_two_process(
        EngineSpec(name="P0", vendor=VendorProfile("B", **P_VENDOR),
                   role="prefill", **common),
        EngineSpec(name="D0", vendor=VendorProfile("A", **D_VENDOR),
                   role="decode", **common),
        reqs(), prefill_chunk=4, max_wall_s=300.0)
    assert rt.stats.finished == len(plens)
    assert tokens == {r.req_id: list(r.output_tokens) for r in single}


# --------------------------------------------------------------------- #
# the flash wrapper's head-dim rules (no card needed)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dk,dv,dtype,ok", [
    (192, 128, torch.bfloat16, True), (24, 16, torch.float32, True),
    (128, 128, torch.bfloat16, True), (192, 64, torch.float32, True),
    (208, 128, torch.bfloat16, True), (256, 128, torch.float32, True),
    (192, 144, torch.bfloat16, True), (64, 80, torch.float32, False),
    (24, 16, torch.bfloat16, False), (192, 100, torch.bfloat16, False),
    (256, 256, torch.bfloat16, True), (272, 128, torch.float32, False),
    (256, 272, torch.bfloat16, False)])
def test_flash_wrapper_head_dim_rules(dk, dv, dtype, ok):
    """dv ≠ dk is accepted up to dk 256 (RecurrentGemma's 256 / 256);
    dk > 256 or dv > dk raise, and so do bf16 head dims that are not
    multiples of 16."""
    q = torch.zeros((1, 4, 3, dk), dtype=dtype, device="meta")
    k = torch.zeros((1, 2, 5, dk), dtype=dtype, device="meta")
    v = torch.zeros((1, 2, 5, dv), dtype=dtype, device="meta")
    if ok:
        assert FA.check_shapes(q, k, v) == (dk, dv, 5)
    else:
        with pytest.raises(ValueError):
            FA.check_shapes(q, k, v)

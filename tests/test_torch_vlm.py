"""The port's vision frontend (patch embeddings before the prompt) against
the JAX package's, on the CPU in float32.

Config: the tiny ``vlm`` of ``tests/conftest.py`` (full attention, 4
heads on 2 KV heads, 4 patches), the reference's ``init_params(key(1))``
carried across (``params_from_numpy``). The frontend is a stub in both
packages: a request carries its patch embeddings, drawn here from a
numpy seed. Tolerances: logits within 1e-4, greedy tokens identical,
wire bytes and D's pools bit-identical from the same package.

Mirrors tests/test_disagg.py (vlm disagg = integrated, its patches),
tests/test_chunked_handoff.py (the capability row) and the reference's
prefix-cache gate: a request with patches never takes a cached prompt.
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
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import PrefillMode as JMode
from repro.serving.engine import VendorProfile as JVendor
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import GlobalScheduler as JSched
from repro_torch.configs.base import config_from_dict
from repro_torch.core.compat.precision import WireFormat
from repro_torch.core.disagg import DisaggPipeline
from repro_torch.core.kv_transfer import TransferEngine
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine, PrefillMode, VendorProfile
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import GlobalScheduler

from conftest import TINY_FAMILIES

J_INIT = jax.jit(JM.init_params, static_argnums=1)
ATOL = 1e-4
NAME = "vlm"
NP = TINY_FAMILIES[NAME].frontend.num_patches          # 4
P_VENDOR = dict(block_size=8, layout="nbhd", kv_dtype="float32", tp=2)
D_VENDOR = dict(block_size=4, layout="nhdb", kv_dtype="float32", tp=1)
ENGINE = dict(num_blocks=64, max_batch=4, max_seq_len=64)
WIRES = [("raw", "float32"), ("raw", "bfloat16"), ("int8", "bfloat16")]


@functools.lru_cache(maxsize=None)
def _params():
    """(repro cfg, port cfg, repro params, port params). The reference's
    init is jitted (eager, it compiles op by op: twice the time)."""
    jcfg = TINY_FAMILIES[NAME]
    jp = J_INIT(jax.random.key(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, config_from_dict(dataclasses.asdict(jcfg)), jp, tp


def _inputs(plen, seed):
    """A prompt and its patch embeddings (NP, d), from a numpy seed."""
    rng = np.random.default_rng(seed)
    cfg = TINY_FAMILIES[NAME]
    return (rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            rng.normal(size=(NP, cfg.d_model)).astype(np.float32))


def _req(torch_side, rid, plen, seed, max_new=6, patches=True):
    prompt, pt = _inputs(plen, seed)
    cls = Request if torch_side else JRequest
    return cls(rid, prompt, max_new, patches=pt if patches else None)


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


def _d_pools(d):
    out = {}
    for gi, g in enumerate(d.caches):
        for pi, c in enumerate(g):
            out[(gi, pi)] = {n: np.asarray(t) for n, t in c.items()}
    return out


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #
def test_patches_on_a_text_model_raise():
    """A model without a vision frontend refuses patches instead of
    dropping them: the serving path counts patches in a sequence's
    length, so the embeddings must hold them or nothing runs. Tokens
    alone still embed."""
    cfg = config_from_dict(dataclasses.asdict(TINY_FAMILIES["dense"]))
    params = TM.init_params(cfg, seed=0, device="cpu")
    tokens = torch.zeros((1, 3), dtype=torch.int32)
    patches = torch.zeros((1, NP, cfg.d_model))
    assert TM.merged_embeds(params, cfg, None, tokens).shape \
        == (1, 3, cfg.d_model)
    with pytest.raises(ValueError, match="vision frontend"):
        TM.merged_embeds(params, cfg, patches, tokens)
    caches = TM.init_caches(cfg, 1, 3 + NP, cfg.cdtype, device="cpu")
    with pytest.raises(ValueError, match="vision frontend"):
        TM.prefill(params, cfg, {"tokens": tokens, "patches": patches},
                   caches)


@pytest.mark.parametrize("plen", [5, 21])
def test_merged_prefill_matches_reference(plen):
    """Patches then tokens at positions 0..NP+plen-1: prefill's last
    logits within 1e-4, the same greedy token, and the KV the cache holds
    over both."""
    jcfg, tcfg, jp, tp = _params()
    toks, pt = _inputs(plen, plen)
    s = plen + NP
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)[None],
                                   "patches": jnp.asarray(pt)[None]},
                        JM.init_caches(jcfg, 1, s))
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)[None],
                                   "patches": torch.from_numpy(pt)[None]},
                        TM.init_caches(tcfg, 1, s, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert int(tl.argmax()) == int(np.asarray(jl).argmax())
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(getattr(tc[0][0], name).numpy(),
                                   np.asarray(getattr(jc[0][0], name)),
                                   atol=ATOL)
    # the patches matter: the same tokens alone give other logits
    alone, _ = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)[None]},
                          TM.init_caches(tcfg, 1, plen, device="cpu"))
    assert float((alone - tl).abs().max()) > 1e-2


def test_chunked_prefill_across_the_patch_boundary():
    """decode_step_embeds over 6-position slices of the merged sequence
    (the first chunk spans the 4 patches and 2 tokens) gives the
    reference's chunked logits and prefill's last logits."""
    jcfg, tcfg, jp, tp = _params()
    toks, pt = _inputs(17, 3)
    s = 17 + NP
    mono, _ = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)[None],
                                    "patches": torch.from_numpy(pt)[None]},
                         TM.init_caches(tcfg, 1, s, device="cpu"))
    emb = TM.merged_embeds(tp, tcfg, torch.from_numpy(pt)[None],
                           torch.from_numpy(toks)[None])
    assert tuple(emb.shape) == (1, s, tcfg.d_model)
    jemb = jnp.concatenate([jnp.asarray(pt)[None], JM.embed_tokens(
        jp, jcfg, jnp.asarray(toks)[None])], axis=1)
    tc = TM.init_caches(tcfg, 1, 24, full_capacity=True, device="cpu")
    jc = JM.init_caches(jcfg, 1, 24, full_capacity=True)
    for c0 in range(0, s, 6):
        c1 = min(c0 + 6, s)
        pos = np.arange(c0, c1, dtype=np.int32)[None]
        tl, tc = TM.decode_step_embeds(tp, tcfg, emb[:, c0:c1],
                                       torch.from_numpy(pos), tc, q_offset=c0)
        jl, jc = JM.decode_step_embeds(jp, jcfg, jemb[:, c0:c1],
                                       jnp.asarray(pos), jc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tl[:, -1].numpy(), mono.numpy(), atol=ATOL)


def test_prefill_capabilities_row():
    """(incremental, resumable, prefix_cache, encoder_preamble,
    kv_on_wire), as the reference declares them; the family check admits
    the tiny config and InternVL2-2B."""
    from repro_torch.configs import get_config as tget
    from repro_torch.device import check_family
    jcfg, tcfg, _, _ = _params()
    for caps in (tcfg.prefill_capabilities(), jcfg.prefill_capabilities()):
        assert (caps.incremental, caps.resumable, caps.prefix_cache,
                caps.encoder_preamble, caps.kv_on_wire) == \
            (True, False, False, True, True)
    check_family(tcfg)
    check_family(tget("internvl2-2b"))


# --------------------------------------------------------------------- #
# the sequence length on every route
# --------------------------------------------------------------------- #
def test_seq_len_counts_patches_in_stream_scheduler_and_p_worker():
    """The stream, the scheduler's D pick, the P worker's load estimate
    and D's reservation all count patches + prompt, as the reference."""
    from repro.serving.multiproc.p_worker import _est_tokens as j_est
    from repro_torch.serving.multiproc.p_worker import _est_tokens
    p, d = _pair()
    req = _req(True, "r0", 13, 1)
    jreq = _req(False, "r0", 13, 1)
    assert req.num_patches == NP and _est_tokens(req) == j_est(jreq) == 13 + NP
    jp_, _ = _pair(False)
    assert p.prefill_stream(req, 4).seq_len == \
        jp_.prefill_stream(jreq, 4).seq_len == 13 + NP
    sched = GlobalScheduler(DisaggPipeline(
        TransferEngine(), WireFormat("raw", "float32")), prefill_chunk=4,
        device="cpu")
    for e in (p, d):
        sched.add_instance(e)
    picked = []
    orig = sched._pick_d
    sched._pick_d = lambda r, n: (picked.append(n), orig(r, n))[1]
    reserved = []
    res = d.reserve_sequence
    d.reserve_sequence = lambda r, n, **kw: (reserved.append(n),
                                             res(r, n, **kw))[1]
    sched.run([req], max_ticks=200)
    assert picked[0] == reserved[0] == 13 + NP and req.done
    assert _est_tokens(_req(True, "t", 13, 1, patches=False)) == 13


def test_patches_cross_the_control_queue():
    """The parent's messages to the workers are pickled onto their
    queues: a request's patches arrive whole in ``SubmitPrefill`` (P) and
    ``BeginStream`` (D), and the D reservation's length counts them."""
    import pickle
    from repro_torch.serving.multiproc.messages import (BeginStream,
                                                        SubmitPrefill)
    req = _req(True, "r0", 13, 1)
    for msg in (SubmitPrefill(req), BeginStream(req, 0, 13 + NP)):
        got = pickle.loads(pickle.dumps(msg))
        assert np.array_equal(got.req.patches, req.patches)
        assert got.req.patches.dtype == np.float32
        assert got.req.num_patches == NP
    assert got.seq_len == got.req.prompt_len + got.req.num_patches


# --------------------------------------------------------------------- #
# the wire and D's pools
# --------------------------------------------------------------------- #
def _streamed(mode, wire, torch_side=True, package=None, plen=19, chunk=6):
    """handoff_streamed of one request with patches (``package``: P's
    prefill returns it). Returns (meta, chunk (start, length) in order,
    wire bytes, D's pools)."""
    p, d = _pair(torch_side)
    if package is not None:
        p.prefill = lambda _req: package
    if torch_side:
        pipe = DisaggPipeline(TransferEngine(), WireFormat(*wire))
    else:
        pipe = JPipe(JTransfer(), JWire(*wire))
        mode = JMode(mode.value)
    req = _req(torch_side, "r0", plen, 3)
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
    return meta, starts, pipe.transfer.stats.bytes_moved, _d_pools(d)


@pytest.mark.parametrize("mode", [PrefillMode.MONOLITHIC,
                                  PrefillMode.INCREMENTAL])
@pytest.mark.parametrize("wire", WIRES, ids=lambda w: "-".join(w))
def test_streamed_wire_bytes_match_reference(mode, wire):
    """Computed on each side: chunks over the merged 23 positions (the
    first spans the patches), the same wire bytes, and D's pools within
    1e-4 — plus, on a bf16 or int8 wire, one rounding step of the wire's
    bf16 where the two float32 KVs (1e-6 apart) straddle a rounding
    boundary. The same package lands bit-identical pools (below)."""
    got = _streamed(mode, wire)
    ref = _streamed(mode, wire, torch_side=False)
    assert got[1] == ref[1] == [(0, 6), (6, 6), (12, 6), (18, 5)]
    assert got[0]["chunks"] == ref[0]["chunks"] == 4
    assert got[2] == ref[2] == got[0]["bytes"]
    assert got[0]["seq_len"] == 19 + NP
    step = 0.0 if wire == ("raw", "float32") else 2.0 ** -7
    for key, pools in got[3].items():
        for n, a in pools.items():
            np.testing.assert_allclose(a, ref[3][key][n], atol=ATOL,
                                       rtol=step)


def _package(torch_side):
    """A prefill package of random KV over 23 positions (4 patches, 19
    tokens), the same on both sides."""
    cfg = TINY_FAMILIES[NAME]
    rng = np.random.default_rng(4)
    kv = []
    for gi, g in enumerate(JM.block_groups(cfg)):
        shape = (g.count, 19 + NP, cfg.num_kv_heads, cfg.hd)
        ent = {"k": rng.standard_normal(shape).astype(np.float32),
               "v": rng.standard_normal(shape).astype(np.float32)}
        if torch_side:
            ent = {n: torch.from_numpy(a) for n, a in ent.items()}
        else:
            ent["pos"] = np.tile(np.arange(19 + NP, dtype=np.int32),
                                 (g.count, 1))
        kv.append(("kv", gi, 0, ent))
    return {"kv": kv, "states": [], "cross": [], "first_token": 1,
            "seq_len": 19 + NP}


@pytest.mark.parametrize("wire", WIRES, ids=lambda w: "-".join(w))
def test_same_package_lands_bit_identical_pools(wire):
    """One package through the monolithic-compute stream in 6-position
    chunks: D's pools and the wire bytes are bit-identical to the
    reference's."""
    got = _streamed(PrefillMode.MONOLITHIC, wire, package=_package(True))
    ref = _streamed(PrefillMode.MONOLITHIC, wire, torch_side=False,
                    package=_package(False))
    assert got[1] == ref[1] and got[2] == ref[2]
    for key, pools in got[3].items():
        for n, a in pools.items():
            assert np.array_equal(a.view(np.uint32),
                                  ref[3][key][n].view(np.uint32)), (key, n)


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #
PLENS = (17, 9, 14)


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
    assert len(sched.run(reqs, max_ticks=500)) == len(reqs)
    return {r.req_id: list(r.output_tokens) for r in reqs}, sched


@functools.lru_cache(maxsize=None)
def _ref_tokens():
    return _serve(None, torch_side=False)[0]


@pytest.mark.parametrize("chunk", [None, 6, 7])
def test_serving_tokens_match_reference(chunk):
    """Monolithic and chunked streaming (6: the first chunk spans the
    patch boundary and ends inside the prompt; 7 likewise, off P's pages)
    emit the reference's tokens."""
    got, sched = _serve(chunk)
    assert got == _ref_tokens()
    if chunk is not None:
        assert sched.stats.chunks_streamed == sum(
            -(-(n + NP) // chunk) for n in PLENS)


def test_disagg_equals_integrated():
    """tests/test_disagg.py's vlm vendors (P: 8 nbhd TP 2, D: 4 nhdb):
    the monolithic handoffs give an integrated engine's tokens, and the
    reference's."""
    jcfg, tcfg, jp, tp = _params()
    out_d, _ = _serve(None)
    both = Engine("I0", tcfg, tp, VendorProfile("A", **dict(
        D_VENDOR, block_size=8, layout="nbhd")), role="both", device="cpu",
        **ENGINE)
    out_i, _ = _serve(None, engines=[both])
    assert out_d == out_i == _ref_tokens()


def test_no_prefix_hit_for_a_request_with_patches():
    """Prefix caches on P and D, a text-only request first, then two
    requests whose text is that prompt: neither the one with patches nor
    the text-only one hits (the family's KV is not prefix-cacheable), D's
    store bypasses both and counts them, P's store is never consulted,
    and the tokens are the reference's."""
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
        first = _req(torch_side, "t0", 20, 5, patches=False)
        sched.run([first], max_ticks=300)
        again = [_req(torch_side, "v1", 20, 5),
                 _req(torch_side, "t1", 20, 5, patches=False)]
        assert not d._prefix_eligible(again[0])
        sched.run(again, max_ticks=300)
        out = [list(r.output_tokens) for r in [first] + again]
        return out, p, d, sched

    out, p, d, sched = run(True)
    jout, jp_, jd, _ = run(False)
    assert out == jout
    assert out[1] != out[2]                   # the patches change the text
    assert sched.pipeline.transfer.stats.prefix_hit_tokens == 0
    assert p.stats.prefix_cached_tokens == jp_.stats.prefix_cached_tokens == 0
    assert d.stats.resume_unsupported == jd.stats.resume_unsupported == 3
    assert p.stats.resume_unsupported == jp_.stats.resume_unsupported == 3
    assert len(d.prefix_store) == 0


def test_multiproc_pair_serves_patches(tmp_path):
    """Tiny VLM through two spawned CPU worker processes (chunks of 6
    positions over the merged patch + token sequences, the first spanning
    the boundary, over shm): ``Request.patches`` reaches P across the
    process boundary, the tokens are the reference's single-process
    scheduler's, and every segment the run announced is unlinked."""
    import os
    from repro_torch.serving.multiproc import EngineSpec, serve_two_process
    jcfg, tcfg, jp, tp = _params()
    path = tmp_path / "vlm.pt"
    torch.save(tp, path)
    common = dict(cfg=tcfg, params_seed=1, device="cpu",
                  params_path=str(path), **ENGINE)
    reqs = [_req(True, f"q{i}", n, i) for i, n in enumerate(PLENS)]
    tokens, rt = serve_two_process(
        EngineSpec(name="P0", vendor=VendorProfile("B", **P_VENDOR),
                   role="prefill", **common),
        EngineSpec(name="D0", vendor=VendorProfile("A", **D_VENDOR),
                   role="decode", **common),
        reqs, prefill_chunk=6, max_wall_s=300.0)
    assert rt.stats.finished == len(reqs)
    assert tokens == _serve(6, torch_side=False)[0] == _ref_tokens()
    chunks = sum(-(-(n + NP) // 6) for n in PLENS)
    assert rt.stats.chunks_streamed == chunks
    assert len(rt.segments_seen) == chunks
    assert [n for n in rt.segments_seen
            if os.path.exists(f"/dev/shm/{n}")] == []

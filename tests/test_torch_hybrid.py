"""The port's hybrid RG-LRU family (Griffin / RecurrentGemma) against the
JAX package's, on the CPU in float32.

Config: the tiny ``hybrid`` of ``tests/conftest.py`` (5 layers: (rglru,
rglru, attn) once, then (rglru, rglru); lru width 64, window 8), the
reference's ``init_params(key(1))`` carried across
(``params_from_numpy``). Tolerances: the RG-LRU layers within 1e-5
(elementwise float32; the scan sums in another order than
``associative_scan``), logits within 1e-4 (XLA's CPU einsum and torch's
matmul sum in different orders), greedy tokens identical. Wire bytes,
chunk starts and the states and pools D places from the same package are
bit-identical to the reference's.

Mirrors tests/test_layers.py (rglru decode = block), tests/test_disagg.py
(hybrid disagg = integrated), tests/test_chunked_handoff.py (capability
row), tests/test_prefill_families.py (resume after a D failure, a P
failure discards the snapshot, cross-process parity), and holds the
kernels' shape rules that RecurrentGemma-9B needs (head dim 256, 16 query
heads on one KV head).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RECURRENT, RecurrentConfig
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
from repro_torch.configs.base import config_from_dict
from repro_torch.core.compat.precision import WireFormat
from repro_torch.core.disagg import DisaggPipeline
from repro_torch.core.kv_transfer import TransferEngine
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine, PrefillMode, VendorProfile
from repro_torch.serving.request import Request, State
from repro_torch.serving.scheduler import GlobalScheduler

from conftest import TINY_FAMILIES, tiny

# the reference's layers, compiled once per shape (eager JAX compiles
# every op of every call)
J_BLOCK = jax.jit(JL.rglru_block, static_argnums=1)
J_SCAN = jax.jit(JL._rglru_scan)
J_CONV = jax.jit(JL._causal_conv1d)

LAYER_ATOL = 1e-5
ATOL = 1e-4
NAME = "hybrid"
P_VENDOR = dict(block_size=8, layout="nhbd", kv_dtype="float32", tp=2)
D_VENDOR = dict(block_size=4, layout="nbhd", kv_dtype="float32", tp=1)
ENGINE = dict(num_blocks=64, max_batch=4, max_seq_len=64)


@functools.lru_cache(maxsize=None)
def _params(jcfg=TINY_FAMILIES[NAME]):
    """(repro cfg, port cfg, repro params, port params)."""
    jp = JM.init_params(jax.random.key(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, config_from_dict(dataclasses.asdict(jcfg)), jp, tp


def _layer(width=64, d_model=64, seed=0):
    """One RG-LRU block's params (repro's, carried across) and configs."""
    jcfg = tiny("rg", family="hybrid", num_layers=1, d_model=d_model,
                recurrent=RecurrentConfig(lru_width=width, d_conv=4,
                                          block_pattern=(RECURRENT,)))
    jp = JL.init_rglru(jax.random.key(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, config_from_dict(dataclasses.asdict(jcfg)), jp, tp


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _states(b, w, seed):
    """A nonzero (h, conv tail) for both packages."""
    h, conv = _rand((b, w), seed, 0.5), _rand((b, 3, w), seed + 1)
    return (JL.RGLRUState(h=jnp.asarray(h), conv=jnp.asarray(conv)),
            TL.RGLRUState(h=torch.from_numpy(h), conv=torch.from_numpy(conv)))


def _prompt(cfg, plen, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, plen).astype(np.int32)


def _pair(torch_side=True, vp=P_VENDOR, vd=D_VENDOR):
    jcfg, tcfg, jp, tp = _params()
    if torch_side:
        return (Engine("P0", tcfg, tp, VendorProfile("B", **vp),
                       role="prefill", device="cpu", **ENGINE),
                Engine("D0", tcfg, tp, VendorProfile("A", **vd),
                       role="decode", device="cpu", **ENGINE))
    return (JEngine("P0", jcfg, jp, JVendor("B", **vp), role="prefill",
                    **ENGINE),
            JEngine("D0", jcfg, jp, JVendor("A", **vd), role="decode",
                    **ENGINE))


def _d_states(d, slot):
    """D's recurrent state rows of one slot, per (gi, pi), as numpy."""
    out = {}
    for gi, g in enumerate(JM.block_groups(TINY_FAMILIES[NAME])):
        for pi, kind in enumerate(g.kinds):
            if kind == RECURRENT:
                c = d.caches[gi][pi]
                out[(gi, pi)] = {n: np.asarray(getattr(c, n))[:, slot]
                                 for n in ("h", "conv")}
    return out


def _d_pools(d):
    out = {}
    for gi, g in enumerate(d.caches):
        for pi, c in enumerate(g):
            if isinstance(c, dict):
                out[(gi, pi)] = {n: np.asarray(t) for n, t in c.items()}
    return out


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv1d_matches_reference(with_tail):
    jcfg, tcfg, jp, tp = _layer()
    x = _rand((2, 9, 64), 3)
    tail = _rand((2, 3, 64), 4) if with_tail else None
    want = J_CONV(jnp.asarray(x), jp["conv_w"], jp["conv_b"],
                             None if tail is None else jnp.asarray(tail))
    got = TL._causal_conv1d(torch.from_numpy(x), tp["conv_w"], tp["conv_b"],
                            None if tail is None else torch.from_numpy(tail))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL)


@pytest.mark.parametrize("s", [1, 7, 64, 500])
def test_rglru_scan_matches_reference(s):
    """The log-depth scan from a nonzero h0, at decode (1), odd, power-of-
    two and chunk (500) lengths."""
    a = np.random.default_rng(s).uniform(0.5, 1.0, (2, s, 16)).astype(
        np.float32)
    b = _rand((2, s, 16), s + 1)
    h0 = _rand((2, 16), s + 2)
    want = J_SCAN(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    got = TL._rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(h0))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL)


@pytest.mark.parametrize("s", [1, 7, 64])
def test_rglru_block_matches_reference(s):
    """Output and final state (h float32, conv tail) from a nonzero state."""
    jcfg, tcfg, jp, tp = _layer()
    x = _rand((2, s, 64), s)
    jst, tst = _states(2, 64, s + 10)
    jout, jnew = J_BLOCK(jp, jcfg, jnp.asarray(x), jst)
    tout, tnew = TL.rglru_block(tp, tcfg, torch.from_numpy(x), tst)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               atol=LAYER_ATOL)
    np.testing.assert_allclose(tnew.h.numpy(), np.asarray(jnew.h),
                               atol=LAYER_ATOL)
    np.testing.assert_array_equal(tnew.conv.numpy(), np.asarray(jnew.conv))
    assert tnew.h.dtype == torch.float32


def test_rglru_block_at_full_lru_width():
    """RecurrentGemma-9B's lru width (4096) on a 16-token sequence."""
    jcfg, tcfg, jp, tp = _layer(width=4096, d_model=256, seed=2)
    x = _rand((1, 16, 256), 16)
    jst, tst = _states(1, 4096, 20)
    jout, jnew = J_BLOCK(jp, jcfg, jnp.asarray(x), jst)
    tout, tnew = TL.rglru_block(tp, tcfg, torch.from_numpy(x), tst)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               atol=LAYER_ATOL)
    np.testing.assert_allclose(tnew.h.numpy(), np.asarray(jnew.h),
                               atol=LAYER_ATOL)


def test_rglru_decode_matches_block():
    """Token-by-token decode from a zero state equals the whole block,
    on both packages (tests/test_layers.py's case, at lru width 32)."""
    jcfg, tcfg, jp, tp = _layer(width=32)
    b, s = 2, 8
    x = np.array(jax.random.normal(jax.random.key(1), (b, s, 64)))
    full, _ = TL.rglru_block(tp, tcfg, torch.from_numpy(x),
                             TL.rglru_state_init(b, tcfg, torch.float32,
                                                 torch.device("cpu")).layer(0))
    st = TL.rglru_state_init(b, tcfg, torch.float32,
                             torch.device("cpu")).layer(0)
    outs = []
    for t in range(s):
        o, new = TL.rglru_decode(tp, tcfg, torch.from_numpy(x[:, t:t + 1]),
                                 st)
        TL.state_put(st, new)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=3e-5)
    jfull, _ = J_BLOCK(jp, jcfg, jnp.asarray(x),
                              JL.rglru_state_init(b, jcfg, jnp.float32))
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull),
                               atol=LAYER_ATOL)


def test_rglru_dtypes_in_bfloat16():
    """The reference's dtypes: bf16 weights but float32 ``lam`` and gate
    biases; the state's h float32 and conv tail in the compute dtype;
    the block's output in the compute dtype."""
    jcfg = tiny("rg16", family="hybrid", num_layers=1,
                param_dtype="bfloat16", compute_dtype="bfloat16",
                recurrent=RecurrentConfig(lru_width=32, d_conv=4,
                                          block_pattern=(RECURRENT,)))
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    gen = torch.Generator().manual_seed(0)
    tp = TL.init_rglru(gen, tcfg, torch.device("cpu"))
    jp = JL.init_rglru(jax.random.key(0), jcfg)
    assert {k: str(v.dtype).replace("torch.", "") for k, v in tp.items()} \
        == {k: str(v.dtype) for k, v in jp.items()}
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    carried = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert {k: v.dtype for k, v in carried.items()} == \
        {k: v.dtype for k, v in tp.items()}
    assert all(np.array_equal(carried[k].float().numpy(),
                              np.asarray(jp[k], np.float32)) for k in jp)
    st = TL.rglru_state_init(2, tcfg, tcfg.cdtype,
                             torch.device("cpu")).layer(0)
    assert st.h.dtype == torch.float32 and st.conv.dtype == torch.bfloat16
    out, new = TL.rglru_block(tp, tcfg, torch.randn(2, 3, 64,
                                                    generator=gen).bfloat16(),
                              st)
    assert out.dtype == torch.bfloat16
    assert new.h.dtype == torch.float32 and new.conv.dtype == torch.bfloat16
    # Λ puts a = exp(-8 softplus(Λ)) (a gate of 1) in (0.9, 0.999), as the
    # reference draws it
    a = torch.exp(-8 * torch.nn.functional.softplus(tp["lam"]))
    assert bool(((a > 0.9 - 1e-6) & (a < 0.999 + 1e-6)).all())


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #
def test_block_groups_and_params_mirror_reference():
    """(rglru, rglru, attn) x 1 then (rglru, rglru): the groups, and every
    parameter's shape and dtype by name, as the reference builds them;
    RecurrentGemma-9B's groups are (rglru, rglru, attn) x 12 + (rglru,
    rglru) x 1."""
    jcfg, tcfg, jp, tp = _params()
    assert [(g.kinds, g.count) for g in TM.block_groups(tcfg)] == \
        [(g.kinds, g.count) for g in JM.block_groups(jcfg)]
    own = TM.init_params(tcfg, seed=0, device="cpu")
    flat = lambda t: {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)
                                                .replace("torch.", ""))
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(own) == flat(jax.tree.map(lambda a: np.asarray(a), jp))
    from repro.configs.base import get_config
    from repro_torch.configs import get_config as tget
    assert [(g.kinds, g.count) for g in TM.block_groups(
        tget("recurrentgemma-9b"))] == [
        (g.kinds, g.count) for g in JM.block_groups(
            get_config("recurrentgemma-9b"))] == [
        (("rglru", "rglru", "attn"), 12), (("rglru", "rglru"), 1)]


@pytest.mark.parametrize("plen", [5, 21])
def test_prefill_logits_and_states_match_reference(plen):
    """Prefill's last logits within 1e-4, the same greedy token, and the
    recurrent states and KV the caches hold."""
    jcfg, tcfg, jp, tp = _params()
    toks = _prompt(jcfg, plen, plen)[None]
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                        JM.init_caches(jcfg, 1, plen))
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                        TM.init_caches(tcfg, 1, plen, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert int(tl.argmax()) == int(np.asarray(jl).argmax())
    for jg, tg in zip(jc, tc):
        for j, t in zip(jg, tg):
            for name in vars(t):
                if name == "full_capacity":
                    continue
                np.testing.assert_allclose(
                    getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                    atol=ATOL)


def test_chunked_prefill_equals_monolithic():
    """decode_step over 5-token chunks (states carried, window masked
    over a full-capacity cache) gives prefill's last logits and the
    reference's chunked logits."""
    jcfg, tcfg, jp, tp = _params()
    toks = _prompt(jcfg, 21, 3)[None]
    mono, _ = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                         TM.init_caches(tcfg, 1, 21, device="cpu"))
    tc = TM.init_caches(tcfg, 1, 25, full_capacity=True, device="cpu")
    jc = JM.init_caches(jcfg, 1, 25, full_capacity=True)
    for c0 in range(0, 21, 5):
        c1 = min(c0 + 5, 21)
        pos = np.arange(c0, c1, dtype=np.int32)[None]
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(toks[:, c0:c1]),
                                torch.from_numpy(pos), tc, q_offset=c0)
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(toks[:, c0:c1]),
                                jnp.asarray(pos), jc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tl[:, -1].numpy(), mono.numpy(), atol=ATOL)


# --------------------------------------------------------------------- #
# serving and the wire
# --------------------------------------------------------------------- #
def _serve(chunk, plens=(21, 9, 14), torch_side=True):
    p, d = _pair(torch_side)
    jcfg = TINY_FAMILIES[NAME]
    if torch_side:
        sched = GlobalScheduler(DisaggPipeline(
            TransferEngine(), WireFormat("raw", "float32")),
            prefill_chunk=chunk, device="cpu")
        cls = Request
    else:
        sched = JSched(JPipe(JTransfer(), JWire("raw", "float32")),
                       prefill_chunk=chunk)
        cls = JRequest
    sched.add_instance(p)
    sched.add_instance(d)
    reqs = [cls(f"q{i}", _prompt(jcfg, n, i), 6) for i, n in enumerate(plens)]
    assert len(sched.run(reqs, max_ticks=500)) == len(reqs)
    return {r.req_id: list(r.output_tokens) for r in reqs}, sched


@functools.lru_cache(maxsize=None)
def _ref_tokens():
    """The reference's monolithic tokens (its own tests hold its chunked
    streams to them)."""
    return _serve(None, torch_side=False)[0]


@pytest.mark.parametrize("chunk", [None, 4, 7])
def test_serving_tokens_match_reference(chunk):
    """Monolithic and chunked (4: aligned to P's pages, 7: not) streaming
    through the scheduler emit the reference's tokens: chunked = mono."""
    got, sched = _serve(chunk)
    assert got == _ref_tokens()
    st = sched.pipeline.transfer.stats
    assert st.bytes_moved > 0
    if chunk is not None:
        assert sched.stats.chunks_streamed >= 3


def test_disagg_equals_integrated():
    """tests/test_disagg.py's hybrid vendors (P: 8 nbhd, D: 4 nhbd): the
    monolithic handoffs (KV, then the states' tail) give an integrated
    engine's tokens, and the reference's."""
    jcfg, tcfg, jp, tp = _params()
    vp = dict(block_size=8, layout="nbhd", kv_dtype="float32", tp=1)
    vd = dict(block_size=4, layout="nhbd", kv_dtype="float32", tp=1)
    plens = [int(n) for n in np.random.default_rng(7).integers(5, 12, 3)]

    def run(instances, torch_side):
        if torch_side:
            sched = GlobalScheduler(DisaggPipeline(
                TransferEngine(), WireFormat("raw", "float32")), device="cpu")
            cls = Request
        else:
            sched = JSched(JPipe(JTransfer(), JWire("raw", "float32")))
            cls = JRequest
        for e in instances:
            sched.add_instance(e)
        reqs = [cls(f"q{i}", _prompt(jcfg, n, i), 6)
                for i, n in enumerate(plens)]
        sched.run(reqs, max_ticks=300)
        assert all(r.done for r in reqs)
        return [list(r.output_tokens) for r in reqs], sched

    out_d, sched = run(_pair(True, vp, vd), True)
    assert sched.pipeline.transfer.stats.transfers == 2 * 3   # KV + tail
    both = Engine("I0", tcfg, tp, VendorProfile("A", block_size=8,
                                                layout="nbhd",
                                                kv_dtype="float32"),
                  role="both", device="cpu", **ENGINE)
    out_i, _ = run([both], True)
    out_j, _ = run(_pair(False, vp, vd), False)
    assert out_d == out_i == out_j


def test_prefill_capabilities_row():
    """(incremental, resumable, prefix_cache, encoder_preamble,
    kv_on_wire, window), as the reference declares them."""
    jcfg, tcfg, _, _ = _params()
    for caps in (tcfg.prefill_capabilities(), jcfg.prefill_capabilities()):
        assert (caps.incremental, caps.resumable, caps.prefix_cache,
                caps.encoder_preamble, caps.kv_on_wire, caps.window) == \
            (True, True, False, False, True, 8)


def _streamed(mode, wire, torch_side=True, package=None, plen=21, chunk=5):
    """handoff_streamed of one request (``package``: P's prefill returns
    it, so both packages ship the same values). Returns (meta, chunk
    (start, length) in order, wire bytes, D's slot-0 states, D's pools,
    the tail's staged bytes)."""
    p, d = _pair(torch_side)
    if package is not None:
        p.prefill = lambda _req: package
    if torch_side:
        pipe = DisaggPipeline(TransferEngine(), WireFormat(*wire))
        req = Request("r0", _prompt(TINY_FAMILIES[NAME], plen, 3), 6)
    else:
        pipe = JPipe(JTransfer(), JWire(*wire))
        req = JRequest("r0", _prompt(TINY_FAMILIES[NAME], plen, 3), 6)
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
    staged = {}
    stage = pipe.transfer.stage

    def spy_stage(key, payload, meta=None):
        staged[key] = stage(key, payload, meta)
        return staged[key]

    pipe.transfer.stage = spy_stage
    meta = pipe.handoff_streamed(req, p, d, chunk_tokens=chunk, mode=mode)
    tail = sum(n for k, n in staged.items() if k.endswith("tail"))
    return (meta, starts, pipe.transfer.stats.bytes_moved, _d_states(d, 0),
            _d_pools(d), tail)


WIRES = [("raw", "float32"), ("raw", "bfloat16"), ("int8", "bfloat16")]


@pytest.mark.parametrize("mode", [PrefillMode.MONOLITHIC,
                                  PrefillMode.INCREMENTAL])
@pytest.mark.parametrize("wire", WIRES, ids=lambda w: "-".join(w))
def test_streamed_wire_bytes_and_states_match_reference(mode, wire):
    """Computed on each side: the same chunk starts (window floor 13, the
    incremental chunks below it progress markers), the same wire bytes
    (chunks + the states' tail), the same D slot states within 1e-4, and
    the tail's bytes are exactly the states' arrays."""
    got = _streamed(mode, wire)
    ref = _streamed(mode, wire, torch_side=False)
    assert got[1] == ref[1] and got[0]["chunks"] == ref[0]["chunks"]
    assert got[2] == ref[2]
    for key in ref[3]:
        for n in ("h", "conv"):
            np.testing.assert_allclose(got[3][key][n], ref[3][key][n],
                                       atol=ATOL)
    cfg = TINY_FAMILIES[NAME]
    w = cfg.recurrent.lru_width
    n_states = sum(g.count * g.kinds.count(RECURRENT)
                   for g in JM.block_groups(cfg))
    # h and the conv tail, float32 in this config
    assert got[5] == ref[5] == n_states * (
        w * 4 + (cfg.recurrent.d_conv - 1) * w * 4)
    assert got[2] == got[0]["bytes"]


def _package(torch_side):
    """A hybrid prefill package of random values: the attention layer's
    KV rows of a 23-token prompt (position 0..22) and every recurrent
    position's states, the same on both sides."""
    cfg = TINY_FAMILIES[NAME]
    rng = np.random.default_rng(4)
    kv, states = [], []
    w = cfg.recurrent.lru_width
    for gi, g in enumerate(JM.block_groups(cfg)):
        for pi, kind in enumerate(g.kinds):
            if kind == RECURRENT:
                ent = {"h": rng.standard_normal((g.count, w)),
                       "conv": rng.standard_normal((g.count, 3, w))}
                ent = {n: a.astype(np.float32) for n, a in ent.items()}
                if torch_side:
                    states.append(("state", gi, pi, {
                        n: torch.from_numpy(a) for n, a in ent.items()}))
                else:
                    states.append(("state", gi, pi, JL.RGLRUState(
                        h=jnp.asarray(ent["h"]),
                        conv=jnp.asarray(ent["conv"]))))
                continue
            shape = (g.count, 23, cfg.num_kv_heads, cfg.hd)
            ent = {"k": rng.standard_normal(shape).astype(np.float32),
                   "v": rng.standard_normal(shape).astype(np.float32)}
            if torch_side:
                ent = {n: torch.from_numpy(a) for n, a in ent.items()}
            else:
                ent["pos"] = np.tile(np.arange(23, dtype=np.int32),
                                     (g.count, 1))
            kv.append(("kv", gi, pi, ent))
    return {"kv": kv, "states": states, "cross": [], "first_token": 1,
            "seq_len": 23}


@pytest.mark.parametrize("wire", [("raw", "float32"), ("raw", "bfloat16")],
                         ids=lambda w: "-".join(w))
def test_same_package_lands_bit_identical_states_and_pools(wire):
    """One package through the monolithic-compute stream in 5-token
    chunks: D's placed states and pools are bit-identical to the
    reference's, and so are the wire bytes."""
    got = _streamed(PrefillMode.MONOLITHIC, wire, package=_package(True),
                    plen=23)
    ref = _streamed(PrefillMode.MONOLITHIC, wire, torch_side=False,
                    package=_package(False), plen=23)
    assert got[1] == ref[1] and got[2] == ref[2]
    assert got[3].keys() == ref[3].keys()
    for key in ref[3]:
        for n in ("h", "conv"):
            assert np.array_equal(got[3][key][n].view(np.uint32),
                                  ref[3][key][n].view(np.uint32))
    jpools = ref[4]
    for key, pools in got[4].items():
        for n, a in pools.items():
            assert np.array_equal(a.view(np.uint32),
                                  jpools[key][n].view(np.uint32)), (key, n)


# --------------------------------------------------------------------- #
# snapshot / resume
# --------------------------------------------------------------------- #
def _d_failure(torch_side):
    """Kill the D after two 4-token chunks of a 24-token prompt; the retry
    on the other D resumes from the flight's snapshot."""
    jcfg, tcfg, jp, tp = _params()
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
    p = mk("P0", P_VENDOR, "prefill")
    for e in (p, mk("D0", D_VENDOR, "decode"), mk("D1", D_VENDOR, "decode")):
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


def test_d_failure_resumes_from_snapshot():
    """The retry resumes from the aborted flight's snapshot — the carried
    RG-LRU states and the window's KV rows — and the tokens, resumed
    tokens, the snapshot's states and rows equal the reference's."""
    toks, stats, snap, state = _d_failure(True)
    jtoks, jstats, jsnap, _ = _d_failure(False)
    assert state == State.FINISHED and toks == jtoks
    assert stats.resumed_tokens == jstats.resumed_tokens > 0
    assert stats.prefill_tokens == jstats.prefill_tokens < 2 * 24
    assert (snap["seq_len"], snap["next_start"], snap["row_start"]) == \
        (jsnap["seq_len"], jsnap["next_start"], jsnap["row_start"])
    assert len(snap["states"]) == len(jsnap["states"]) == 4
    for (gi, pi, rows), (jgi, jpi, jst) in zip(snap["states"],
                                               jsnap["states"]):
        assert (gi, pi) == (jgi, jpi)
        for n in ("h", "conv"):
            np.testing.assert_allclose(rows[n].numpy(),
                                       np.asarray(getattr(jst, n)),
                                       atol=ATOL)
    for (gi, pi, ent), (jgi, jpi, jent) in zip(snap["kv"], jsnap["kv"]):
        assert (gi, pi) == (jgi, jpi)
        for k in ("k", "v"):
            np.testing.assert_allclose(ent[k].numpy(), jent[k], atol=ATOL)


def test_snapshot_is_a_copy_of_the_live_states():
    """The snapshot's states do not follow the stream's later chunks."""
    p, _ = _pair()
    stream = p.prefill_stream(Request("r", _prompt(TINY_FAMILIES[NAME], 20,
                                                   1), 2), 4)
    stream.next_chunk()
    snap = stream.snapshot()
    before = [{n: t.clone() for n, t in rows.items()}
              for _, _, rows in snap["states"]]
    stream.next_chunk()
    for (_, _, rows), old in zip(snap["states"], before):
        for n in rows:
            assert torch.equal(rows[n], old[n])


def test_p_failure_discards_snapshot_for_other_p():
    """When the P dies, the retry on another P starts clean (no resumed
    tokens) and still finishes with the reference's tokens."""
    jcfg, tcfg, jp, tp = _params()
    ref_req = JRequest("rq", _prompt(jcfg, 24, 5), 4)
    ref_sched = JSched(JPipe(JTransfer(), JWire("raw", "float32")),
                       prefill_chunk=4)
    for e in _pair(False):
        ref_sched.add_instance(e)
    ref_sched.run([ref_req], max_ticks=200)
    mk = lambda n, v, role: Engine(n, tcfg, tp, VendorProfile(n, **v),
                                   role=role, device="cpu", **ENGINE)
    p0, p1 = mk("P0", P_VENDOR, "prefill"), mk("P1", P_VENDOR, "prefill")
    sched = GlobalScheduler(DisaggPipeline(
        TransferEngine(), WireFormat("raw", "float32")),
        prefill_chunk=4, chunk_budget=1, device="cpu")
    for e in (p0, p1, mk("D0", D_VENDOR, "decode")):
        sched.add_instance(e)
    req = Request("rq", _prompt(jcfg, 24, 5), 4)
    sched.submit(req)
    sched.step()
    sched.step()
    victim = sched.inflight[0].p
    victim.fail()
    for _ in range(100):
        if sched.stats.finished >= 1:
            break
        sched.step()
    assert sched.stats.finished == 1
    survivor = p1 if victim is p0 else p0
    assert survivor.stats.resumed_tokens == 0
    assert list(req.output_tokens) == list(ref_req.output_tokens)


# --------------------------------------------------------------------- #
# the process boundary
# --------------------------------------------------------------------- #
def test_multiproc_pair_ships_the_states_tail(tmp_path):
    """Tiny hybrid through two spawned CPU worker processes (chunked
    compute, window floor, shm wire, one tail segment of states per
    request): the reference's single-process tokens; every segment the
    run announced — the tails among them — is unlinked at the end."""
    import os
    from repro_torch.serving.multiproc import EngineSpec, serve_two_process
    jcfg, tcfg, jp, tp = _params()
    path = tmp_path / "hybrid.pt"
    torch.save(tp, path)
    plens = (21, 9, 14)
    ref = _serve(4, plens, torch_side=False)[0]
    common = dict(cfg=tcfg, params_seed=1, device="cpu",
                  params_path=str(path), **ENGINE)
    reqs = [Request(f"q{i}", _prompt(jcfg, n, i), 6)
            for i, n in enumerate(plens)]
    tokens, rt = serve_two_process(
        EngineSpec(name="P0", vendor=VendorProfile("B", **P_VENDOR),
                   role="prefill", **common),
        EngineSpec(name="D0", vendor=VendorProfile("A", **D_VENDOR),
                   role="decode", **common),
        reqs, prefill_chunk=4, max_wall_s=300.0)
    assert rt.stats.finished == len(reqs)
    assert tokens == ref
    assert len(rt.segments_seen) == rt.stats.chunks_streamed + len(reqs)
    assert [n for n in rt.segments_seen
            if os.path.exists(f"/dev/shm/{n}")] == []


# --------------------------------------------------------------------- #
# what RecurrentGemma-9B needs of the kernels' wrappers (no card needed)
# --------------------------------------------------------------------- #
def test_kernel_shape_rules_take_recurrentgemma():
    """Flash takes dk = dv = 256 in both dtypes; paged takes 16 query heads x 256 on one KV head as two
    blocks of 8 heads; the family check admits the hybrid, SSM, VLM and
    enc-dec families, and enc-dec builds its params on the CPU."""
    from repro_torch.device import check_family
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.paged_attention import launch_plan
    from repro_torch.configs import get_config as tget
    for dt in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 16, 500, 256), dtype=dt, device="meta")
        kv = torch.zeros((1, 1, 8192, 256), dtype=dt, device="meta")
        assert FA.check_shapes(q, kv, kv) == (256, 256, 8192)
    plan = launch_plan(16, 1, 256, 32, 2, 16)
    assert plan["head_split"] == 2 and plan["head_dim"] == 256
    check_family(tget("recurrentgemma-9b"))
    check_family(config_from_dict(dataclasses.asdict(TINY_FAMILIES[NAME])))
    for fam in ("ssm", "vlm"):
        check_family(config_from_dict(dataclasses.asdict(TINY_FAMILIES[fam])))
    encdec = config_from_dict(dataclasses.asdict(TINY_FAMILIES["encdec"]))
    check_family(encdec)
    assert "enc_groups" in TM.init_params(encdec, device="cpu")

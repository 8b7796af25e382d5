"""The port's Mamba-2 SSD family against the JAX package's, on the CPU in
float32.

Config: the tiny ``ssm`` of ``tests/conftest.py`` (3 SSD layers, d 64, 8
heads of 16, d_state 16, one group, chunk 4), the reference's
``init_params(key(1))`` carried across (``params_from_numpy``).
Tolerances: the SSD layer within 1e-5 (float32; the products sum in
another order than XLA's einsums), logits within 1e-4, greedy tokens
identical. Wire bytes, chunk starts, the tail's bytes and the states D
places from the same package are bit-identical to the reference's.

The family ships no KV: its streams send zero-length progress markers,
then one package of no entries that declares the whole length, and the
SSD states ride the tail. Mirrors tests/test_layers.py (ssd decode =
block), tests/test_chunked_handoff.py (the capability row, one chunk
total), tests/test_disagg.py (ssm disagg = integrated) and
tests/test_prefill_families.py (resume after a D failure, the
cross-process pair).
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
from repro_torch.configs.base import SSD, config_from_dict
from repro_torch.core.compat.precision import WireFormat
from repro_torch.core.disagg import DisaggPipeline
from repro_torch.core.kv_transfer import TransferEngine
from repro_torch.core.transport.wirefmt import WireChunk
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine, PrefillMode, VendorProfile
from repro_torch.serving.request import Request, State
from repro_torch.serving.scheduler import GlobalScheduler

from conftest import TINY_FAMILIES

J_INIT = jax.jit(JM.init_params, static_argnums=1)
J_BLOCK = jax.jit(JL.ssd_block, static_argnums=1)
J_DECODE = jax.jit(JL.ssd_decode, static_argnums=1)
J_SEGSUM = jax.jit(JL._segsum_exp)

LAYER_ATOL = 1e-5
ATOL = 1e-4
NAME = "ssm"
P_VENDOR = dict(block_size=8, layout="nhbd", kv_dtype="float32", tp=2)
D_VENDOR = dict(block_size=4, layout="nbhd", kv_dtype="float32", tp=1)
ENGINE = dict(num_blocks=64, max_batch=4, max_seq_len=64)
WIRES = [("raw", "float32"), ("raw", "bfloat16"), ("int8", "bfloat16")]


@functools.lru_cache(maxsize=None)
def _params(jcfg=TINY_FAMILIES[NAME]):
    """(repro cfg, port cfg, repro params, port params). The reference's
    init is jitted (eager, it compiles op by op: twice the time)."""
    jp = J_INIT(jax.random.key(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, config_from_dict(dataclasses.asdict(jcfg)), jp, tp


def _layer(seed=0):
    """One SSD layer's params (repro's, carried across) and configs."""
    jcfg = TINY_FAMILIES[NAME]
    jp = JL.init_ssd(jax.random.key(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, config_from_dict(dataclasses.asdict(jcfg)), jp, tp


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _states(cfg, b, seed, zero=False):
    """An (h, conv tail) for both packages: zero, or drawn from a seed."""
    s = cfg.ssm
    nh = s.n_heads(cfg.d_model)
    conv_dim = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
    h = _rand((b, nh, s.head_dim, s.d_state), seed, 0.5)
    conv = _rand((b, s.d_conv - 1, conv_dim), seed + 1)
    if zero:
        h, conv = np.zeros_like(h), np.zeros_like(conv)
    return (JL.SSMState(h=jnp.asarray(h), conv=jnp.asarray(conv)),
            TL.SSMState(h=torch.from_numpy(h), conv=torch.from_numpy(conv)))


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
    """D's SSD state rows of one slot, per (gi, pi), as numpy."""
    return {(gi, pi): {n: np.asarray(getattr(d.caches[gi][pi], n))[:, slot]
                       for n in ("h", "conv")}
            for gi, g in enumerate(JM.block_groups(TINY_FAMILIES[NAME]))
            for pi, kind in enumerate(g.kinds) if kind == SSD}


def _tail_bytes(cfg, conv_itemsize):
    """Every SSD layer's h (float32) and conv tail, one sequence."""
    s = cfg.ssm
    nh = s.n_heads(cfg.d_model)
    conv_dim = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
    return cfg.num_layers * (nh * s.head_dim * s.d_state * 4
                             + (s.d_conv - 1) * conv_dim * conv_itemsize)


# --------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("q", [1, 4, 7])
def test_segsum_exp_matches_reference(q):
    """exp(cum_i - cum_j) below and on the diagonal, 0 above — and no
    inf or NaN where the upper triangle's exp would overflow."""
    cs = np.cumsum(_rand((2, 3, q), q, 30.0), axis=-1).astype(np.float32)
    got = TL._segsum_exp(torch.from_numpy(cs))
    # relative to each entry; atol only below float32's smallest normal
    # number, which XLA's CPU flushes to zero and torch keeps
    np.testing.assert_allclose(got.numpy(), np.asarray(J_SEGSUM(
        jnp.asarray(cs))), rtol=1e-6, atol=1.2e-38)
    assert bool(torch.isfinite(got).all())
    assert bool((got.triu(1) == 0).all())


@pytest.mark.parametrize("zero_state", [True, False],
                         ids=["zero-state", "nonzero-state"])
@pytest.mark.parametrize("s", [8, 7, 1])
def test_ssd_block_matches_reference(s, zero_state):
    """Output and final state (h float32, conv tail) at S a multiple of
    the chunk (8 = 2 x 4), not one (7: padded to 8) and one token (Q = 1),
    from a zero state and from a nonzero one."""
    jcfg, tcfg, jp, tp = _layer()
    x = _rand((2, s, 64), s)
    jst, tst = _states(jcfg, 2, s + 10, zero=zero_state)
    jout, jnew = J_BLOCK(jp, jcfg, jnp.asarray(x), jst)
    tout, tnew = TL.ssd_block(tp, tcfg, torch.from_numpy(x), tst)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               atol=LAYER_ATOL)
    np.testing.assert_allclose(tnew.h.numpy(), np.asarray(jnew.h),
                               atol=LAYER_ATOL)
    np.testing.assert_array_equal(tnew.conv.numpy(), np.asarray(jnew.conv))
    assert tnew.h.dtype == torch.float32


def test_ssd_decode_matches_block():
    """Token-by-token decode from a nonzero state equals the chunked block
    (the port's), and each step equals the reference's decode step."""
    jcfg, tcfg, jp, tp = _layer(seed=3)
    x = _rand((2, 9, 64), 5)
    _, st0 = _states(jcfg, 2, 6)
    full, fnew = TL.ssd_block(tp, tcfg, torch.from_numpy(x), st0)
    jst, st = _states(jcfg, 2, 6)
    outs = []
    for t in range(9):
        xt = x[:, t:t + 1]
        o, new = TL.ssd_decode(tp, tcfg, torch.from_numpy(xt), st)
        jo, jst = J_DECODE(jp, jcfg, jnp.asarray(xt), jst)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=LAYER_ATOL)
        np.testing.assert_allclose(new.h.numpy(), np.asarray(jst.h),
                                   atol=LAYER_ATOL)
        TL.state_put(st, new)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=LAYER_ATOL)
    np.testing.assert_allclose(st.h.numpy(), fnew.h.numpy(), atol=LAYER_ATOL)


def test_ssd_dtypes_in_bfloat16():
    """The reference's dtypes: bf16 weights but float32 ``a_log``,
    ``d_skip`` and ``dt_bias``; the state's h float32 and conv tail in the
    compute dtype; the block's and the step's output in the compute
    dtype."""
    jcfg = dataclasses.replace(TINY_FAMILIES[NAME], param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    gen = torch.Generator().manual_seed(0)
    tp = TL.init_ssd(gen, tcfg, torch.device("cpu"))
    jp = JL.init_ssd(jax.random.key(0), jcfg)
    assert {k: str(v.dtype).replace("torch.", "") for k, v in tp.items()} \
        == {k: str(v.dtype) for k, v in jp.items()}
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    carried = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert all(np.array_equal(carried[k].float().numpy(),
                              np.asarray(jp[k], np.float32)) for k in jp)
    st = TL.ssm_state_init(2, tcfg, tcfg.cdtype, torch.device("cpu")).layer(0)
    assert st.h.dtype == torch.float32 and st.conv.dtype == torch.bfloat16
    x = torch.randn(2, 6, 64, generator=gen).bfloat16()
    for fn, xs in ((TL.ssd_block, x), (TL.ssd_decode, x[:, :1])):
        out, new = fn(tp, tcfg, xs, st)
        assert out.dtype == torch.bfloat16 and bool(torch.isfinite(
            out.float()).all())
        assert new.h.dtype == torch.float32
        assert new.conv.dtype == torch.bfloat16
    # dt_bias is softplus^-1 of a step in [1e-3, 0.1]; -exp(a_log) in
    # [-16, -1], as the reference draws them
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert bool(((dt > 1e-3 - 1e-6) & (dt < 0.1 + 1e-6)).all())
    assert bool(((tp["a_log"] >= 0) & (tp["a_log"] <= np.log(16) + 1e-6))
                .all())


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #
def test_block_groups_and_params_mirror_reference():
    """One group of SSD layers; every parameter's shape and dtype by name
    as the reference builds them; Mamba2-370M is 48 SSD layers."""
    jcfg, tcfg, jp, tp = _params()
    assert [(g.kinds, g.count) for g in TM.block_groups(tcfg)] == \
        [(g.kinds, g.count) for g in JM.block_groups(jcfg)] == [(("ssd",), 3)]
    own = TM.init_params(tcfg, seed=0, device="cpu")
    flat = lambda t: {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)
                                                .replace("torch.", ""))
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(own) == flat(jax.tree.map(lambda a: np.asarray(a), jp))
    from repro.configs.base import get_config
    from repro_torch.configs import get_config as tget
    assert [(g.kinds, g.count) for g in TM.block_groups(
        tget("mamba2-370m"))] == [
        (g.kinds, g.count) for g in JM.block_groups(
            get_config("mamba2-370m"))] == [(("ssd",), 48)]


@pytest.mark.parametrize("plen", [5, 21])
def test_prefill_logits_and_states_match_reference(plen):
    """Prefill's last logits within 1e-4, the same greedy token, and the
    SSD states (h, conv tail) the caches hold."""
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
            assert isinstance(t, TL.SSMState)
            for name in ("h", "conv"):
                np.testing.assert_allclose(
                    getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                    atol=ATOL)


def test_chunked_prefill_equals_monolithic():
    """decode_step over chunks of 5 and 8 tokens (the chunk scan, states
    carried; 5 pads to a multiple of the chunk size 4), then single-token
    steps (the recurrence), gives prefill's last logits and the
    reference's chunked logits."""
    jcfg, tcfg, jp, tp = _params()
    toks = _prompt(jcfg, 23, 3)[None]
    mono, _ = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                         TM.init_caches(tcfg, 1, 23, device="cpu"))
    tc = TM.init_caches(tcfg, 1, 25, full_capacity=True, device="cpu")
    jc = JM.init_caches(jcfg, 1, 25, full_capacity=True)
    bounds = [(0, 5), (5, 13), (13, 21), (21, 22), (22, 23)]
    for c0, c1 in bounds:
        pos = np.arange(c0, c1, dtype=np.int32)[None]
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(toks[:, c0:c1]),
                                torch.from_numpy(pos), tc, q_offset=c0)
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(toks[:, c0:c1]),
                                jnp.asarray(pos), jc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tl[:, -1].numpy(), mono.numpy(), atol=ATOL)


def test_prefill_capabilities_row():
    """(incremental, resumable, prefix_cache, encoder_preamble,
    kv_on_wire, window), as the reference declares them; the family check
    admits the tiny config and Mamba2-370M."""
    from repro_torch.configs import get_config as tget
    from repro_torch.device import check_family
    jcfg, tcfg, _, _ = _params()
    for caps in (tcfg.prefill_capabilities(), jcfg.prefill_capabilities()):
        assert (caps.incremental, caps.resumable, caps.prefix_cache,
                caps.encoder_preamble, caps.kv_on_wire, caps.window) == \
            (True, True, False, False, False, 0)
    check_family(tcfg)
    check_family(tget("mamba2-370m"))


# --------------------------------------------------------------------- #
# the stream and the wire
# --------------------------------------------------------------------- #
def _stream_packages(torch_side, mode, plen=21, chunk=4):
    p, _ = _pair(torch_side)
    if torch_side:
        req = Request("r0", _prompt(TINY_FAMILIES[NAME], plen, 3), 6)
    else:
        req = JRequest("r0", _prompt(TINY_FAMILIES[NAME], plen, 3), 6)
        mode = JMode(mode.value)
    stream = p.prefill_stream(req, chunk, mode=mode)
    out = []
    while (c := stream.next_chunk()) is not None:
        out.append((len(c["kv"]), c["start"], c["length"]))
    return out, p.stats.prefill_chunks, stream.first_token


@pytest.mark.parametrize("mode", [PrefillMode.MONOLITHIC,
                                  PrefillMode.INCREMENTAL])
def test_markers_then_one_full_length_package(mode):
    """Incremental: a zero-length progress marker for each of the first
    five 4-token chunks of 21, then one package of no entries covering
    [0, 21); monolithic: that one package alone. Both as the reference,
    with the same first token."""
    got = _stream_packages(True, mode)
    assert got == _stream_packages(False, mode)
    if mode is PrefillMode.INCREMENTAL:
        assert got[0] == [(0, c0, 0) for c0 in range(0, 20, 4)] + \
            [(0, 0, 21)]
        assert got[1] == 6
    else:
        assert got[0] == [(0, 0, 21)] and got[1] == 1


def _streamed(mode, wire, torch_side=True, package=None, plen=21, chunk=4):
    """handoff_streamed of one request (``package``: P's prefill returns
    it, so both packages ship the same values). Returns (meta, wire
    bytes, D's slot-0 states, the tail's staged bytes, the chunks'
    staged bytes, the wire's payload bytes)."""
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
    staged = {}
    stage = pipe.transfer.stage

    def spy_stage(key, payload, meta=None):
        staged[key] = stage(key, payload, meta)
        return staged[key]

    pipe.transfer.stage = spy_stage
    meta = pipe.handoff_streamed(req, p, d, chunk_tokens=chunk, mode=mode)
    tail = sum(n for k, n in staged.items() if k.endswith("tail"))
    return (meta, pipe.transfer.stats.bytes_moved, _d_states(d, 0), tail,
            sum(staged.values()) - tail, pipe.transfer.stats.payload_bytes)


@pytest.mark.parametrize("mode", [PrefillMode.MONOLITHIC,
                                  PrefillMode.INCREMENTAL])
@pytest.mark.parametrize("wire", WIRES, ids=lambda w: "-".join(w))
def test_streamed_wire_and_tail_bytes_match_reference(mode, wire):
    """Computed on each side: one chunk of a header and no payload (the
    wire's payload is the tail alone), the same wire bytes, the tail
    exactly every layer's h and conv tail (float32 here), and the same D
    slot states within 1e-4."""
    got = _streamed(mode, wire)
    ref = _streamed(mode, wire, torch_side=False)
    assert got[0]["chunks"] == ref[0]["chunks"] == 1
    assert got[1] == ref[1] == got[0]["bytes"]
    assert got[3] == ref[3] == _tail_bytes(TINY_FAMILIES[NAME], 4)
    empty = WireChunk.from_entries([], WireFormat(*wire), 2, seq_len=21)
    assert got[4] == empty.nbytes and got[5] == got[3]
    for key in ref[2]:
        for n in ("h", "conv"):
            np.testing.assert_allclose(got[2][key][n], ref[2][key][n],
                                       atol=ATOL)


def _package(torch_side):
    """An SSM prefill package of random states, the same on both sides."""
    cfg = TINY_FAMILIES[NAME]
    s = cfg.ssm
    rng = np.random.default_rng(4)
    nh = s.n_heads(cfg.d_model)
    conv_dim = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
    states = []
    for gi, g in enumerate(JM.block_groups(cfg)):
        ent = {"h": rng.standard_normal((g.count, nh, s.head_dim,
                                         s.d_state)),
               "conv": rng.standard_normal((g.count, s.d_conv - 1,
                                            conv_dim))}
        ent = {n: a.astype(np.float32) for n, a in ent.items()}
        if torch_side:
            states.append(("state", gi, 0, {n: torch.from_numpy(a)
                                            for n, a in ent.items()}))
        else:
            states.append(("state", gi, 0, JL.SSMState(
                h=jnp.asarray(ent["h"]), conv=jnp.asarray(ent["conv"]))))
    return {"kv": [], "states": states, "cross": [], "first_token": 1,
            "seq_len": 21}


@pytest.mark.parametrize("wire", WIRES, ids=lambda w: "-".join(w))
def test_same_package_lands_bit_identical_states(wire):
    """One package through the monolithic-compute stream: D's placed
    states are bit-identical to the reference's on every wire (the states
    ride the tail as they are), and so are the wire bytes."""
    got = _streamed(PrefillMode.MONOLITHIC, wire, package=_package(True))
    ref = _streamed(PrefillMode.MONOLITHIC, wire, torch_side=False,
                    package=_package(False))
    assert got[1] == ref[1] and got[3] == ref[3]
    assert got[2].keys() == ref[2].keys()
    for key in ref[2]:
        for n in ("h", "conv"):
            assert np.array_equal(got[2][key][n].view(np.uint32),
                                  ref[2][key][n].view(np.uint32))


def test_tail_bytes_formula_at_mamba2_370m():
    """The tail's bytes: every layer's h (H x P x N float32) and conv tail
    ((d_conv - 1) x conv width, compute dtype). The reference's tiny tail
    (float32) holds to the formula, and Mamba2-370M's states in bf16 come
    to 48 x (32 x 64 x 128 x 4 + 3 x 2304 x 2) = 50,995,200 bytes."""
    from repro_torch.configs import get_config as tget
    cfg = TINY_FAMILIES[NAME]
    jp = _params()[2]
    stream = JEngine("P0", cfg, jp, JVendor("B", **P_VENDOR),
                     role="prefill", **ENGINE).prefill_stream(
        JRequest("r", _prompt(cfg, 9, 1), 2), 4)
    while stream.next_chunk() is not None:
        pass
    ref = sum(np.asarray(leaf).nbytes for _, _, _, st in
              stream.tail_package()["states"]
              for leaf in jax.tree.leaves(st))
    assert ref == _tail_bytes(cfg, 4)
    big = tget("mamba2-370m")
    st = TL.ssm_state_init(1, big, big.cdtype, torch.device("meta"),
                           count=big.num_layers)
    assert st.h.numel() * 4 + st.conv.numel() * st.conv.element_size() == \
        _tail_bytes(big, 2) == 50_995_200


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #
def _serve(chunk, plens=(21, 9, 14), torch_side=True, vp=P_VENDOR,
           vd=D_VENDOR, engines=None):
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
    for e in engines or _pair(torch_side, vp, vd):
        sched.add_instance(e)
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
    """Monolithic and chunked (4, 7) streaming through the scheduler emit
    the reference's tokens; a chunked stream sends one chunk a request
    and counts its markers."""
    got, sched = _serve(chunk)
    assert got == _ref_tokens()
    if chunk is not None:
        assert sched.stats.chunks_streamed == 3
        p = sched.p_pool["P0"]
        assert p.stats.prefill_chunks == sum(-(-n // chunk)
                                             for n in (21, 9, 14))


def test_disagg_equals_integrated():
    """tests/test_disagg.py's ssm vendors (P and D: 8 nbhd): the
    monolithic handoffs (an empty chunk, then the states' tail) give an
    integrated engine's tokens, and the reference's."""
    jcfg, tcfg, jp, tp = _params()
    v = dict(block_size=8, layout="nbhd", kv_dtype="float32", tp=1)
    out_d, sched = _serve(None, torch_side=True, vp=v, vd=v)
    st = sched.pipeline.transfer.stats
    assert st.transfers == 2 * 3                 # an empty chunk + the tail
    assert st.payload_bytes == 3 * _tail_bytes(jcfg, 4)      # no KV byte
    both = Engine("I0", tcfg, tp, VendorProfile("A", **v), role="both",
                  device="cpu", **ENGINE)
    out_i, _ = _serve(None, engines=[both])
    out_j, _ = _serve(None, torch_side=False, vp=v, vd=v)
    assert out_d == out_i == out_j
    assert both.paged_pools() == []


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
    SSD states, no KV rows — and the tokens, resumed tokens and the
    snapshot's states equal the reference's."""
    toks, stats, snap, state = _d_failure(True)
    jtoks, jstats, jsnap, _ = _d_failure(False)
    assert state == State.FINISHED and toks == jtoks
    assert stats.resumed_tokens == jstats.resumed_tokens > 0
    assert stats.prefill_tokens == jstats.prefill_tokens < 2 * 24
    assert (snap["seq_len"], snap["next_start"], snap["row_start"]) == \
        (jsnap["seq_len"], jsnap["next_start"], jsnap["row_start"])
    assert snap["kv"] == [] and len(snap["states"]) == len(jsnap["states"])
    for (gi, pi, rows), (jgi, jpi, jst) in zip(snap["states"],
                                               jsnap["states"]):
        assert (gi, pi) == (jgi, jpi)
        for n in ("h", "conv"):
            np.testing.assert_allclose(rows[n].numpy(),
                                       np.asarray(getattr(jst, n)),
                                       atol=ATOL)


def test_multiproc_pair_ships_states_only(tmp_path):
    """Tiny SSM through two spawned CPU worker processes (chunked compute,
    markers never staged, one empty chunk and one tail segment of states
    a request over shm): the reference's single-process tokens; every
    segment the run announced is unlinked at the end."""
    import os
    from repro_torch.serving.multiproc import EngineSpec, serve_two_process
    jcfg, tcfg, jp, tp = _params()
    path = tmp_path / "ssm.pt"
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
    assert rt.stats.chunks_streamed == len(reqs)
    assert len(rt.segments_seen) == 2 * len(reqs)
    assert [n for n in rt.segments_seen
            if os.path.exists(f"/dev/shm/{n}")] == []

"""The port's shared-memory and modeled-RDMA connectors against the JAX
package's (``repro.core.transport``).

Mirrors the shm and rdma cases of tests/test_transport.py and
tests/test_wire.py on the port's connectors, and adds the checks across
the two packages: the same KV chunk staged by either package's
``SharedMemoryConnector`` makes a byte-identical segment, and a segment
staged by either adopts and decodes in the other to the same values —
also from another OS process. The modeled link is driven through the
same operations on both packages and must report the same clock and
counters. The streamed handoff (``DisaggPipeline.handoff_streamed``)
over every backend and wire leaves D pools bit-identical to the
reference's.
"""
import dataclasses
import multiprocessing as mp
import pickle
from multiprocessing import shared_memory

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compat import precision as JP
from repro.core.compat.precision import WireFormat as JWire
from repro.core.disagg import DisaggPipeline as JPipe
from repro.core.transport import ModeledRDMAConnector as JRdma
from repro.core.transport import SharedMemoryConnector as JShm
from repro.core.transport import make_connector as j_make
from repro.core.transport.wirefmt import WireChunk as JChunk
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import VendorProfile as JVendor
from repro.serving.request import Request as JRequest
from repro_torch.configs.base import config_from_dict
from repro_torch.core.compat import precision as TP
from repro_torch.core.compat.precision import WireFormat
from repro_torch.core.disagg import DisaggPipeline
from repro_torch.core.transport import (CONNECTORS, InProcessConnector,
                                        ModeledRDMAConnector,
                                        SharedMemoryConnector, make_connector,
                                        wirefmt)
from repro_torch.core.transport.wirefmt import WireChunk
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine, VendorProfile
from repro_torch.serving.request import Request
from tests.conftest import TINY_FAMILIES

WIRES = [("raw", "float32"), ("raw", "bfloat16"), ("int8", "bfloat16")]
WIRE_IDS = [f"{k}-{d}" for k, d in WIRES]
BACKENDS = sorted(CONNECTORS)          # ["inproc", "rdma", "shm"]


def _np_entries(seed=0):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(3, 13, 4, 8)).astype(np.float32)
    v = rng.normal(size=(3, 13, 4, 8)).astype(np.float32)
    return k, v, 5


def _chunks(wire, seed=0):
    """The same KV chunk planned by each package: (port, reference)."""
    k, v, start = _np_entries(seed)
    t = WireChunk.from_entries(
        [("kv", 0, 0, {"k": torch.from_numpy(k), "v": torch.from_numpy(v),
                       "start": start})], WireFormat(*wire), tp_p=2,
        seq_len=13)
    j = JChunk.from_entries([("kv", 0, 0, {"k": k, "v": v, "start": start})],
                            JWire(*wire), tp_p=2, seq_len=13)
    return t, j


def _entry_bytes(chunk):
    return [(e["kind"], e["gi"], e["start"], e["payload"].tobytes(),
             b"" if e["scales"] is None else e["scales"].tobytes())
            for e in chunk.entries()]


def _decode_port(chunk, wire):
    out = []
    for e in chunk.entries():
        pay = TP.host_tensor(np.array(e["payload"]), e["dtype"])
        sc = None if e["scales"] is None else torch.from_numpy(
            np.array(e["scales"])).reshape(tuple(pay.shape[:-1]) + (1,))
        out.append(TP.decode_wire(pay, sc, WireFormat(*wire),
                                  torch.float32).numpy())
    return out


def _decode_ref(chunk, wire):
    out = []
    for e in chunk.entries():
        # copies: a jax array may alias the segment and pin it open
        pay = jnp.asarray(np.array(e["payload"]))
        sc = None if e["scales"] is None else jnp.asarray(
            np.array(e["scales"])).reshape(pay.shape[:-1] + (1,))
        out.append(np.asarray(JP.decode_wire(pay, sc, JWire(*wire),
                                             jnp.float32)))
    return out


def _segment_bytes(conn, key):
    seg = shared_memory.SharedMemory(name=conn.segment_name(key))
    try:
        return bytes(seg.buf[:conn._sizes[key]])
    finally:
        seg.close()


def _payload(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"k": rng.normal(size=(n, 2, 4)).astype(np.float32),
            "scales": rng.normal(size=(n,)).astype(np.float32)}


# --------------------------------------------------------------------- #
# across the packages: one segment format
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("wire", WIRES, ids=WIRE_IDS)
def test_segment_bytes_identical_across_packages(wire):
    t_chunk, j_chunk = _chunks(wire)
    t_conn, j_conn = SharedMemoryConnector(), JShm()
    nt = t_conn.stage("x", t_chunk, t_chunk.meta())
    nj = j_conn.stage("x", j_chunk, j_chunk.meta())
    assert nt == nj == t_chunk.nbytes
    assert t_chunk.header_nbytes == j_chunk.header_nbytes
    assert _segment_bytes(t_conn, "x") == _segment_bytes(j_conn, "x")
    t_conn.close()
    j_conn.close()


@pytest.mark.parametrize("wire", WIRES, ids=WIRE_IDS)
@pytest.mark.parametrize("stager", ["port", "reference"])
def test_segment_adopts_and_decodes_in_the_other_package(wire, stager):
    t_chunk, j_chunk = _chunks(wire, seed=2)
    if stager == "port":
        creator, reader, chunk = SharedMemoryConnector(), JShm(), t_chunk
    else:
        creator, reader, chunk = JShm(), SharedMemoryConnector(), j_chunk
    creator.stage("c0", chunk, chunk.meta())
    desc = creator.export_descriptor("c0")
    reader.adopt_segment(desc["key"], desc["segment"], desc["nbytes"])
    payload, meta = reader.issue_read("c0").wait()
    assert (meta["wire"].kind, meta["tp_p"], meta["seq_len"]) \
        == (wire[0], 2, 13)
    assert _entry_bytes(payload) == _entry_bytes(chunk)
    if stager == "port":                       # the reference decodes
        got, want = _decode_ref(payload, wire), _decode_port(t_chunk, wire)
    else:                                      # the port decodes
        got, want = _decode_port(payload, wire), _decode_ref(j_chunk, wire)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    payload.release()
    reader.complete("c0")
    creator.complete("c0")
    assert creator.pool.in_use == 0 and reader.pool.in_use == 0
    reader.close()
    creator.close()


def _adopt_and_dump(desc, q):
    """Child process: adopt the staged segment with the port's connector
    and ship its entry bytes home."""
    conn = SharedMemoryConnector()
    try:
        conn.adopt_segment(desc["key"], desc["segment"], desc["nbytes"])
        payload, meta = conn.read(desc["key"])
        ents = _entry_bytes(payload)
        m = (meta["wire"].kind, meta["tp_p"], meta["seq_len"])
        payload.release()
        conn.complete(desc["key"])
        q.put(("ok", ents, m))
    except Exception as e:                     # noqa: BLE001 — report home
        q.put(("err", repr(e), None))
    finally:
        conn.close()


@pytest.mark.parametrize("stager", ["port", "reference"])
def test_cross_process_adopted_chunk_is_bit_exact(stager):
    wire = ("int8", "bfloat16")
    t_chunk, j_chunk = _chunks(wire, seed=4)
    conn, chunk = (SharedMemoryConnector(), t_chunk) if stager == "port" \
        else (JShm(), j_chunk)
    conn.stage("x@P0#c0", chunk, chunk.meta())
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=_adopt_and_dump,
                       args=(conn.export_descriptor("x@P0#c0"), q))
    proc.start()
    status, ents, m = q.get(timeout=120)
    proc.join(timeout=30)
    assert status == "ok", ents
    assert m == ("int8", 2, 13)
    assert ents == _entry_bytes(chunk)
    conn.complete("x@P0#c0")
    assert conn.pool.in_use == 0
    conn.close()


# --------------------------------------------------------------------- #
# shm specifics
# --------------------------------------------------------------------- #
def test_shm_segment_readable_by_name():
    """A plain payload lives pickled in an OS segment: a fresh attach by
    name (what another process would do) deserializes it."""
    conn = SharedMemoryConnector()
    pay = _payload(seed=7)
    n = conn.stage("x", pay, {"m": 3})
    seg = shared_memory.SharedMemory(name=conn.segment_name("x"))
    try:
        got, meta = pickle.loads(bytes(seg.buf[:n]))
    finally:
        seg.close()
    np.testing.assert_array_equal(got["k"], pay["k"])
    assert meta == {"m": 3}
    conn.complete("x")
    conn.close()


def test_shm_segments_carry_the_port_prefix():
    """Every segment the port stages, a chunk or a plain payload, is named
    with the port's prefix, never CPython's ``psm_``, and is gone after
    ``complete``."""
    import os
    from repro_torch.core.transport.shared_memory import SEGMENT_PREFIX
    conn = SharedMemoryConnector()
    chunk, _ = _chunks(("raw", "float32"))
    conn.stage("zc", chunk, chunk.meta())
    conn.stage("plain", _payload(seed=8), {})
    names = [conn.segment_name(k) for k in ("zc", "plain")]
    assert len(set(names)) == 2
    for n in names:
        assert n.startswith(SEGMENT_PREFIX) and not n.startswith("psm_")
        if os.path.isdir("/dev/shm"):
            assert os.path.exists(f"/dev/shm/{n}")
    conn.complete("zc")
    conn.complete("plain")
    if os.path.isdir("/dev/shm"):
        assert not any(os.path.exists(f"/dev/shm/{n}") for n in names)
    conn.close()


def test_shm_get_reuses_held_mapping(monkeypatch):
    """A read never re-attaches the segment by name."""
    import repro_torch.core.transport.shared_memory as shm_mod
    conn = SharedMemoryConnector()
    chunk, _ = _chunks(("raw", "float32"))
    conn.stage("zc", chunk, chunk.meta())
    conn.stage("legacy", {"x": np.arange(8)}, {})
    attaches = []
    real = shm_mod.shared_memory.SharedMemory

    class Counting(real):
        def __init__(self, *a, **kw):
            attaches.append((a, kw))
            super().__init__(*a, **kw)

    monkeypatch.setattr(shm_mod.shared_memory, "SharedMemory", Counting)
    pay, _ = conn.issue_read("zc").wait()
    assert isinstance(pay, WireChunk)
    pay.release()
    conn.issue_read("legacy").wait()
    assert attaches == []
    conn.complete("zc")
    conn.complete("legacy")
    conn.close()


def test_shm_stages_wirechunk_zero_copy_and_splits_stats():
    conn, jconn = SharedMemoryConnector(), JShm()
    for key, wire in (("raw", ("raw", "float32")),
                      ("int8", ("int8", "bfloat16"))):
        t_chunk, j_chunk = _chunks(wire)
        for c, chunk in ((conn, t_chunk), (jconn, j_chunk)):
            n = c.stage(key, chunk, chunk.meta())
            assert n == chunk.nbytes           # segment == wire layout
            pay, meta = c.issue_read(key).wait()
            assert meta["wire"].kind == wire[0]
            pay.release()
            c.complete(key)
    assert isinstance(pay, JChunk)
    st, jst = conn.stats, jconn.stats
    assert st.payload_bytes > st.bytes_moved   # int8 compresses
    assert st.wire_compression < 1.0
    assert (st.transfers, st.bytes_moved, st.payload_bytes) \
        == (jst.transfers, jst.bytes_moved, jst.payload_bytes)
    assert conn.pool.in_use == 0 and conn._deferred_close == []
    conn.close()
    jconn.close()


def test_shm_close_defers_a_pinned_segment():
    """A reader view still alive at complete(): the close is deferred, not
    lost, and retried once the view is gone."""
    conn = SharedMemoryConnector()
    chunk, _ = _chunks(("raw", "float32"))
    conn.stage("p", chunk, chunk.meta())
    name = conn.segment_name("p")
    pay, _ = conn.read("p")
    view = pay.entries()[0]["payload"]         # pins the mapping
    conn.complete("p")
    assert len(conn._deferred_close) == 1
    with pytest.raises(FileNotFoundError):     # unlinked all the same
        shared_memory.SharedMemory(name=name)
    del view
    pay.release()
    conn.close()
    assert conn._deferred_close == []


def test_shm_failed_stage_leaves_no_segment(monkeypatch):
    """A chunk whose encode fails mid-stage (a device→host copy that
    raises, say) unlinks its new segment and frees its pool bytes."""
    conn = SharedMemoryConnector()
    chunk, _ = _chunks(("raw", "float32"))
    created = []
    real_new = conn._new_segment

    def new_segment(nbytes):
        seg = real_new(nbytes)
        created.append(seg.name)
        return seg

    def boom(buf):
        raise RuntimeError("copy failed")

    monkeypatch.setattr(conn, "_new_segment", new_segment)
    monkeypatch.setattr(chunk, "write_into", boom)
    with pytest.raises(RuntimeError, match="copy failed"):
        conn.stage("bad", chunk, chunk.meta())
    assert created and conn.pool.in_use == 0 and conn.staged_keys() == []
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=created[0])
    conn.close()


def test_capabilities_declare_codec_and_sharing():
    inproc = InProcessConnector().capabilities()
    shm = SharedMemoryConnector().capabilities()
    fair = ModeledRDMAConnector().capabilities()
    serial = ModeledRDMAConnector(link_sharing="serial").capabilities()
    for caps in (inproc, shm, fair):
        assert caps.wire_codec == "fixed"
        assert caps.header_bytes == wirefmt.nominal_header_bytes()
    assert shm.zero_copy and shm.cross_process
    assert fair.link_sharing == "fair"
    assert serial.link_sharing == "exclusive"
    for kind in BACKENDS:
        got = dataclasses.asdict(make_connector(kind).capabilities())
        want = dataclasses.asdict(j_make(kind).capabilities())
        assert got == want, kind


# --------------------------------------------------------------------- #
# modeled RDMA: the same operations, the same clock and counters
# --------------------------------------------------------------------- #
def _both(**kw):
    return ModeledRDMAConnector(**kw), JRdma(**kw)


def _same_state(t, j):
    assert t._now == pytest.approx(j._now, rel=1e-12, abs=1e-15)
    assert dataclasses.asdict(t.stats).keys() \
        == dataclasses.asdict(j.stats).keys()
    for f, v in dataclasses.asdict(j.stats).items():
        if f.endswith("seconds") and f not in ("congested_seconds",
                                               "modeled_seconds",
                                               "overlap_modeled_seconds"):
            continue                           # host wall clocks
        assert getattr(t.stats, f) == pytest.approx(v, rel=1e-12), f


def test_rdma_handle_completes_over_multiple_ticks():
    """fixed_latency 1s, 0.6s of wire progress per tick → ready on the
    second tick; wait() before that fast-forwards instead of hanging."""
    t_conn, j_conn = _both(fixed_latency_s=1.0, tick_seconds=0.6,
                           bandwidth_gbps=1e9)
    for conn in (t_conn, j_conn):
        conn.stage("a", _payload())
        h = conn.issue_read("a")
        assert not h.poll()
        conn.tick()
        assert not h.poll()
        conn.tick()
        assert h.poll()
        h.wait()
        conn.complete("a")
        conn.stage("b", _payload(seed=1))
        h2 = conn.issue_read("b")
        assert not h2.poll()
        h2.wait()
        assert h2.poll()
        conn.complete("b")
    _same_state(t_conn, j_conn)
    t_conn.close()
    j_conn.close()


def test_rdma_serializes_reads_on_the_link():
    for conn in _both(fixed_latency_s=0.5, tick_seconds=0.6,
                      bandwidth_gbps=1e9, link_sharing="serial"):
        conn.stage("a", _payload(seed=0))
        conn.stage("b", _payload(seed=1))
        ha = conn.issue_read("a")
        hb = conn.issue_read("b")
        conn.tick()                            # t=0.6: a ready, b not
        assert ha.poll() and not hb.poll()
        conn.tick()                            # t=1.2: b ready (0.5+0.5)
        assert hb.poll()
        conn.close()


def test_fair_share_two_flights_slower_than_alone_but_equal():
    B = 10_000_000
    t_conn, j_conn = _both(bandwidth_gbps=0.01, fixed_latency_s=0.1,
                           tick_seconds=0.05)
    for conn in (t_conn, j_conn):
        assert conn.capabilities().link_sharing == "fair"
        conn.stage("a", {"x": np.zeros(B, np.uint8)})
        conn.stage("b", {"x": np.zeros(B, np.uint8)})
        ha = conn.issue_read("a")
        hb = conn.issue_read("b")
        alone = 0.1 + B / 0.01e9
        shared = 0.1 + 2 * B / 0.01e9
        t, t_a = 0.0, None
        while not (ha.poll() and hb.poll()):
            conn.tick()
            t += conn.tick_seconds
            if t_a is None and ha.poll():
                t_a = t
            assert t < 10.0, "fair-share link never delivered"
        assert t_a is not None and t_a > alone + 0.5
        assert t_a == pytest.approx(t)
        assert t == pytest.approx(shared, abs=2 * conn.tick_seconds)
        ha.wait()
        hb.wait()
        assert conn.stats.congested_seconds == \
            pytest.approx(2 * (shared - alone), abs=0.01)
        assert conn.stats.concurrent_reads_peak == 2
        conn.complete("a")
        conn.complete("b")
    _same_state(t_conn, j_conn)
    t_conn.close()
    j_conn.close()


def test_fair_share_wait_fast_forwards_and_cancel_leaves_the_link():
    B = 10_000_000
    t_conn, j_conn = _both(bandwidth_gbps=0.01, fixed_latency_s=0.1)
    for conn in (t_conn, j_conn):
        conn.stage("a", {"x": np.zeros(B, np.uint8)})
        conn.stage("b", {"x": np.zeros(B, np.uint8)})
        ha = conn.issue_read("a")
        hb = conn.issue_read("b")
        ha.wait()
        assert conn._now == pytest.approx(0.1 + 2 * B / 0.01e9)
        hb.wait()                              # already done: no advance
        assert conn._now == pytest.approx(0.1 + 2 * B / 0.01e9)
        assert conn.stats.contended_read_seconds > 0
        conn.complete("a")
        conn.complete("b")
    _same_state(t_conn, j_conn)
    for conn in _both(bandwidth_gbps=0.01, fixed_latency_s=0.0):
        conn.stage("a", {"x": np.zeros(B, np.uint8)})
        conn.stage("b", {"x": np.zeros(B, np.uint8)})
        ha = conn.issue_read("a")
        conn.issue_read("b").cancel()
        ha.wait()
        assert conn._now == pytest.approx(B / 0.01e9)   # alone, no sharing
        conn.close()


# --------------------------------------------------------------------- #
# the streamed handoff over every backend: the reference's D pools
# --------------------------------------------------------------------- #
JCFG = TINY_FAMILIES["dense"]
CFG = config_from_dict(dataclasses.asdict(JCFG))
P_VENDOR = dict(block_size=8, layout="nhbd", kv_dtype="float32", tp=2)
D_VENDOR = dict(block_size=4, layout="nbhd", kv_dtype="float32", tp=1)


@pytest.fixture(scope="module")
def params():
    jp = JM.init_params(jax.random.key(1), JCFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _prompt(plen=13, seed=3):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, plen).astype(np.int32)


@pytest.mark.parametrize("kind", BACKENDS)
@pytest.mark.parametrize("wire", WIRES, ids=WIRE_IDS)
def test_handoff_streamed_pools_equal_reference_per_backend(params, kind,
                                                            wire):
    """Chunk 5 straddles the D vendor's 4-token blocks (read-merge-write
    re-paging); fed the same prefill KV (the reference's), the port's
    streamed handoff leaves the reference's pools, bit for bit, and the
    monolithic handoff's pools too."""
    jp, tp = params
    kw = dict(num_blocks=64, max_batch=4, max_seq_len=64)
    jpe = JEngine("P0", JCFG, jp, JVendor("B", **P_VENDOR), role="prefill",
                  **kw)
    jde = JEngine("D0", JCFG, jp, JVendor("A", **D_VENDOR), role="decode",
                  **kw)
    package = jpe.prefill(JRequest("r0", _prompt(), 4))
    kv = [(kind, gi, pi, {"k": np.asarray(e["k"]), "v": np.asarray(e["v"])})
          for kind, gi, pi, e in package["kv"]]
    jpe.prefill = lambda _req: dict(package, kv=kv)
    j_pipe = JPipe(j_make(kind), JWire(*wire))
    j_meta = j_pipe.handoff_streamed(JRequest("r0", _prompt(), 4), jpe, jde,
                                     chunk_tokens=5, chunked_compute=False)
    tpe = Engine("P0", CFG, tp, VendorProfile("B", **P_VENDOR),
                 role="prefill", device="cpu", **kw)
    t_kv = [(kind, gi, pi, {n: torch.from_numpy(np.array(a))
                            for n, a in e.items()})
            for kind, gi, pi, e in kv]
    tpe.prefill = lambda _req: {"kv": t_kv, "states": [], "cross": [],
                                "first_token": int(package["first_token"]),
                                "seq_len": 13}
    tde = Engine("D0", CFG, tp, VendorProfile("A", **D_VENDOR),
                 role="decode", device="cpu", **kw)
    t_pipe = DisaggPipeline(make_connector(kind), WireFormat(*wire))
    t_meta = t_pipe.handoff_streamed(Request("r0", _prompt(), 4), tpe, tde,
                                     chunk_tokens=5, chunked_compute=False)
    assert t_meta["chunks"] == j_meta["chunks"] == 3       # ceil(13 / 5)
    assert t_meta["first_token"] == j_meta["first_token"]
    assert t_meta["bytes"] == j_meta["bytes"]
    for t_pools, j_pools in zip(tde.caches[0], jde.caches[0]):
        for name in ("k_pool", "v_pool"):
            np.testing.assert_array_equal(t_pools[name].numpy(),
                                          np.asarray(j_pools[name]))
    np.testing.assert_array_equal(tde.block_tables, jde.block_tables)
    mono = Engine("D1", CFG, tp, VendorProfile("A", **D_VENDOR),
                  role="decode", device="cpu", **kw)
    DisaggPipeline(make_connector(kind), WireFormat(*wire)).handoff(
        Request("r0", _prompt(), 4), tpe, mono)
    for a, b in zip(mono.caches[0], tde.caches[0]):
        for name in ("k_pool", "v_pool"):
            assert torch.equal(a[name], b[name])
    assert tde.decode_step()[0][2] == jde.decode_step()[0][2]
    assert t_pipe.transfer.pool.in_use == 0
    t_pipe.transfer.close()
    j_pipe.transfer.close()


# --------------------------------------------------------------------- #
# the scheduler over the modeled link
# --------------------------------------------------------------------- #
def _sched_over(params, conn, n_p=2, **kw):
    from repro_torch.serving.scheduler import GlobalScheduler
    _jp, tp = params
    ekw = dict(num_blocks=64, max_batch=4, max_seq_len=64, device="cpu")
    sched = GlobalScheduler(DisaggPipeline(conn, WireFormat("raw", "float32")),
                            prefill_chunk=4, chunk_budget=1, device="cpu",
                            **kw)
    for i in range(n_p):
        sched.add_instance(Engine(f"P{i}", CFG, tp,
                                  VendorProfile("B", **P_VENDOR),
                                  role="prefill", **ekw))
    sched.add_instance(Engine("D0", CFG, tp, VendorProfile("A", **D_VENDOR),
                              role="decode", **ekw))
    return sched


def _req(rid, plen, max_new, seed):
    return Request(rid, _prompt(plen, seed), max_new)


def test_decode_step_runs_while_chunk_wire_in_flight(params):
    """Handles span scheduler ticks (fixed latency 1s, 0.45s of wire
    progress per tick): a short request decodes in ticks where the long
    request's chunk read is still on the wire."""
    conn = ModeledRDMAConnector(fixed_latency_s=1.0, tick_seconds=0.45,
                                bandwidth_gbps=1e9)
    sched = _sched_over(params, conn, repage_budget=1)
    short_req = _req("short", 8, 10, 12)
    long_req = _req("long", 24, 3, 11)
    sched.submit(short_req)
    sched.submit(long_req)
    decoded_during_inflight_wire = 0
    for _ in range(200):
        emitted = sched.step()
        short_decoded = any(r is short_req for r, _tok in emitted)
        wire_busy = any(fl.handoff.pending_reads() > 0
                        for fl in sched.inflight)
        if short_decoded and wire_busy:
            decoded_during_inflight_wire += 1
        if sched.stats.finished == 2:
            break
    assert sched.stats.finished == 2
    assert len(short_req.output_tokens) == 10
    assert len(long_req.output_tokens) == 3
    assert decoded_during_inflight_wire >= 3
    assert conn.stats.chunks == 2 + 6          # ceil(8/4) + ceil(24/4)
    conn.close()


def test_concurrent_flights_throttle_on_shared_channel(params):
    """max_inflight=1 on a slow modeled wire: two flights share the one
    read slot and take turns instead of failing on a full channel."""
    conn = ModeledRDMAConnector(fixed_latency_s=1.0, tick_seconds=0.6,
                                bandwidth_gbps=1e9, max_inflight=1)
    sched = _sched_over(params, conn)
    reqs = [_req(f"q{i}", 12, 3, i) for i in range(2)]
    done = sched.run(reqs, max_ticks=400)
    assert len(done) == 2
    assert sched.stats.requeues == 0
    assert all(len(r.output_tokens) == 3 for r in reqs)
    conn.close()

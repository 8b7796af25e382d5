"""The port's multi-instance P/D runtime (``repro_torch.serving.multiproc``)
against the JAX package's.

Mirrors tests/test_multiproc.py (all but the planner round trip, which
waits for the port's planner) and the cross-process cases of
tests/test_prefix_cache.py, on the tiny ``dense`` config in float32, with
every worker on the CPU (``EngineSpec.device="cpu"``). The workers load
the reference's parameters from a ``torch.save``d file
(``EngineSpec.params_path``), so their tokens are held to the reference's
single-process ``GlobalScheduler`` over its own ``SharedMemoryConnector``:

1. *parity*: 1P1D through ``serve_two_process`` and a routed 2P2D
   cluster through ``serve_cluster`` give the reference's tokens;
2. *failure surfacing*: a P that dies hard mid-stream is requeued (the
   retry visible in the merged ``TransferStats.retries``); a D that dies
   fails over to the surviving D, also from the prefix cache;
3. *no leaks*: no segment that a run announced (``segments_seen``) or a
   connector staged (``segment_name``) outlives it — only the names this
   test created are checked, so other processes' segments do not count;
4. the router, the admission policy and the launcher's accounting helpers
   give the reference's answers on the same inputs.
"""
import dataclasses
import functools
import gc
import os

import jax
import numpy as np
import pytest
import torch

from repro.core.compat.precision import WireFormat as JWire
from repro.core.disagg import DisaggPipeline as JPipe
from repro.core.kv_transfer import TransferEngine as JTransfer
from repro.core.transport import SharedMemoryConnector as JShm
from repro.core.transport.base import TransferStats as JStats
from repro.models import model as JM
from repro.serving import router as jrouter
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import VendorProfile as JVendor
from repro.serving.multiproc.launcher import _interval_overlap as j_overlap
from repro.serving.multiproc.launcher import _union as j_union
from repro.serving.multiproc import report as jreport
from repro.serving.prefix_cache import hashing as jhash
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import GlobalScheduler as JSched
from repro.serving.server import Server as JServer
from repro_torch.configs.base import config_from_dict
from repro_torch.core.compat.precision import WireFormat
from repro_torch.core.transport import SharedMemoryConnector, make_connector
from repro_torch.core.transport.base import TransferStats
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import router
from repro_torch.serving.engine import VendorProfile
from repro_torch.serving.multiproc import (ClusterRuntime, ClusterSpec,
                                           EngineSpec, TwoProcessRuntime,
                                           serve_cluster, serve_two_process)
from repro_torch.serving.multiproc import report
from repro_torch.serving.multiproc.launcher import _interval_overlap, _union
from repro_torch.serving.prefix_cache import hashing
from repro_torch.serving.request import Request
from tests.conftest import TINY_FAMILIES

JCFG = TINY_FAMILIES["dense"]
CFG = config_from_dict(dataclasses.asdict(JCFG))
P_VENDOR = dict(block_size=8, layout="nhbd", kv_dtype="float32", tp=2)
D_VENDOR = dict(block_size=4, layout="nbhd", kv_dtype="float32", tp=1)
VENDOR_P, VENDOR_D = VendorProfile("B", **P_VENDOR), VendorProfile("A",
                                                                   **D_VENDOR)
SEED = 0
CHUNK = 8
WIRE = ("raw", "float32")
WALL = 300.0


@pytest.fixture(scope="module")
def params_path(tmp_path_factory):
    """The reference's parameters, converted and saved for the workers."""
    jp = JM.init_params(jax.random.key(SEED), JCFG)
    path = tmp_path_factory.mktemp("params") / "dense.pt"
    torch.save(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), path)
    return str(path)


def _requests(n=3, max_new=4, cls=Request):
    rng = np.random.default_rng(7)
    return [cls(req_id=f"req-{i}",
                prompt=rng.integers(0, JCFG.vocab_size,
                                    int(rng.integers(14, 30))
                                    ).astype(np.int32),
                max_new_tokens=max_new)
            for i in range(n)]


def _spec(params_path, name, vendor, role, prefix_cache=False):
    return EngineSpec(name, CFG, vendor, params_seed=SEED, num_blocks=64,
                      max_batch=4, max_seq_len=64, role=role,
                      prefix_cache=prefix_cache, device="cpu",
                      params_path=params_path)


@functools.lru_cache(maxsize=None)
def _serve_single(n, max_new=4):
    """The reference's single-process loop over its own shm connector."""
    reqs = _requests(n, max_new, cls=JRequest)
    params = JM.init_params(jax.random.key(SEED), JCFG)
    mk = lambda name, vendor, role: JEngine(
        name, JCFG, params, vendor, num_blocks=64, max_batch=4,
        max_seq_len=64, role=role)
    connector = JShm()
    sched = JSched(JPipe(connector, JWire(*WIRE)), prefill_chunk=CHUNK)
    sched.add_instance(mk("P0", JVendor("B", **P_VENDOR), "prefill"))
    sched.add_instance(mk("D0", JVendor("A", **D_VENDOR), "decode"))
    server = JServer(sched)
    for r in reqs:
        server.submit(r)
    ticks = 0
    while sched.stats.finished < len(reqs) and ticks < 2000:
        sched.step()
        ticks += 1
    assert sched.stats.finished == len(reqs)
    connector.close()
    return {r.req_id: list(r.output_tokens) for r in reqs}


def _gone(names):
    """None of these shared-memory segments is still linked."""
    assert names
    return [n for n in names if os.path.exists(f"/dev/shm/{n}")] == []


def _kw(**kw):
    return dict(prefill_chunk=CHUNK, wire=WireFormat(*WIRE), **kw)


# --------------------------------------------------------------------- #
# 1. parity: separate OS processes, token-exact vs the reference
# --------------------------------------------------------------------- #
def test_two_process_token_exact_vs_single_process(params_path):
    reqs = _requests()
    tokens, rt = serve_two_process(
        _spec(params_path, "P0", VENDOR_P, "prefill"),
        _spec(params_path, "D0", VENDOR_D, "decode"),
        reqs, max_wall_s=WALL, **_kw())
    assert set(rt.worker_pids) == {"P0", "D0"}
    assert len({os.getpid(), *rt.worker_pids.values()}) == 3
    assert rt.stats.finished == len(reqs)
    assert tokens == _serve_single(3)
    st = rt.transfer_stats
    assert st.transfers > 0 and st.bytes_moved > 0
    assert st.wall_handoff_seconds > 0
    assert 0 <= st.wall_overlap_seconds <= st.wall_handoff_seconds
    # both workers shipped their launch counts home (all 0 on the CPU)
    assert set(rt.worker_launches) == {"P0", "D0"}
    assert all(n == 0 for c in rt.worker_launches.values()
               for n in c.values())
    assert _gone(rt.segments_seen)
    # the plan-vs-measured report reads the runtime as the reference's does
    got = report.plan_vs_measured(rt, reqs, wall_s=1.0)
    assert got == jreport.plan_vs_measured(rt, reqs, wall_s=1.0)
    assert got["measured"]["finished"] == len(reqs)
    assert report.format_report(got) == jreport.format_report(got)
    assert report.slo_section(reqs, 1.0, 0.5, 0.1) \
        == jreport.slo_section(reqs, 1.0, 0.5, 0.1)


def test_pickle_codec_refused_by_name_at_construction(params_path):
    """The port ships KV chunks in the fixed layout only and has no codec
    knob: the reference's ``codec="pickle"`` is refused before any worker
    spawns."""
    from repro_torch.core.disagg import DisaggPipeline
    from repro_torch.core.transport import InProcessConnector
    specs = (_spec(params_path, "P0", VENDOR_P, "prefill"),
             _spec(params_path, "D0", VENDOR_D, "decode"))
    with pytest.raises(TypeError, match="codec"):
        TwoProcessRuntime(*specs, codec="pickle", **_kw())
    with pytest.raises(TypeError, match="codec"):
        DisaggPipeline(InProcessConnector(), codec="pickle")
    rt = TwoProcessRuntime(*specs, **_kw())
    assert not rt.worker_pids and rt._evt_q is None     # nothing spawned


def test_worker_that_cannot_build_fails_start_at_once(tmp_path,
                                                      params_path):
    """A worker that dies before reporting ready (here: its parameter
    file is missing) fails ``start()`` with its exit code instead of a
    wait for the spawn timeout; shutdown leaves no process behind."""
    missing = str(tmp_path / "missing.pt")
    rt = TwoProcessRuntime(_spec(params_path, "P0", VENDOR_P, "prefill"),
                           _spec(missing, "D0", VENDOR_D, "decode"), **_kw())
    try:
        with pytest.raises(RuntimeError, match="exited before reporting"):
            rt.start(spawn_timeout_s=WALL)
    finally:
        rt.shutdown()
    assert all(i.proc is None for i in rt._instances.values())


def test_admission_sheds_at_the_door_and_pools_keep_a_member(params_path):
    """``try_submit`` sheds once the measured queue depth reaches the
    watermark (State.SHED, counted, never dispatched); a pool cannot
    drain its last member; a member added before ``start`` joins the
    pool unspawned. No worker runs here."""
    from repro_torch.serving.request import State
    rt = ClusterRuntime(_cluster(params_path, 1, 1),
                        admission=router.AdmissionConfig(max_queue_depth=2),
                        **_kw())
    reqs = _requests(n=3)
    assert [rt.try_submit(r) for r in reqs] == [True, True, False]
    assert reqs[2].state == State.SHED
    assert (rt.stats.submitted, rt.stats.shed, rt.queue_depth()) == (2, 1, 2)
    with pytest.raises(ValueError, match="last D"):
        rt.remove_instance("D0")
    iid = rt.add_instance(_spec(params_path, "Dx", VENDOR_D, "decode"), "D")
    assert iid == "D1" and rt._instances[iid].proc is None
    rt.remove_instance("D1")
    assert rt._instances["D1"].draining
    with pytest.raises(ValueError, match="role"):
        rt.add_instance(_spec(params_path, "Q", VENDOR_D, "decode"), "Q")
    rt.shutdown()                              # never started: a no-op


def test_two_process_backpressure_on_one_slot_channel(params_path):
    reqs = _requests(n=3)
    tokens, rt = serve_two_process(
        _spec(params_path, "P0", VENDOR_P, "prefill"),
        _spec(params_path, "D0", VENDOR_D, "decode"),
        reqs, max_wall_s=WALL, **_kw(connector_kwargs={"max_inflight": 1}))
    assert rt.stats.finished == len(reqs)
    assert rt.stats.failed == 0
    assert not rt.stream_failures
    for r in reqs:
        assert len(tokens[r.req_id]) == r.max_new_tokens
    assert tokens == _serve_single(3)


# --------------------------------------------------------------------- #
# 2. P dies hard mid-stream → D surfaces it, launcher requeues, recovers
# --------------------------------------------------------------------- #
def test_p_crash_mid_stream_surfaces_failure_and_requeues(params_path):
    reqs = _requests(n=2)
    rt = TwoProcessRuntime(_spec(params_path, "P0", VENDOR_P, "prefill"),
                           _spec(params_path, "D0", VENDOR_D, "decode"),
                           fault_exit_after_chunks=2, **_kw())
    rt.start()
    try:
        tokens = rt.serve(reqs, max_wall_s=WALL)
    finally:
        rt.shutdown()
    assert rt.crashes["P"] == 1                # died once, was respawned
    assert rt.stream_failures
    assert rt.stats.requeues >= 1
    assert rt.transfer_stats.retries >= 1      # merged across processes
    assert rt.stats.finished == len(reqs)
    assert rt.stats.failed == 0
    for r in reqs:
        assert len(tokens[r.req_id]) == r.max_new_tokens
    assert tokens == {k: v for k, v in _serve_single(3).items()
                      if k in tokens}
    assert _gone(rt.segments_seen)             # the dead attempt's too


# --------------------------------------------------------------------- #
# 2b. N×M cluster: routed 2P2D parity, D-crash failover onto a survivor
# --------------------------------------------------------------------- #
def _cluster(params_path, n_p, n_d, prefix_cache=False):
    return ClusterSpec(
        p=tuple(_spec(params_path, f"P{i}", VENDOR_P, "prefill",
                      prefix_cache) for i in range(n_p)),
        d=tuple(_spec(params_path, f"D{i}", VENDOR_D, "decode",
                      prefix_cache) for i in range(n_d)))


def test_cluster_2p2d_token_exact_vs_single_process(params_path):
    reqs = _requests(n=6)
    tokens, rt = serve_cluster(_cluster(params_path, 2, 2), reqs,
                               max_wall_s=WALL, **_kw())
    assert set(rt.worker_pids) == {"P0", "P1", "D0", "D1"}
    assert len({os.getpid(), *rt.worker_pids.values()}) == 5
    assert rt.stats.finished == len(reqs)
    assert tokens == _serve_single(6)
    assert sum(rt.stats.p_dispatches.values()) == len(reqs)
    assert sum(rt.stats.d_dispatches.values()) == len(reqs)
    assert len(rt.stats.d_dispatches) == 2      # both Ds served work
    assert _gone(rt.segments_seen)


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["cold", "prefix-cache"])
def test_d_crash_fails_over_to_surviving_d(params_path, prefix_cache):
    """One of two D instances dies hard mid-decode: its streams re-prefill
    onto the surviving D (generated prefix appended — still token-exact)
    with no respawn. With the prefix cache on, the retry replays the
    original prefill from P's host store instead of recomputing it."""
    reqs = _requests(n=4, max_new=4)
    rt = ClusterRuntime(_cluster(params_path, 1, 2, prefix_cache),
                        fault_exit_after_tokens=3, **_kw())
    rt.start()
    try:
        tokens = rt.serve(reqs, max_wall_s=WALL)
    finally:
        rt.shutdown()
    assert rt.crashes["D"] == 1
    assert rt.respawns["D"] == 0               # survivor took over instead
    assert "D0" not in rt._instances           # dead member left the pool
    assert rt.stats.finished == len(reqs)
    assert rt.stats.failed == 0
    assert rt.stats.requeues >= 1              # the failover re-prefill
    for r in reqs:
        assert len(tokens[r.req_id]) == r.max_new_tokens
    assert tokens == _serve_single(4)          # greedy: failover is exact
    if prefix_cache:
        assert rt.worker_stats["P0"]["prefix_cached_tokens"] \
            >= VENDOR_P.block_size
    assert _gone(rt.segments_seen)


# --------------------------------------------------------------------- #
# 2c. the prefix cache across processes
# --------------------------------------------------------------------- #
def _shared_prefix_reqs(cls, n=3, shared=40, tail=4, max_new=4, seed=11):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, JCFG.vocab_size, shared).astype(np.int32)
    return [cls(req_id=f"q{i}",
                prompt=np.concatenate(
                    [head, rng.integers(0, JCFG.vocab_size,
                                        tail).astype(np.int32)]),
                max_new_tokens=max_new)
            for i in range(n)]


def test_cross_process_cached_vs_cold_token_parity_and_skipping(params_path):
    """Over real OS processes, a shared 40-token prefix changes no token
    against the reference's cold single-process loop, keeps the shared
    blocks off the wire and skips P's forward pass over them."""
    params = JM.init_params(jax.random.key(SEED), JCFG)
    mk = lambda name, vendor, role: JEngine(
        name, JCFG, params, vendor, num_blocks=64, max_batch=4,
        max_seq_len=64, role=role)
    sched = JSched(JPipe(JTransfer(), JWire(*WIRE)), prefill_chunk=CHUNK)
    sched.add_instance(mk("P0", JVendor("B", **P_VENDOR), "prefill"))
    sched.add_instance(mk("D0", JVendor("A", **D_VENDOR), "decode"))
    ref = {}
    for r in _shared_prefix_reqs(JRequest):
        sched.submit(r)
        for _ in range(400):
            if r.state.name in ("FINISHED", "FAILED"):
                break
            sched.step()
        ref[r.req_id] = list(r.output_tokens)

    reqs = _shared_prefix_reqs(Request)
    rt = TwoProcessRuntime(
        _spec(params_path, "P0", VENDOR_P, "prefill", prefix_cache=True),
        _spec(params_path, "D0", VENDOR_D, "decode", prefix_cache=True),
        **_kw())
    rt.start()
    try:
        for r in reqs:
            rt.serve([r], max_wall_s=120.0)
    finally:
        rt.shutdown()
    assert {r.req_id: list(r.output_tokens) for r in reqs} == ref
    assert rt.transfer_stats.prefix_hit_tokens >= 2 * 40
    assert rt.transfer_stats.bytes_saved > 0
    assert rt.worker_stats["P0"]["prefix_cached_tokens"] >= 2 * 40
    assert _gone(rt.segments_seen)


def test_cluster_2p2d_affinity_routes_same_prefix_to_same_d(params_path):
    """Once a D advertises a prefix (heartbeat digest summary), a new
    request sharing it lands there, although load ordering would pick
    the other D."""
    import time
    rng = np.random.default_rng(21)
    head_a = rng.integers(0, CFG.vocab_size, 40).astype(np.int32)
    head_b = rng.integers(0, CFG.vocab_size, 40).astype(np.int32)
    mk = lambda rid, head: Request(
        req_id=rid,
        prompt=np.concatenate(
            [head, rng.integers(0, CFG.vocab_size, 4).astype(np.int32)]),
        max_new_tokens=4)
    rt = ClusterRuntime(_cluster(params_path, 2, 2, prefix_cache=True),
                        **_kw())
    rt.start()
    try:
        rt.serve([mk("rA", head_a), mk("rB", head_b)], max_wall_s=120.0)
        assert dict(rt.stats.d_dispatches) == {"D0": 1, "D1": 1}
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            rt.step(timeout=0.05)
            inst = rt._instances.get("D1")
            if inst is not None and inst.prefix_hashes:
                break
        assert rt._instances["D1"].prefix_hashes
        rt.serve([mk("rA2", head_b)], max_wall_s=120.0)
        assert rt.stats.d_dispatches["D1"] == 2
    finally:
        rt.shutdown()
    assert rt.transfer_stats.prefix_hit_tokens >= 40


# --------------------------------------------------------------------- #
# 3. routing and admission policy (pure), held to the reference
# --------------------------------------------------------------------- #
def _both_dsnap(iid, active=0, free_blocks=15, max_batch=4, block_size=4,
                max_seq_len=64, block_bytes=1024, prompt=None,
                prompt_blocks=0):
    kw = dict(iid=iid, active=active, max_batch=max_batch,
              free_blocks=free_blocks, block_size=block_size,
              max_blocks_per_seq=-(-max_seq_len // block_size),
              max_seq_len=max_seq_len, block_bytes=block_bytes)
    th = jh = frozenset()
    if prompt is not None and prompt_blocks:
        th = frozenset(hashing.chain_hashes(prompt, block_size)
                       [:prompt_blocks])
        jh = frozenset(jhash.chain_hashes(prompt, block_size)
                       [:prompt_blocks])
    return (router.DSnapshot(**kw, prefix_hashes=th),
            jrouter.DSnapshot(**kw, prefix_hashes=jh))


def test_pick_p_least_outstanding_tokens():
    cases = [[("P0", 1, 100), ("P1", 3, 40)], [],
             [("P1", 1, 10), ("P0", 1, 10)], [("P2", 0, 0), ("P0", 2, 5)]]
    want = ["P1", None, "P0", "P2"]
    for snaps, w in zip(cases, want):
        got = router.pick_p([router.PSnapshot(*s) for s in snaps])
        ref = jrouter.pick_p([jrouter.PSnapshot(*s) for s in snaps])
        assert got == ref == w


PROMPT = np.arange(32, dtype=np.int32)
PICK_D_CASES = [
    ([{}], 20, 4, None),
    ([dict(active=4)], 20, 4, None),
    ([{}], 80, 4, None),
    ([dict(free_blocks=5)], 20, 4, None),
    ([dict(active=2), dict(active=1)], 20, 4, None),
    ([dict(active=1, free_blocks=6), dict(active=1, free_blocks=12)], 20, 4,
     None),
    # prefix affinity beats load; foreign or absent prompts fall back
    ([dict(active=2, prompt=PROMPT[:24], prompt_blocks=4), {}], 24, 4,
     PROMPT[:24]),
    ([dict(active=2, prompt=PROMPT[:24], prompt_blocks=4), {}], 24, 4, None),
    ([dict(active=2, prompt=PROMPT[:24] + 100, prompt_blocks=4), {}], 24, 4,
     PROMPT[:24]),
    ([dict(prompt=PROMPT, prompt_blocks=2),
      dict(prompt=PROMPT, prompt_blocks=6)], 32, 4, PROMPT),
]


@pytest.mark.parametrize("case", range(len(PICK_D_CASES)))
def test_pick_d_admission_load_and_affinity_match_reference(case):
    snaps, seq_len, new, prompt = PICK_D_CASES[case]
    pairs = [_both_dsnap(f"D{i}", **kw) for i, kw in enumerate(snaps)]
    got = router.pick_d([t for t, _ in pairs], seq_len, new, prompt=prompt)
    ref = jrouter.pick_d([j for _, j in pairs], seq_len, new, prompt=prompt)
    assert got == ref


def test_admission_and_block_math_match_reference():
    cfgs = [None, (None, None, 1.0, 0.3), (3, None, 1.0, 0.3),
            (None, 0.5, 1.0, 0.3), (4, 0.5, 2.0, 0.5)]
    for c in cfgs:
        t = None if c is None else router.AdmissionConfig(*c)
        j = None if c is None else jrouter.AdmissionConfig(*c)
        for depth in (0, 1, 3, 5):
            for ema in (None, 0.2, 0.6, 1.5):
                assert router.should_admit(t, depth, ema) \
                    == jrouter.should_admit(j, depth, ema)
    ema_t = ema_j = None
    for sample in (0.4, 0.1, 0.9, 0.3):
        ema_t = router.update_ttft_ema(ema_t, sample, 0.3)
        ema_j = jrouter.update_ttft_ema(ema_j, sample, 0.3)
        assert ema_t == ema_j
    for total, bs, cap in ((24, 4, 16), (1, 8, 4), (100, 4, 16), (32, 32, 2)):
        assert router.blocks_needed(total, bs, cap) \
            == jrouter.blocks_needed(total, bs, cap)
    for vendor in (P_VENDOR, D_VENDOR, dict(D_VENDOR, kv_dtype="bfloat16")):
        assert router.kv_block_bytes(CFG, VendorProfile("v", **vendor)) \
            == jrouter.kv_block_bytes(JCFG, JVendor("v", **vendor))


def test_blocks_needed_mirrors_engine_reservation():
    eng = EngineSpec("Dx", CFG, VENDOR_D, num_blocks=64, max_batch=4,
                     max_seq_len=64, role="decode", device="cpu").build()
    req = Request(req_id="probe",
                  prompt=np.arange(18, dtype=np.int32) % CFG.vocab_size,
                  max_new_tokens=5)
    _slot, block_ids = eng.reserve_sequence(req, req.prompt_len)
    assert len(block_ids) == router.blocks_needed(
        req.prompt_len + req.max_new_tokens, eng.block_size,
        eng.max_blocks_per_seq)


# --------------------------------------------------------------------- #
# 4. segment-leak guard on the connector itself
# --------------------------------------------------------------------- #
def _stage_some(conn, n=3):
    names = []
    for i in range(n):
        key = f"leak-{i}"
        conn.stage(key, {"k": np.arange(64, dtype=np.float32)}, {"i": i})
        names.append(conn.segment_name(key))
    return names


def test_shm_close_unlinks_every_segment():
    conn = SharedMemoryConnector()
    names = _stage_some(conn)
    assert not _gone(names)
    conn.close()
    assert _gone(names)


def test_shm_finalizer_unlinks_on_drop_without_close():
    conn = SharedMemoryConnector()
    names = _stage_some(conn)
    del conn                               # no drop(), no close()
    gc.collect()
    assert _gone(names)


def test_shm_adopted_segment_not_unlinked_by_reader():
    """The reader detaches on complete(); only the creator unlinks."""
    creator = make_connector("shm")
    reader = make_connector("shm")
    creator.stage("x", {"k": np.ones(8, np.float32)}, {})
    desc = creator.export_descriptor("x")
    reader.adopt_segment(desc["key"], desc["segment"], desc["nbytes"])
    payload, _meta = reader.read("x")
    np.testing.assert_array_equal(payload["k"], np.ones(8, np.float32))
    reader.complete("x")                   # detach only
    assert not _gone([desc["segment"]])
    creator.complete("x")                  # creator unlinks
    assert _gone([desc["segment"]])
    reader.close()
    creator.close()


# --------------------------------------------------------------------- #
# 5. launcher accounting helpers, held to the reference
# --------------------------------------------------------------------- #
def test_transfer_stats_merge_sums_counters_and_maxes_peak():
    kw_a = dict(transfers=2, bytes_moved=100, retries=1,
                peak_buffer_bytes=50, wall_handoff_seconds=1.0,
                concurrent_reads_peak=3)
    kw_b = dict(transfers=3, bytes_moved=10, retries=0,
                peak_buffer_bytes=80, wall_overlap_seconds=0.5,
                concurrent_reads_peak=1)
    a, ja = TransferStats(**kw_a), JStats(**kw_a)
    a.merge(TransferStats(**kw_b))
    ja.merge(JStats(**kw_b))
    assert (a.transfers, a.bytes_moved, a.retries) == (5, 110, 1)
    assert a.peak_buffer_bytes == 80       # high-water, not a sum
    assert a.concurrent_reads_peak == 3
    assert dataclasses.asdict(a) == dataclasses.asdict(ja)
    assert TransferStats._PEAK_FIELDS == JStats._PEAK_FIELDS


SPANS = [[(0.0, 1.0), (2.0, 3.0)], [(0.0, 2.0), (1.0, 3.0)],
         [(2.0, 3.0), (0.0, 1.5), (1.0, 2.5), (5.0, 5.0)], []]


@pytest.mark.parametrize("spans", SPANS, ids=range(len(SPANS)))
def test_interval_overlap_and_union_match_reference(spans):
    assert _union(spans) == j_union(spans)
    merged = _union(spans)
    for a in ((0.5, 2.5), (1.0, 2.0), (-1.0, 4.0), (4.0, 6.0)):
        assert _interval_overlap(a, merged) == j_overlap(a, merged)
    assert _union([(2.0, 3.0), (0.0, 1.5), (1.0, 2.5), (5.0, 5.0)]) \
        == [(0.0, 3.0)]
    assert _interval_overlap((0.5, 2.5), [(0.0, 1.0), (2.0, 3.0)]) \
        == pytest.approx(1.0)


def test_reset_launch_counts_zeroes_both_workers_and_reaches_live_ones():
    """``ResetLaunchCounts`` zeroes a P's and a D's kernel launch counts
    from their command queues, and ``ClusterRuntime.reset_launch_counts``
    sends it to every live member and to no stopping or dead one."""
    import queue
    from types import SimpleNamespace

    from repro_torch.kernels import ops
    from repro_torch.serving.multiproc.d_worker import DWorker
    from repro_torch.serving.multiproc.messages import ResetLaunchCounts
    from repro_torch.serving.multiproc.p_worker import PWorker

    def set_counts(n):
        for mod in ops._WRAPPERS:
            for name in mod.LAUNCHES:
                mod.LAUNCHES[name] = n

    try:
        set_counts(3)
        p = object.__new__(PWorker)
        p._handle(ResetLaunchCounts())
        assert set(ops.launch_counts().values()) == {0}
        set_counts(5)
        d = object.__new__(DWorker)
        d.cmd_q = queue.Queue()
        d.cmd_q.put(ResetLaunchCounts())
        assert d._drain_cmds() is True
        assert set(ops.launch_counts().values()) == {0}
    finally:
        set_counts(0)

    def member(alive, stopping):
        return SimpleNamespace(alive=lambda: alive, stopping=stopping,
                               cmd_q=queue.Queue())
    rt = object.__new__(ClusterRuntime)
    rt._instances = {"P0": member(True, False), "D0": member(True, False),
                     "D1": member(True, True), "P1": member(False, False)}
    rt.reset_launch_counts()

    def sent(q):
        out = []
        while not q.empty():
            out.append(type(q.get_nowait()).__name__)
        return out
    assert {iid: sent(i.cmd_q) for iid, i in rt._instances.items()} == {
        "P0": ["ResetLaunchCounts"], "D0": ["ResetLaunchCounts"],
        "D1": [], "P1": []}

"""The port's global scheduler and chunked handoff against the JAX
package's.

Mirrors tests/test_scheduler.py (routing spread, D and P failure, elastic
drain, straggler penalty, admission, stats) and the dense cases of
tests/test_chunked_handoff.py (pinned-pool exhaustion, permanent failure,
``prefill_chunk=0``, typed mode errors, chunked = monolithic tokens with
overlap credit, decode during a long prefill, P failure mid-stream, one
requeue on D failure) on the tiny ``dense`` config in float32, on the
CPU, with the reference's parameters. Where a case serves tokens, the
reference serves the same requests and the port must match it: tokens,
chunk counts, wire bytes and the modeled overlap. Also the API the
reference's callers use: ``prefill_stream(..., chunked_compute=)``
(keyword-only), ``GlobalScheduler(straggler_factor=)`` and
``Request.decode_steps_at_dispatch``.
"""
import dataclasses

import jax
import numpy as np
import pytest

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
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import (Engine, PrefillMode,
                                        PrefillModeError, VendorProfile)
from repro_torch.serving.request import Request, State
from repro_torch.serving.scheduler import GlobalScheduler
from tests.conftest import TINY_FAMILIES

JCFG = TINY_FAMILIES["dense"]
CFG = config_from_dict(dataclasses.asdict(JCFG))
F32 = ("raw", "float32")
VP = dict(block_size=8, layout="nhbd", kv_dtype="float32", tp=2)
VD = dict(block_size=4, layout="nbhd", kv_dtype="float32")


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(jax.random.key(1), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _engine(name, params, role, vendor=None, **kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq_len", 64)
    return Engine(name, CFG, params, VendorProfile("A", **(vendor or
                                                          dict(block_size=8))),
                  role=role, device="cpu", **kw)


def _sched(*engines, pipe=None, **kw):
    sched = GlobalScheduler(pipe or DisaggPipeline(TransferEngine(),
                                                   WireFormat(*F32)),
                            device="cpu", **kw)
    for e in engines:
        sched.add_instance(e)
    return sched


def _reqs(n, seed=0, max_new=5):
    rng = np.random.default_rng(seed)
    return [Request(req_id=f"q{i}",
                    prompt=rng.integers(0, CFG.vocab_size, 8).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n)]


def _req(plen, rid="r0", max_new=6, seed=3, cls=Request):
    rng = np.random.default_rng(seed)
    return cls(req_id=rid,
               prompt=rng.integers(0, CFG.vocab_size, plen).astype(np.int32),
               max_new_tokens=max_new)


def _pair(params, vd=VD, names=("P0", "D0")):
    return (_engine(names[0], params, "prefill", VP),
            _engine(names[1], params, "decode", vd))


# --------------------------------------------------------------------- #
# tests/test_scheduler.py
# --------------------------------------------------------------------- #
def test_all_requests_finish_and_route_across_pool(params):
    p = [_engine(f"P{i}", params, "prefill") for i in range(2)]
    d = [_engine(f"D{i}", params, "decode") for i in range(3)]
    sched = _sched(*(p + d))
    reqs = _reqs(12)
    done = sched.run(reqs, max_ticks=500)
    assert len(done) == 12
    assert all(r.state == State.FINISHED for r in reqs)
    assert sum(sched.stats.p_dispatches.values()) == 12
    assert len([k for k, v in sched.stats.d_dispatches.items() if v > 0]) >= 2


def test_decode_failure_requeues_and_finishes(params):
    p = _engine("P0", params, "prefill")
    d = _engine("D0", params, "decode")
    sched = _sched(p, d)
    reqs = _reqs(3, max_new=8)
    for r in reqs:
        sched.submit(r)
    for _ in range(3):
        sched.step()
    d.fail()                                  # node dies, volatile KV gone
    for _ in range(200):
        if sched.stats.finished >= 3:
            break
        sched.step()
    assert sched.stats.finished == 3
    assert sched.stats.requeues >= 1
    for r in reqs:
        assert len(r.output_tokens) == 8


def test_prefill_failure_falls_back(params):
    p0 = _engine("P0", params, "prefill")
    p1 = _engine("P1", params, "prefill")
    d = _engine("D0", params, "decode")
    sched = _sched(p0, p1, d)
    p0.fail()
    done = sched.run(_reqs(4), max_ticks=400)
    assert len(done) == 4
    assert sched.stats.p_dispatches.get("P0", 0) == 0
    assert sched.stats.p_dispatches["P1"] == 4


def test_elastic_drain_stops_new_work(params):
    p = _engine("P0", params, "prefill")
    d0 = _engine("D0", params, "decode")
    d1 = _engine("D1", params, "decode")
    sched = _sched(p, d0, d1)
    sched.remove_instance("D1")               # drain: no new routing
    done = sched.run(_reqs(6), max_ticks=500)
    assert len(done) == 6
    assert sched.stats.d_dispatches.get("D1", 0) == 0


def test_straggler_penalty_prefers_fast_instance(params):
    p = _engine("P0", params, "prefill")
    d0 = _engine("D0", params, "decode")
    d1 = _engine("D1", params, "decode")
    sched = _sched(p, d0, d1)
    sched._ema["D0"] = 1.0                    # a 100x straggler
    sched._ema["D1"] = 0.01
    sched.run(_reqs(4), max_ticks=400)
    assert sched.stats.d_dispatches.get("D1", 0) \
        > sched.stats.d_dispatches.get("D0", 0)


def test_admission_respects_capacity(params):
    d = _engine("D0", params, "decode", num_blocks=4, max_seq_len=16)
    assert not d.can_admit(seq_len=12, new_tokens=30)
    assert d.can_admit(seq_len=4, new_tokens=4)


def test_engine_stats_accumulate(params):
    p = _engine("P0", params, "prefill")
    d = _engine("D0", params, "decode")
    sched = _sched(p, d)
    sched.run(_reqs(2), max_ticks=200)
    assert p.stats.prefill_tokens > 0
    assert d.stats.decode_tokens > 0
    assert d.stats.decode_seconds > 0
    assert p.stats.as_dict()["prefill_tokens"] == p.stats.prefill_tokens


# --------------------------------------------------------------------- #
# tests/test_chunked_handoff.py, dense cases
# --------------------------------------------------------------------- #
def test_flight_aborts_on_pinned_pool_exhaustion(params):
    p, d = _pair(params)
    sched = _sched(p, d, pipe=DisaggPipeline(
        TransferEngine(buffer_capacity_bytes=64), WireFormat(*F32)),
        prefill_chunk=4)
    sched.submit(_req(16, rid="big", max_new=2))
    for _ in range(3):
        sched.step()                   # dispatch + failed chunk → requeue
    assert sched.stats.requeues >= 1
    assert not sched.inflight
    assert all(r is None for r in d.slot_req)      # reservation released
    assert d.allocator.free_blocks == d.allocator.num_blocks - 1


def test_permanent_failure_marks_request_failed(params):
    p, d = _pair(params)
    sched = _sched(p, d, pipe=DisaggPipeline(
        TransferEngine(buffer_capacity_bytes=64), WireFormat(*F32)),
        prefill_chunk=4, max_retries=3)
    req = _req(16, rid="big", max_new=2)
    sched.submit(req)
    for _ in range(10):
        sched.step()
    assert req.state == State.FAILED
    assert sched.stats.failed == 1
    assert req.retries == 3
    assert not sched.pending and not sched.inflight
    assert all(r is None for r in d.slot_req)


def test_zero_chunk_tokens_means_monolithic(params):
    p, d = _pair(params)
    pipe = DisaggPipeline(TransferEngine(), WireFormat(*F32))
    with pytest.warns(DeprecationWarning, match="chunk_tokens <= 0"):
        meta = pipe.handoff_streamed(_req(13), p, d, chunk_tokens=0)
    assert meta["chunks"] == 1
    assert GlobalScheduler(pipe, prefill_chunk=0,
                           device="cpu").prefill_chunk is None


def test_unsupported_prefill_mode_fails_fast(params):
    p, _ = _pair(params)
    with pytest.raises(PrefillModeError, match="chunk_tokens"):
        p.prefill_stream(_req(21), mode=PrefillMode.INCREMENTAL)
    with pytest.raises(PrefillModeError, match="mode"):
        p.prefill_stream(_req(21), chunk_tokens=4, mode="incremental")
    # dense is not resumable (no state, no window): a snapshot is refused
    with pytest.raises(PrefillModeError, match="resume"):
        p.prefill_stream(_req(21), chunk_tokens=4,
                         resume={"seq_len": 21, "next_start": 8,
                                 "row_start": 8, "states": [], "kv": []})
    assert p.stats.resume_unsupported == 1
    assert issubclass(PrefillModeError, ValueError)
    # chunked_compute is keyword-only: a third positional argument is
    # neither the reference's chunked_compute nor the old mode
    with pytest.raises(TypeError):
        p.prefill_stream(_req(21), 4, PrefillMode.MONOLITHIC)


@pytest.mark.parametrize("chunked_compute,mode,want", [
    (None, None, True), (True, None, True), (False, None, False),
    (True, PrefillMode.MONOLITHIC, False), (None, PrefillMode.AUTO, True)])
def test_chunked_compute_has_the_reference_meaning(jparams, params,
                                                   chunked_compute, mode,
                                                   want):
    """``chunked_compute`` forces the mode only when ``mode`` is None, as
    in the reference; both packages choose the same compute."""
    p, _ = _pair(params)
    jp = JEngine("P0", JCFG, jparams, JVendor("B", **VP), num_blocks=64,
                 max_batch=4, max_seq_len=64, role="prefill")
    got = p.prefill_stream(_req(21), 4, chunked_compute=chunked_compute,
                           mode=mode)
    ref = jp.prefill_stream(_req(21, cls=JRequest), 4,
                            chunked_compute=chunked_compute,
                            mode=None if mode is None else JMode(mode.value))
    assert got.chunked_compute == ref.chunked_compute == want


def _serve_tokens(params, prefill_chunk, n=3, plens=(21, 9, 14)):
    p, d = _pair(params)
    pipe = DisaggPipeline(TransferEngine(), WireFormat(*F32))
    sched = _sched(p, d, pipe=pipe, prefill_chunk=prefill_chunk)
    reqs = [_req(plens[i], rid=f"q{i}", seed=i) for i in range(n)]
    assert len(sched.run(reqs, max_ticks=500)) == n
    return {r.req_id: list(r.output_tokens) for r in reqs}, sched, p


def _serve_tokens_ref(jparams, prefill_chunk, n=3, plens=(21, 9, 14)):
    kw = dict(num_blocks=64, max_batch=4, max_seq_len=64)
    p = JEngine("P0", JCFG, jparams, JVendor("B", **VP), role="prefill", **kw)
    d = JEngine("D0", JCFG, jparams, JVendor("A", **VD), role="decode", **kw)
    sched = JSched(JPipe(JTransfer(), JWire(*F32)),
                   prefill_chunk=prefill_chunk)
    sched.add_instance(p)
    sched.add_instance(d)
    reqs = [_req(plens[i], rid=f"q{i}", seed=i, cls=JRequest)
            for i in range(n)]
    assert len(sched.run(reqs, max_ticks=500)) == n
    return {r.req_id: list(r.output_tokens) for r in reqs}, sched, p


def test_chunked_streaming_token_exact_vs_monolithic(jparams, params):
    """prefill_chunk=4 (incremental compute, chunked wire) emits exactly
    the monolithic scheduler's tokens, and exactly the reference's, with
    the reference's chunk counts, wire bytes and modeled overlap."""
    out_mono, _, _ = _serve_tokens(params, prefill_chunk=None)
    out_chunk, sched, p = _serve_tokens(params, prefill_chunk=4)
    ref_chunk, jsched, jp = _serve_tokens_ref(jparams, prefill_chunk=4)
    assert out_chunk == out_mono == ref_chunk
    assert sched.stats.chunks_streamed == jsched.stats.chunks_streamed >= 3
    assert p.stats.prefill_chunks == jp.stats.prefill_chunks > 3
    st = sched.pipeline.transfer.stats
    jst = jsched.pipeline.transfer.stats
    assert 0 < st.overlap_modeled_seconds < st.modeled_seconds
    assert st.bytes_moved == jst.bytes_moved == 69_248
    assert (st.transfers, st.chunks) == (jst.transfers, jst.chunks)
    assert st.modeled_seconds == pytest.approx(jst.modeled_seconds,
                                               rel=1e-12)
    assert st.overlap_modeled_seconds == pytest.approx(
        jst.overlap_modeled_seconds, rel=1e-12)


def test_decode_tokens_emitted_during_long_prefill(params):
    p0, d = _pair(params)
    p1 = _engine("P1", params, "prefill", VP)
    sched = _sched(p0, p1, d, prefill_chunk=4, chunk_budget=1)
    long_req = _req(40, rid="long", max_new=4, seed=11)
    short_req = _req(8, rid="short", max_new=8, seed=12)
    sched.submit(long_req)
    sched.submit(short_req)
    short_while_long_prefilling = 0
    long_first_tick = None
    for tick in range(1, 60):
        for r, _tok in sched.step():
            if r is short_req and long_req.state == State.PREFILLING:
                short_while_long_prefilling += 1
            if r is long_req and long_first_tick is None:
                long_first_tick = tick
        if sched.stats.finished == 2:
            break
    assert long_first_tick is not None and long_first_tick >= 10
    assert long_req.chunks_streamed == 10
    assert short_while_long_prefilling >= 4
    assert len(long_req.output_tokens) == 4
    assert len(short_req.output_tokens) == 8
    assert sched.stats.p_dispatches["P0"] + sched.stats.p_dispatches["P1"] == 2


def test_flight_aborts_and_requeues_on_p_failure(params):
    p0, d = _pair(params)
    p1 = _engine("P1", params, "prefill", VP)
    sched = _sched(p0, p1, d, prefill_chunk=4, chunk_budget=1)
    req = _req(32, rid="rq", max_new=4, seed=5)
    sched.submit(req)
    sched.step()
    sched.step()
    sched.inflight[0].p.fail()
    for _ in range(80):
        if sched.stats.finished == 1:
            break
        sched.step()
    assert sched.stats.finished == 1
    assert sched.stats.requeues >= 1
    assert len(req.output_tokens) == 4
    assert all(r is None for r in d.slot_req)
    assert d.allocator.free_blocks == d.allocator.num_blocks - 1  # scratch


def test_flight_requeues_once_on_d_failure(params):
    p, d0 = _pair(params)
    d1 = _engine("D1", params, "decode", VD)
    sched = _sched(p, d0, d1, prefill_chunk=4, chunk_budget=1)
    req = _req(24, rid="rq", max_new=4, seed=9)
    sched.submit(req)
    sched.step()
    sched.step()
    assert len(sched.inflight) == 1
    sched.inflight[0].d.fail()          # decode node dies mid-stream
    for _ in range(80):
        if sched.stats.finished >= 1:
            break
        sched.step()
    assert sched.stats.finished == 1
    assert sched.stats.requeues == 1
    assert len(req.output_tokens) == 4
    assert req.state == State.FINISHED
    assert not sched.inflight and not sched.pending


# --------------------------------------------------------------------- #
# the reference's keywords and fields
# --------------------------------------------------------------------- #
def test_straggler_factor_and_dispatch_reset(params):
    pipe = DisaggPipeline(TransferEngine(), WireFormat(*F32))
    sched = GlobalScheduler(pipe, straggler_factor=3.5, device="cpu")
    assert sched.straggler_factor == 3.5
    assert GlobalScheduler(pipe, device="cpu").straggler_factor \
        == JSched(JPipe(JTransfer(), JWire(*F32))).straggler_factor
    assert "decode_steps_at_dispatch" in {
        f.name for f in dataclasses.fields(JRequest)}
    p, d = _pair(params)
    sched.add_instance(p)
    sched.add_instance(d)
    reqs = _reqs(2, max_new=3)
    for r in reqs:
        r.decode_steps_at_dispatch = 7          # stale from a past life
    sched.run(reqs, max_ticks=200)
    assert all(r.state == State.FINISHED for r in reqs)
    assert all(r.decode_steps_at_dispatch == 0 for r in reqs)

"""The port's open-loop load harness (``repro_torch.serving.loadgen``)
against the JAX package's.

1. Arrival schedules from ``poisson_arrivals`` and ``bursty_arrivals`` are
   the reference's list for list, to the bit, at several (rate, duration,
   seed, burst) points, ``chip_smoke.py`` phase 12's among them.
2. ``build_workload`` gives the same ids, prompts, lengths, frames and
   patches (text, audio, vision and mixed), and phase 12's schedule digest
   is the same from both packages.
3. The open-loop driver cases of tests/test_loadgen.py over a stub
   runtime: the scheduled arrival is stamped (not the submit time),
   shedding happens exactly at the watermark, and the autoscaler's
   actions are collected.
4. ``Request.tpot_live`` equals the reference's for in-flight, finished
   and one-token requests.

Every comparison here is exact: no tolerance.
"""
import time

import numpy as np
import pytest

import chip_smoke
from repro.serving import loadgen as jlg
from repro.serving.request import Request as JRequest
from repro_torch.serving import loadgen as lg
from repro_torch.serving.loadgen import (WorkloadConfig, build_workload,
                                         run_open_loop)
from repro_torch.serving.request import Request, State
from repro_torch.serving.router import AdmissionConfig, should_admit
from repro_torch.serving.scheduler import RuntimeStats


# --------------------------------------------------------------------- #
# 1. arrival schedules
# --------------------------------------------------------------------- #
POISSON = [(4.0, 12.0, 11), (5.0, 5.0, 1), (0.5, 60.0, 3), (40.0, 3.0, 0),
           (1.0, 30.0, 7)]
BURSTY = [
    # chip_smoke.py phase 12
    (1.0, 30.0, 7, dict(burst_factor=4, duty=0.25, period_s=2.0)),
    (4.0, 30.0, 3, {}),
    (2.0, 20.0, 5, dict(burst_factor=8.0, duty=0.1, period_s=1.0)),
    # burst_factor × duty > 1: the OFF state is silent
    (1.0, 15.0, 2, dict(burst_factor=6.0, duty=0.5, period_s=3.0)),
    (3.0, 10.0, 9, dict(burst_factor=1.0, duty=1.0)),
]


@pytest.mark.parametrize("rate,dur,seed", POISSON)
def test_poisson_schedule_equals_reference(rate, dur, seed):
    got = lg.poisson_arrivals(rate, dur, seed=seed)
    assert got == jlg.poisson_arrivals(rate, dur, seed=seed)
    assert got and got == sorted(got) and all(0 <= t < dur for t in got)


@pytest.mark.parametrize("rate,dur,seed,kw", BURSTY)
def test_bursty_schedule_equals_reference(rate, dur, seed, kw):
    got = lg.bursty_arrivals(rate, dur, seed, **kw)
    assert got == jlg.bursty_arrivals(rate, dur, seed, **kw)
    assert got and got == sorted(got) and all(0 <= t < dur for t in got)


def test_empty_schedules_equal_reference():
    for args in ((0.0, 10.0), (2.0, 0.0), (-1.0, 5.0)):
        assert lg.poisson_arrivals(*args) == jlg.poisson_arrivals(*args) == []
        assert lg.bursty_arrivals(*args) == jlg.bursty_arrivals(*args) == []


# --------------------------------------------------------------------- #
# 2. workloads
# --------------------------------------------------------------------- #
WORKLOADS = {
    "text": dict(),
    "phase12": dict(chip_smoke.PHASE12_WORKLOAD),
    "audio": dict(multimodal_fraction=1.0, modality="audio", encoder_d=64,
                  frame_len=10),
    "vision": dict(multimodal_fraction=1.0, modality="vision", encoder_d=32,
                   patch_min=2, patch_max=8),
    "mixed": dict(multimodal_fraction=0.5, modality="vision", encoder_d=16),
}


def _same_array(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("kind", sorted(WORKLOADS))
def test_build_workload_equals_reference(kind):
    offs = lg.poisson_arrivals(5.0, 5.0, seed=1)
    got = build_workload(offs, WorkloadConfig(**WORKLOADS[kind]), seed=9,
                         id_prefix="w")
    want = jlg.build_workload(offs, jlg.WorkloadConfig(**WORKLOADS[kind]),
                              seed=9, id_prefix="w")
    assert len(got) == len(want) == len(offs)
    for a, b in zip(got, want):
        assert type(a.request) is Request
        assert a.offset_s == b.offset_s
        ra, rb = a.request, b.request
        assert ra.req_id == rb.req_id
        assert _same_array(ra.prompt, rb.prompt)
        assert ra.max_new_tokens == rb.max_new_tokens
        assert _same_array(ra.frames, rb.frames)
        assert _same_array(ra.patches, rb.patches)
        assert ra.arrival_time is None and ra.state == State.QUEUED
    if kind == "mixed":
        n = sum(it.request.patches is not None for it in got)
        assert 0 < n < len(got)


def test_default_workload_config_equals_reference():
    import dataclasses
    assert dataclasses.asdict(WorkloadConfig()) == \
        dataclasses.asdict(jlg.WorkloadConfig())
    assert set(lg.__all__) == set(jlg.__all__)


def test_phase12_schedule_digest_equals_reference():
    """chip_smoke.py phase 12's traffic: the same offsets, prompts and
    output lengths from both packages, so the digest it prints names one
    schedule."""
    rate, dur, seed, kw = BURSTY[0]
    assert (rate, dur, seed, kw) == (chip_smoke.PHASE12_RATE,
                                     chip_smoke.PHASE12_DURATION_S,
                                     chip_smoke.PHASE12_SEED,
                                     chip_smoke.PHASE12_BURSTS)
    ours = chip_smoke.phase12_workload(lg)
    ref = chip_smoke.phase12_workload(jlg)
    assert chip_smoke.schedule_digest(ours) == chip_smoke.schedule_digest(ref)
    assert 20 <= len(ours) <= 45
    lens = [it.request.prompt_len for it in ours]
    assert 32 <= min(lens) and max(lens) <= 1024
    assert all(8 <= it.request.max_new_tokens <= 64 for it in ours)
    # the digest sees every field it names
    other = chip_smoke.phase12_workload(lg)
    other[-1].request.max_new_tokens += 1
    assert chip_smoke.schedule_digest(other) != \
        chip_smoke.schedule_digest(ours)


# --------------------------------------------------------------------- #
# 3. the open-loop driver over a stub runtime (tests/test_loadgen.py)
# --------------------------------------------------------------------- #
class _StubRuntime:
    """Minimal try_submit/step surface: finishes ``per_step`` queued
    requests per step, records submit wall times."""

    def __init__(self, admission=None, per_step=1):
        self.admission = admission
        self.ttft_ema = None
        self.stats = RuntimeStats()
        self.queue = []
        self.per_step = per_step
        self.submit_walls = {}

    def queue_depth(self):
        return len(self.queue)

    def try_submit(self, req):
        if not should_admit(self.admission, self.queue_depth(),
                            self.ttft_ema):
            req.state = State.SHED
            self.stats.shed += 1
            return False
        self.submit_walls[req.req_id] = time.monotonic()
        self.stats.submitted += 1
        self.queue.append(req)
        return True

    def step(self, timeout=0.0):
        for r in self.queue[:self.per_step]:
            now = time.monotonic()
            r.first_token_time = r.first_token_time or now
            r.last_token_time = now
            r.output_tokens = list(range(r.max_new_tokens))
            r.finish_time = now
            r.state = State.FINISHED
            self.stats.finished += 1
        del self.queue[:self.per_step]


def _workload(offsets):
    return build_workload(list(offsets), WorkloadConfig(), seed=5)


def test_driver_stamps_scheduled_arrival_not_submit_wall():
    rt = _StubRuntime()
    wl = _workload([0.0, 0.12])
    res = run_open_loop(rt, wl, max_wall_s=30.0)
    assert res.finished == 2 and res.shed == 0
    r0, r1 = wl[0].request, wl[1].request
    # arrivals are the schedule rebased onto one epoch: exact spacing
    assert r1.arrival_time - r0.arrival_time == pytest.approx(0.12,
                                                              abs=1e-9)
    for it in wl:
        assert it.request.arrival_time <= \
            rt.submit_walls[it.request.req_id]
        assert it.request.ttft() is not None and it.request.ttft() >= 0.0


def test_driver_sheds_exactly_at_headroom_never_mid_stream():
    rt = _StubRuntime(admission=AdmissionConfig(max_queue_depth=2),
                      per_step=1)
    wl = _workload([0.0] * 5)
    res = run_open_loop(rt, wl, max_wall_s=30.0)
    assert res.offered == 5
    assert res.admitted == 2 and res.shed == 3
    assert rt.stats.shed == 3
    states = [it.request.state for it in wl]
    assert states.count(State.SHED) == 3
    assert states.count(State.FINISHED) == 2
    assert res.finished == 2 and res.failed == 0
    assert res.as_dict() == {"wall_s": res.wall_s, "offered": 5,
                             "admitted": 2, "shed": 3, "finished": 2,
                             "failed": 0, "autoscale_actions": []}
    assert [r.req_id for r in res.requests] == [it.request.req_id
                                                for it in wl]


def test_driver_ticks_autoscaler_and_collects_actions():
    class _Scaler:
        def __init__(self):
            self.ticks = 0

        def tick(self):
            self.ticks += 1
            return "grow-d:D-auto0" if self.ticks == 1 else None

    rt = _StubRuntime(per_step=1)
    sc = _Scaler()
    res = run_open_loop(rt, _workload([0.0, 0.05, 0.30]), autoscaler=sc,
                        autoscale_every_s=0.05, max_wall_s=30.0)
    assert sc.ticks >= 2
    assert res.autoscale_actions == ["grow-d:D-auto0"]


def test_driver_raises_past_max_wall():
    class _Stuck(_StubRuntime):
        def step(self, timeout=0.0):
            time.sleep(0.01)

    with pytest.raises(RuntimeError, match="exceeded"):
        run_open_loop(_Stuck(), _workload([0.0]), max_wall_s=0.2)


# --------------------------------------------------------------------- #
# 4. Request.tpot_live
# --------------------------------------------------------------------- #
TPOT_CASES = {
    "in_flight": dict(first_token_time=10.0, last_token_time=10.9,
                      output_tokens=[1, 2, 3, 4]),
    "finished": dict(first_token_time=10.0, last_token_time=10.9,
                     finish_time=11.5, output_tokens=[1, 2, 3, 4, 5, 6]),
    "one_token": dict(first_token_time=10.0, last_token_time=10.0,
                      output_tokens=[7]),
    "two_tokens_finished": dict(first_token_time=3.0, last_token_time=3.25,
                                finish_time=3.25, output_tokens=[7, 8]),
    "no_first_token": dict(output_tokens=[]),
    "no_end": dict(first_token_time=1.0, output_tokens=[1, 2]),
}


@pytest.mark.parametrize("case", sorted(TPOT_CASES))
def test_tpot_live_equals_reference(case):
    kw = TPOT_CASES[case]
    prompt = np.arange(5, dtype=np.int32)
    got = Request("r", prompt, 8, **kw).tpot_live()
    want = JRequest("r", prompt, 8, **kw).tpot_live()
    assert got == want
    if case in ("one_token", "no_first_token", "no_end"):
        assert got is None
    else:
        assert got is not None and got > 0

"""The port's elastic P:D autoscaler (``repro_torch.core.autoscale``)
against the JAX package's.

1. The three in-process cases of tests/test_autoscale.py (grow D under
   slot pressure, drain back to the baseline when idle, no growth without
   pressure) on tiny dense CPU engines with the reference's parameters:
   the port's schedulers, engines and controller run beside the
   reference's, and the tokens, the action lists and the controller's
   stats are the reference's.
2. Lockstep: one scripted ``LoadSource`` trace of 64 ticks (queue depth,
   slot utilization, TTFTs, TPOTs) drives both controllers; the actions,
   the factory calls, the drains and the stats are identical.
3. One spawned case: ``ClusterLoadSource`` over the port's
   ``ClusterRuntime`` grows a live CPU D worker without stalling serving,
   every request finishes with the reference's single-process tokens, the
   surplus member drains back to the baseline, and the drained worker's
   final counts arrive.

Every comparison is exact: no tolerance.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro.core import autoscale as jauto
from repro.core.compat.precision import WireFormat as JWire
from repro.core.disagg import DisaggPipeline as JPipe
from repro.core.kv_transfer import TransferEngine as JTransfer
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import VendorProfile as JVendor
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import GlobalScheduler as JSched
from repro_torch.configs.base import config_from_dict
from repro_torch.core import autoscale as tauto
from repro_torch.core.autoscale import (AutoscalerConfig, ClusterLoadSource,
                                        PDAutoscaler)
from repro_torch.core.compat.precision import WireFormat
from repro_torch.core.disagg import DisaggPipeline
from repro_torch.core.kv_transfer import TransferEngine
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine, VendorProfile
from repro_torch.serving.multiproc import (ClusterRuntime, ClusterSpec,
                                           EngineSpec)
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import GlobalScheduler
from tests.conftest import TINY_FAMILIES

JCFG = TINY_FAMILIES["dense"]
CFG = config_from_dict(dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(jax.random.key(1), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


# --------------------------------------------------------------------- #
# 1. in-process (tests/test_autoscale.py), both packages side by side
# --------------------------------------------------------------------- #
def _port_side(params):
    def factory(role):
        return lambda name: Engine(name, CFG, params,
                                   VendorProfile("A", block_size=8),
                                   num_blocks=64, max_batch=2,
                                   max_seq_len=64, role=role, device="cpu")
    sched = GlobalScheduler(DisaggPipeline(TransferEngine(),
                                           WireFormat("raw", "float32")),
                            device="cpu")
    return sched, factory, tauto, Request


def _ref_side(jparams):
    def factory(role):
        return lambda name: JEngine(name, JCFG, jparams,
                                    JVendor("A", block_size=8),
                                    num_blocks=64, max_batch=2,
                                    max_seq_len=64, role=role)
    sched = JSched(JPipe(JTransfer(), JWire("raw", "float32")))
    return sched, factory, jauto, JRequest


def _setup(side, **cfg_kw):
    sched, factory, auto_mod, req_cls = side
    mk_p, mk_d = factory("prefill"), factory("decode")
    sched.add_instance(mk_p("P0"))
    sched.add_instance(mk_d("D0"))
    # huge SLOs: CPU wall-clock latencies must not trigger SLO pressure —
    # these cases exercise the queue/slot-utilization signals
    cfg_kw.setdefault("slo_ttft_s", 1e9)
    cfg_kw.setdefault("slo_tpot_s", 1e9)
    auto = auto_mod.PDAutoscaler(
        sched, mk_p, mk_d, baseline_p=1, baseline_d=1,
        config=auto_mod.AutoscalerConfig(cooldown_ticks=2, **cfg_kw))
    return sched, auto, req_cls


def _reqs(req_cls, n, seed=0):
    rng = np.random.default_rng(seed)
    return [req_cls(req_id=f"a{i}",
                    prompt=rng.integers(0, JCFG.vocab_size, 8)
                    .astype(np.int32), max_new_tokens=6)
            for i in range(n)]


def _grow_case(side):
    sched, auto, req_cls = _setup(side, d_util_high=0.7)
    reqs = _reqs(req_cls, 10)
    for r in reqs:
        sched.submit(r)
    actions = []
    for _ in range(300):
        if sched.stats.finished >= len(reqs):
            break
        sched.step()
        a = auto.tick()
        if a:
            actions.append(a)
    assert sched.stats.finished == len(reqs)
    assert auto.stats.grew_d >= 1, actions
    served = {k for k, v in sched.stats.d_dispatches.items() if v > 0}
    assert any(k.startswith("D-auto") for k in served)
    return {"tokens": {r.req_id: list(r.output_tokens) for r in reqs},
            "actions": actions, "stats": dataclasses.asdict(auto.stats)}


def _drain_case(side):
    sched, auto, req_cls = _setup(side, d_util_high=0.7)
    reqs = _reqs(req_cls, 10)
    for r in reqs:
        sched.submit(r)
    actions = []
    for _ in range(300):
        sched.step()
        actions.append(auto.tick())
        if sched.stats.finished >= len(reqs):
            break
    grew = auto.stats.grew_d + auto.stats.grew_p
    for _ in range(10 * (grew + 1)):
        sched.step()
        actions.append(auto.tick())
    assert auto.stats.drained >= min(grew, 1)
    assert len(sched._routable(sched.d_pool)) >= auto.baseline_d
    assert "D0" in sched.d_pool and "D0" not in sched._draining
    return {"tokens": {r.req_id: list(r.output_tokens) for r in reqs},
            "actions": [a for a in actions if a],
            "stats": dataclasses.asdict(auto.stats),
            "draining": sorted(sched._draining)}


def _quiet_case(side):
    sched, auto, req_cls = _setup(side)
    reqs = _reqs(req_cls, 1)
    for r in reqs:
        sched.submit(r)
    for _ in range(100):
        sched.step()
        assert auto.tick() is None
        if sched.stats.finished >= 1:
            break
    assert auto.stats.grew_p == 0 and auto.stats.grew_d == 0
    return {"tokens": {r.req_id: list(r.output_tokens) for r in reqs},
            "stats": dataclasses.asdict(auto.stats)}


@pytest.mark.parametrize("case", [_grow_case, _drain_case, _quiet_case],
                         ids=["grows_d_under_slot_pressure",
                              "drains_when_idle_but_keeps_baseline",
                              "no_growth_without_pressure"])
def test_in_process_case_equals_reference(case, params, jparams):
    got = case(_port_side(params))
    want = case(_ref_side(jparams))
    assert got == want


# --------------------------------------------------------------------- #
# 2. lockstep over one scripted trace
# --------------------------------------------------------------------- #
def _trace(n=64, seed=3):
    """(p_queue_depth, d_utilization, ttfts, tpots) per tick: quiet, a
    queue burst, slot pressure, SLO pressure on each side, then a long
    idle tail that drains — with seeded noise so no branch is scripted
    by hand alone."""
    rng = np.random.default_rng(seed)
    rows = []
    for t in range(n):
        q = float(rng.uniform(0.0, 0.5))
        util = float(rng.uniform(0.1, 0.5))
        ttfts = [float(x) for x in rng.uniform(0.1, 0.5, rng.integers(0, 4))]
        tpots = [float(x) for x in rng.uniform(0.01, 0.05,
                                                rng.integers(0, 4))]
        if 6 <= t < 12:
            q = 3.0 + t                          # queue burst → grow P
        elif 12 <= t < 18:
            util = 0.95                          # slot pressure → grow D
        elif 18 <= t < 24:
            ttfts.append(0.9)                    # TTFT past 80 % → grow P
        elif 24 <= t < 30:
            tpots.append(0.085)                  # TPOT past 80 % → grow D
        elif 30 <= t < 34:
            q, util, ttfts, tpots = 0.0, 0.2, [], []   # busy, not idle
        elif t >= 34:
            q, util = 0.0, 0.05                  # idle: drain to baseline
        rows.append((q, util, ttfts, tpots))
    return rows


def _scripted_source(base):
    class Scripted(base):
        def __init__(self, rows):
            self.rows, self.t = rows, -1
            self.pools = {"P": ["P0"], "D": ["D0"]}
            self.added = []
            self.log = []

        def advance(self):
            self.t += 1

        def _row(self):
            return self.rows[self.t]

        def num_p(self):
            return len(self.pools["P"])

        def num_d(self):
            return len(self.pools["D"])

        def p_queue_depth(self):
            return self._row()[0]

        def d_utilization(self):
            return self._row()[1]

        def recent_ttfts(self):
            return list(self._row()[2])

        def recent_tpots(self):
            return list(self._row()[3])

        def grow(self, name, role, factory):
            self.log.append(("grow", self.t, name, role, factory(name)))
            self.pools[role].append(name)
            self.added.append((name, role))

        def surplus(self, role):
            return [n for n, r in self.added if r == role]

        def drain(self, name):
            self.log.append(("drain", self.t, name))
            self.added = [(n, r) for n, r in self.added if n != name]
            for pool in self.pools.values():
                if name in pool:
                    pool.remove(name)
    return Scripted


def _lockstep(mod, rows, **cfg_kw):
    src = _scripted_source(mod.LoadSource)(rows)
    auto = mod.PDAutoscaler(src, lambda n: f"spec-P:{n}",
                            lambda n: f"spec-D:{n}", baseline_p=1,
                            baseline_d=1,
                            config=mod.AutoscalerConfig(**cfg_kw))
    assert auto.src is src and auto.sched is None
    actions = []
    for _ in rows:
        src.advance()
        actions.append(auto.tick())
    return {"actions": actions, "log": src.log,
            "stats": dataclasses.asdict(auto.stats),
            "pools": src.pools}


@pytest.mark.parametrize("cfg_kw", [
    dict(slo_ttft_s=1.0, slo_tpot_s=0.1, cooldown_ticks=3, max_p=3,
         max_d=3),
    dict(slo_ttft_s=1.0, slo_tpot_s=0.1, cooldown_ticks=1, max_p=2,
         max_d=4, pressure=0.9, low_util=0.1)],
    ids=["cooldown3", "cooldown1"])
def test_lockstep_trace_gives_reference_actions(cfg_kw):
    rows = _trace()
    got = _lockstep(tauto, rows, **cfg_kw)
    want = _lockstep(jauto, rows, **cfg_kw)
    assert got == want
    kinds = {a.split(":")[0] for a in got["actions"] if a}
    assert kinds == {"grow-p", "grow-d", "drain"}, got["actions"]
    assert got["pools"] == {"P": ["P0"], "D": ["D0"]}   # back to baseline


def test_config_defaults_equal_reference():
    assert dataclasses.asdict(tauto.AutoscalerConfig()) == \
        dataclasses.asdict(jauto.AutoscalerConfig())
    assert dataclasses.asdict(tauto.AutoscalerStats()) == \
        dataclasses.asdict(jauto.AutoscalerStats())


# --------------------------------------------------------------------- #
# 3. spawned: ClusterLoadSource grows a live CPU D worker
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def params_path(tmp_path_factory):
    """The reference's seed-0 parameters, converted for the workers."""
    jp = JM.init_params(jax.random.key(0), JCFG)
    path = tmp_path_factory.mktemp("params") / "dense.pt"
    torch.save(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), path)
    return str(path)


def _ref_tokens():
    """The reference's single-process loop on the same requests."""
    jp = JM.init_params(jax.random.key(0), JCFG)
    sched = JSched(JPipe(JTransfer(), JWire("raw", "float32")),
                   prefill_chunk=8)
    for name, role in (("P0", "prefill"), ("D0", "decode")):
        sched.add_instance(JEngine(name, JCFG, jp, JVendor("A", block_size=8),
                                   num_blocks=64, max_batch=2,
                                   max_seq_len=64, role=role))
    reqs = _reqs(JRequest, 8)
    sched.run(reqs, max_ticks=2000)
    assert sched.stats.finished == len(reqs)
    return {r.req_id: list(r.output_tokens) for r in reqs}


def test_cluster_load_source_grows_live_d_process(params_path):
    vendor = VendorProfile("A", block_size=8)
    mk = lambda name, role: EngineSpec(name, CFG, vendor, params_seed=0,
                                       num_blocks=64, max_batch=2,
                                       max_seq_len=64, role=role,
                                       device="cpu", params_path=params_path)
    rt = ClusterRuntime(ClusterSpec(p=(mk("P0", "prefill"),),
                                    d=(mk("D0", "decode"),)),
                        prefill_chunk=8, wire=WireFormat("raw", "float32"))
    try:
        rt.start()
        rt.reset_launch_counts()         # idle workers: a no-op on the CPU
        auto = PDAutoscaler(
            ClusterLoadSource(rt),
            p_factory=lambda n: mk(n, "prefill"),
            d_factory=lambda n: mk(n, "decode"),
            baseline_p=1, baseline_d=1,
            config=AutoscalerConfig(cooldown_ticks=2, d_util_high=0.5,
                                    slo_ttft_s=1e9, slo_tpot_s=1e9,
                                    max_p=1, max_d=2))
        reqs = _reqs(Request, 8)
        for r in reqs:
            rt.submit(r)
        actions = []
        deadline = time.monotonic() + 300.0
        while rt._unresolved() and time.monotonic() < deadline:
            rt.step(timeout=0.02)
            a = auto.tick()
            if a:
                actions.append(a)
        assert rt._unresolved() == 0
        assert rt.stats.finished == len(reqs) and rt.stats.failed == 0
        assert auto.stats.grew_d >= 1 and actions[0] == "grow-d:D-auto0"
        assert all(len(r.output_tokens) == r.max_new_tokens for r in reqs)
        # non-blocking grow: the new member is routable once its Hello lands
        deadline = time.monotonic() + 120.0
        while "D1" not in {i.iid for i in rt._routable("D")} \
                and time.monotonic() < deadline:
            rt.step(timeout=0.05)
        assert "D1" in {i.iid for i in rt._routable("D")}
        assert rt.worker_pids.get("D1")
        # idle: sustained low utilization drains the surplus D, never D0
        deadline = time.monotonic() + 120.0
        while "D1" in rt._instances and time.monotonic() < deadline:
            rt.step(timeout=0.02)
            auto.tick()
        assert "D1" not in rt._instances
        assert auto.stats.drained >= 1
        assert "D0" in {i.iid for i in rt._routable("D")}
    finally:
        rt.shutdown()
    assert {r.req_id: list(r.output_tokens) for r in reqs} == _ref_tokens()
    # every worker's final counts arrived, the drained one's too
    assert set(rt.worker_launches) == {"P0", "D0", "D1"}
    assert all(n == 0 for c in rt.worker_launches.values()
               for n in c.values())                 # CPU: plain versions

"""Elastic P:D pool autoscaler — port of ``repro.core.autoscale``: the
paper's 'adjust the P-D instance ratio' knob made dynamic (§IV benefit
scenario #1). The same decisions in the same order as the reference.

Policy, evaluated per control tick against SLO headroom:
  * TTFT pressure  (pending prefills per routable P > p_queue_high, or
    TTFT EMA > slo_ttft × pressure)  → add a P instance
  * TPOT pressure  (decode slot utilization > d_util_high, or TPOT EMA >
    slo_tpot × pressure)             → add a D instance
  * sustained idleness (utilization < low watermark for `cooldown` ticks)
    → drain the newest surplus instance (never below the planner's
    baseline ratio)

The planner's DeploymentPlan provides the baseline (n_prefill, n_decode);
the autoscaler never scales below it — the static optimum is the floor,
the dynamics handle bursts.

The controller is decoupled from where the load numbers come from by a
:class:`LoadSource`: :class:`SchedulerLoadSource` reads the in-process
``GlobalScheduler`` (engines in this process, ``Engine.load()`` is
callable), while :class:`ClusterLoadSource` reads the multi-process
``ClusterRuntime`` — *measured* queue depth and slot occupancy from
worker heartbeats plus the parent's own dispatch bookkeeping, with
grow/drain mapped onto ``add_instance``/``remove_instance`` (spawning
and draining real worker processes). Instances are created through a
user factory (on a real cluster: pod allocation + weight loading; here:
``Engine()`` / ``EngineSpec``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class AutoscalerConfig:
    slo_ttft_s: float = 1.0
    slo_tpot_s: float = 0.1
    pressure: float = 0.8          # act at 80% of the SLO
    p_queue_high: float = 2.0      # pending prefills per routable P
    d_util_high: float = 0.85      # occupied decode slots fraction
    low_util: float = 0.15
    cooldown_ticks: int = 20       # hysteresis for both grow and shrink
    max_p: int = 8
    max_d: int = 8


@dataclasses.dataclass
class AutoscalerStats:
    grew_p: int = 0
    grew_d: int = 0
    drained: int = 0


class LoadSource:
    """What the controller observes and actuates, independent of runtime."""

    def num_p(self) -> int:
        raise NotImplementedError

    def num_d(self) -> int:
        raise NotImplementedError

    def p_queue_depth(self) -> float:
        """Pending prefills per routable P instance."""
        raise NotImplementedError

    def d_utilization(self) -> float:
        """Mean occupied-slot fraction across routable D instances."""
        raise NotImplementedError

    def recent_ttfts(self) -> List[float]:
        raise NotImplementedError

    def recent_tpots(self) -> List[float]:
        raise NotImplementedError

    def grow(self, name: str, role: str, factory: Callable[[str], Any]) -> None:
        raise NotImplementedError

    def surplus(self, role: str) -> List[str]:
        """Autoscaler-added instances (newest last) eligible for draining."""
        raise NotImplementedError

    def drain(self, name: str) -> None:
        raise NotImplementedError


class SchedulerLoadSource(LoadSource):
    """In-process backend: the ``GlobalScheduler``'s pools and queue."""

    def __init__(self, scheduler):
        self.sched = scheduler

    def _routable_p(self):
        return self.sched._routable(self.sched.p_pool)

    def _routable_d(self):
        return self.sched._routable(self.sched.d_pool)

    def num_p(self) -> int:
        return len(self._routable_p())

    def num_d(self) -> int:
        return len(self._routable_d())

    def p_queue_depth(self) -> float:
        return len(self.sched.pending) / max(self.num_p(), 1)

    def d_utilization(self) -> float:
        ds = self._routable_d()
        if not ds:
            return 1.0
        return sum(e.load() for e in ds) / len(ds)

    def recent_ttfts(self) -> List[float]:
        return [r.ttft() for r in self.sched.finished[-16:]
                if r.ttft() is not None]

    def recent_tpots(self) -> List[float]:
        return [r.tpot() for r in self.sched.finished[-16:]
                if r.tpot() is not None]

    def grow(self, name: str, role: str,
             factory: Callable[[str], Any]) -> None:
        self.sched.add_instance(
            factory(name), role="prefill" if role == "P" else "decode")

    def surplus(self, role: str) -> List[str]:
        pool = self.sched.p_pool if role == "P" else self.sched.d_pool
        return [n for n in pool if n.startswith(f"{role}-auto")
                and n not in self.sched._draining]

    def drain(self, name: str) -> None:
        self.sched.remove_instance(name)


class ClusterLoadSource(LoadSource):
    """Multi-process backend: the ``ClusterRuntime``'s *measured* load —
    worker heartbeats (each P reports its backlog, each D its occupied
    slots) plus the parent's pending queue and dispatch bookkeeping —
    actuated through real process spawn/drain. Factories here return
    ``EngineSpec``s, not ``Engine``s: the engine is built inside the new
    worker process."""

    def __init__(self, runtime):
        self.rt = runtime
        self._added: Dict[str, str] = {}      # iid → role, newest last

    def _members(self, role: str) -> list:
        """Pool members counted against max_p/max_d and the drain floor:
        includes instances still booting (spawned without waiting, Hello
        not yet seen). Counting only *routable* members would re-trigger
        grow every cooldown for the whole boot window — on slow hosts
        that is many seconds — overshooting the cap with processes whose
        imports then starve the serving loop."""
        return [i for i in self.rt._instances.values()
                if i.role == role and i.alive()
                and not i.draining and not i.stopping]

    def num_p(self) -> int:
        return len(self._members("P"))

    def num_d(self) -> int:
        return len(self._members("D"))

    def p_queue_depth(self) -> float:
        """Parent's undispatched queue + each P's heartbeat-reported
        backlog (work dispatched but not yet prefilled), per routable P."""
        ps = self.rt._routable("P")
        backlog = len(self.rt._pending) + sum(
            int(i.load.get("backlog", i.queue_reqs)) for i in ps)
        return backlog / max(len(ps), 1)

    def d_utilization(self) -> float:
        ds = self.rt._routable("D")
        if not ds:
            return 1.0
        total = 0.0
        for i in ds:
            cap = max(i.spec.engine.max_batch, 1)
            # heartbeat-measured occupancy when fresh, parent's reserved
            # count otherwise (heartbeats lag the dispatch edge)
            total += max(i.load.get("active", 0.0), float(i.active)) / cap
        return total / len(ds)

    def recent_ttfts(self) -> List[float]:
        """Newest 16 first-token latencies, *including in-flight streams*.
        Sampling finished requests only biased the EMA toward short,
        already-completed requests and reacted a full request-length late
        under ramp — a request that just got its first token after 5 s of
        queueing is exactly the signal scale-up must see."""
        live = [r for r in self.rt._requests.values()
                if r.first_token_time is not None]
        live.sort(key=lambda r: r.first_token_time)
        return [t for t in (r.ttft() for r in live[-16:]) if t is not None]

    def recent_tpots(self) -> List[float]:
        """Newest 16 per-token latencies, including in-flight streams
        (``tpot_live`` uses the last emitted token as the endpoint)."""
        live = [r for r in self.rt._requests.values()
                if r.first_token_time is not None]
        live.sort(key=lambda r: r.last_token_time
                  or r.finish_time or r.first_token_time)
        return [t for t in (r.tpot_live() for r in live[-16:])
                if t is not None]

    def grow(self, name: str, role: str,
             factory: Callable[[str], Any]) -> None:
        # non-blocking: the worker becomes routable when its Hello lands;
        # a live run must keep serving while the new process boots
        iid = self.rt.add_instance(factory(name), role, wait=False)
        self._added[iid] = role

    def surplus(self, role: str) -> List[str]:
        return [iid for iid, r in self._added.items()
                if r == role and iid in self.rt._instances
                and not self.rt._instances[iid].draining]

    def drain(self, name: str) -> None:
        self.rt.remove_instance(name)
        self._added.pop(name, None)


class PDAutoscaler:
    def __init__(self, scheduler,
                 p_factory: Callable[[str], Any],
                 d_factory: Callable[[str], Any],
                 baseline_p: int = 1, baseline_d: int = 1,
                 config: Optional[AutoscalerConfig] = None):
        # accept either a raw GlobalScheduler (compat) or any LoadSource
        self.src = scheduler if isinstance(scheduler, LoadSource) \
            else SchedulerLoadSource(scheduler)
        self.sched = getattr(self.src, "sched", None)
        self.p_factory = p_factory
        self.d_factory = d_factory
        self.baseline_p = baseline_p
        self.baseline_d = baseline_d
        self.cfg = config or AutoscalerConfig()
        self.stats = AutoscalerStats()
        self._counter = 0
        self._idle_ticks = 0
        self._last_grow = -10**9
        self._tick = 0

    # -- control ------------------------------------------------------------ #
    def tick(self) -> Optional[str]:
        """Run one control decision. Returns the action taken, if any."""
        self._tick += 1
        cfg, src = self.cfg, self.src
        cooled = (self._tick - self._last_grow) >= cfg.cooldown_ticks
        ttfts = src.recent_ttfts()
        tpots = src.recent_tpots()
        ttft = max(ttfts) if ttfts else 0.0
        tpot = max(tpots) if tpots else 0.0

        if (src.p_queue_depth() > cfg.p_queue_high
                or ttft > cfg.slo_ttft_s * cfg.pressure) \
                and src.num_p() < cfg.max_p and cooled:
            name = f"P-auto{self._counter}"
            self._counter += 1
            src.grow(name, "P", self.p_factory)
            self.stats.grew_p += 1
            self._last_grow = self._tick
            return f"grow-p:{name}"

        if (src.d_utilization() > cfg.d_util_high
                or tpot > cfg.slo_tpot_s * cfg.pressure) \
                and src.num_d() < cfg.max_d and cooled:
            name = f"D-auto{self._counter}"
            self._counter += 1
            src.grow(name, "D", self.d_factory)
            self.stats.grew_d += 1
            self._last_grow = self._tick
            return f"grow-d:{name}"

        # shrink: sustained idleness, never below the planner baseline
        busy = src.d_utilization() > cfg.low_util \
            or src.p_queue_depth() > 0
        self._idle_ticks = 0 if busy else self._idle_ticks + 1
        if self._idle_ticks >= cfg.cooldown_ticks:
            self._idle_ticks = 0
            surplus_d = src.surplus("D")
            surplus_p = src.surplus("P")
            if src.num_d() > self.baseline_d and surplus_d:
                src.drain(surplus_d[-1])
                self.stats.drained += 1
                return f"drain:{surplus_d[-1]}"
            if src.num_p() > self.baseline_p and surplus_p:
                src.drain(surplus_p[-1])
                self.stats.drained += 1
                return f"drain:{surplus_p[-1]}"
        return None

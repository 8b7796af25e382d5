"""Open-loop driver — port of ``repro.serving.loadgen.driver``: replay a
scheduled workload against a running ``ClusterRuntime`` in real time.

The driver rebases each item's arrival offset onto the host monotonic
clock (``t0 + offset_s``) and stamps it into ``Request.arrival_time``
*before* submitting — TTFT therefore measures from the scheduled
arrival, so time a request spends queued (or waiting for the driver loop
to get around to it) counts against the server, exactly as an external
client would experience it. The closed-loop accounting (TTFT from the
moment of submit) stays reachable by submitting requests with
``arrival_time=None`` through ``ClusterRuntime.serve`` — the parity
baseline for closed-loop tests.

Submission is admission-controlled and non-blocking
(``ClusterRuntime.try_submit``): when the cluster's measured headroom is
exhausted the request is shed at the door (terminal ``State.SHED``,
counted), never abandoned mid-stream. Between due arrivals the driver
pumps ``runtime.step`` and, at a fixed cadence, ticks an optional
autoscaler — live elasticity: grow decisions spawn real worker processes
that join the pool when their Hello lands, while serving continues.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List

from repro_torch.serving.loadgen.workload import ScheduledRequest
from repro_torch.serving.request import Request, State

_TERMINAL = (State.FINISHED, State.FAILED, State.SHED)


@dataclasses.dataclass
class OpenLoopResult:
    """Outcome of one open-loop run (requests carry their own timings)."""
    wall_s: float
    offered: int                       # scheduled arrivals replayed
    admitted: int
    shed: int
    finished: int
    failed: int
    autoscale_actions: List[str] = dataclasses.field(default_factory=list)
    requests: List[Request] = dataclasses.field(default_factory=list)

    def as_dict(self) -> Dict[str, Any]:
        return {"wall_s": self.wall_s, "offered": self.offered,
                "admitted": self.admitted, "shed": self.shed,
                "finished": self.finished, "failed": self.failed,
                "autoscale_actions": list(self.autoscale_actions)}


def run_open_loop(runtime: Any, workload: List[ScheduledRequest], *,
                  autoscaler: Any = None, autoscale_every_s: float = 0.25,
                  step_timeout_s: float = 0.02,
                  max_wall_s: float = 900.0) -> OpenLoopResult:
    """Replay ``workload`` open-loop; drive every admitted request to a
    terminal state. ``runtime`` needs ``try_submit`` and ``step`` (duck-
    typed: tests drive a stub). Raises after ``max_wall_s`` — an open
    loop over a saturated cluster with no admission control would
    otherwise queue without bound."""
    items = collections.deque(sorted(workload, key=lambda it: it.offset_s))
    t0 = time.monotonic()
    deadline = t0 + max_wall_s
    last_tick = t0
    admitted: List[Request] = []
    result = OpenLoopResult(wall_s=0.0, offered=len(items), admitted=0,
                            shed=0, finished=0, failed=0)
    result.requests = [it.request for it in items]

    def outstanding() -> bool:
        return bool(items) or any(r.state not in _TERMINAL for r in admitted)

    while outstanding():
        now = time.monotonic()
        if now > deadline:
            raise RuntimeError(
                f"open-loop run exceeded {max_wall_s:.0f}s with "
                f"{len(items)} arrival(s) unplayed and "
                f"{sum(1 for r in admitted if r.state not in _TERMINAL)} "
                f"request(s) in flight")
        while items and t0 + items[0].offset_s <= now:
            it = items.popleft()
            # scheduled arrival, not submit wall time: queueing delay —
            # including driver-loop lag — lands on TTFT
            it.request.arrival_time = t0 + it.offset_s
            if runtime.try_submit(it.request):
                admitted.append(it.request)
                result.admitted += 1
            else:
                result.shed += 1
        runtime.step(timeout=step_timeout_s)
        if autoscaler is not None and now - last_tick >= autoscale_every_s:
            last_tick = now
            action = autoscaler.tick()
            if action:
                result.autoscale_actions.append(action)

    result.wall_s = time.monotonic() - t0
    result.finished = sum(1 for r in admitted if r.state == State.FINISHED)
    result.failed = sum(1 for r in admitted if r.state == State.FAILED)
    return result

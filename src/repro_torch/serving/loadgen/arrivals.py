"""Open-loop arrival processes — port of
``repro.serving.loadgen.arrivals`` (same draws in the same order).

An *open-loop* load generator emits requests on a schedule that does not
depend on the system's responses — the arrival process is fixed up front,
and a slow server accumulates queue instead of slowing the offered load
down (the closed-loop artifact that hides capacity cliffs; see the
coordinated-omission literature). Generators here return sorted arrival
*offsets* in seconds from the run epoch; the driver rebases them onto the
host monotonic clock at run start.

Both processes are deterministic under a seed: the same (seed, rate,
duration) produces bit-identical schedules, so a benchmark run is
replayable and two topologies face the same traffic.
"""
from __future__ import annotations

from typing import List

import numpy as np


def poisson_arrivals(rate_rps: float, duration_s: float,
                     seed: int = 0) -> List[float]:
    """Homogeneous Poisson process: i.i.d. exponential inter-arrival gaps
    at ``rate_rps``, truncated to ``duration_s``."""
    if rate_rps <= 0 or duration_s <= 0:
        return []
    rng = np.random.default_rng(seed)
    out: List[float] = []
    t = 0.0
    # draw in blocks: E[n] = rate·duration, pad by 4·sigma and top up
    while True:
        n = max(int(rate_rps * duration_s
                    + 4 * np.sqrt(rate_rps * duration_s)) + 1, 16)
        for gap in rng.exponential(1.0 / rate_rps, size=n):
            t += float(gap)
            if t >= duration_s:
                return out
            out.append(t)


def bursty_arrivals(rate_rps: float, duration_s: float, seed: int = 0, *,
                    burst_factor: float = 4.0, duty: float = 0.25,
                    period_s: float = 2.0) -> List[float]:
    """Two-state Markov-modulated Poisson process (ON/OFF bursts).

    The ON state offers ``burst_factor``× the base intensity for a
    ``duty`` fraction of each (exponentially jittered) ``period_s``; the
    OFF state offers the remainder so the *average* rate stays
    ``rate_rps`` — bursty and smooth schedules are load-comparable, the
    burstiness only moves when the traffic lands.
    """
    if rate_rps <= 0 or duration_s <= 0:
        return []
    duty = min(max(duty, 1e-6), 1.0)
    on_rate = rate_rps * burst_factor
    # solve duty·on + (1−duty)·off = base  (clamped at 0: extreme
    # burst_factor turns OFF fully silent)
    off_rate = max((rate_rps - duty * on_rate) / max(1.0 - duty, 1e-6), 0.0)
    rng = np.random.default_rng(seed)
    out: List[float] = []
    t = 0.0
    on = True
    while t < duration_s:
        frac = duty if on else (1.0 - duty)
        dwell = float(rng.exponential(period_s * frac))
        rate = on_rate if on else off_rate
        if rate > 0:
            tt = t
            while True:
                tt += float(rng.exponential(1.0 / rate))
                if tt >= min(t + dwell, duration_s):
                    break
                out.append(tt)
        t += dwell
        on = not on
    return out

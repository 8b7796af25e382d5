"""Server front-end (paper Fig. 1 'server' module) — port of
``repro.serving.server``.

HTTP is out of scope here; `Server` is the request-queue +
completion-callback layer the global scheduler sits behind. `ServeResult`
aggregates the SLO metrics the paper reports (TTFT / TPOT / throughput).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import GlobalScheduler


@dataclasses.dataclass
class ServeResult:
    requests: List[Request]
    wall_seconds: float

    def ttft(self) -> np.ndarray:
        return np.asarray([r.ttft() for r in self.requests
                           if r.ttft() is not None])

    def tpot(self) -> np.ndarray:
        return np.asarray([r.tpot() for r in self.requests
                           if r.tpot() is not None])

    def throughput_tok_s(self) -> float:
        tokens = sum(len(r.output_tokens) for r in self.requests)
        return tokens / max(self.wall_seconds, 1e-9)

    def summary(self) -> Dict[str, float]:
        ttft, tpot = self.ttft(), self.tpot()
        return {
            "requests": len(self.requests),
            "ttft_mean_s": float(ttft.mean()) if ttft.size else float("nan"),
            "ttft_p99_s": float(np.percentile(ttft, 99)) if ttft.size else float("nan"),
            "tpot_mean_s": float(tpot.mean()) if tpot.size else float("nan"),
            "throughput_tok_s": self.throughput_tok_s(),
        }


class Server:
    def __init__(self, scheduler: GlobalScheduler):
        self.scheduler = scheduler
        self._streams: Dict[str, List[int]] = {}
        self._callbacks: Dict[str, Callable[[Request, int], None]] = {}

    def submit(self, req: Request,
               on_token: Optional[Callable[[Request, int], None]] = None) -> None:
        self._streams[req.req_id] = []
        if on_token:
            self._callbacks[req.req_id] = on_token
        self.scheduler.submit(req)

    def serve(self, requests: List[Request], max_ticks: int = 10_000
              ) -> ServeResult:
        t0 = time.perf_counter()
        for r in requests:
            self.submit(r)
        done_target = len(requests)
        for _ in range(max_ticks):
            stats = self.scheduler.stats
            if stats.finished + stats.failed >= done_target:
                break
            for req, tok in self.scheduler.step():
                self._streams.setdefault(req.req_id, []).append(tok)
                cb = self._callbacks.get(req.req_id)
                if cb:
                    cb(req, tok)
        return ServeResult(requests=list(requests),
                           wall_seconds=time.perf_counter() - t0)

    def stream(self, req_id: str) -> List[int]:
        return list(self._streams.get(req_id, []))

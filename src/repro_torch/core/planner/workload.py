"""Workload descriptors: QPS, context lengths, SLOs (paper §IV-V) — port
of ``repro.core.planner.workload``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Workload:
    qps: float                    # requests / second, cluster-wide
    input_len: int                # prompt tokens (paper: 256..1024)
    output_len: int               # generated tokens
    slo_ttft_s: float = 2.0       # L_ttft
    slo_tpot_s: float = 0.1       # L_tpot
    encoder_len: int = 0          # encoder positions (audio frames / image
                                  # patches) run as a P-side preamble; 0 for
                                  # text-only families

    def label(self) -> str:
        base = f"{self.input_len}+{self.output_len} QPS{self.qps:g}"
        return f"{base} enc{self.encoder_len}" if self.encoder_len else base


# the paper's experimental points
PAPER_CONTEXTS = [(256, 256), (512, 512), (512, 1024), (1024, 1024)]
FIG6 = [Workload(qps=2.0, input_len=i, output_len=o)
        for (i, o) in PAPER_CONTEXTS]
FIG7 = Workload(qps=2.0, input_len=256, output_len=256)
FIG8 = Workload(qps=3.0, input_len=1024, output_len=1024)
FIG9 = Workload(qps=3.0, input_len=512, output_len=1024)
FIG10 = Workload(qps=2.0, input_len=1024, output_len=1024)

"""Open-loop heavy-traffic harness — port of ``repro.serving.loadgen``:
seeded arrival processes, ShareGPT-like synthetic workloads, and a
real-time driver that replays them against the cluster runtime with
SLO-aware admission and live autoscaling. Host-side numpy and Python
only; the schedules and workloads are the reference's to the bit."""
from repro_torch.serving.loadgen.arrivals import (bursty_arrivals,
                                                  poisson_arrivals)
from repro_torch.serving.loadgen.driver import OpenLoopResult, run_open_loop
from repro_torch.serving.loadgen.workload import (ScheduledRequest,
                                                  WorkloadConfig,
                                                  build_workload)

__all__ = ["poisson_arrivals", "bursty_arrivals", "WorkloadConfig",
           "ScheduledRequest", "build_workload", "OpenLoopResult",
           "run_open_loop"]

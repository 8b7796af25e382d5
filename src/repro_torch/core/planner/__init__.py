"""Deployment planner: layered simulator + two-stage joint optimization —
port of ``repro.core.planner`` (host-side numpy and Python; the same
plans and simulations as the reference, field for field)."""
from repro_torch.core.planner.hardware import (  # noqa: F401
    GPU_A, GPU_B, H100_SXM, TPU_V5E, HardwareSpec)
from repro_torch.core.planner.optimizer import (  # noqa: F401
    DeploymentPlan, optimize_decode, optimize_prefill, plan_deployment)
from repro_torch.core.planner.simulator import (  # noqa: F401
    FrameworkModel, InstanceModel, ParallelStrategy)
from repro_torch.core.planner.workload import Workload  # noqa: F401

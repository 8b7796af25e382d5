"""Joint optimization walkthrough of the PyTorch port (paper §III-C/§IV):
given a customer QPS + SLO + context profile, pick parallel strategies
and the P:D ratio on the paper's heterogeneous GPU pair, then
sanity-check the plan in the discrete-event simulator. The PyTorch
counterpart of ``examples/plan_deployment.py``: the same flags, defaults
and printed lines.

The planner and the event simulator are host arithmetic: ``--device``
only checks that the device asked for is there (the card unless
``--device cpu``), as every entry point of the port does.

  PYTHONPATH=src python examples/torch_plan_deployment.py [--qps 6] \\
      [--input 1024] [--device cpu]
"""
import argparse

from repro_torch.configs.base import get_config
from repro_torch.core.planner.events import simulate
from repro_torch.core.planner.hardware import GPU_A, GPU_B, TPU_V5E
from repro_torch.core.planner.optimizer import plan_deployment
from repro_torch.core.planner.simulator import InstanceModel
from repro_torch.core.planner.workload import Workload


def main(argv=None):
    from repro_torch import device as _dev
    ap = argparse.ArgumentParser()
    ap.add_argument("--qps", type=float, default=6.0)
    ap.add_argument("--input", type=int, default=1024, dest="input_len")
    ap.add_argument("--output", type=int, default=1024, dest="output_len")
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' where there is none")
    args = ap.parse_args(argv)
    _dev.resolve(args.device)

    cfg = get_config(args.model)
    wl = Workload(qps=args.qps, input_len=args.input_len,
                  output_len=args.output_len,
                  slo_ttft_s=1.0, slo_tpot_s=0.08)
    print(f"workload: {wl.label()}  SLO ttft≤{wl.slo_ttft_s}s "
          f"tpot≤{wl.slo_tpot_s*1e3:.0f}ms\n")

    print("— stage 1 (Eq. 1): prefill strategy on GPU B (512 TF, 32 GB)")
    print("— stage 2 (Eq. 4): decode strategy + instance count on GPU A "
          "(312 TF, 80 GB, 2 TB/s)")
    plan = plan_deployment(cfg, wl, p_hw=GPU_B, d_hw=GPU_A)
    print(f"\nplan: {plan.ratio()}")
    print(f"  P: {plan.n_prefill}× {plan.prefill.strategy.label()} "
          f"(l_p={plan.prefill.latency_s*1e3:.0f} ms, "
          f"{plan.prefill.vram_gb:.1f} GiB)  "
          f"[searched {plan.prefill.candidates_evaluated}, "
          f"rejected {plan.prefill.rejected_slo} SLO / "
          f"{plan.prefill.rejected_vram} VRAM]")
    print(f"  D: {plan.n_decode}× {plan.decode.strategy.label()} "
          f"batch={plan.decode.batch} "
          f"(l_d={plan.decode.latency_s*1e3:.1f} ms, "
          f"{plan.decode.vram_gb:.1f} GiB)")
    print(f"  cost {plan.cost_per_hour:.1f} $/h, "
          f"capacity {plan.qps_capacity:.2f} QPS")

    # validate in the event simulator at the planned ratio
    mP = InstanceModel(cfg, GPU_B, plan.prefill.strategy)
    mD = InstanceModel(cfg, GPU_A, plan.decode.strategy)
    r = simulate(cfg, wl, p_model=mP, d_model=mD,
                 n_prefill=plan.n_prefill, n_decode=plan.n_decode,
                 duration_s=90)
    print(f"\nsimulated at plan: ttft {r.ttft_mean()*1e3:.0f} ms "
          f"(SLO {wl.slo_ttft_s*1e3:.0f}), tpot {r.tpot_mean()*1e3:.1f} ms "
          f"(SLO {wl.slo_tpot_s*1e3:.0f}), "
          f"attainment {r.slo_attainment(wl)*100:.0f}%")

    # cross-check: same plan on a homogeneous TPU v5e pool
    plan_tpu = plan_deployment(cfg, wl, p_hw=TPU_V5E, d_hw=TPU_V5E)
    print(f"\nv5e reference: {plan_tpu.ratio()} "
          f"P={plan_tpu.prefill.strategy.label()} "
          f"D={plan_tpu.decode.strategy.label()} "
          f"cost {plan_tpu.cost_per_hour:.1f} $/h")


if __name__ == "__main__":
    main()

"""60-second tour of the PyTorch port: build a tiny model, serve one
request through a heterogeneous P→D handoff, and plan a deployment. The
PyTorch counterpart of ``examples/quickstart.py``: the same model,
vendors, request and printed lines.

The engines run on the card (the hand-written CUDA kernels) unless
``--device cpu`` asks for the plain PyTorch path; the weights are random,
drawn from seed 0.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compat.precision import WireFormat
from repro_torch.core.disagg import DisaggPipeline
from repro_torch.core.kv_transfer import TransferEngine
from repro_torch.serving.engine import Engine, VendorProfile
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import GlobalScheduler
from repro_torch.serving.server import Server

# 1. a tiny dense LM (the same ModelConfig drives the 32B assigned archs)
CFG = ModelConfig(name="tiny", family="dense", num_layers=3, d_model=64,
                  num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                  vocab_size=256, param_dtype="float32",
                  compute_dtype="float32")


def serve_one(params=None, device=None):
    """Steps 1-3: serve one request from P (block 8, head-major, TP 2) to
    D (block 4, token-major, TP 1) on ``device`` (None: the card).
    ``params``: the model's weights there, drawn from seed 0 when not
    given. Prints the tokens, the wire bytes and the summary; returns the
    request and the pipeline."""
    from repro_torch import device as _dev
    from repro_torch.models import model as M
    dev = _dev.resolve(device)
    if params is None:
        params = M.init_params(CFG, seed=0, device=dev)

    # 2. two "vendors": P has block_size 8 / head-major layout / TP=2,
    #    D has block_size 4 / token-major layout / TP=1 — the compat module
    #    aligns them at handoff (paper §III-B).
    p_inst = Engine("P0", CFG, params,
                    VendorProfile("vendorB", block_size=8, layout="nhbd",
                                  kv_dtype="float32", tp=2),
                    num_blocks=64, max_batch=4, max_seq_len=64,
                    role="prefill", device=dev)
    d_inst = Engine("D0", CFG, params,
                    VendorProfile("vendorA", block_size=4, layout="nbhd",
                                  kv_dtype="float32", tp=1),
                    num_blocks=64, max_batch=4, max_seq_len=64,
                    role="decode", device=dev)

    pipeline = DisaggPipeline(TransferEngine(), WireFormat("raw", "float32"))
    sched = GlobalScheduler(pipeline, device=dev)
    sched.add_instance(p_inst)
    sched.add_instance(d_inst)
    server = Server(sched)

    # 3. serve a request
    req = Request(req_id="hello",
                  prompt=np.asarray([3, 1, 4, 1, 5, 9, 2, 6], np.int32),
                  max_new_tokens=8)
    result = server.serve([req])
    print("tokens:", req.output_tokens)
    print("wire bytes through the compat module:",
          pipeline.transfer.stats.bytes_moved)
    print("summary:", result.summary())
    return req, pipeline


def plan_line() -> str:
    """Step 4: plan llama2-7b for the paper's GPU pair; prints and returns
    the plan's line."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.planner.hardware import GPU_A, GPU_B
    from repro_torch.core.planner.optimizer import plan_deployment
    from repro_torch.core.planner.workload import Workload

    plan = plan_deployment(get_config("llama2-7b"),
                           Workload(qps=3.0, input_len=512, output_len=1024),
                           p_hw=GPU_B, d_hw=GPU_A)
    line = (f"plan: {plan.ratio()}  P={plan.prefill.strategy.label()} "
            f"D={plan.decode.strategy.label()} "
            f"cost={plan.cost_per_hour:.1f}$/h")
    print(line)
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain PyTorch "
                         "path")
    args = ap.parse_args(argv)
    serve_one(device=args.device)
    # 4. plan a deployment for the paper's GPU pair
    plan_line()


if __name__ == "__main__":
    main()

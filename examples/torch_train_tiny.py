"""Train a ~100M-param LM for a few hundred steps with the PyTorch port's
full training substrate: AdamW + schedule, microbatch accumulation,
periodic checkpoints with the async writer, and a restart-from-checkpoint
proof. The PyTorch counterpart of ``examples/train_tiny.py``: the same
flags, defaults, model, optimizer, data and printed lines.

It trains on the card unless ``--device cpu`` asks for the CPU. Training
takes the plain attention route (the hand-written kernels have no
backward pass), so no kernel launches. The checkpoints go under
``tempfile.gettempdir()``; a previous run's are removed first, so the
restart proof restores this run's last step.

  PYTHONPATH=src python examples/torch_train_tiny.py [--steps 300] \\
      [--device cpu]
"""
import argparse
import os
import shutil
import tempfile
import time

from repro_torch.configs.base import ModelConfig

CFG = ModelConfig(name="train-100m", family="dense", num_layers=8,
                  d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
                  d_ff=2048, vocab_size=16384, param_dtype="float32",
                  compute_dtype="float32")
CKPT_NAME = "repro_torch_train_tiny"


def train(args, state=None):
    """The training loop, the checkpoints and the restart proof on
    ``args.device`` (None: the card). ``state``: the initial train state
    there, drawn from seed 0 when not given (it is updated in place).
    Returns each step's loss, the final state, the restored step, the
    batch after the loop and the restored state's loss on it."""
    import torch

    from repro_torch import device as _dev
    from repro_torch.models import model as M
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.data import DataConfig, SyntheticTokens
    from repro_torch.training.optim import AdamWConfig
    from repro_torch.training.train_step import (device_batch,
                                                 make_train_step,
                                                 train_state_init)
    from repro_torch.training.tree import leaves

    dev = _dev.resolve(args.device)
    label = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    n = sum(p.numel() for p in leaves(M.abstract_params(CFG)))
    print(f"model: {n/1e6:.0f}M params, batch {args.batch}×{args.seq}, "
          f"{args.steps} steps")

    opt = AdamWConfig(lr=3e-4, warmup_steps=30, total_steps=args.steps)
    if state is None:
        state = train_state_init(CFG, seed=0, device=dev)
    step = make_train_step(CFG, opt, n_micro=2)
    data = iter(SyntheticTokens(CFG, DataConfig(batch_size=args.batch,
                                                seq_len=args.seq, seed=0)))

    ckpt_dir = os.path.join(tempfile.gettempdir(), CKPT_NAME)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(ckpt_dir, keep=2)
    t0 = time.time()
    losses = []
    for i in range(1, args.steps + 1):
        state, m = step(state, device_batch(next(data), dev))
        losses.append(float(m["loss"]))
        if i % 50 == 0 or i == 1:
            toks = i * args.batch * args.seq
            print(f"step {i:4d}  loss {losses[-1]:.3f}  "
                  f"gnorm {float(m['grad_norm']):.2f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"{toks / (time.time() - t0):.0f} tok/s on {label}")
        if i % max(args.steps // 3, 1) == 0 or i == args.steps:
            mgr.save(i, state, meta={"loss": losses[-1]})
    mgr.wait()
    first, final = losses[0], losses[-1]
    print(f"\nloss {first:.3f} → {final:.3f} "
          f"({'OK' if final < first - 0.5 else 'no descent?'})")

    # restart proof: restore the latest checkpoint and take a step
    last = mgr.latest_step()
    restored = mgr.restore(last, like=state, device=dev)
    batch = device_batch(next(data), dev)
    _, m2 = step(restored, batch)
    print(f"restored step_{last}: next-step loss {float(m2['loss']):.3f} "
          f"(checkpoints at {ckpt_dir})")
    return {"losses": losses, "state": state, "restored_step": last,
            "next_batch": batch, "restored_loss": m2["loss"], "opt": opt}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' trains on the CPU")
    train(ap.parse_args(argv))


if __name__ == "__main__":
    main()

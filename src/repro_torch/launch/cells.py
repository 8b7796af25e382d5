"""The assigned (architecture × input-shape) grid — 40 cells, 7 of them
skipped (a copy of ``repro.launch.cells`` over the port's configs).

Shapes:
  train_4k     seq 4,096   global_batch 256   train step
  prefill_32k  seq 32,768  global_batch 32    prefill step (P)
  decode_32k   seq 32,768  global_batch 128   serve step (D, 1 new token)
  long_500k    seq 524,288 global_batch 1     serve step

long_500k needs a bounded live context: it runs for the SSM, hybrid and
sliding-window archs (mamba2, recurrentgemma, mixtral) and is skipped for
the full-attention ones.

``cache_dtype``: qwen1.5-32b (40 KV heads) at decode_32k serves from a
float8 (e4m3) cache — the paper's precision alignment used as a capacity
lever; every other cell keeps bf16 KV.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.configs import ASSIGNED
from repro_torch.configs.base import get_config

LONG_OK = {"mamba2-370m", "recurrentgemma-9b", "mixtral-8x7b"}

SHAPES = {
    "train_4k": dict(seq_len=4096, batch=256, mode="train"),
    "prefill_32k": dict(seq_len=32768, batch=32, mode="prefill"),
    "decode_32k": dict(seq_len=32768, batch=128, mode="decode"),
    "long_500k": dict(seq_len=524288, batch=1, mode="decode"),
}

_CACHE_DTYPE_OVERRIDE = {("qwen1.5-32b", "decode_32k"): "float8_e4m3fn"}

# activation budget for the train micro-batch count (bytes a chip of
# residual-stream checkpoints under remat)
_ACT_BUDGET = 1.2e9


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    mode: str                  # train | prefill | decode
    seq_len: int
    batch: int
    n_micro: int = 1
    cache_dtype: str = "bfloat16"
    zero3: bool = False        # weights sharded over the data axes (train, > 8B)
    act_seq: bool = False      # sequence-parallel residual stream (train)
    skip: Optional[str] = None

    @property
    def name(self) -> str:
        return f"{self.arch}@{self.shape}"

    def decode_capacity(self) -> int:
        """Room for the live context and a margin of new tokens, padded to
        a multiple of 16 so the capacity axis shards."""
        cap = self.seq_len + 128
        return -(-cap // 16) * 16


def _n_micro(arch: str, batch: int, seq: int, dp: int = 16) -> int:
    cfg = get_config(arch)
    layers = cfg.num_layers + cfg.encoder_layers
    n = 1
    while n < batch // dp:
        per_chip = (batch / (n * dp)) * seq * cfg.d_model * 2 * layers
        if per_chip <= _ACT_BUDGET:
            break
        n *= 2
    return n


def make_cells(archs: Optional[List[str]] = None) -> List[Cell]:
    out = []
    for arch in (archs or ASSIGNED):
        for shape, sd in SHAPES.items():
            skip = None
            if shape == "long_500k" and arch not in LONG_OK:
                skip = "full-attention arch: 500k live KV is unservable " \
                       "(see DESIGN.md §5)"
            nm = _n_micro(arch, sd["batch"], sd["seq_len"]) \
                if sd["mode"] == "train" else 1
            # weights sharded over the data axes too: a bf16 replica of a
            # model over 8B parameters leaves no room for gradients
            z3 = (sd["mode"] == "train"
                  and get_config(arch).param_count() > 8e9)
            # mixtral train: fewer micro-batches paid for with
            # sequence-parallel residuals
            act_seq = False
            if arch == "mixtral-8x7b" and sd["mode"] == "train":
                nm, act_seq = 8, True
            out.append(Cell(
                arch=arch, shape=shape, mode=sd["mode"],
                seq_len=sd["seq_len"], batch=sd["batch"], n_micro=nm,
                cache_dtype=_CACHE_DTYPE_OVERRIDE.get((arch, shape),
                                                      "bfloat16"),
                zero3=z3, act_seq=act_seq, skip=skip))
    return out


def get_cell(arch: str, shape: str) -> Cell:
    for c in make_cells([arch]):
        if c.shape == shape:
            return c
    raise KeyError((arch, shape))

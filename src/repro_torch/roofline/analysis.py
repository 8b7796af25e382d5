"""Three-term roofline of a step (PyTorch port of
``repro.roofline.analysis``).

  compute term    = FLOPs a chip / peak FLOP/s
  memory term     = HBM bytes a chip / HBM bandwidth
  collective term = wire bytes a chip / link bandwidth

The default hardware is ``H100_SXM``: the planner's NOMINAL datasheet
values for an NVIDIA H100 SXM (``core/planner/hardware.py``: 989.4 TFLOP/s
dense bf16, 3,350 GB/s HBM3, 450 GB/s a link) — not measured. ``V5E`` (TPU
v5e) stays as a copy of the reference's constants for the parity tests;
its numbers are a TPU's, never the port's.

Counting (``analyze_step``): the step runs once on ``meta`` tensors, as
the card runs it (``ops.count_as_card``: attention takes the kernel route,
as it does on CUDA tensors), and nothing is allocated or computed.
``FlopCounterMode`` counts the products that run as PyTorch operations
(matmuls, batched products) and no elementwise work, where the
reference's XLA ``cost_analysis`` counts both; ``useful_ratio`` therefore
reads higher than the reference's for the same program. The flash
kernel's products are those of each query row against its visible keys
(causal, window, ``kv_len``), and the flash_decode kernel's those of each
row against the slots it sees on a ring or float8 cache, as the kernels
do them, not the masked square of their plain versions. The port's layer loop is Python, so one
count covers every layer at full depth: the reference's probe plans
(XLA counts a while body once) have nothing to correct here and are not
ported. Nor are its HLO-text parsers (``collective_bytes``,
``convert_emulation_bytes``), which have nothing to parse (ROADMAP B12):
``wire_bytes`` is 0 on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import get_config
from repro_torch.core.planner.hardware import H100_SXM as _H100_SPEC
from repro_torch.kernels import ops
from repro_torch.launch.sharding import named_leaves, storage_ids


@dataclasses.dataclass(frozen=True)
class HW:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12          # bf16
    hbm_bw: float = 819e9               # B/s
    link_bw: float = 50e9               # B/s effective per chip


V5E = HW()                              # the reference's TPU constants
# NOMINAL (datasheet, not measured): the planner's h100-sxm spec
H100_SXM = HW(name=_H100_SPEC.name, peak_flops=_H100_SPEC.tflops * 1e12,
              hbm_bw=_H100_SPEC.hbm_gbps * 1e9,
              link_bw=_H100_SPEC.link_gbps * 1e9)


# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class RooflineTerms:
    flops: float = 0.0                  # per chip
    hbm_bytes: float = 0.0              # per chip
    wire_bytes: float = 0.0             # per chip
    convert_bytes: float = 0.0          # the reference's CPU-emulation term
    flash_flops: float = 0.0            # the attention kernels', within flops

    @property
    def hbm_bytes_corrected(self) -> float:
        return max(self.hbm_bytes - self.convert_bytes, 0.0)

    def seconds(self, hw: HW = H100_SXM) -> Dict[str, float]:
        return {"compute": self.flops / hw.peak_flops,
                "memory": self.hbm_bytes_corrected / hw.hbm_bw,
                "memory_raw": self.hbm_bytes / hw.hbm_bw,
                "collective": self.wire_bytes / hw.link_bw}

    def _terms(self, hw: HW = H100_SXM) -> Dict[str, float]:
        s = self.seconds(hw)
        return {k: s[k] for k in ("compute", "memory", "collective")}

    def dominant(self, hw: HW = H100_SXM) -> str:
        t = self._terms(hw)
        return max(t, key=t.get)

    def step_time(self, hw: HW = H100_SXM) -> float:
        """Roofline-optimistic step time: the terms overlap perfectly."""
        return max(self._terms(hw).values())


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor leaf of a tree (any nesting of tuples, dicts
    and dataclasses)."""
    return sum(x.numel() * x.element_size() for _, x in named_leaves(tree))


def fresh_bytes(out: Any, args: Any) -> int:
    """Bytes of the tensor leaves of ``out`` that lie in no storage of
    ``args``' leaves: an output that is an argument updated in place (the
    decode caches, the train state) is that argument's bytes, counted
    once with it."""
    seen = storage_ids(args)
    return sum(x.numel() * x.element_size() for _, x in named_leaves(out)
               if not storage_ids(x) <= seen)


def analyze_step(fn: Callable, *args: Any, chips: int = 1) -> RooflineTerms:
    """The roofline terms of one call ``fn(*args)`` on ``meta`` arguments
    (a launch step built on a ``meta`` mesh): FLOPs from ``count_flops``
    (products only, every layer, attention as the card runs it),
    ``hbm_bytes`` the bytes of the tensor arguments plus the outputs that
    are not arguments updated in place — each read or written once, a
    lower bound that leaves out every intermediate — and no wire.
    ``chips`` divides all, for a program that stands for a mesh's whole
    work (the dry run's per-chip share)."""
    flops, flash, out = count_flops(fn, *args)
    nbytes = tree_bytes(args) + fresh_bytes(out, args)
    return RooflineTerms(flops=flops / chips, hbm_bytes=float(nbytes) / chips,
                         flash_flops=flash / chips)


def count_flops(fn: Callable, *args: Any) -> Tuple[float, float, Any]:
    """Runs ``fn(*args)`` once on ``meta`` arguments as the card runs it
    (``ops.count_as_card``): (the FLOPs of its products, the attention
    kernels' share of them — flash and flash_decode —, its outputs)."""
    counter = FlopCounterMode(display=False)
    with counter, ops.count_as_card() as tally:
        out = fn(*args)
    attn = tally.get("flash_attention", 0.0) + tally.get("flash_decode", 0.0)
    return float(counter.get_total_flops()) + attn, attn, out


# --------------------------------------------------------------------------- #
def model_flops(arch: str, mode: str, tokens: int) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for training (the
    ×3 of forward + backward inside the 6); inference forward only =
    2·N·D."""
    cfg = get_config(arch)
    n = cfg.active_param_count()
    per_tok = 6.0 * n if mode == "train" else 2.0 * n
    return per_tok * tokens


def useful_ratio(arch: str, mode: str, tokens: int, flops_global: float
                 ) -> float:
    if flops_global <= 0:
        return 0.0
    return model_flops(arch, mode, tokens) / flops_global

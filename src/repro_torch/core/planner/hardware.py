"""Hardware descriptors for the planner's operator libraries — port of
``repro.core.planner.hardware``, with one entry more: ``h100-sxm``, the
card the port serves on (the key ``VendorProfile.hardware`` names).

The paper's experimental platform: GPU A (80 GB, 312 TFLOPS) used for
decode, GPU B (32 GB, 512 TFLOPS) used for prefill. We carry both, plus the
TPU v5e target of the dry-run/roofline (197 TFLOP/s bf16, 819 GB/s HBM,
~50 GB/s/link ICI) so one planner serves both studies.

Discount factors λ (compute), α (HBM), β (network) are the paper's Eq. (2)/(5)
efficiency knobs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    tflops: float               # dense bf16/fp16 peak, TFLOP/s
    hbm_gb: float               # VRAM capacity (M_p / M_d in the paper)
    hbm_gbps: float             # VRAM bandwidth, GB/s
    link_gbps: float            # intra-instance interconnect per link, GB/s
    scaleout_gbps: float        # NIC for P→D KV transfer, GB/s
    compute_discount: float = 0.55   # λ
    hbm_discount: float = 0.75       # α
    net_discount: float = 0.80       # β
    cost_per_hour: float = 1.0

    @property
    def eff_flops(self) -> float:
        return self.tflops * 1e12 * self.compute_discount

    @property
    def eff_hbm(self) -> float:
        return self.hbm_gbps * 1e9 * self.hbm_discount

    @property
    def eff_link(self) -> float:
        return self.link_gbps * 1e9 * self.net_discount

    @property
    def hbm_bytes(self) -> float:
        return self.hbm_gb * (1 << 30)


REGISTRY: Dict[str, HardwareSpec] = {}


def register(spec: HardwareSpec) -> HardwareSpec:
    REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> HardwareSpec:
    return REGISTRY[name]


# --- the paper's two vendors (§V: "GPU A (80G, 312TFLOPS)" decode-side,
# "GPU B (32G, 512TFLOPS)" prefill-side). Bandwidths are representative of
# the classes these specs imply (A100-80G-class HBM2e vs a compute-dense
# 32 GB part with weaker memory).
GPU_A = register(HardwareSpec(
    name="gpu-a", tflops=312.0, hbm_gb=80.0, hbm_gbps=2039.0,
    link_gbps=300.0, scaleout_gbps=25.0, cost_per_hour=2.2))
GPU_B = register(HardwareSpec(
    name="gpu-b", tflops=512.0, hbm_gb=32.0, hbm_gbps=1000.0,
    link_gbps=200.0, scaleout_gbps=25.0, cost_per_hour=1.6))

# --- TPU targets (dry-run / roofline constants)
TPU_V5E = register(HardwareSpec(
    name="tpu-v5e", tflops=197.0, hbm_gb=16.0, hbm_gbps=819.0,
    link_gbps=50.0, scaleout_gbps=25.0, cost_per_hour=1.2))
TPU_V5P = register(HardwareSpec(
    name="tpu-v5p", tflops=459.0, hbm_gb=95.0, hbm_gbps=2765.0,
    link_gbps=100.0, scaleout_gbps=25.0, cost_per_hour=4.2))

# --- NVIDIA H100 SXM5: NOMINAL datasheet values, not measured. 989.4
# TFLOP/s dense bf16, 80 GB HBM3 at 3,350 GB/s, NVLink 900 GB/s both
# directions (450 a direction, as gpu-a's 300 halves the A100's 600), a
# 400 Gb/s NIC (50 GB/s). The discounts and cost are the defaults: no
# measurement has calibrated them for this card.
H100_SXM = register(HardwareSpec(
    name="h100-sxm", tflops=989.4, hbm_gb=80.0, hbm_gbps=3350.0,
    link_gbps=450.0, scaleout_gbps=50.0))

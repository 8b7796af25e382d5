"""Mixtral 8x7B — 8-expert top-2 MoE with sliding-window attention.
[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    attention_kind="sliding",
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, num_shared_experts=0, top_k=2,
                  d_ff_expert=14336),
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
))

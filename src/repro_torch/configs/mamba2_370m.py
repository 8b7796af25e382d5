"""Mamba2-370M — attention-free SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=32,                    # SSD heads = d_inner / head_dim
    num_kv_heads=0,
    head_dim=64,
    d_ff=0,                          # attention-free, no separate MLP
    vocab_size=50280,
    attention_kind="none",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4,
                  chunk_size=256, n_groups=1),
    source="arXiv:2405.21060",
))

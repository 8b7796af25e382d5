"""Llama2-7B — the paper's own experimental model (§V). [arXiv:2307.09288]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama2-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    rope_theta=10_000.0,
    source="arXiv:2307.09288",
))

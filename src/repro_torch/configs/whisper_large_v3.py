"""Whisper-large-v3 — encoder-decoder audio transformer. [arXiv:2212.04356]

The conv frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (post-conv, stride-2 downsampled). 32 encoder + 32 decoder layers.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,                   # decoder layers
    encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    frontend=FrontendConfig(kind="audio", downsample=2),
    max_source_len=1500,
    rope_theta=10_000.0,             # we use RoPE in place of learned abs-pos
    source="arXiv:2212.04356",
))

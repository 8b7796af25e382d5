"""InternVL2-2B — InternViT frontend (STUB) + InternLM2-1.8B backbone.
[arXiv:2404.16821; hf]

``input_specs()`` provides precomputed patch embeddings which are prepended
to the token embeddings.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    frontend=FrontendConfig(kind="vision", num_patches=256),
    rope_theta=1_000_000.0,
    source="arXiv:2404.16821",
))

"""RecurrentGemma-9B — Griffin hybrid: RG-LRU + local attention, 2:1.
[arXiv:2402.19427]

38 blocks with pattern (recurrent, recurrent, local-attn); MQA (kv=1).
"""
from repro_torch.configs.base import (ATTN, RECURRENT, ModelConfig,
                                RecurrentConfig, register)

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    attention_kind="sliding",
    sliding_window=2048,
    recurrent=RecurrentConfig(lru_width=4096, d_conv=4,
                              block_pattern=(RECURRENT, RECURRENT, ATTN),
                              local_window=2048),
    rope_theta=10_000.0,
    source="arXiv:2402.19427",
))

"""DeepSeek-V2-Lite 16B — MLA + fine-grained MoE. [arXiv:2405.04434; hf]

Assignment string lists both "64e top-6" and "2 shared + 160 routed";
published V2-Lite is 64 routed + 2 shared, top-6 (160 routed is full V2).
We implement 64 routed + 2 shared top-6 — see DESIGN.md §5.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,                      # dense MLP of the first layer
    vocab_size=102400,
    attention_kind="mla",
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6,
                  d_ff_expert=1408, first_dense_layers=1),
    rope_theta=10_000.0,
    source="arXiv:2405.04434",
))

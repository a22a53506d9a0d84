"""qwen2-moe-a2.7b — MoE, 4 shared + 60 routed top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936, MoE 60e top-4.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2_048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1_408,
    vocab_size=151_936,
    num_experts=60,
    num_experts_per_tok=4,
    num_shared_experts=4,
    moe_d_ff=1_408,
)

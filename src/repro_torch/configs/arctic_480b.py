"""arctic-480b — MoE, 128 experts top-2 + dense residual.

[hf:Snowflake/snowflake-arctic-base; hf]
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.
Arctic runs a small dense FFN residually in parallel with the routed MoE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7_168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4_864,
    vocab_size=32_000,
    num_experts=128,
    num_experts_per_tok=2,
    moe_d_ff=4_864,
    dense_residual=True,
)

"""mamba2-2.7b — SSM, SSD (state-space duality).  [arXiv:2405.21060; unverified]

64L d_model=2560 (attn-free) vocab=50280, ssm_state=128, expand=2,
head_dim=64 (80 SSD heads).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2_560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    tie_embeddings=True,
)

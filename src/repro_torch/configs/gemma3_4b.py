"""gemma3-4b — dense, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt; unverified]
34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, head_dim=256,
sliding window 1024 on local layers, qk_norm (gemma3 uses RMS qk-norm).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2_560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10_240,
    vocab_size=262_144,
    qk_norm=True,
    attention_pattern="local_global",
    local_global_ratio=5,
    sliding_window=1_024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

"""hymba-1.5b — hybrid: parallel attention + mamba heads.  [arXiv:2411.13676; hf]

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Every layer runs attention heads and SSM heads in parallel on the same
input and sums their outputs (Hymba's parallel-head design).  Attention
uses a sliding window on most layers (sub-quadratic ⇒ long_500k runs).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1_600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5_504,
    vocab_size=32_001,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    parallel_ssm=True,
    # Hymba's 3 global-attention layers are approximated as windowed so the
    # layer stack stays scan-uniform (period 1) — the hybrid parallel-head
    # structure is the systems-relevant property (DESIGN.md §5).
    attention_pattern="local",
    sliding_window=1_024,
    attn_q_chunk=2_048,
    attn_kv_chunk=4_096,
)

"""phi-3-vision-4.2b — VLM: phi3-mini backbone + CLIP frontend (stubbed).

[hf:microsoft/Phi-3-vision-128k-instruct; hf]
32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.  The CLIP ViT
frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (576 CLIP ViT-L/14@336 patches).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3_072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8_192,
    vocab_size=32_064,
    frontend="patch_stub",
    num_frontend_tokens=576,
)

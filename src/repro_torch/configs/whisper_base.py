"""whisper-base — enc-dec audio, conv frontend (stub).  [arXiv:2212.04356; unverified]

6L (enc) + 6L (dec) d_model=512 8H d_ff=2048 vocab=51865.  The conv audio
frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2_048,
    vocab_size=51_865,
    is_encoder_decoder=True,
    num_encoder_layers=6,
    cross_attention=True,
    frontend="audio_stub",
    max_source_positions=1_500,
    rope_theta=0.0,  # whisper uses learned positions; we use sinusoidal stub
    tie_embeddings=True,
)

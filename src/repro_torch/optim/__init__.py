from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.optim.compress import compress_grads, init_residuals
from repro_torch.optim.schedule import Constant, WarmupCosine

__all__ = [
    "AdamW",
    "AdamWConfig",
    "Constant",
    "WarmupCosine",
    "compress_grads",
    "init_residuals",
]

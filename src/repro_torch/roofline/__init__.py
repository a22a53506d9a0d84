"""Hardware constants and roofline terms (twin of ``repro.roofline``)."""
from repro_torch.roofline import analysis, hw

__all__ = ["analysis", "hw"]

"""Public entry points of the model kernels (twin of ``repro.kernels.ops``).

The device decides: a CUDA tensor launches the hand-written kernel or
raises, a CPU tensor takes the kernel's plain PyTorch version.  There is
no environment selector and no ``mode=`` argument, and the TPU tiling
knobs (``block_q``/``block_k``) are gone: the CUDA kernel picks its own
tiles.
"""
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["flash_attention", "ssd_scan"]

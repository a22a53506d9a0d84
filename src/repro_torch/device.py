"""Where the port's entry points put their tensors.

Entry points take ``device="cuda"`` by default and run on the card; the
caller asks for the CPU (the kernels' plain versions) with
``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises, never a quiet CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device; pass device="cpu" to run the plain versions '
            "of the kernels on the CPU"
        )
    return dev

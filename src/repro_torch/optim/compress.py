"""Gradient compression with error feedback (DP all-reduce width reduction).

Twin of ``repro.optim.compress``.  ``compress_grads`` quantizes each
gradient tensor to blockwise int8 (blocks of 256 along the last axis,
``round`` half to even) and carries the quantization residual into the
next step (error feedback), so the compression error is unbiased over
time.  The train step applies

    g_q, residual' = compress(g + residual)

and feeds ``g_q`` to AdamW.  On one card there is no reduction to
narrow: the transform runs for its numbers, as the reference's does on
one device.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_map, tree_pick

BLOCK = 256


def _quantize(x: torch.Tensor) -> torch.Tensor:
    """Blockwise symmetric int8 round-trip (simulates the wire format)."""
    shape = x.shape
    last = shape[-1] if x.dim() else 1
    pad = (-last) % BLOCK
    xb = x.reshape(*shape[:-1], last) if x.dim() else x.reshape(1)
    if pad:
        xb = F.pad(xb, (0, pad))
    blocks = xb.reshape(*xb.shape[:-1], -1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12))
    q = torch.clamp(q, -127, 127)
    deq = (q * scale).reshape(*xb.shape[:-1], -1)[..., :last]
    return deq.reshape(shape)


def init_residuals(params) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def compress_grads(grads, residuals) -> Tuple[dict, dict]:
    """Returns (quantized grads, new residuals)."""

    def one(g, r):
        g = g.to(torch.float32) + r
        q = _quantize(g)
        return q, g - q

    out = tree_map(one, grads, residuals)
    return tree_pick(out, 0), tree_pick(out, 1)


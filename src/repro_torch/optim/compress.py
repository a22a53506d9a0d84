"""Gradient compression with error feedback (DP all-reduce width reduction).

Twin of ``repro.optim.compress``.  ``compress_grads`` quantizes each
gradient tensor to blockwise int8 (blocks of 256 along the last axis,
``round`` half to even) and carries the quantization residual into the
next step (error feedback), so the compression error is unbiased over
time.  The train step applies

    g_q, residual' = compress(g + residual)

and feeds ``g_q`` to AdamW.  On one process there is no reduction to
narrow: the transform runs for its numbers, as the reference's does on
one device.  Over ranks the step compresses the gradients' mean, whole,
as the reference compresses its reduced gradients (``train/step.py``).
Where the ``model`` axis spans ranks, a leaf split over it along a leading
dimension holds whole blocks on each rank and is compressed there; one
split along its last dimension is compressed as the whole leaf's blocks
run, across the ranks' columns (:func:`_quantize_columns`).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.meshes import gather_dim
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
    q = (blocks / torch.clamp(scale, min=1e-12)).round_().clamp_(-127, 127)
    deq = q.mul_(scale).reshape(*xb.shape[:-1], -1)[..., :last]
    return deq.reshape(shape)


def init_residuals(params) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def _quantize_columns(x: torch.Tensor, mesh) -> torch.Tensor:
    """The round-trip of this rank's columns ``x`` of a leaf whose last
    dimension is split over ``mesh``'s model group, in the whole leaf's
    blocks: local where the rank's width is whole blocks (its columns then
    start at a block boundary), else gathered over the group, quantized
    whole and cut back to the rank's columns."""
    k = x.shape[-1]
    if k % BLOCK == 0:
        return _quantize(x)
    whole = gather_dim(x, x.dim() - 1, mesh.model_group, mesh.n_model)
    return _quantize(whole).narrow(-1, mesh.model_index * k, k)


def compress_grads(grads, residuals, shardings=None) -> Tuple[dict, dict]:
    """Returns (quantized grads, new residuals): each new residual written
    into the given one once that leaf's sum has read it, as the
    reference's step writes its donated buffers.  ``shardings``: the
    gradients' ``NamedSharding`` tree where each leaf is this rank's share
    along ``model`` (tensor parallelism over ranks); a leaf split along its
    last dimension is then quantized in the whole leaf's blocks."""

    def one(g, r, s=None):
        g = g.to(torch.float32) + r
        if s is not None and s.mdim is not None and s.mdim == g.dim() - 1:
            q = _quantize_columns(g, s.mesh)
        else:
            q = _quantize(g)
        return q, torch.sub(g, q, out=r)

    if shardings is None:
        out = tree_map(one, grads, residuals)
    else:
        out = tree_map(lambda s, g, r: one(g, r, s), shardings, grads, residuals)
    return tree_pick(out, 0), tree_pick(out, 1)


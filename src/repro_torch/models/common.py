"""Shared primitives: norms, rotary embeddings, SwiGLU, init helpers.

Twin of ``repro.models.common``.  Everything is a plain function over
explicit parameter dicts of torch tensors; layer stacks carry a leading
``L`` axis, as in the reference, so carrying weights across is a
leaf-for-leaf map.  Init helpers draw from an explicit
``torch.Generator`` on the device the parameters go to.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.distributed.ctx import enter_model, leave_model, model_max


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """float32 standard normals times ``scale``, cast to ``dtype``, on the
    generator's device (scaled in place: a whole leaf of arctic-480b's
    experts is 17.9 GB in float32)."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return x.mul_(scale).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype) -> torch.Tensor:
    return normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim), dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> torch.Tensor:
    return normal(gen, (vocab, dim), 0.02, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMS over the head_dim of (..., H, hd) tensors."""
    return rms_norm(x, scale, eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_table(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_frequencies`` on ``device``, copied there once: a copy from
    pageable host memory waits for the card, and apply_rope runs twice a
    layer."""
    with torch.inference_mode(False):
        return torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Split
    halves (not interleaved), as the reference."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    # on fake tensors (a dry-run) the table is made anew, not cached: a
    # cached fake table would stand in for the real one in later steps
    table = _rope_table.__wrapped__ if is_fake(x) else _rope_table
    freqs = table(hd, theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    angles = angles[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(num_pos: int, dim: int) -> np.ndarray:
    """Whisper-style fixed sinusoidal embedding table (num_pos, dim)."""
    log_timescale = math.log(10_000) / (dim // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(dim // 2, dtype=np.float32))
    scaled = np.arange(num_pos, dtype=np.float32)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, rounded after each op as ``jax.nn.silu`` is in
    bfloat16 (``F.silu`` rounds once)."""
    return x * torch.sigmoid(x)


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, dtype) -> dict:
    return {
        "gate": dense_init(gen, d_model, d_ff, dtype),
        "up": dense_init(gen, d_model, d_ff, dtype),
        "down": dense_init(gen, d_ff, d_model, dtype),
    }


def swiglu_apply(p: dict, x: torch.Tensor, region: bool = False) -> torch.Tensor:
    """The SwiGLU MLP.  ``region``: ``p`` holds this rank's columns of
    ``gate``/``up`` and rows of ``down`` (tensor parallelism): ``x``
    enters the model-parallel region and the output leaves it after
    ``down``."""
    if region:
        x = enter_model(x)
    g = silu(x @ p["gate"])
    out = (g * (x @ p["up"])) @ p["down"]
    return leave_model(out) if region else out


def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor, lo: int) -> torch.Tensor:
    """Rows ``tokens`` of an embedding split by rows over the model group:
    ``table`` holds rows ``[lo, lo + len(table))``; each rank looks up the
    tokens it holds (zeros elsewhere) and the model group sums them."""
    local = tokens.long() - lo
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))
    return leave_model(rows)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          z_loss: float = 0.0) -> torch.Tensor:
    """logits (..., V) fp32-accumulated CE with optional z-loss; labels int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    target = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - target
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, lo: int,
                                 z_loss: float = 0.0) -> torch.Tensor:
    """``softmax_cross_entropy`` of logits split over the model group by
    vocabulary columns: ``logits`` (..., V/m) are this rank's columns
    ``[lo, lo + V/m)``.  The max, the sum of exps and the target logit are
    each reduced over the model group; the whole logits are never
    gathered.  Every rank gets the same loss, and its gradient only for
    its own columns."""
    logits = logits.float()
    n = logits.shape[-1]
    m = model_max(logits.amax(dim=-1))
    lse = m + torch.log(leave_model(torch.exp(logits - m[..., None]).sum(dim=-1)))
    local = labels.long() - lo
    inside = (local >= 0) & (local < n)
    target = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    target = leave_model(torch.where(inside, target, torch.zeros_like(target)))
    loss = lse - target
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss

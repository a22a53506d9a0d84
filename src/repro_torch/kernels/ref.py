"""Definitional oracles of the model kernels, in plain PyTorch.

Twin of ``repro.kernels.ref``: materialised scores for attention and the
step-by-step recurrence for the SSD scan.  The tests hold the kernels'
plain versions and the models' chunked paths against these.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import (
    NEG_INF,
    flash_attention_plain as flash_attention_ref,
)


def ssd_ref(xh, dt, A, Bm, Cm, *, h0: Optional[torch.Tensor] = None):
    """Definitional SSD recurrence, one step at a time.

    h_t = exp(A·Δ_t)·h_{t-1} + Δ_t · x_t ⊗ B_t ;  y_t = h_t · C_t
    Returns (y (B,S,nh,hp) fp32, final state (B,nh,hp,N) fp32).
    """
    B, S, nh, hp = xh.shape
    N = Bm.shape[-1]
    xh, dt, Bm, Cm = xh.float(), dt.float(), Bm.float(), Cm.float()
    h = (torch.zeros((B, nh, hp, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        x_t, dt_t, B_t, C_t = xh[:, t], dt[:, t], Bm[:, t], Cm[:, t]
        dA = torch.exp(dt_t * A[None, :])  # (B, nh)
        h = h * dA[..., None, None] + torch.einsum("bh,bhp,bn->bhpn", dt_t, x_t, B_t)
        ys.append(torch.einsum("bn,bhpn->bhp", C_t, h))
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((B, 0, nh, hp), dtype=torch.float32, device=xh.device))
    return y, h


__all__ = ["NEG_INF", "flash_attention_ref", "ssd_ref"]

"""Mamba2 SSD chunked scan (PyTorch + CUDA).

Twin of ``repro.kernels.ssd_scan``.  The sequence is cut into chunks of
Q tokens; per (batch, head) the chunks are walked in order, carrying the
(hp × N) state.  Within a chunk, with La the inclusive cumulative sum of
dt·A:

    y[i]  = Σ_{j≤i} (C_i·B_j)·exp(La_i − La_j)·dt_j·x_j  +  exp(La_i)·(C_i·hᵀ)
    h    ← exp(La_Q)·h + Σ_j x_jᵀ (B_j·exp(La_Q − La_j)·dt_j)

Returns y (B, S, nh, hp) float32 **without** the D·x skip term, and the
final state (B, nh, hp, N) float32.  There is no initial state, as in the
reference kernel.

On a CUDA tensor :func:`ssd_scan` launches the hand-written kernel of
``csrc/ssd_scan.cu`` or raises; on a CPU tensor it runs
:func:`ssd_scan_plain`, the reference kernel's chunk loop in torch.  Only
a kernel launch counts in ``STATS``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instantiations of hp
MAX_CHUNK = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

STATS: Dict[str, int] = {"ssd_scan": 0}


def reset_stats() -> None:
    STATS["ssd_scan"] = 0


def _check(xh, dt, A, Bm, Cm, chunk):
    for name, t in (("xh", xh), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch tensor")
        if t.device != xh.device:
            raise ValueError(f"{name} is on {t.device}, xh on {xh.device}")
    if xh.dim() != 4:
        raise ValueError("xh must be (B, S, nh, hp)")
    B, S, nh, hp = xh.shape
    N = Bm.shape[-1]
    for name, t, shape in (("dt", dt, (B, S, nh)), ("A", A, (nh,)),
                           ("Bm", Bm, (B, S, N)), ("Cm", Cm, (B, S, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if xh.dtype not in _DTYPES or Bm.dtype != xh.dtype or Cm.dtype != xh.dtype:
        raise TypeError("xh, Bm and Cm must share one type, float32 or bfloat16")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("dt and A must be float32")
    Q = min(chunk, S)
    if Q <= 0 or S % Q:
        raise ValueError(f"S={S} is not a multiple of the chunk {Q}")
    return B, S, nh, hp, N, Q


def ssd_scan_plain(xh, dt, A, Bm, Cm, *, chunk: int = 256
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the reference kernel's per-chunk body, one
    chunk at a time over all batches and heads.  Same arguments and
    result as :func:`ssd_scan`."""
    B, S, nh, hp, N, Q = _check(xh, dt, A, Bm, Cm, chunk)
    x, Bf, Cf = xh.float(), Bm.float(), Cm.float()
    h = torch.zeros((B, nh, hp, N), dtype=torch.float32, device=xh.device)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    ys = []
    for c0 in range(0, S, Q):
        sl = slice(c0, c0 + Q)
        xc, dtc, Bc, Cc = x[:, sl], dt[:, sl], Bf[:, sl], Cf[:, sl]
        La = torch.cumsum(dtc * A, dim=1)  # (B, Q, nh)
        Ltot = La[:, -1]  # (B, nh)
        cb = torch.einsum("bqn,bkn->bqk", Cc, Bc)
        decay = torch.exp(La[:, :, None, :] - La[:, None, :, :])  # (B,Q,Q,nh)
        scores = torch.where(causal[None, :, :, None], cb[..., None] * decay,
                             torch.zeros((), device=xh.device))
        scores = scores * dtc[:, None, :, :]
        y = torch.einsum("bqkh,bkhp->bqhp", scores, xc)
        y = y + torch.einsum("bqn,bhpn->bqhp", Cc, h) * torch.exp(La)[..., None]
        w = torch.exp(Ltot[:, None, :] - La) * dtc  # (B, Q, nh)
        h = torch.exp(Ltot)[..., None, None] * h + torch.einsum(
            "bqhp,bqn->bhpn", xc * w[..., None], Bc)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def ssd_scan(xh, dt, A, Bm, Cm, *, chunk: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan; see the module docstring.

    ``xh`` (B, S, nh, hp), ``Bm``/``Cm`` (B, S, N) in one type (float32 or
    bfloat16); ``dt`` (B, S, nh) and ``A`` (nh,) float32.  ``S`` must be a
    multiple of ``min(chunk, S)``.  On the card ``hp`` must be one of
    :data:`HEAD_DIMS` and the chunk at most :data:`MAX_CHUNK`.
    """
    B, S, nh, hp, N, Q = _check(xh, dt, A, Bm, Cm, chunk)
    if xh.device.type == "cpu":
        return ssd_scan_plain(xh, dt, A, Bm, Cm, chunk=chunk)
    if xh.device.type != "cuda":
        raise ValueError(f"unsupported device {xh.device}")
    if hp not in HEAD_DIMS:
        raise ValueError(f"head dim {hp} not in the kernel's {HEAD_DIMS}")
    if Q > MAX_CHUNK:
        raise ValueError(f"chunk {Q} above the kernel's {MAX_CHUNK}")
    for name, t in (("xh", xh), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    y = torch.empty((B, S, nh, hp), dtype=torch.float32, device=xh.device)
    h = torch.empty((B, nh, hp, N), dtype=torch.float32, device=xh.device)
    if y.numel() == 0 or h.numel() == 0:
        return y.zero_(), h.zero_()
    from repro_torch.kernels._build import library

    stream = torch.cuda.current_stream(xh.device).cuda_stream
    err = library().ssd_scan_launch(
        xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, nh, hp, N, Q,
        _DTYPES[xh.dtype], ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"ssd_scan launch: CUDA error {err}")
    STATS["ssd_scan"] += 1
    return y, h

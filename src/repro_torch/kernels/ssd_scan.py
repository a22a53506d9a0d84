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

On a CUDA tensor :func:`ssd_scan` launches the hand-written kernels of
``csrc/ssd_scan.cu`` or raises; on a CPU tensor it runs
:func:`ssd_scan_plain`.  Both take the chunks in parallel, as four steps:
C·Bᵀ once per (batch, chunk); every chunk's local state from zero,
s_c = xᵀ (B·exp(Ltot − La)·dt); a serial pass over the chunks only,
h_c = exp(Ltot_c)·h_{c−1} + s_c; and the outputs, the causal scores
against x plus exp(La_i)·(C_i·h_{c−1}ᵀ).  Only a call that launches the
kernels counts in ``STATS``, once.
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
    """Plain PyTorch version, in the kernels' decomposition: C·Bᵀ and the
    chunk-local states for all chunks at once, then the serial pass over
    the chunks, then each chunk's outputs.  Same arguments and result as
    :func:`ssd_scan`."""
    B, S, nh, hp, N, Q = _check(xh, dt, A, Bm, Cm, chunk)
    nc = S // Q
    x = xh.float().reshape(B, nc, Q, nh, hp)
    dtc = dt.reshape(B, nc, Q, nh)
    Bc = Bm.float().reshape(B, nc, Q, N)
    Cc = Cm.float().reshape(B, nc, Q, N)
    La = torch.cumsum(dtc * A, dim=2)  # (B, nc, Q, nh)
    Ltot = La[:, :, -1]  # (B, nc, nh)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # once per (batch, chunk)
    w = torch.exp(Ltot[:, :, None, :] - La) * dtc  # (B, nc, Q, nh)
    s = torch.einsum("bcjhp,bcjn->bchpn", x * w[..., None], Bc)  # from zero
    h = torch.zeros((B, nh, hp, N), dtype=torch.float32, device=xh.device)
    h_in = []  # the state each chunk starts from
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(Ltot[:, c])[..., None, None] * h + s[:, c]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    ys = []
    for c in range(nc):
        decay = torch.exp(La[:, c, :, None, :] - La[:, c, None, :, :])  # (B,Q,Q,nh)
        scores = torch.where(causal[None, :, :, None], cb[:, c, ..., None] * decay,
                             torch.zeros((), device=xh.device))
        scores = scores * dtc[:, c, None, :, :]
        y = torch.einsum("bqkh,bkhp->bqhp", scores, x[:, c])
        y = y + torch.einsum("bqn,bhpn->bqhp", Cc[:, c], h_in[c]) * torch.exp(
            La[:, c])[..., None]
        ys.append(y)
    return torch.cat(ys, dim=1), h


def ssd_scan(xh, dt, A, Bm, Cm, *, chunk: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan; see the module docstring.

    ``xh`` (B, S, nh, hp), ``Bm``/``Cm`` (B, S, N) in one type (float32 or
    bfloat16); ``dt`` (B, S, nh) and ``A`` (nh,) float32.  ``S`` must be a
    multiple of ``min(chunk, S)``.  On the card ``hp`` must be one of
    :data:`HEAD_DIMS`, the chunk at most :data:`MAX_CHUNK`, and the state
    size N small enough for one block's shared memory (it holds the
    carried state as hi + lo bf16, a 64-row tile of C and the copies in
    flight: at chunk 256, N up to 240 at hp 128 in bf16 and 144 in
    float32, 448 at hp 64 in bf16 and 288 in float32); the
    wrapper raises with the need otherwise.
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

    lib = library()
    scratch_floats, smem = ctypes.c_longlong(0), ctypes.c_int(0)
    code = lib.ssd_scan_plan(B, S, nh, hp, N, Q, _DTYPES[xh.dtype],
                             ctypes.byref(scratch_floats), ctypes.byref(smem))
    if code != 0:
        raise ValueError(
            f"ssd_scan: state size N={N} at head dim {hp} needs {smem.value} "
            f"bytes of shared memory in one block, above the 226 KB the "
            f"kernels take" if code == 2 else
            f"ssd_scan: shape (B={B}, S={S}, hp={hp}, N={N}, chunk={Q}) not taken")
    # C·Bᵀ per (batch, chunk), the chunk states and their decays
    scratch = torch.empty(scratch_floats.value, dtype=torch.float32, device=xh.device)
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    err = lib.ssd_scan_launch(
        xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), h.data_ptr(), scratch.data_ptr(), B, S,
        nh, hp, N, Q, _DTYPES[xh.dtype], ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"ssd_scan launch: CUDA error {err}")
    STATS["ssd_scan"] += 1
    return y, h

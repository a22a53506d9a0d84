"""Attention: GQA with causal / sliding-window / cross variants.

Twin of ``repro.models.attention``.  Two plain paths plus the kernel:

* ``dense``   — materializes the full score tensor.  Used for short
  sequences and for decode (Sq == 1).
* ``blocked`` — flash-style running softmax over (q_chunk × kv_chunk)
  blocks in Python loops; fully-masked blocks are skipped, so
  sliding-window layers get near-linear work.
* ``pallas``  — the hand-written kernel (``kernels/ops.flash_attention``:
  CUDA on a CUDA tensor, its plain version on a CPU tensor), taken for
  self-attention with Sq == Skv and no ``kv_valid_len``; anything else
  goes down the ``auto`` route, as in the reference.  The name is the
  reference's, so a ``Runtime`` reads the same in both packages.

Shapes: q (B, Sq, H, hd); k, v (B, Skv, KVH, hd) with H % KVH == 0.
Scores are float32 whatever the input type (the reference's
``preferred_element_type=float32``).
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch import trace

NEG_INF = -1e30

Index = Union[int, torch.Tensor]


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return scores
    return cap * torch.tanh(scores / cap)


def _block_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
                window: int, kv_valid_len: Optional[Index]) -> torch.Tensor:
    """Boolean (Sq, Skv) mask: True = attend."""
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= kv_pos[None, :] > (q_pos[:, None] - window)
    if kv_valid_len is not None:
        mask &= kv_pos[None, :] < kv_valid_len
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float, softcap: float) -> torch.Tensor:
    """q (B,Sq,KVH,G,hd) × k (B,Skv,KVH,hd) -> (B,KVH,G,Sq,Skv) fp32."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    return _softcap(s * scale, softcap)


def dense_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: Index = 0, kv_offset: Index = 0,
                    kv_valid_len: Optional[Index] = None, softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    scale = scale or (1.0 / math.sqrt(hd))
    qg = q.reshape(B, Sq, KVH, G, hd)
    s = _scores(qg, k, scale, softcap)  # (B,KVH,G,Sq,Skv)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    kv_pos = torch.arange(Skv, device=q.device) + kv_offset
    mask = _block_mask(q_pos, kv_pos, causal=causal, window=window,
                       kv_valid_len=kv_valid_len)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, hd)


def blocked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, q_chunk: int = 1024,
                      kv_chunk: int = 2048,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Flash-style blocked attention, Python-looped blocks, fp32 softmax.

    Assumes self-attention over a full sequence (q_offset == 0,
    kv_valid_len == Skv); decode uses ``dense_attention``.
    """
    B, Sq, H, hd = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    scale = scale or (1.0 / math.sqrt(hd))
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    if Sq % q_chunk or Skv % kv_chunk:
        raise ValueError(f"blocked attention needs Sq % {q_chunk} == 0 and "
                         f"Skv % {kv_chunk} == 0, got {Sq}, {Skv}")
    dev = q.device
    out_chunks = []
    for qi in range(Sq // q_chunk):
        q_lo, q_hi = qi * q_chunk, (qi + 1) * q_chunk
        qg = q[:, q_lo:q_hi].reshape(B, q_chunk, KVH, G, hd)
        m = torch.full((B, KVH, G, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KVH, G, q_chunk), dtype=torch.float32, device=dev)
        o = torch.zeros((B, KVH, G, q_chunk, hd), dtype=torch.float32, device=dev)
        for kj in range(Skv // kv_chunk):
            k_lo, k_hi = kj * kv_chunk, (kj + 1) * kv_chunk
            if causal and k_lo > q_hi - 1:
                continue
            if window > 0 and k_hi - 1 <= q_lo - window:
                continue
            s = _scores(qg, k[:, k_lo:k_hi], scale, softcap)  # (B,KVH,G,qc,kc)
            needs_mask = (causal and k_hi > q_lo) or (window > 0 and k_lo <= q_hi - window)
            if needs_mask:
                mask = _block_mask(
                    torch.arange(q_lo, q_hi, device=dev),
                    torch.arange(k_lo, k_hi, device=dev),
                    causal=causal, window=window, kv_valid_len=None,
                )
                s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(),
                              v[:, k_lo:k_hi].float())
            o = o * alpha[..., None] + pv
            m = m_new
        o = o / torch.clamp(l[..., None], min=1e-37)
        out_chunks.append(
            o.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, hd).to(q.dtype)
        )
    return torch.cat(out_chunks, dim=1)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: Index = 0, kv_valid_len: Optional[Index] = None,
              kv_offset: Index = 0, softcap: float = 0.0, impl: str = "auto",
              q_chunk: int = 1024, kv_chunk: int = 2048) -> torch.Tensor:
    """Dispatching entry point used by the model zoo."""
    Sq, Skv = q.shape[1], k.shape[1]
    if impl == "pallas":
        from repro_torch.kernels import ops as kops

        if Sq == Skv and kv_valid_len is None:
            trace.note("model.attention", impl="pallas")
            return kops.flash_attention(q, k, v, causal=causal, window=window,
                                        softcap=softcap)
        impl = "auto"  # decode / ragged inputs take the reference's route
    if impl == "auto":
        impl = "dense" if (Sq == 1 or Skv <= max(kv_chunk, 2048)) else "blocked"
    trace.note("model.attention", impl=impl)
    if impl == "dense":
        return dense_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            kv_offset=kv_offset, kv_valid_len=kv_valid_len, softcap=softcap,
        )
    if impl == "blocked":
        if kv_valid_len is not None or not (isinstance(q_offset, int) and q_offset == 0):
            raise ValueError("blocked attention takes a full self-attention "
                             "sequence (no kv_valid_len, q_offset 0)")
        return blocked_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap, q_chunk=q_chunk,
                                 kv_chunk=kv_chunk)
    raise ValueError(f"unknown attention impl {impl!r}")

"""Flash attention: causal / sliding-window / GQA / softcap (PyTorch + CUDA).

Twin of ``repro.kernels.flash_attention``.  For q (B, Sq, H, hd) and
k, v (B, Skv, KVH, hd) with H = KVH·G, query head ``j`` attends to KV
head ``j // G``:

    s = softcap·tanh((scale·q)·kᵀ / softcap)     (no tanh when softcap = 0)
    s = -1e30 where the causal (k ≤ q) or window (k > q − window) mask fails
    o = softmax(s)·v

in float32 whatever the input type (float32 or bfloat16); the output has
q's type.  Positions count from 0 on both axes, as in the reference.

On a CUDA tensor :func:`flash_attention` launches a hand-written kernel
of ``csrc/flash_attention.cu`` (built at first use by ``_build``) or
raises; it never falls back.  The input type picks the kernel, every
head dim of :data:`HEAD_DIMS` on both:

* bfloat16 (the serving type) runs ``flash_kernel_ws``, in
  FlashAttention-3's shape: a block of three warpgroups owns 128 query
  rows of one head.  The producer warpgroup (its registers given to the
  others) issues TMA loads -- Q once, K and V tiles into a ring of two
  stages with full and empty mbarriers -- from tensor maps the launch
  encodes; two consumer warpgroups of 64 rows each run both products on
  the tensor cores (``wgmma``, bf16 in, float32 accumulation, P rounded
  to bf16 in registers for P·V), S_j issued beside P_{j-1}·V_{j-1}, and
  named barriers pass the turn between them so one's products run
  beside the other's softmax; every exp on the MUFU.  Where the tiles
  allow (a causal mask without a window, or no mask, and more tile pairs
  than SMs) the grid is persistent: a block an SM walks pairs of a long and a
  short causal tile, or equal tiles, loading the next tile's Q and K/V
  while it finishes this one; otherwise a block takes one tile.  O is
  written into the tile's Q buffer and leaves by TMA stores.  Key tiles
  are 128 (64 at hd 256); shared memory per block is two Q buffers (one
  at hd 256) and two stages of K and V: 24, 48, 96, 144, 192 and 192 KB
  at hd 16, 32, 64, 96, 128 and 256.  No atomics: two calls give the
  same bits.
* float32 runs ``flash_kernel_tf32``, both products on the tensor cores
  as a three-pass TF32 split: each operand x becomes hi = tf32(x) and
  lo = tf32(x − hi), and a product is lo·hi + hi·lo + hi·hi in float32
  accumulators.  One TF32 pass keeps about three decimal digits, which
  the exp of a steep score turns into errors far above the 2e-5
  tolerance; the split keeps about 2⁻²² a product.  A pre-pass kernel,
  ``flash_split_kv_kernel``, splits K and V once per call into a
  scratch buffer this wrapper allocates (K hi/lo as (B, KVH, Skp, hd);
  V hi/lo transposed, (B, KVH, hd, Skp), since TF32 ``wgmma`` reads only
  K-major operands; each 8-key group of Vᵀ in the order 0,2,4,6,1,3,5,7,
  so the P accumulator is the A fragment in place; Skp is Skv rounded up
  to 64, zero-filled), so the G query heads of a KV head share one
  split.  Shared memory per block: 41 / 81 KB at hd 16 / 32 (64-key
  tiles, two stages), 65 / 97 KB at hd 64 / 96 (32-key tiles, one
  stage), 193 KB at hd 128 (32-key tiles, two stages) and at hd 256
  (16-key tiles, one stage).  The pre-pass and the main kernel together
  are one launch in ``STATS``.

On a CPU tensor it runs :func:`flash_attention_plain`, the
materialised-scores definition (the reference's
``ref.flash_attention_ref``).  Only a kernel launch counts in ``STATS``.

The kernel has no backward, as the reference's has none: on a CUDA
tensor, with grad enabled and an input that requires grad, the wrapper
raises rather than return an output cut off from the graph.  The plain
version, on the CPU, differentiates (the reference's ``ref`` route).

The reference's TPU tiling knobs (``block_q``/``block_k``) are gone: the
kernel picks its own tiles, and a ragged last tile is masked, so any
sequence length is taken.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 96, 128, 256)  # the kernel's instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

STATS: Dict[str, int] = {"flash_attention": 0}


def reset_stats() -> None:
    STATS["flash_attention"] = 0


def _check(q, k, v, dtypes=tuple(_DTYPES)):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise TypeError(f"{name} must be a 4-D torch tensor")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
    B, Sq, H, hd = q.shape
    _, Skv, KVH, _ = k.shape
    if tuple(k.shape) != (B, Skv, KVH, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if KVH == 0 or H % KVH:
        raise ValueError(f"H={H} is not a multiple of KVH={KVH}")
    return B, Sq, Skv, H, KVH, hd


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: the full (Sq, Skv) score matrix per head,
    float32 softmax.  Same arguments and result as :func:`flash_attention`.
    It also takes float64 tensors and then computes in float64: the exact
    answer that the float32 kernel is held to where float32 arithmetic's
    own error nears the tolerance (steep scores at large head dims)."""
    B, Sq, Skv, H, KVH, hd = _check(q, k, v, (*_DTYPES, torch.float64))
    G = H // KVH
    scale = scale or 1.0 / math.sqrt(hd)
    work = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, Sq, KVH, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(work), k.to(work)) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(Sq, device=q.device)
    kp = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp[None, :] <= qp[:, None]
    if window > 0:
        mask &= kp[None, :] > qp[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(work))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention; see the module docstring.

    ``q`` (B, Sq, H, hd), ``k``/``v`` (B, Skv, KVH, hd), contiguous, one
    type (float32 or bfloat16) and one device.  ``scale`` defaults to
    1/sqrt(hd).  On the card ``hd`` must be one of :data:`HEAD_DIMS`.
    """
    B, Sq, Skv, H, KVH, hd = _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention's CUDA kernel has no backward (nor has the reference's "
            "Pallas kernel): differentiate a plain route, attn_impl='dense' or "
            "'blocked', or call it under torch.no_grad()")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the kernel's {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:  # 16-byte copies and TMA tensor maps
            raise ValueError(f"{name} must be 16-byte aligned")
    if Skv == 0:
        raise ValueError("flash_attention needs at least one key")
    if q.numel() == 0:
        return torch.empty_like(q)
    from repro_torch.kernels._build import library

    out = launch_with(library(), q, k, v, causal=causal, window=window,
                      softcap=softcap, scale=scale)
    STATS["flash_attention"] += 1
    return out


def launch_with(lib, q, k, v, *, causal, window, softcap, scale):
    """Launch ``flash_attention_launch`` of the kernel library ``lib`` on
    checked CUDA tensors and return the output; counts nothing.  The
    float32 route's scratch (the split K and Vᵀ) is allocated here."""
    B, Sq, Skv, H, KVH, hd = _check(q, k, v)
    dtype = _DTYPES[q.dtype]
    out = torch.empty_like(q)
    n = lib.flash_attention_scratch(B, Skv, KVH, hd, dtype)
    scratch = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    scale = scale or 1.0 / math.sqrt(hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if n else None, B, Sq, Skv, H, KVH, hd, dtype,
        int(bool(causal)), int(window), float(scale), float(softcap),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention launch: CUDA error {err}")
    return out

"""The decoders of the configurations, in plain float32 PyTorch, layer
by layer: the parts every family shares.

A layer is pre-norm: ``h += mixer(h)``, the family's mixer
(``families/<family>.py``: attention for the dense family, attention and
SSD heads side by side for the hybrid), then ``h += swiglu(norm(h))``.
A family may replace the FFN, the whole layer, which leaves a layer
takes, and put scales on the embedding and the logits (``family.py``).
Norms are RMS norms scaled by (1 + scale); attention is grouped-query
with rotary positions on split halves, causal, windowed where the
configuration gives a window.  Untied heads are ``lm_head``; a tied head
is the embedding's transpose.

Every weight product goes through ``mm``: ``fp32_mm`` for the reference,
``fp8_mm`` (both operands rounded to float8 e4m3 with a per-tensor scale,
and in the backward pass the incoming gradient to e5m2) for the
lower-precision control, ``bf16_mm`` (both operands rounded to
bfloat16, the product in float32) for a witness of bf16 rounding.
"""
from __future__ import annotations

import math

import torch

import family as F

F8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}  # largest finite values


def fp32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.float() @ b.float()


def _f8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to float8 under a per-tensor scale, as float32."""
    x = x.float()
    s = x.abs().amax().clamp(min=1e-30) / F8_MAX[dtype]
    return (x / s).to(dtype).float() * s


class _Fp8Matmul(torch.autograd.Function):
    """a @ b as float8 training recipes compute it: both operands in e4m3
    forward; backward, the incoming gradient in e5m2 times the saved e4m3
    operands."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _f8(a), _f8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _f8(g, torch.float8_e5m2)
        rows = qa.reshape(-1, qa.shape[-1]).transpose(0, 1)  # b is a weight: (in, out)
        return qg @ qb.transpose(-1, -2), rows @ qg.reshape(-1, qg.shape[-1])


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _Fp8Matmul.apply(a.float(), b.float())
    with torch.no_grad():
        return _f8(a) @ _f8(b)


def bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def rms(x, scale, eps):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def silu(x):
    return x * torch.sigmoid(x)


def rope(x, theta):
    """x (B, S, H, hd): rotary positions 0..S-1 on split halves."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, window):
    """Causal grouped-query attention, windowed to ``window`` keys where
    > 0: q (B, S, H, hd), k and v (B, S, KVH, hd), float32."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qg = q.reshape(B, S, KVH, G, hd)
    out = torch.empty_like(qg)
    i = torch.arange(S, device=q.device)
    keep = i[None, :] <= i[:, None]
    if window > 0:
        keep &= i[None, :] > i[:, None] - window
    for b in range(B):  # one row at a time keeps the scores of one row live
        s = torch.einsum("qhgd,khd->hgqk", qg[b], k[b]) / math.sqrt(hd)
        s = s.masked_fill(~keep, float("-inf"))
        out[b] = torch.einsum("hgqk,khd->qhgd", torch.softmax(s, dim=-1), v[b])
    return out.reshape(B, S, H, hd)


def _scaled(x, scale):
    return x if scale is None else x * scale


class Decoder:
    """The configuration's decoder over stacked weights ``params`` (the
    benchmark's layout; any float type, used as float32).  A stack may
    also be a list of its entries (one tensor a layer of its kind)."""

    def __init__(self, cfg: dict, params: dict, mm=fp32_mm):
        self.cfg, self.p, self.mm = cfg, params, mm
        self.eps = cfg["norm_eps"]
        self.family = F.of(cfg)

    def _own(self, name):
        return getattr(self.family, name, None)

    def layer_params(self, li: int) -> dict:
        own = self._own("layer_params")
        if own is not None:
            return own(self, li)

        def pick(t):
            return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) else t[li]
        return pick(self.p["blocks"])

    def embed(self, tokens):
        scale = self._own("embed_scale")
        h = self.p["embed"][tokens.long()].float()
        return _scaled(h, scale and scale(self.cfg))

    def layer(self, lp: dict, h):
        """One layer: (new h, its cache entries, as the family's mixer
        makes them)."""
        own = self._own("layer")
        if own is not None:
            return own(self, lp, h)
        out, cache = self.family.mixer(self, lp, h)
        h = h + out
        return h + self.ffn(lp, h), cache

    def ffn(self, lp: dict, h):
        """The FFN's output over the residual ``h``: the family's, or a
        SwiGLU after an RMS norm."""
        own = self._own("ffn")
        if own is not None:
            return own(self, lp, h)
        g = lp["mlp"]
        x = rms(h, lp["mlp_ln"], self.eps)
        return self.mm(silu(self.mm(x, g["gate"])) * self.mm(x, g["up"]), g["down"])

    def head_weight(self):
        return self.p["lm_head"] if "lm_head" in self.p else self.p["embed"].transpose(0, 1)

    def head(self, h):
        scale = self._own("logit_scale")
        logits = self.mm(rms(h, self.p["final_norm"], self.eps), self.head_weight())
        return _scaled(logits, scale and scale(self.cfg))

"""Mixture-of-Experts layer: top-k routing, capacity-based dispatch.

Twin of ``repro.models.moe`` (``moe_init``, ``moe_apply``,
``moe_aux_loss``), as plain functions over explicit parameter dicts of
torch tensors, drawn from an explicit ``torch.Generator`` like
``models/common.py``.

* routing and position-in-expert are computed per batch row;
* tokens are scattered into an ``(E, B, C, d)`` buffer; every kept
  (expert, row, slot) is written exactly once, and tokens over capacity
  ``C = ceil(cf · S · k / E)`` (cf = 1.25) go to a scratch slot ``C``
  that is cut off -- so the scatter is a plain indexed write, never a
  float accumulation (no atomics on the card);
* the expert FFNs run as grouped einsums over the stacked (E, d, ff)
  weights; dense dispatch reads every expert's weights whatever the
  routing, at decode too (C = 1);
* the router (and qwen2-moe's shared-expert gate) stays float32 in a
  bf16 model, as in the reference.

The top-k takes the lower expert index on tied router probabilities, as
``jax.lax.top_k`` does (a stable descending sort; ``torch.topk``'s order
on ties is unspecified on CUDA), so the capacity drops are the
reference's.  The expert-parallel ``moe_apply_ep`` needs a mesh and is
not ported (``ROADMAP.md``, distributed and launch).

Supports qwen2-moe (shared experts + routed) and arctic (dense-residual
FFN in parallel with the routed experts).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    dense_init,
    normal,
    silu,
    swiglu_apply,
    swiglu_init,
)


def moe_init(gen: torch.Generator, cfg, dtype) -> dict:
    d = cfg.d_model
    e_ff = cfg.moe_d_ff or cfg.d_ff
    E = cfg.num_experts
    scale = 1.0 / math.sqrt(d)
    p = {
        "router": dense_init(gen, d, E, torch.float32),
        "experts": {
            "gate": normal(gen, (E, d, e_ff), scale, dtype),
            "up": normal(gen, (E, d, e_ff), scale, dtype),
            "down": normal(gen, (E, e_ff, d), 1.0 / math.sqrt(e_ff), dtype),
        },
    }
    if cfg.num_shared_experts:
        p["shared"] = swiglu_init(gen, d, cfg.num_shared_experts * e_ff, dtype)
        p["shared_gate"] = dense_init(gen, d, 1, torch.float32)
    if cfg.dense_residual:
        p["dense_ffn"] = swiglu_init(gen, d, cfg.d_ff, dtype)
    return p


def router_probs(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Router softmax in float32: (B, S, d) -> (B, S, E)."""
    return torch.softmax(x.float() @ p["router"], dim=-1)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis, ties to the lower index
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: dict, x: torch.Tensor, cfg, capacity_factor: float = 1.25):
    """Routing and dispatch positions of ``x`` (B, S, d): each of the
    B·S·k slots' expert ``flat_e``, its position ``pos_clip`` in that
    expert's buffer (``C`` for a dropped slot), ``keep``, the
    renormalised weights ``flat_w``, and ``C``."""
    B, S, _ = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = max(1, math.ceil(capacity_factor * S * k / E))
    top_w, top_e = top_k(router_probs(p, x), k)  # (B, S, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # per-row position-in-expert (B, S*k)
    flat_e = top_e.reshape(B, S * k)
    pos = torch.cumsum(F.one_hot(flat_e, E), dim=1) - 1
    pos_of = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    keep = pos_of < C
    pos_clip = torch.where(keep, pos_of, torch.full_like(pos_of, C))
    return flat_e, pos_clip, keep, top_w.reshape(B, S * k), C


def dispatch(x: torch.Tensor, flat_e, pos_clip, E: int, C: int) -> torch.Tensor:
    """Scatter each slot's token into the (E, B, C, d) expert buffers: each
    kept slot is written once; dropped slots all land in scratch slot C,
    which is cut off."""
    B, S, d = x.shape
    k = flat_e.shape[1] // S
    tok = torch.repeat_interleave(x, k, dim=1)  # (B, S*k, d), token per slot
    buf = torch.zeros((E, B, C + 1, d), dtype=x.dtype, device=x.device)
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, S * k)
    buf[flat_e, b_idx, pos_clip] = tok
    return buf[:, :, :C]


def expert_ffn(w: dict, buf: torch.Tensor) -> torch.Tensor:
    """The grouped SwiGLU of every expert over its buffer: (E, B, C, d)."""
    g = silu(torch.einsum("ebcd,edf->ebcf", buf, w["gate"]))
    u = torch.einsum("ebcd,edf->ebcf", buf, w["up"])
    return torch.einsum("ebcf,efd->ebcd", g * u, w["down"])


def combine(eo: torch.Tensor, flat_e, pos_clip, keep, flat_w, S: int) -> torch.Tensor:
    """Gather each slot's expert output back, weight it, and sum a token's
    k slots: (E, B, C, d) -> (B, S, d)."""
    _, B, _, d = eo.shape
    k = flat_e.shape[1] // S
    eo = F.pad(eo, (0, 0, 0, 1))  # the scratch slot reads zeros
    b_idx = torch.arange(B, device=eo.device)[:, None].expand(B, S * k)
    back = eo[flat_e, b_idx, pos_clip]  # (B, S*k, d)
    back = back * (keep[..., None] * flat_w[..., None]).to(back.dtype)
    return back.reshape(B, S, k, d).sum(dim=2)


def residual_ffn(p: dict, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out`` plus the shared experts (gated) and the dense residual FFN,
    where the layer has them."""
    if "shared" in p:
        sh = swiglu_apply(p["shared"], x)
        gate = torch.sigmoid(x.float() @ p["shared_gate"]).to(x.dtype)
        out = out + sh * gate
    if "dense_ffn" in p:
        out = out + swiglu_apply(p["dense_ffn"], x)
    return out


def moe_apply(p: dict, x: torch.Tensor, cfg, *, capacity_factor: float = 1.25
              ) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    flat_e, pos_clip, keep, flat_w, C = route(p, x, cfg, capacity_factor)
    buf = dispatch(x, flat_e, pos_clip, cfg.num_experts, C)
    eo = expert_ffn(p["experts"], buf)
    out = combine(eo, flat_e, pos_clip, keep, flat_w, x.shape[1])
    return residual_ffn(p, x, out)


def moe_aux_loss(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style f·P)."""
    probs = router_probs(p, x)  # (B, S, E)
    top_e = top_k(probs, cfg.num_experts_per_tok)[1]
    E = cfg.num_experts
    frac = F.one_hot(top_e, E).float().mean(dim=(0, 1, 2))  # fraction routed
    imp = probs.mean(dim=(0, 1))  # mean router prob
    return E * torch.sum(frac * imp)

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
reference's.

``moe_apply_ep`` is the expert-parallel path over a mesh's ``model``
axis: column j of the mesh holds experts ``[j·E/mp, (j+1)·E/mp)``, routes
every token of its data shard over all E experts, keeps the (token,
slot) pairs that land on its own experts (capacity from the shard's own
token count, positions counted over the shard's flattened tokens), and
computes their part of the output; the columns' parts are summed (the
reference's ``psum``).  On one card the columns run one by one and are
summed in column order, with no float atomics.  On a mesh over ranks
(``distributed/meshes.py``) ``x`` is already this rank's data shard; where
the model axis spans the ranks too, each rank computes its own column.

Under tensor parallelism (a ``model`` axis across ranks) ``moe_apply_tp``
is the dense dispatch on the rank's share of the reference's specs: its
E/m experts (or every expert's share of the hidden columns where E does
not divide the axis), its columns of the shared experts and of the dense
FFN.  The experts stay where they are and the residual stream stays
replicated: each rank routes every token, computes the slots routed to
its experts, and the ranks' partial outputs meet in one all-reduce a
layer (the reference's ``psum`` over ``model``, ``distributed/ctx.py``'s
``leave_model``); no token moves.

Supports qwen2-moe (shared experts + routed) and arctic (dense-residual
FFN in parallel with the routed experts).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.ctx import (
    data_mean,
    enter_model,
    leave_model,
    model_group,
    model_rank,
)
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


def route(p: dict, x: torch.Tensor, cfg, capacity_factor: float = 1.25, *,
          e_base: int = 0, n_exp: int = 0):
    """Routing and dispatch positions of ``x`` (B, S, d), every token over
    all E experts, the slots kept for experts ``[e_base, e_base + n_exp)``
    (all E when ``n_exp`` is 0): each of the B·S·k slots' expert
    ``flat_e`` counted from ``e_base`` (``n_exp`` for a slot of another
    expert), its position ``pos_clip`` in that expert's buffer (``C`` for
    a slot dropped or another's), ``keep``, the renormalised weights
    ``flat_w``, and ``C`` (from the whole row's tokens).  A slot's
    position among its expert's slots reads only that expert's column of
    the one-hot, so counting over a share of the experts (a rank's, under
    tensor parallelism) drops the slots one process drops."""
    B, S, _ = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = max(1, math.ceil(capacity_factor * S * k / E))
    top_w, top_e = top_k(router_probs(p, x), k)  # (B, S, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # per-row position-in-expert (B, S*k)
    flat_e = top_e.reshape(B, S * k)
    cols = E
    if n_exp and n_exp < E:
        own = (flat_e >= e_base) & (flat_e < e_base + n_exp)
        flat_e = torch.where(own, flat_e - e_base, torch.full_like(flat_e, n_exp))
        cols = n_exp + 1  # the last column gathers the other experts' slots
    pos = torch.cumsum(F.one_hot(flat_e, cols), dim=1) - 1
    pos_of = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    keep = pos_of < C
    if cols != E:
        keep = keep & own
    pos_clip = torch.where(keep, pos_of, torch.full_like(pos_of, C))
    return flat_e, pos_clip, keep, top_w.reshape(B, S * k), C


def dispatch(x: torch.Tensor, flat_e, pos_clip, E: int, C: int) -> torch.Tensor:
    """Scatter each slot's token into the (E, B, C, d) buffers of the E
    experts held: each kept slot is written once; dropped slots all land
    in scratch slot C, and another expert's slots (``flat_e`` = E) in a
    scratch expert, both cut off."""
    B, S, d = x.shape
    k = flat_e.shape[1] // S
    tok = torch.repeat_interleave(x, k, dim=1)  # (B, S*k, d), token per slot
    buf = torch.zeros((E + 1, B, C + 1, d), dtype=x.dtype, device=x.device)
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, S * k)
    buf[flat_e, b_idx, pos_clip] = tok
    return buf[:E, :, :C]


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
    eo = F.pad(eo, (0, 0, 0, 1, 0, 0, 0, 1))  # the scratch slot and expert read zeros
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


def routed_experts(p: dict, x: torch.Tensor, cfg, capacity_factor: float = 1.25,
                   e_base: int = 0) -> torch.Tensor:
    """The routed experts' part of the output for ``x`` (B, S, d): every
    token routed with the whole ``router``; the slots of the experts that
    ``p["experts"]`` holds (``[e_base, e_base + E_held)``, all their hidden
    columns or a share of them) dispatched, computed and combined."""
    n = p["experts"]["gate"].shape[0]
    flat_e, pos_clip, keep, flat_w, C = route(p, x, cfg, capacity_factor, e_base=e_base,
                                              n_exp=n)
    eo = expert_ffn(p["experts"], dispatch(x, flat_e, pos_clip, n, C))
    return combine(eo, flat_e, pos_clip, keep, flat_w, x.shape[1])


def moe_apply(p: dict, x: torch.Tensor, cfg, *, capacity_factor: float = 1.25
              ) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    return residual_ffn(p, x, routed_experts(p, x, cfg, capacity_factor))


# ---------------------------------------------------------------------------
# Tensor parallelism over a model group across ranks (the reference's specs)
# ---------------------------------------------------------------------------


def _residual_parts(p: dict, x, xe, cfg, inside: list, outside: list) -> None:
    """The shared experts (gated) and the dense residual FFN of ``x``:
    appended to ``inside`` where the rank holds a share of their columns
    (computed on ``xe``, ``x`` entering the region, with ``shared_gate``
    entering too, as the gate weighs a partial sum), else whole to
    ``outside``."""
    e_ff = cfg.moe_d_ff or cfg.d_ff
    if "shared" in p:
        split = p["shared"]["gate"].shape[-1] < cfg.num_shared_experts * e_ff
        xs, sg = (xe, enter_model(p["shared_gate"])) if split else (x, p["shared_gate"])
        gate = torch.sigmoid(xs.float() @ sg).to(x.dtype)
        (inside if split else outside).append(swiglu_apply(p["shared"], xs) * gate)
    if "dense_ffn" in p:
        split = p["dense_ffn"]["gate"].shape[-1] < cfg.d_ff
        (inside if split else outside).append(swiglu_apply(p["dense_ffn"], xe if split else x))


def _leave(inside: list, outside: list) -> torch.Tensor:
    """The rank's partial sums ``inside`` added and summed over the model
    group (one all-reduce), plus the parts ``outside`` it computed whole."""
    out = None
    if inside:
        part = inside[0]
        for t in inside[1:]:
            part = part + t
        out = leave_model(part)
    for t in outside:
        out = t if out is None else out + t
    return out


def moe_apply_tp(p: dict, x: torch.Tensor, cfg, *, capacity_factor: float = 1.25
                 ) -> torch.Tensor:
    """``moe_apply`` of ``x`` (B, S, d), the layer's normed input and the
    same on every rank of the model group, where the rank holds its share
    of the reference's specs (``distributed/sharding.py``): E/m experts
    (``e_base = model_rank() · E/m``) where E divides the axis, else every
    expert's share of the hidden columns; the shared experts' and the
    dense FFN's columns where they divide it.  Every token is routed with
    the whole ``router`` and the row's capacity C of ``moe_apply``; the
    rank dispatches, computes and combines only its own slots (or its
    hidden columns of all of them), adds its shares of the shared experts
    and the dense FFN, and the sum leaves the region once (one all-reduce,
    the reference's ``psum``).  ``x``, ``router`` and ``shared_gate``
    enter it: each rank's gradient of them is partial.  A part whose
    leaves the specs leave whole is computed whole, outside the region."""
    E, e_ff = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    w = p["experts"]
    n = w["gate"].shape[0]
    xe = enter_model(x)
    inside, outside = [], []
    if n < E or w["gate"].shape[-1] < e_ff:
        q = {"router": enter_model(p["router"]), "experts": w}
        inside.append(routed_experts(q, xe, cfg, capacity_factor,
                                     e_base=model_rank() * n if n < E else 0))
    else:
        outside.append(routed_experts(p, x, cfg, capacity_factor))
    _residual_parts(p, x, xe, cfg, inside, outside)
    return _leave(inside, outside)


def moe_aux_loss(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style f·P), of the whole
    batch: where the train step splits it over ranks, the fractions and
    mean probabilities are averaged over the data group
    (``distributed.ctx.data_mean``) before their product."""
    probs = router_probs(p, x)  # (B, S, E)
    top_e = top_k(probs, cfg.num_experts_per_tok)[1]
    E = cfg.num_experts
    frac = data_mean(F.one_hot(top_e, E).float().mean(dim=(0, 1, 2)))  # fraction routed
    imp = data_mean(probs.mean(dim=(0, 1)))  # mean router prob
    return E * torch.sum(frac * imp)


# ---------------------------------------------------------------------------
# Expert-parallel path (the reference's shard_map over the ``model`` axis)
# ---------------------------------------------------------------------------


def local_route(logits: torch.Tensor, *, e_base: int, E_loc: int, k: int, C: int):
    """Routing of one (data, model) shard: ``logits`` (T, E) float32 over
    all experts; the local experts are ``[e_base, e_base + E_loc)``.
    Returns, per (token, slot) pair in token-major order, the local
    expert ``loc_e`` (``E_loc`` for a pair not kept), the position
    ``pos`` in its buffer (``C`` when not kept), ``keep`` and the
    renormalised weight ``flat_w``."""
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, k)  # (T, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_e.reshape(-1)
    flat_w = top_w.reshape(-1)
    local = (flat_e >= e_base) & (flat_e < e_base + E_loc)
    loc_e = torch.where(local, flat_e - e_base, torch.full_like(flat_e, E_loc))
    pos = torch.cumsum(F.one_hot(loc_e, E_loc + 1), dim=0) - 1
    pos_of = torch.gather(pos, 1, loc_e[:, None])[:, 0]
    keep = local & (pos_of < C)
    pos_clip = torch.where(keep, pos_of, torch.full_like(pos_of, C))
    loc_e_c = torch.where(keep, loc_e, torch.full_like(loc_e, E_loc))
    return loc_e_c, pos_clip, keep, flat_w


def _local_expert_compute(x, logits, w_gate, w_up, w_down, *, e_base, k, C):
    """One (data, model) shard: route all local tokens to local experts.
    x (T, d); logits (T, E) float32.  Returns the partial output (T, d)."""
    E_loc = w_gate.shape[0]
    T, d = x.shape
    loc_e, pos, keep, flat_w = local_route(logits, e_base=e_base, E_loc=E_loc, k=k, C=C)
    tok = torch.repeat_interleave(x, k, dim=0)  # (T*k, d), token per slot
    buf = torch.zeros((E_loc + 1, C + 1, d), dtype=x.dtype, device=x.device)
    buf[loc_e, pos] = tok  # kept pairs written once; the rest land in the cut-off scratch
    buf = buf[:E_loc, :C]
    g = silu(torch.einsum("ecd,edf->ecf", buf, w_gate))
    u = torch.einsum("ecd,edf->ecf", buf, w_up)
    eo = torch.einsum("ecf,efd->ecd", g * u, w_down)  # (E_loc, C, d)
    eo = F.pad(eo, (0, 0, 0, 1, 0, 1))
    back = eo[loc_e, pos]  # (T*k, d)
    back = back * (keep * flat_w)[:, None].to(back.dtype)
    return back.reshape(T, k, d).sum(dim=1)


def moe_apply_ep(p: dict, x: torch.Tensor, cfg, mesh, *,
                 capacity_factor: float = 1.25) -> torch.Tensor:
    """Expert-parallel MoE over ``mesh`` (model axis = EP); x (B, S, d).
    Where the ``model`` axis spans ranks, this rank computes column
    ``model_rank()`` alone, with the E/mp experts it holds, and the
    columns' parts (its shares of the shared experts and the dense FFN
    with them) leave the region once, as in ``moe_apply_tp``."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    mp = mesh.shape.get("model", 1)
    if E % mp:
        raise ValueError(f"{E} experts do not divide the model axis {mp}")
    E_loc = E // mp
    dp = 1
    if getattr(mesh, "group", None) is None:  # over ranks, x is this rank's rows
        for a in mesh.axis_names:
            if a in ("pod", "data"):
                dp *= mesh.shape[a]
    n_shards = dp if (dp > 1 and B % dp == 0) else 1
    B_loc = B // n_shards
    T = B_loc * S
    C = max(1, math.ceil(capacity_factor * T * k / E))
    w = p["experts"]
    if model_group() is not None:  # the model axis across ranks: one column here
        if w["gate"].shape[0] != E_loc:
            raise ValueError(f"a rank of a model axis of {mp} holds {w['gate'].shape[0]} "
                             f"experts, not {E_loc}")
        xe = enter_model(x)
        x2 = xe.reshape(T, d)
        logits = x2.float() @ enter_model(p["router"])
        inside = [_local_expert_compute(x2, logits, w["gate"], w["up"], w["down"],
                                        e_base=model_rank() * E_loc, k=k, C=C).reshape(B, S, d)]
        outside = []
        _residual_parts(p, x, xe, cfg, inside, outside)
        return _leave(inside, outside)
    outs = []
    for i in range(n_shards):
        x2 = x[i * B_loc:(i + 1) * B_loc].reshape(T, d)
        logits = x2.float() @ p["router"]
        out = None
        for j in range(mp):  # the psum over model, in column order
            cols = slice(j * E_loc, (j + 1) * E_loc)
            part = _local_expert_compute(x2, logits, w["gate"][cols], w["up"][cols],
                                         w["down"][cols], e_base=j * E_loc, k=k, C=C)
            out = part if out is None else out + part
        outs.append(out.reshape(B_loc, S, d))
    return residual_ffn(p, x, torch.cat(outs, dim=0))

"""Mamba2 / SSD (state-space duality) layer.

Twin of ``repro.models.ssd``.  Chunked dual form (arXiv:2405.21060): the
sequence is split into chunks of ``Q`` tokens; within a chunk the output
is a (masked, decay-weighted) attention-like quadratic form, and states
propagate across chunks through a scalar-decay linear recurrence.  The
reference evaluates that recurrence with ``jax.lax.associative_scan``;
here it is a loop over the chunks (same values, float32 sums in another
order).

Projections are stored split (z, x, B/C, Δ), as in the reference, so the
parameter trees map leaf for leaf.

``ssd_forward(use_pallas=True)`` runs the chunked scan through the
hand-written kernel (``kernels/ops.ssd_scan``): CUDA on a CUDA tensor,
its plain version on a CPU tensor.  That flag is the kernel's only way
in, as in the reference: the model's layers take the chunked form.

Decode is the O(1) recurrent step:  h ← e^{AΔ}·h + Δ·B⊗x,  y = C·h + D·x,
with a small causal-conv ring buffer.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, normal, rms_norm, silu


def ssd_init(gen: torch.Generator, cfg, dtype) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    N = cfg.ssm_state
    nh = cfg.ssm_heads
    w = cfg.ssm_conv
    dev = gen.device
    a_init = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=dev))
    dt_bias = torch.log(torch.expm1(
        torch.linspace(1e-3, 1e-1, nh, dtype=torch.float32, device=dev)))
    return {
        "wz": dense_init(gen, d, di, dtype),
        "wx": dense_init(gen, d, di, dtype),
        "wbc": dense_init(gen, d, 2 * N, dtype),
        "wdt": dense_init(gen, d, nh, dtype),
        "conv_x": normal(gen, (w, di), 1.0 / math.sqrt(w), dtype),
        "conv_bc": normal(gen, (w, 2 * N), 1.0 / math.sqrt(w), dtype),
        "conv_bx": torch.zeros((di,), dtype=dtype, device=dev),
        "conv_bbc": torch.zeros((2 * N,), dtype=dtype, device=dev),
        "A_log": a_init,
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": dt_bias,
        "norm": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, ch) with kernel (w, ch) + silu."""
    W = w.shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):  # tiny static loop (W == 4)
        out = out + pad[:, i:i + S].float() * w[i].float()
    return silu(out + b.float()).to(x.dtype)


def ssd_chunked(xh, dt, A, Bm, Cm, *, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xh (B,S,nh,hp), dt (B,S,nh) positive, A (nh,) negative, Bm/Cm
    (B,S,N), optional initial state h0 (B,nh,hp,N).  Returns (y
    (B,S,nh,hp) fp32, final_state (B,nh,hp,N) fp32)."""
    B, S, nh, hp = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:  # pad tail: dt=0 ⇒ decay=1 and zero deposit ⇒ exact
        pad = Q - S % Q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q

    xc = xh.reshape(B, nc, Q, nh, hp).float()
    dtc = dt.reshape(B, nc, Q, nh).float()
    Bc = Bm.reshape(B, nc, Q, N).float()
    Cc = Cm.reshape(B, nc, Q, N).float()

    a = dtc * A  # (B,nc,Q,nh) negative log-decay per step
    La = torch.cumsum(a, dim=2)  # inclusive within-chunk cumulative
    Ltot = La[:, :, -1]  # (B,nc,nh)

    # ---- intra-chunk (quadratic dual form) --------------------------------
    cb = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    idx = torch.arange(Q, device=xh.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    # the mask goes inside the exp: above the diagonal La_i - La_j > 0 can
    # overflow (a chunk of 256 steps at |dt·A| up to 1.6), and the
    # reference's where(causal, exp(·), 0) then sends 0·inf = NaN back
    # through exp's gradient.  exp(-inf) = 0 gives the same forward values.
    decay = torch.exp(torch.where(causal, La[:, :, :, None, :] - La[:, :, None, :, :],
                                  torch.full((), -math.inf, device=xh.device)))
    scores = cb[..., None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores, xc)

    # ---- chunk states -------------------------------------------------------
    w_state = torch.exp(Ltot[:, :, None, :] - La) * dtc  # (B,nc,Q,nh)
    S_chunk = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bc, w_state, xc)

    # ---- cross-chunk recurrence: the state entering each chunk --------------
    chunk_decay = torch.exp(Ltot)  # (B,nc,nh)
    h = (torch.zeros((B, nh, hp, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.float())
    H_prev = []
    for c in range(nc):
        H_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S_chunk[:, c]
    H_prev = torch.stack(H_prev, dim=1)  # (B,nc,nh,hp,N)

    # ---- inter-chunk contribution ------------------------------------------
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, H_prev) * torch.exp(La)[..., None]

    y = (y_intra + y_inter).reshape(B, S, nh, hp)[:, :S_orig]
    return y, h  # final: (B, nh, hp, N)


def ssd_forward(p: dict, x: torch.Tensor, cfg, *, h0: Optional[torch.Tensor] = None,
                use_pallas: bool = False):
    """Full Mamba2 block over (B, S, d).

    Returns (out (B,S,d), final_state (B,nh,hp,N), conv_tail (B,w-1,di+2N)).
    ``use_pallas`` runs the scan through the kernel, which takes no
    initial state: passing ``h0`` with it raises (the reference drops
    ``h0`` silently there).
    """
    if use_pallas and h0 is not None:
        raise ValueError("ssd_forward(use_pallas=True) takes no h0: the "
                         "ssd_scan kernel starts from a zero state")
    B, S, d = x.shape
    di, N, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z = x @ p["wz"]
    xr_pre = x @ p["wx"]
    bc_pre = x @ p["wbc"]
    dt = x @ p["wdt"]
    xr = _causal_conv(xr_pre, p["conv_x"], p["conv_bx"])
    bc = _causal_conv(bc_pre, p["conv_bc"], p["conv_bbc"])
    xs = xr.reshape(B, S, nh, hp)
    Bm = bc[..., :N]
    Cm = bc[..., N:]
    dtp = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if use_pallas:
        from repro_torch.kernels import ops as kops

        y, state = kops.ssd_scan(xs.contiguous(), dtp.contiguous(), A,
                                 Bm.contiguous(), Cm.contiguous(),
                                 chunk=cfg.ssm_chunk)
    else:
        y, state = ssd_chunked(xs, dtp, A, Bm, Cm, chunk=cfg.ssm_chunk, h0=h0)
    y = y + xs.float() * p["D"][None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype)
    y = rms_norm(y * silu(z), p["norm"], cfg.norm_eps)
    w = cfg.ssm_conv
    # conv tails store the *pre-conv* inputs needed to resume decoding
    lo = max(S - (w - 1), 0)
    conv_tail = torch.cat([xr_pre[:, lo:, :], bc_pre[:, lo:, :]], dim=-1)
    return y @ p["out_proj"], state, conv_tail


def ssd_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    return ssd_forward(p, x, cfg)[0]


# ---------------------------------------------------------------------------
# Decode (recurrent) path
# ---------------------------------------------------------------------------


def ssd_decode_step(p: dict, state: dict, x: torch.Tensor, cfg):
    """x: (B, 1, d) single token.  Returns (out (B,1,d), new_state).

    state = {"conv": (B, w-1, di+2N) pre-conv inputs, "h": (B,nh,hp,N)}.
    """
    B = x.shape[0]
    di, N, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    x0 = x[:, 0]
    z = x0 @ p["wz"]
    xr = x0 @ p["wx"]
    bc = x0 @ p["wbc"]
    dt = x0 @ p["wdt"]

    cur = torch.cat([xr, bc], dim=-1)  # (B, di+2N)
    win = torch.cat([state["conv"], cur[:, None, :]], dim=1)  # (B, w, ch)
    kern = torch.cat([p["conv_x"], p["conv_bc"]], dim=-1)  # (w, ch)
    bias = torch.cat([p["conv_bx"], p["conv_bbc"]], dim=-1)
    conv_out = torch.einsum("bwc,wc->bc", win.float(), kern.float())
    act = silu(conv_out + bias.float()).to(x.dtype)
    new_conv = win[:, 1:]

    xs = act[..., :di].reshape(B, nh, hp)
    Bm = act[..., di:di + N]
    Cm = act[..., di + N:]
    dtp = F.softplus(dt.float() + p["dt_bias"])  # (B,nh)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dtp * A)  # (B,nh)

    h = state["h"] * dA[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dtp, xs.float(), Bm.float()
    )
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), h)
    y = y + xs.float() * p["D"][None, :, None]
    y = y.reshape(B, di).to(x.dtype)
    y = rms_norm(y * silu(z), p["norm"], cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None, :]
    return out, {"conv": new_conv, "h": h}

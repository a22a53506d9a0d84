"""The hybrid family: each layer's mixer is the dense family's attention
beside Mamba2 SSD heads (arXiv:2405.21060), both from the same normed
input, their outputs summed.  The module's parts are the dense family's
(see ``families/dense.py``), plus the SSD's.

The SSD mixer: z, x, B|C and dt projections, a depthwise causal conv of
width ``ssm_conv`` with SiLU on x and B|C, dt = softplus(dt + dt_bias),
A = -exp(A_log), the selective scan, D·x, a gated RMS norm of y·silu(z),
and the output projection.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

import weights as W
from families import dense
from reference.model import rms, silu


def _sizes(cfg):
    di = cfg["ssm_expand"] * cfg["d_model"]
    return di, cfg["ssm_state"], di // cfg["ssm_head_dim"], cfg["ssm_conv"]


def draw(cfg: dict, gen, dt, device) -> dict:
    L, d = cfg["num_layers"], cfg["d_model"]
    di, N, nh, w = _sizes(cfg)
    f32 = torch.float32
    blocks = dense.draw(cfg, gen, dt, device)  # drawn first: the generator's order
    blocks["ssm"] = {
        "wz": W.dense(gen, L, d, di, dt), "wx": W.dense(gen, L, d, di, dt),
        "wbc": W.dense(gen, L, d, 2 * N, dt), "wdt": W.dense(gen, L, d, nh, dt),
        "conv_x": W.normal(gen, (L, w, di), 1.0 / math.sqrt(w), dt),
        "conv_bc": W.normal(gen, (L, w, 2 * N), 1.0 / math.sqrt(w), dt),
        "conv_bx": W.zeros(device, dt, L, di), "conv_bbc": W.zeros(device, dt, L, 2 * N),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32, device=device)
                           ).expand(L, nh).contiguous(),
        "D": W.zeros(device, f32, L, nh).add_(1.0),
        "dt_bias": torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, nh, dtype=f32,
                                                        device=device))
                             ).expand(L, nh).contiguous(),
        "norm": W.zeros(device, dt, L, di),
        "out_proj": W.dense(gen, L, di, d, dt),
    }
    return blocks


def weight_macs(cfg: dict) -> int:
    """The attention's, the SSD's projections and its depthwise conv."""
    d = cfg["d_model"]
    di, N, nh, w = _sizes(cfg)
    return dense.weight_macs(cfg) + d * (2 * di + 2 * N + nh) + di * d + w * (di + 2 * N)


def ssd_macs(cfg: dict, S: int) -> int:
    """Multiply-adds of the SSD mixer's chunked form over one sequence of
    S positions (one layer): within each chunk C.B and the decayed scores
    times x over the causal pairs, each chunk's state, its read-out by C,
    and the recurrence across chunks."""
    di, N, nh, _ = _sizes(cfg)
    hp = cfg["ssm_head_dim"]
    Q = min(cfg["ssm_chunk"], S)
    nc = -(-S // Q)
    pairs = Q * (Q + 1) // 2
    return nc * (pairs * N + pairs * nh * hp + 2 * Q * nh * hp * N + nh * hp * N)


def sequence_macs(cfg: dict, S: int) -> int:
    return dense.sequence_macs(cfg, S) + ssd_macs(cfg, S)


def causal_conv(x, w, b):
    """Depthwise causal conv over (B, S, ch), kernel (W, ch), then SiLU."""
    Wd = w.shape[0]
    xp = F.pad(x.float(), (0, 0, Wd - 1, 0))
    out = sum(xp[:, i:i + x.shape[1]] * w[i].float() for i in range(Wd))
    return silu(out + b.float())


def selective_scan(x, dt, A, Bm, Cm, chunk):
    """y_t = C_t · h_t, h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_tᵀ, from a
    zero state, evaluated a chunk at a time (exact in any chunking).
    x (B, S, nh, hp), dt (B, S, nh), A (nh,), Bm and Cm (B, S, N).
    Returns y (B, S, nh, hp) and the final state (B, nh, hp, N)."""
    Bsz, S, nh, hp = x.shape
    N = Bm.shape[-1]
    h = torch.zeros(Bsz, nh, hp, N, dtype=torch.float32, device=x.device)
    ys = []
    for lo in range(0, S, chunk):
        xc, dtc = x[:, lo:lo + chunk], dt[:, lo:lo + chunk]
        Bc, Cc = Bm[:, lo:lo + chunk], Cm[:, lo:lo + chunk]
        Q = xc.shape[1]
        cum = torch.cumsum(dtc * A, dim=1)  # (B, Q, nh): log-decay from the chunk start
        i = torch.arange(Q, device=x.device)
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # (B, t, s, nh)
        seg = seg.masked_fill(~(i[None, :] <= i[:, None])[None, :, :, None], float("-inf"))
        w = torch.einsum("btn,bsn->bts", Cc, Bc)[..., None] * torch.exp(seg) * dtc[:, None]
        y = torch.einsum("btsh,bshp->bthp", w, xc)
        y = y + torch.einsum("btn,bhpn->bthp", Cc, h) * torch.exp(cum)[..., None]
        ys.append(y)
        tail = torch.exp(cum[:, -1:, :] - cum) * dtc  # (B, Q, nh)
        h = h * torch.exp(cum[:, -1])[:, :, None, None] + torch.einsum(
            "bsh,bshp,bsn->bhpn", tail, xc, Bc)
    return torch.cat(ys, dim=1), h


def ssd(dec, sp: dict, x):
    """The SSD heads over the normed input ``x``: (output, the final SSM
    state h, the conv buffer: the last ssm_conv - 1 pre-conv inputs of x
    and of B|C)."""
    cfg, mm = dec.cfg, dec.mm
    B, S, _ = x.shape
    N, hp, Wd = cfg["ssm_state"], cfg["ssm_head_dim"], cfg["ssm_conv"]
    bc_pre, x_pre = mm(x, sp["wbc"]), mm(x, sp["wx"])
    z, dt = mm(x, sp["wz"]), mm(x, sp["wdt"])
    bc = causal_conv(bc_pre, sp["conv_bc"], sp["conv_bbc"])
    xs = causal_conv(x_pre, sp["conv_x"], sp["conv_bx"]).reshape(B, S, -1, hp)
    dt = F.softplus(dt + sp["dt_bias"].float())
    A = -torch.exp(sp["A_log"].float())
    y, state = selective_scan(xs, dt, A, bc[..., :N], bc[..., N:], cfg["ssm_chunk"])
    y = (y + xs * sp["D"].float()[None, None, :, None]).reshape(B, S, -1)
    y = rms(y * silu(z), sp["norm"], dec.eps)
    conv = torch.cat([x_pre[:, S - (Wd - 1):], bc_pre[:, S - (Wd - 1):]], dim=-1)
    return mm(y, sp["out_proj"]), state, conv


def mixer(dec, lp: dict, h):
    x = rms(h, lp["attn"]["ln"], dec.eps)
    out, cache = dense.attention(dec, lp["attn"], x)
    y, cache["h"], cache["conv"] = ssd(dec, lp["ssm"], x)
    return out + y, cache

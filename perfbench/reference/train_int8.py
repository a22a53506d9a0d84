"""The reference training steps of a run whose optimizer keeps float32
master weights and int8 moments and compresses its gradients to int8 (a
tensor-parallel job's, ``kinds/train_tp.py``), with the model's layers
spread over several cards in blocks.

The loss and its gradients are ``reference/train.py``'s: the token-mean
cross-entropy of the next token, by autograd in float32 with each layer
recomputed in the backward pass.  Here it runs a batch row at a time, the
rows' sums added, so that cards holding different blocks of layers work
on different rows at once.  The parameters the forward takes are the
master copies rounded to their leaf's type.  Then, each step:

- compression with error feedback: g + r in blocks of 256 along the
  last axis, a block's scale its largest magnitude over 127, its codes
  rounded half to even and held to [-127, 127]; the new residual r is
  g + r less the codes times the scale, and that round trip goes on;
- the global norm of the round trips, clipped to ``clip_norm``;
- AdamW on the master copies in float32: each moment read back from its
  int8 codes (the same blocks, a float32 scale a block), updated with
  the clipped gradient, and stored as codes again; the update takes the
  moments before they are stored; bias correction; decoupled weight
  decay on leaves of two or more dimensions in the stacked layout.

Nothing here imports the program under test.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.model import Decoder, fp32_mm
from reference.train import _flat, _nest

BLOCK = 256


def codes(x: torch.Tensor):
    """``x``'s codes (float32 integers) and scales in blocks of 256 along
    its last axis: (..., nb, 256) and (..., nb, 1)."""
    xb = F.pad(x, (0, (-x.shape[-1]) % BLOCK)).reshape(*x.shape[:-1], -1, BLOCK)
    scale = xb.abs().amax(-1, keepdim=True) / 127.0
    return torch.round(xb / scale.clamp(min=1e-12)), scale


def decode(q: torch.Tensor, scale: torch.Tensor, last: int) -> torch.Tensor:
    """The values of codes ``q`` under ``scale``, the last axis cut back
    to ``last``."""
    return (q.float() * scale).reshape(*q.shape[:-2], -1)[..., :last]


def round_trip(x: torch.Tensor) -> torch.Tensor:
    """``x`` through the compressed wire format: its codes held to
    [-127, 127], times their scales."""
    q, scale = codes(x)
    return decode(q.clamp(-127, 127), scale, x.shape[-1])


class Moment:
    """An AdamW moment as the configuration stores it: int8 codes with
    float32 scales, or float32."""

    def __init__(self, dtype: str):
        self.int8 = dtype == "int8"

    def store(self, x: torch.Tensor):
        if not self.int8:
            return x
        q, scale = codes(x)
        return q.to(torch.int8), scale, x.shape[-1]

    def read(self, held, like: torch.Tensor) -> torch.Tensor:
        if held is None:
            return torch.zeros_like(like)
        return decode(*held) if self.int8 else held


def _layer(dec, x, lp):
    lp = {k: _layer_to(v, x.device) for k, v in lp.items()}
    return dec.layer(lp, x)[0]


def _layer_to(t, device):
    return {k: _layer_to(v, device) for k, v in t.items()} if isinstance(t, dict) else t.to(device)


def loss(cfg: dict, top: dict, stacks: dict, tokens: torch.Tensor, devices,
         mm=fp32_mm) -> torch.Tensor:
    """The token-mean cross-entropy of ``tokens`` (B, S), a row at a
    time; layer li on ``devices[li * len(devices) // L]``, its leaves
    moved there where they lie elsewhere."""
    dec = Decoder(cfg, dict(top, blocks=stacks), mm)
    L, n = cfg["num_layers"], len(devices)
    B, S = tokens.shape
    total = None
    for b in range(B):
        row = tokens[b:b + 1]
        h = dec.embed(row.to(dec.p["embed"].device))
        for li in range(L):
            h = checkpoint(_layer, dec, h.to(devices[li * n // L]), dec.layer_params(li),
                           use_reentrant=False)
        w = dec.head_weight()
        logits = dec.head(h.to(w.device))
        targets = torch.roll(row.long().to(w.device), -1, dims=1)
        ce = torch.logsumexp(logits, -1) - torch.gather(logits, -1, targets[..., None])[..., 0]
        part = ce[:, :-1].sum().to(devices[0])
        total = part if total is None else total + part
    return total / (B * (S - 1))


def train(cfg: dict, params0: dict, batches: List[torch.Tensor], opt: dict, *, devices,
          master: bool = True, moments: str = "int8", compress: bool = True,
          mm=fp32_mm) -> dict:
    """``len(batches)`` steps from ``params0`` (stacked, as drawn; not
    changed), entry j of a stack of n on ``devices[j * len(devices) //
    n]``, the embedding on the first card and the head (with the final
    norm) on the last, or the first where it is the embedding.  Without
    ``master`` the parameters are stored in their leaf's type after each
    update.  Returns the losses, each leaf's first gradient norm as the
    optimizer takes it (from the stored first moment, m / (1 - b1)), and
    each leaf's norm of change over the steps."""
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    wd, clip, lr = opt["weight_decay"], opt["clip_norm"], opt["lr"]
    flat0 = dict(_flat(params0))
    n = len(devices)
    head = devices[-1] if "lm_head" in flat0 else devices[0]
    keys = []  # (path, entry of its stack or None, dimensions of the leaf, device)
    for path, t in flat0.items():
        if path.startswith("blocks/"):
            keys += [(path, j, t.dim(), devices[j * n // t.shape[0]]) for j in range(t.shape[0])]
        else:
            keys.append((path, None, t.dim(), devices[0] if path == "embed" else head))

    def first(k):
        t = flat0[k[0]]
        return (t if k[1] is None else t[k[1]]).to(k[3])

    dtype = {k: flat0[k[0]].dtype for k in keys}
    w = {k: first(k).to(torch.float32, copy=True) for k in keys}  # master copies (or parameters)
    r = {k: torch.zeros_like(t) for k, t in w.items()} if compress else {}
    mo = Moment(moments)
    m: Dict = dict.fromkeys(keys)
    v: Dict = dict.fromkeys(keys)
    losses, grad_sq = [], dict.fromkeys(flat0, 0.0)

    def change_norms():
        sq = dict.fromkeys(flat0, 0.0)
        for k in keys:
            d = w[k].to(dtype[k]).float() - first(k).float()
            sq[k[0]] += float(d.double().square().sum())
        return {p: s ** 0.5 for p, s in sq.items()}

    for step, tokens in enumerate(batches, 1):
        live = {k: w[k].to(dtype[k]).to(torch.float32, copy=True).requires_grad_() for k in keys}
        top = {k[0]: t for k, t in live.items() if k[1] is None}
        stacks: Dict[str, list] = {}
        for k, t in live.items():
            if k[1] is not None:
                stacks.setdefault(k[0][len("blocks/"):], []).append(t)
        with torch.enable_grad():
            value = loss(cfg, top, _nest(stacks), tokens, devices, mm)
            grads = torch.autograd.grad(value, list(live.values()))
        losses.append(float(value.detach()))
        g = dict(zip(keys, grads))
        del grads, live, top, stacks
        with torch.no_grad():
            if compress:
                for k in keys:
                    x = g[k] + r[k]
                    g[k] = round_trip(x)
                    r[k] = x - g[k]
                    del x
            gnorm = torch.sqrt(sum(torch.sum(x * x).to(devices[0]) for x in g.values()))
            scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
            for k in keys:
                gk = g.pop(k) * scale.to(k[3])
                mk = mo.read(m[k], gk).mul_(b1).add_((1 - b1) * gk)
                vk = mo.read(v[k], gk).mul_(b2).add_((1 - b2) * gk * gk)
                del gk
                upd = (mk / (1 - b1 ** step)) / (torch.sqrt(vk / (1 - b2 ** step)) + eps)
                if wd and k[2] >= 2:
                    upd = upd + wd * w[k]
                new = w[k] - lr * upd
                w[k] = new if master else new.to(dtype[k]).float()
                m[k], v[k] = mo.store(mk), mo.store(vk)
                del mk, vk, upd, new
                if step == 1:
                    grad_sq[k[0]] += float(mo.read(m[k], w[k]).double().square().sum())
        if step == 1:
            change_first = change_norms()
    return {"losses": losses, "grad_norms": {p: s ** 0.5 / (1 - b1) for p, s in grad_sq.items()},
            "change_norms": change_norms(), "change_first": change_first}

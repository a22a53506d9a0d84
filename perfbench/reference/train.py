"""The reference training steps: the token-mean cross-entropy of the next
token (the last position has no target), its gradients by autograd with
each layer recomputed in the backward pass (to fit, not to change the
numbers), and AdamW: the global gradient norm clipped to ``clip_norm``,
moments in float32, bias correction, decoupled weight decay on leaves of
two or more dimensions in the stacked layout, and the new parameter
stored in its leaf's type (the configuration's parameters are bf16, with
no float32 master copy).  Arithmetic is float32 throughout."""
from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from reference.model import Decoder, fp32_mm


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


def _nest(flat: Dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for path, t in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def loss(cfg: dict, params: dict, tokens: torch.Tensor, mm=fp32_mm) -> torch.Tensor:
    dec = Decoder(cfg, params, mm)
    unbound = {k: t.unbind(0) for k, t in _flat(params["blocks"])}
    h = dec.embed(tokens)
    for li in range(cfg["num_layers"]):
        lp = _nest({k: t[li] for k, t in unbound.items()})
        h = checkpoint(lambda x, p: dec.layer(p, x)[0], h, lp, use_reentrant=False)
    logits = dec.head(h)
    targets = torch.roll(tokens.long(), -1, dims=1)
    ce = torch.logsumexp(logits, -1) - torch.gather(logits, -1, targets[..., None])[..., 0]
    return ce[:, :-1].mean()


def train(cfg: dict, params0: dict, batches: List[torch.Tensor], opt: dict, *,
          mm=fp32_mm) -> dict:
    """``len(batches)`` steps from ``params0`` (not changed).  Returns the
    losses, each leaf's first gradient norm as the optimizer takes it
    (after clipping), and each leaf's norm of change over the steps."""
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    wd, clip, lr = opt["weight_decay"], opt["clip_norm"], opt["lr"]
    flat0 = dict(_flat(params0))
    p = {k: t.float().clone() for k, t in flat0.items()}
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    losses, grad_norms = [], {}
    for step, tokens in enumerate(batches, 1):
        live = {k: t.requires_grad_() for k, t in p.items()}
        with torch.enable_grad():
            value = loss(cfg, _nest(live), tokens, mm)
            grads = torch.autograd.grad(value, list(live.values()))
        losses.append(float(value.detach()))
        g = dict(zip(live, grads))
        del grads
        gnorm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        with torch.no_grad():
            for k in p:
                gk = g.pop(k) * scale
                m[k].mul_(b1).add_((1 - b1) * gk)
                v[k].mul_(b2).add_((1 - b2) * gk * gk)
                del gk
                if step == 1:
                    grad_norms[k] = float(torch.linalg.vector_norm(m[k])) / (1 - b1)
                upd = (m[k] / (1 - b1 ** step)) / (torch.sqrt(v[k] / (1 - b2 ** step)) + eps)
                pk = p[k].detach()
                if wd and pk.dim() >= 2:
                    upd = upd + wd * pk
                p[k] = (pk - lr * upd).to(flat0[k].dtype).float()
    change = {k: float(torch.linalg.vector_norm(p[k] - flat0[k].float())) for k in p}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

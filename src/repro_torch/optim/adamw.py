"""AdamW with selectable moment precision: fp32 / bf16 / int8-blockwise.

Twin of ``repro.optim.adamw``.  The int8 path stores both Adam moments as
symmetric int8 blocks of 256 along the last axis with float32 scales
(``{"q": (..., nb, 256) int8, "scale": (..., nb, 1) float32}``), about
2.03 bytes a parameter against 8 for float32.  Moments are dequantized,
updated with the fresh gradient and re-quantized every step, as in 8-bit
Adam minus the dynamic-tree format.  Codes round half to even
(``torch.round``, as ``jnp.round``), so both packages store the same
codes for the same moments.

Every update is float32 arithmetic in the reference's order: the global
gradient norm over the leaves in tree order, clipping by it, bias
correction by ``b ** count``, decay only on leaves with ``ndim >= 2``
(matrices, not norms or biases), and the new parameter cast back to the
leaf's type (from the float32 master copy when ``master_weights``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import leaves, tree_map, tree_pick

BLOCK = 256


# ---------------------------------------------------------------------------
# Blockwise int8 quantization
# ---------------------------------------------------------------------------


def _q8(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Blockwise int8 along the last axis only (the reference's layout:
    leading dimensions keep their sharding)."""
    last = x.shape[-1] if x.dim() else 1
    xb = x if x.dim() else x.reshape(1)
    pad = (-last) % BLOCK
    if pad:
        xb = F.pad(xb, (0, pad))
    nb = xb.shape[-1] // BLOCK
    blocks = xb.reshape(*xb.shape[:-1], nb, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32)}


def _dq8(qs: Dict[str, torch.Tensor], shape) -> torch.Tensor:
    blocks = qs["q"].to(torch.float32) * qs["scale"]
    padded = blocks.shape[-2] * blocks.shape[-1]
    flat_last = blocks.reshape(*blocks.shape[:-2], padded)
    last = shape[-1] if len(shape) else 1
    return flat_last[..., :last].reshape(shape)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"  # float32 | bfloat16 | int8
    clip_norm: float = 1.0
    # float32 master copies of the parameters in the optimizer state; the
    # parameters are the master cast to their type after every update
    master_weights: bool = False


class AdamW:
    def __init__(self, cfg: AdamWConfig = AdamWConfig()):
        self.cfg = cfg

    # -- state ----------------------------------------------------------
    def _encode(self, x: torch.Tensor):
        sd = self.cfg.state_dtype
        if sd == "int8":
            return _q8(x)
        return x.to(torch.bfloat16 if sd == "bfloat16" else torch.float32)

    def _decode(self, enc, shape) -> torch.Tensor:
        if isinstance(enc, dict) and "q" in enc:
            return _dq8(enc, shape)
        return enc.to(torch.float32)

    def init(self, params) -> dict:
        def zeros(p):
            return self._encode(torch.zeros(p.shape, dtype=torch.float32, device=p.device))

        some = leaves(params)
        dev = some[0].device if some else None
        state = {
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev),
        }
        if self.cfg.master_weights:
            state["master"] = tree_map(lambda p: p.to(torch.float32), params)
        return state

    # -- update ----------------------------------------------------------
    def update(self, grads, state: dict, params, lr: torch.Tensor
               ) -> Tuple[dict, dict, Dict[str, torch.Tensor]]:
        """Returns (new_params, new_state, metrics)."""
        cfg = self.cfg
        count = state["count"] + 1
        sq = torch.zeros((), dtype=torch.float32, device=count.device)
        for g in leaves(grads):
            sq = sq + torch.sum(torch.square(g.to(torch.float32)))
        gnorm = torch.sqrt(sq)
        if cfg.clip_norm:
            scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        else:
            scale = 1.0
        countf = count.to(torch.float32)
        b1c = 1.0 - torch.pow(cfg.b1, countf)
        b2c = 1.0 - torch.pow(cfg.b2, countf)
        use_master = cfg.master_weights and "master" in state
        masters = state.get("master", params)

        def upd(p, g, m_enc, v_enc, master):
            g = g.to(torch.float32) * scale
            m = self._decode(m_enc, p.shape)
            v = self._decode(v_enc, p.shape)
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
            del g
            step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            p32 = master.to(torch.float32) if use_master else p.to(torch.float32)
            if cfg.weight_decay and p.dim() >= 2:  # decay matrices, not norms/bias
                step = step + cfg.weight_decay * p32
            new_master = p32 - lr * step
            new_p = new_master.to(p.dtype)
            return new_p, self._encode(m), self._encode(v), (new_master if use_master else None)

        out = tree_map(upd, params, grads, state["m"], state["v"], masters)
        new_state = {"m": tree_pick(out, 1), "v": tree_pick(out, 2), "count": count}
        if use_master:
            new_state["master"] = tree_pick(out, 3)
        return tree_pick(out, 0), new_state, {"grad_norm": gnorm}

    def state_bytes_per_param(self) -> float:
        return {"float32": 8.0, "bfloat16": 4.0, "int8": 2.0 + 8.0 / BLOCK}[
            self.cfg.state_dtype
        ]


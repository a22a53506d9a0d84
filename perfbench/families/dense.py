"""The dense family: each layer's mixer is grouped-query attention with
rotary positions, causal, windowed where the configuration gives a
window.

A family module holds all that the benchmark knows of one family's
layer, found by the configuration's ``family``: ``draw`` (its mixer's
weights in the port's layout), ``weight_macs`` and ``sequence_macs`` (its
mixer's work) and ``mixer`` (its plain float32 reference), and any of
the hooks that ``family.py`` lists.  This family defines none of them: it
takes the defaults (the SwiGLU FFN, the same layer at every depth, no
scales, the cache indexed by layer).
"""
from __future__ import annotations

import weights as W
from reference.model import attend, rms, rope


def draw(cfg: dict, gen, dt, device) -> dict:
    """The mixer's stacked weights (leading axis the layers)."""
    L, d, hd = cfg["num_layers"], cfg["d_model"], cfg["head_dim"]
    qd, kvd = cfg["num_heads"] * hd, cfg["num_kv_heads"] * hd
    return {"attn": {"ln": W.zeros(device, dt, L, d), "wq": W.dense(gen, L, d, qd, dt),
                     "wk": W.dense(gen, L, d, kvd, dt), "wv": W.dense(gen, L, d, kvd, dt),
                     "wo": W.dense(gen, L, qd, d, dt)}}


def weight_macs(cfg: dict) -> int:
    """Multiply-adds of the mixer's weight products for one token."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    qd, kvd = cfg["num_heads"] * hd, cfg["num_kv_heads"] * hd
    return d * (qd + 2 * kvd) + qd * d


def causal_pairs(S: int, window: int = 0) -> int:
    """Query-key pairs kept by a causal mask over S positions, with a
    window of ``window`` keys (the query's own included) when > 0."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def sequence_macs(cfg: dict, S: int) -> int:
    """Multiply-adds over one sequence of S positions in one layer that
    are not weight products: q.k and p.v over the kept pairs."""
    return 2 * cfg["head_dim"] * cfg["num_heads"] * causal_pairs(S, cfg.get("sliding_window", 0))


def attention(dec, a: dict, x):
    """Attention over the normed input ``x``: (output, {k (after rotary), v})."""
    cfg, mm = dec.cfg, dec.mm
    B, S, _ = x.shape
    hd = cfg["head_dim"]
    q = mm(x, a["wq"]).reshape(B, S, -1, hd)
    k = mm(x, a["wk"]).reshape(B, S, -1, hd)
    v = mm(x, a["wv"]).reshape(B, S, -1, hd)
    if cfg["rope_theta"] > 0:
        q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    o = attend(q, k, v, cfg.get("sliding_window", 0))
    return mm(o.reshape(B, S, -1), a["wo"]), {"k": k, "v": v}


def mixer(dec, lp: dict, h):
    """The reference mixer of one layer over the residual ``h``: (its
    output, added to ``h``; the layer's cache entries)."""
    return attention(dec, lp["attn"], rms(h, lp["attn"]["ln"], dec.eps))

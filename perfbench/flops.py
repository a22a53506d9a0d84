"""Work counts from shapes: the model FLOPs of a training step and of a
prefill, and the operations and bytes of one ``flash_attention`` call.

Model FLOPs count what the model's mathematics needs, once: 2 for each
multiply-add of every weight product of every token, attention over the
query-key pairs its mask keeps (a window of w at S > w averages fewer
than S/2 keys a query), the SSD mixer's chunked products over the pairs
its causal mask keeps, and the head on the positions whose logits are
computed (every position in training, the last one in a prefill), each
layer's as its family counts it (``layer_macs``: a routed FFN counts the
experts a token uses, not all of them).  A
training step is three forward passes' worth (the forward, and the
backward's two products for each); recomputation under remat is not
model work and is not counted.  Norms, activations, softmax and other
elementwise work are not counted.
"""
from __future__ import annotations

import family as F
from families.dense import causal_pairs


def flash_ops(B: int, S: int, H: int, hd: int, window: int) -> int:
    """Operations of one causal ``flash_attention`` call with Sq = Skv = S:
    q.k and p.v, a multiply and an add each, for every kept pair of every
    row and query head."""
    return 4 * hd * B * H * causal_pairs(S, window)


def flash_bytes(B: int, S: int, H: int, KVH: int, hd: int, itemsize: int) -> int:
    """Bytes one call needs to move: q, k and v read once, o written once."""
    return (2 * B * S * H * hd + 2 * B * S * KVH * hd) * itemsize


def dense_layer_macs(cfg: dict, li: int, S: int):
    """The default ``layer_macs``: the family's mixer and the SwiGLU FFN,
    alike in every layer."""
    fam = F.of(cfg)
    return (fam.weight_macs(cfg) + 3 * cfg["d_model"] * cfg["d_ff"],
            fam.sequence_macs(cfg, S))


def layer_macs(cfg: dict, li: int, S: int):
    """Layer ``li``'s multiply-adds: (its weight products for one token,
    the rest over one sequence of S positions)."""
    return F.hook(cfg, "layer_macs", dense_layer_macs)(cfg, li, S)


def layer_weight_macs(cfg: dict, li: int = 0) -> int:
    """Multiply-adds of layer ``li``'s weight products for one token."""
    return layer_macs(cfg, li, 1)[0]


def forward_flops(cfg: dict, B: int, S: int, head_positions: int) -> int:
    """Model FLOPs of one forward pass over B sequences of S tokens, with
    the head computed at ``head_positions`` positions of each."""
    macs = 0
    for li in range(cfg["num_layers"]):
        weight, sequence = layer_macs(cfg, li, S)
        macs += B * S * weight + B * sequence
    macs += B * head_positions * cfg["d_model"] * cfg["vocab_size"]
    return 2 * macs


def train_step_flops(cfg: dict, B: int, S: int) -> int:
    """Model FLOPs of one training step: the forward and backward passes
    over every position."""
    return 3 * forward_flops(cfg, B, S, S)


def prefill_flops(cfg: dict, B: int, S: int) -> int:
    """Model FLOPs of one prefill: logits at the last position only."""
    return forward_flops(cfg, B, S, 1)

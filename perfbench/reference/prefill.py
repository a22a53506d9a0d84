"""The reference prefill: the decoder over a batch of prompts, layer by
layer, handing each layer's cache entries to a callback as they are made
(so no layer's cache is held after it is judged)."""
from __future__ import annotations

import torch

from reference.model import Decoder, fp32_mm


@torch.no_grad()
def prefill(cfg: dict, params: dict, tokens: torch.Tensor, *, mm=fp32_mm,
            on_layer=None) -> torch.Tensor:
    """Last-position logits (B, V) float32 of ``tokens`` (B, S);
    ``on_layer(li, cache)`` sees each layer's cache entries."""
    dec = Decoder(cfg, params, mm)
    h = dec.embed(tokens)
    for li in range(cfg["num_layers"]):
        h, cache = dec.layer(dec.layer_params(li), h)
        if on_layer is not None:
            on_layer(li, cache)
        del cache
    return dec.head(h[:, -1])

"""The benchmark's weights: drawn on the device from the seed, in the
port's parameter layout (one stacked leaf a kind of weight, its leading
axis the layers), in the type they are served in.  One generator call a
leaf.  The program and the reference are both given these tensors.

The mixer's weights are the family's (``families/<family>.py``
``draw``); the FFN, the norms, the embedding and the head are every
family's.
"""
from __future__ import annotations

import importlib
import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def normal(gen, shape, scale, dtype):
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device).mul_(scale)


def dense(gen, L, n_in, n_out, dtype):
    return normal(gen, (L, n_in, n_out), 1.0 / math.sqrt(n_in), dtype)


def zeros(device, dtype, *shape):
    return torch.zeros(shape, dtype=dtype, device=device)


def draw(cfg: dict, seed: int, device) -> dict:
    """The parameters of configuration ``cfg`` (its JSON file's sizes),
    drawn from ``seed`` on ``device``."""
    dt = DTYPES[cfg["dtype"]]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    L, d, V = cfg["num_layers"], cfg["d_model"], cfg["vocab_size"]
    family = importlib.import_module(f"families.{cfg['family']}")
    blocks = family.draw(cfg, gen, dt, device)
    blocks["mlp_ln"] = zeros(device, dt, L, d)
    blocks["mlp"] = {"gate": dense(gen, L, d, cfg["d_ff"], dt),
                     "up": dense(gen, L, d, cfg["d_ff"], dt),
                     "down": dense(gen, L, cfg["d_ff"], d, dt)}
    params = {"embed": normal(gen, (V, d), 0.02, dt), "blocks": blocks,
              "final_norm": zeros(device, dt, d)}
    if not cfg.get("tie_embeddings", False):
        params["lm_head"] = dense(gen, 1, d, V, dt)[0]
    return params


def leaves(tree: dict, prefix: str = ""):
    """(path, tensor) of every leaf, in the tree's order."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaves(v, path)
        else:
            yield path, v

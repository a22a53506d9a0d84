"""Serving steps (twin of ``repro.train.step``).

``make_prefill`` and ``make_decode_step`` wrap the model's serving entry
points.  ``init_state`` and ``make_train_step`` wait for the training
slice (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.models.model import Model


def make_decode_step(model: Model) -> Callable:
    def serve_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos)

    return serve_step


def make_prefill(model: Model) -> Callable:
    def prefill(params, batch):
        return model.prefill(params, batch)

    return prefill

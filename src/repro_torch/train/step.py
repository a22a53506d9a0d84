"""train_step / serve_step builders (twin of ``repro.train.step``).

``train_step`` is a function (state, batch) -> (state, metrics) over a
plain dict state ``{"params", "opt", "step"[, "residuals"]}``, so the
checkpoint layer and the sharding-spec layer need no special casing; it
returns a new state and leaves the one it was given as it was.
Gradients are ``torch.autograd.grad`` over the parameter leaves, in the
leaves' types (bf16 leaves give bf16 grads, as ``jax.value_and_grad``
does).  ``decode_step``/``prefill`` wrap the model's serving entry
points.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.models.model import Model
from repro_torch.optim import AdamW, compress_grads, init_residuals
from repro_torch.tree import leaves_with_paths, set_by_path, tree_map


def init_state(model: Model, optimizer: AdamW, rng=0, *, compress: bool = False,
               device=None) -> dict:
    """Parameters from ``rng`` (a seed, or a ``torch.Generator``) on
    ``device`` (``"cuda"`` when not given), the optimizer state and the
    step counter beside them."""
    params = model.init(rng, device=device)
    dev = params["embed"].device
    state = {
        "params": params,
        "opt": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if compress:
        state["residuals"] = init_residuals(params)
    return state


def value_and_grad(model: Model, params: dict, batch: dict):
    """(loss, metrics, grads) of ``model.loss`` at ``params``: the grads
    a tree like ``params``, each in its leaf's type."""
    flat = list(leaves_with_paths(params))
    live = [t.detach().requires_grad_() for _, t in flat]
    p: Dict = {}
    for (path, _), t in zip(flat, live):
        set_by_path(p, path, t)
    with torch.enable_grad():
        loss, metrics = model.loss(p, batch)
        # a leaf the loss does not reach (a layer stack of extent 0) gets
        # zeros, as ``jax.grad`` gives it
        gs = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    grads: Dict = {}
    for (path, _), g in zip(flat, gs):
        set_by_path(grads, path, g)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(
    model: Model,
    optimizer: AdamW,
    schedule: Callable,
    *,
    compress: bool = False,
    grad_accum: int = 1,
    grad_shardings=None,
) -> Callable:
    """``grad_shardings``: optional ``NamedSharding`` tree (the ZeRO
    layout) the reference constrains every (micro)batch's gradients to.
    On one card that layout is the gradients as they are, so it is
    accepted and changes nothing."""

    def train_step(state: dict, batch: dict) -> Tuple[dict, Dict[str, torch.Tensor]]:
        if grad_accum > 1:
            # Microbatches over the leading batch dim, in order, each
            # one's grads in float32 added to the running sum; loss,
            # grads and the first microbatch's metrics divided at the
            # end, as the reference does.
            def micro(i, params):
                mb = {k: v.reshape(grad_accum, -1, *v.shape[1:])[i] for k, v in batch.items()}
                loss, mt, g = value_and_grad(model, params, mb)
                return (loss, mt), tree_map(lambda x: x.to(torch.float32), g)

            params = state["params"]
            (loss, metrics), grads = micro(0, params)
            for i in range(1, grad_accum):
                (l2, _), g2 = micro(i, params)
                loss = loss + l2
                grads = tree_map(torch.add, grads, g2)
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
            metrics = {k: v / grad_accum for k, v in metrics.items()}
        else:
            loss, metrics, grads = value_and_grad(model, state["params"], batch)

        new_state = dict(state)
        if compress:
            grads, new_state["residuals"] = compress_grads(grads, state["residuals"])
        lr = schedule(state["step"])
        new_params, new_opt, om = optimizer.update(grads, state["opt"], state["params"], lr)
        del grads
        new_state.update(params=new_params, opt=new_opt, step=state["step"] + 1)
        out_metrics = dict(metrics)
        out_metrics.update(loss=loss, lr=lr, **om)
        return new_state, out_metrics

    return train_step


def make_decode_step(model: Model) -> Callable:
    def serve_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos)

    return serve_step


def make_prefill(model: Model) -> Callable:
    def prefill(params, batch):
        return model.prefill(params, batch)

    return prefill

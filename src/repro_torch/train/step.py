"""train_step / serve_step builders (twin of ``repro.train.step``).

``train_step`` is a function (state, batch) -> (state, metrics) over a
plain dict state ``{"params", "opt", "step"[, "residuals"]}``, so the
checkpoint layer and the sharding-spec layer need no special casing; it
returns a new state and leaves the one it was given as it was, or, built
with ``donate=True``, writes the new state into the given one's tensors
(the reference's ``jax.jit(step, donate_argnums=(0,))``).
Gradients are ``torch.autograd.grad`` over the parameter leaves, in the
leaves' types (bf16 leaves give bf16 grads, as ``jax.value_and_grad``
does).  On a mesh over ranks the step is data-parallel
(``make_train_step``), and tensor-parallel too where the mesh's ``model``
axis spans ranks.  ``decode_step``/``prefill`` wrap the model's serving
entry points, over such a mesh when given one.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import trace
from repro_torch.distributed.ctx import data_context, mesh_context
from repro_torch.distributed.meshes import NamedSharding, P
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, compress_grads, init_residuals
from repro_torch.tree import leaves, leaves_with_paths, set_by_path, tree_map


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


def placed_params(model: Model, rng, shardings, *, device=None) -> dict:
    """``model.init(rng)``'s parameters as this process holds them under
    ``shardings`` (a ``NamedSharding`` tree like the parameters): each leaf
    placed as it is drawn, so a rank holds its share and never the whole
    model (a layer's leaf is placed under its stacked leaf's spec without
    the leading ``L`` entry)."""
    shard_of = dict(leaves_with_paths(shardings))

    def place(path, t):
        s = shard_of[path]
        if path.split("/")[0] in ("blocks", "enc_blocks"):
            s = NamedSharding(s.mesh, P(*s.spec[1:]))
        return s.place(t)

    return model.init(rng, device=device, place=place)


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
    opt_shardings=None,
    donate: bool = False,
) -> Callable:
    """``donate``: the step returns the state it was given, every leaf's
    new values written into that leaf's storage (parameters, master
    copies, moments or their int8 codes and scales, residuals, ``count``
    and ``step``) as the leaf's update lands, so a step holds one state
    and at most one leaf's temporaries beside the gradients.  The
    reference's callers donate the state to their jitted step
    (``Trainer``, the dry-run's train cell).  The default keeps the given
    state, for callers that reuse it: the same update runs on a copy, so
    the numbers are the donated step's bit for bit.

    ``grad_shardings``: optional ``NamedSharding`` tree the reference
    constrains every (micro)batch's gradients to (its ZeRO layout).  On a
    mesh over ranks (``distributed/meshes.py``) each rank computes the
    loss of its rows, and each (micro)batch's gradients are reduced over
    the ranks to that layout: reduce-scattered where a leaf's spec names
    ``data``, all-reduced where it does not (a leaf ZeRO leaves whole, or
    every leaf without ZeRO), and divided by the rank count.  A gradient is
    reduced in the type the step holds it in: a bf16 leaf's in bf16, as
    the one-process step computes it, and every microbatch's in float32
    under ``grad_accum``.  The loss and metrics are the ranks' mean
    (exact for the token-mean loss on equal shares of rows; MoE's
    balance loss is the whole (micro)batch's, its statistics averaged
    over the ranks under ``distributed.ctx.data_context``).  With
    ``compress`` the gradients are all-reduced, compressed whole and then
    split, as the reference compresses its reduced gradients.  ``opt_shardings`` (the optimizer
    state's tree) goes to ``AdamW.update``.  On a mesh of one process the
    layout is the gradients as they are, and nothing changes.

    Where the mesh's ``model`` axis spans ranks (tensor parallelism) each
    rank holds its share of every leaf the specs split over ``model``, the
    forward enters and leaves its model-parallel regions through
    ``distributed/ctx.py`` under ``mesh_context(mesh)``, and each gradient
    comes out model-local and complete: the gradients of the leaves the
    specs replicate but a region uses (``wk``/``wv`` with fewer KV heads
    than the axis, ``q_norm``/``k_norm``, a MoE layer's ``router`` and
    ``shared_gate``, an SSM mixer's ``wbc``/``conv_bc``/``conv_bbc``) are
    summed over the model group by the region's entry in the backward
    pass, and the SSM's gated norm sums its mean square's gradient over
    it (``distributed.ctx.model_sum``).  The reduction above then runs
    over the data group, and the loss and metrics are averaged over it.
    With ``compress`` each leaf is compressed in the whole leaf's blocks of
    256 along its last dimension, as the reference compresses it: a leaf
    split over ``model`` along a leading dimension on its rank, one split
    along its last dimension across the ranks' columns
    (``optim.compress``); its residual is the rank's share, under the
    parameters' specs.  Int8 moments keep the reference's layout too
    (``AdamW.update``)."""
    mesh = None if grad_shardings is None else leaves(grad_shardings)[0].mesh
    ranked = mesh is not None and mesh.group is not None
    tp = mesh if ranked and mesh.model_group is not None else None
    whole = (tree_map(lambda s: NamedSharding(s.mesh, P()), grad_shardings)
             if ranked and compress else grad_shardings)

    def reduce(grads):
        return tree_map(lambda s, g: s.reduce(g), whole, grads) if ranked else grads

    def train_step(state: dict, batch: dict) -> Tuple[dict, Dict[str, torch.Tensor]]:
        tokens = batch["tokens"]
        with trace.span("step.train", tokens, tokens=tokens.numel()):
            with _within(tp), data_context(mesh if ranked else None):
                return step(state, batch)

    def step(state: dict, batch: dict) -> Tuple[dict, Dict[str, torch.Tensor]]:
        if grad_accum > 1:
            # Microbatches over the leading batch dim, in order, each
            # one's grads in float32 (reduced over the ranks) added to the
            # running sum; loss, grads and the first microbatch's metrics
            # divided at the end, as the reference does.
            def micro(i, params):
                mb = {k: v.reshape(grad_accum, -1, *v.shape[1:])[i] for k, v in batch.items()}
                loss, mt, g = value_and_grad(model, params, mb)
                return (loss, mt), reduce(tree_map(lambda x: x.to(torch.float32), g))

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
            grads = reduce(grads)
        if ranked:
            names = sorted(metrics)
            means = mesh.mean(torch.stack([loss] + [metrics[k] for k in names]))
            loss, metrics = means[0], dict(zip(names, means[1:]))

        with torch.no_grad():
            if not donate:  # the update below writes into the state it is given
                state = tree_map(torch.clone, state)
            new_state = dict(state)
            if compress:
                grads, new_state["residuals"] = compress_grads(
                    grads, state["residuals"], grad_shardings if tp is not None else None)
                if ranked:
                    grads = tree_map(lambda s, g: s.data_part.place(g), grad_shardings, grads)
            lr = schedule(state["step"])
            shardings = (dict(grad_shardings=grad_shardings, opt_shardings=opt_shardings)
                         if ranked else {})
            with trace.span("optim.update", state["step"]) as sp:
                if sp:
                    sp.count(leaves=len(leaves(grads)),
                             state_bytes=sum(t.nbytes for t in leaves(state["opt"])))
                new_state["params"], new_state["opt"], om = optimizer.update(
                    grads, state["opt"], state["params"], lr, **shardings)
            del grads
            state["step"].add_(1)
        out_metrics = dict(metrics)
        out_metrics.update(loss=loss, lr=lr, **om)
        return new_state, out_metrics

    return train_step


def _within(mesh):
    """``mesh_context(mesh)``; nothing for None (an outer context stays)."""
    return contextlib.nullcontext() if mesh is None else mesh_context(mesh)


def make_decode_step(model: Model, mesh: Optional[object] = None) -> Callable:
    """One decode step.  ``mesh``: a mesh over ranks whose ``model`` axis
    spans them (tensor-parallel serving): the parameters are each rank's
    shares (``NamedSharding.place`` of ``param_specs``, or
    ``placed_params``), the cache holds the rank's KV heads and SSM heads
    (``Model.init_cache`` under the mesh, or the prefill's) and the logits
    come back whole on every rank."""

    def serve_step(params, cache, token, pos):
        with _within(mesh):
            return model.decode_step(params, cache, token, pos)

    return serve_step


def make_prefill(model: Model, mesh: Optional[object] = None) -> Callable:
    """The prefill; ``mesh`` as in :func:`make_decode_step` (the cache it
    returns holds the rank's KV and SSM heads)."""

    def prefill(params, batch):
        tokens = batch["tokens"]
        with trace.span("step.prefill", tokens, tokens=tokens.numel()), _within(mesh):
            return model.prefill(params, batch)

    return prefill

"""Activation-sharding context.

Twin of ``repro.distributed.ctx``.  Model code stays mesh-agnostic: it
calls ``constrain(x, tag)`` at the reference's points ("embed",
"residual", "attn_out").  Launchers install a rule table (tag ->
``NamedSharding``) around the step; with no rules installed the call
does nothing.  With rules it does nothing either: on a mesh of one
process the constrained layout and the unconstrained one are the same
tensor, and on a mesh over ranks each rank already holds its own rows of
the batch while the model axis lies within it (``distributed/meshes.py``),
so the tags are kept as the reference's.  The rules and the mesh are
thread-local, so co-scheduled jobs training in threads do not see each
other's.

Tensor parallelism across ranks (a mesh whose ``model`` axis spans
ranks, ``distributed/meshes.py``) makes GSPMD's collectives explicit with
two autograd functions tied to ``current_mesh()``'s model group, the
Megatron pair: :func:`enter_model` (identity forward, all-reduce of the
gradient backward) where a replicated tensor goes into a region computed
on the rank's share of a split leaf, and :func:`leave_model` (all-reduce
forward, identity backward) where the region's partial sums come out.
A statistic that a region reduces over a split dimension and reads
again inside it (the SSM's gated norm, over the whole ``d_inner``) goes
through :func:`model_sum`, an all-reduce both ways.  Without a model
group all three return their input, so the model code stays
mesh-agnostic, as the reference's does.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.meshes import all_reduce, gather_dim

_tls = threading.local()


# what the context managers below install in this thread
_KEYS = ("rules", "mesh", "data_mesh")


def snapshot() -> tuple:
    """The contexts installed in this thread (the sharding rules, the
    mesh, the data mesh), for :func:`installed` to put back in another:
    the backward pass of a card's tensors runs in autograd's own thread,
    and recomputes a checkpointed forward there (``models/model.py``,
    ``_remat``)."""
    return tuple(getattr(_tls, k, None) for k in _KEYS)


@contextlib.contextmanager
def installed(snap: tuple):
    """The contexts of :func:`snapshot` ``snap`` installed in this thread
    while entered."""
    old = snapshot()
    for k, v in zip(_KEYS, snap):
        setattr(_tls, k, v)
    try:
        yield
    finally:
        for k, v in zip(_KEYS, old):
            setattr(_tls, k, v)


def current_rules() -> Optional[Dict[str, object]]:
    """The rule table installed by the innermost ``sharding_rules``, or
    None outside one."""
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def sharding_rules(rules: Optional[Dict[str, object]]):
    """Install tag -> NamedSharding constraints for the enclosed step."""
    old = getattr(_tls, "rules", None)
    _tls.rules = rules
    try:
        yield
    finally:
        _tls.rules = old


def constrain(x: torch.Tensor, tag: str) -> torch.Tensor:
    """``x`` under the sharding its tag names: ``x`` itself (see the
    module docstring)."""
    return x


@contextlib.contextmanager
def mesh_context(mesh):
    """Install the active mesh for modules that need it (the
    expert-parallel MoE path)."""
    old = getattr(_tls, "mesh", None)
    _tls.mesh = mesh
    try:
        yield
    finally:
        _tls.mesh = old


def current_mesh():
    return getattr(_tls, "mesh", None)


def model_group():
    """The model group of ``current_mesh()`` (the ranks of this rank's
    row), or None without one."""
    mesh = current_mesh()
    return None if mesh is None else getattr(mesh, "model_group", None)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def enter_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` entering a model-parallel region: itself, its gradient
    summed over the model group (each rank's region gives a partial
    one)."""
    group = model_group()
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Enter.apply(x, group)


def leave_model(x: torch.Tensor) -> torch.Tensor:
    """``x``, a rank's partial sum out of a model-parallel region, summed
    over the model group (in ``x``'s type); its gradient passes as it is."""
    group = model_group()
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Leave.apply(x, group)
    return all_reduce(x, group)


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``, a rank's partial sum that the region reads again (each rank
    with its own share of the terms), summed over the model group; its
    gradient summed too, since each rank's comes only through the terms
    it reads the sum with.  ``leave_model`` would pass the forward and
    give each rank a partial gradient."""
    group = model_group()
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Sum.apply(x, group)
    return all_reduce(x, group)


@contextlib.contextmanager
def data_context(mesh):
    """Install the mesh whose data group splits the batch over ranks (the
    train step over ranks), for :func:`data_mean`; None installs none."""
    old = getattr(_tls, "data_mesh", None)
    _tls.data_mesh = mesh
    try:
        yield
    finally:
        _tls.data_mesh = old


class _DataMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.mean(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """``x``, a statistic of this rank's equal share of the batch,
    averaged over the data group of the mesh :func:`data_context`
    installed: the whole batch's, as one process computes it; ``x``
    itself without one.  Its gradient passes as it is: every rank's loss
    holds the same average, and the train step averages the ranks'
    gradients, so each rank's share is counted once."""
    mesh = getattr(_tls, "data_mesh", None)
    if mesh is None or mesh.data_group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _DataMean.apply(x, mesh)
    return mesh.mean(x)


def split_share(n_local: int, n_whole: int) -> bool:
    """Whether a leaf of ``n_local`` columns is this rank's share of
    ``n_whole`` (the specs split it): a model-parallel region, which
    needs the model group of ``current_mesh()``."""
    if n_local == n_whole:
        return False
    if model_group() is None:
        raise RuntimeError(
            f"a leaf of {n_local} of {n_whole} columns outside a mesh whose model axis "
            "spans ranks: run it under distributed.ctx.mesh_context")
    return True


def model_rank() -> int:
    """This rank's position along ``model`` in ``current_mesh()``'s model
    group; 0 without one."""
    return current_mesh().model_index if model_group() is not None else 0


def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the model group (no gradient);
    ``x`` itself without one."""
    group = model_group()
    if group is None:
        return x
    x = x.detach().contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def gather_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The model group's shares ``x`` joined along ``dim`` in rank order
    (all-gather, no gradient); ``x`` itself without a model group."""
    group = model_group()
    if group is None:
        return x
    return gather_dim(x, dim % x.dim(), group, current_mesh().n_model)

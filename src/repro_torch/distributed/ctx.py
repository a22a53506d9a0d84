"""Activation-sharding context.

Twin of ``repro.distributed.ctx``.  Model code stays mesh-agnostic: it
calls ``constrain(x, tag)`` at the reference's points ("embed",
"residual", "attn_out").  Launchers install a rule table (tag ->
``NamedSharding``) around the step; with no rules installed the call
does nothing.  With rules it does nothing either: every unit of a mesh
lies on one card, where the constrained layout and the unconstrained one
are the same tensor (``distributed/meshes.py``), so the tags are kept
for the day a mesh spans cards.  The rules and the mesh are thread-local,
so co-scheduled jobs training in threads do not see each other's.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch

_tls = threading.local()


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
    """``x`` under the sharding its tag names: ``x`` itself, on one card."""
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

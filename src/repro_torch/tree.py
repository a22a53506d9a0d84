"""Nested-dict trees of tensors: the port's counterpart of the few
``jax.tree_util`` calls the training slice makes.

A tree is a dict whose values are trees or leaves (tensors, numpy
arrays, specs).  Leaves are visited in JAX's order, dict keys sorted, and
a leaf's path is its keys joined by ``/``, as the reference's checkpoint
and sharding code spell it (``params/blocks/attn/wq``), so the two
packages name every leaf alike.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch


def is_tree(x) -> bool:
    return isinstance(x, dict)


def leaves_with_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` in JAX's flattening order (sorted dict keys)."""
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        v = tree[k]
        if is_tree(v):
            yield from leaves_with_paths(v, path)
        else:
            yield path, v


def leaves(tree) -> List[Any]:
    return [v for _, v in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *others)`` over ``tree``'s leaves.  ``rest`` trees are
    read up to ``tree``'s structure: where ``tree`` has a leaf, the
    others' subtree at that place (an int8 moment's ``{q, scale}``) is
    passed whole, as ``jax.tree_util.tree_map`` passes it."""
    if is_tree(tree):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_pick(tree, i: int):
    """Item ``i`` of every tuple leaf: one tree of a ``tree_map`` whose
    function returned tuples."""
    if is_tree(tree):
        return {k: tree_pick(v, i) for k, v in tree.items()}
    return tree[i]


def tree_map_with_path(fn: Callable, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves, the structure kept."""
    if is_tree(tree):
        return {k: tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def set_by_path(tree: Dict, path: str, value) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def eval_shape(fn: Callable):
    """The tree ``fn()`` returns, as ``meta`` tensors of the same shapes
    and types, without computing or allocating it (``jax.eval_shape``).
    ``fn`` runs under a fake-tensor mode, so it must build its tensors on
    the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        out = fn()
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), out)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's host copy as numpy; bfloat16, which numpy lacks, as its
    ``uint16`` bit pattern (the checkpoint format's encoding)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


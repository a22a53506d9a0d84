"""Carry state across from the reference package as plain data.

A scheduler has no weights; what both packages must share to be compared
is the ground-truth profile table the simulator reads, the Phase-I
estimates the decision scores and, for a fleet, the arrival stream.  A
model has weights: its parameter tree, and in training its whole train
state.  The reference's objects export to plain dicts and numpy arrays
(``dataclasses.asdict`` of a ``JobProfile``; per-mode columns of a
``JobSpec``; ``(name, app, t)`` rows of a stream; ``tree_map(np.asarray,
tree)`` of a parameter tree or a train state), and these functions turn
that data into this package's types, value for value.  Nothing here
imports the reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.arrivals import Arrival
from repro_torch.core.types import JobProfile, JobSpec, ModeEstimate
from repro_torch.device import resolve_device

_CURVES = ("runtime", "busy_power", "dram_util", "freq_time", "freq_power")


def _curve(d: Mapping) -> Dict[int, float]:
    return {int(k): float(v) for k, v in d.items()}


def profiles_from_arrays(table: Mapping[str, Mapping[str, Any]]) -> Dict[str, JobProfile]:
    """``{app: fields}`` -> ``{app: JobProfile}``.  ``fields`` holds the
    ``JobProfile`` fields: ``runtime``/``busy_power`` (and optionally
    ``dram_util``/``freq_time``/``freq_power``) as ``{int: float}``
    mappings, ``profiling_energy``/``profiling_time`` as floats.  The
    table's order is kept (schedules iterate over it)."""
    out: Dict[str, JobProfile] = {}
    for app, fields in table.items():
        kw = {c: _curve(fields.get(c, {})) for c in _CURVES}
        out[app] = JobProfile(
            name=str(fields.get("name", app)),
            profiling_energy=float(fields.get("profiling_energy", 0.0)),
            profiling_time=float(fields.get("profiling_time", 0.0)),
            **kw,
        )
    return out


def specs_from_arrays(table: Sequence[Mapping[str, Any]]) -> List[JobSpec]:
    """``[{"name", "g", "f", "t_norm", "p_bar", "e_norm"}, ...]`` ->
    ``[JobSpec, ...]``: one entry per job, each mode column a 1-D array
    in the job's mode order (integers for ``g``/``f``, float64 for the
    estimates, so the scores are the reference's to the last bit)."""
    out = []
    for row in table:
        g = np.asarray(row["g"], dtype=np.int64)
        f = np.asarray(row.get("f", np.zeros_like(g)), dtype=np.int64)
        cols = [np.asarray(row[c], dtype=np.float64)
                for c in ("t_norm", "p_bar", "e_norm")]
        if not all(len(c) == len(g) for c in cols) or len(f) != len(g):
            raise ValueError(f"{row['name']}: mode columns differ in length")
        modes = tuple(
            ModeEstimate(g=int(gi), t_norm=float(t), p_bar=float(p),
                         e_norm=float(e), f=int(fi))
            for gi, fi, t, p, e in zip(g, f, *cols)
        )
        out.append(JobSpec(name=str(row["name"]), modes=modes))
    return out


def arrivals_from_tuples(rows: Sequence[Sequence[Any]]) -> List[Arrival]:
    """``[(name, app, t), ...]`` -> ``[Arrival, ...]`` in the rows' order
    (``Cluster.simulate`` keeps same-instant arrivals in submission
    order, so the order is part of the stream)."""
    return [Arrival(t=float(t), name=str(name), app=str(app))
            for name, app, t in rows]


def params_from_numpy(tree: Mapping[str, Any], *, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A nested dict of numpy arrays (a reference parameter tree, or a
    cache) -> the same dict of torch tensors on ``device``, keys and
    shapes unchanged.  Each leaf keeps its type (bfloat16 leaves, which
    numpy holds as ``ml_dtypes.bfloat16`` and ``torch.from_numpy``
    refuses, go through float32, exactly) unless ``dtype`` is given, which
    every floating leaf is cast to.  A CUDA ``device`` without a card
    raises."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))  # a writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return {k: params_from_numpy(v, device=dev, dtype=dtype)
            if isinstance(v, Mapping) else leaf(v) for k, v in tree.items()}


_STATE_KEYS = ("params", "opt", "step")


def state_from_numpy(state: Mapping[str, Any], *, device="cuda") -> Dict[str, Any]:
    """A reference train state as numpy (``{"params", "opt": {"m", "v",
    "count"[, "master"]}, "step"[, "residuals"]}``, int8 moments as
    ``{"q", "scale"}`` dicts) -> the port's, on ``device``: every leaf
    keeps its type (bfloat16, float32, int8, int32) and shape, so
    ``train.step.make_train_step`` continues the reference's run."""
    missing = [k for k in _STATE_KEYS if k not in state]
    if missing or not {"m", "v", "count"} <= set(state["opt"]):
        raise ValueError(f"not a train state: missing {missing or 'opt/m, v or count'}")
    return params_from_numpy(state, device=device)

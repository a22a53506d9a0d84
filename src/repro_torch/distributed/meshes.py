"""Logical devices, meshes, sub-mesh carving and the pod topology.

Twin of ``repro.distributed.meshes``.  The reference carves
``jax.devices()`` into contiguous blocks, one per co-scheduled job, and
runs one SPMD program over each.  Here:

* a **unit** is an entry of :func:`units`, a :class:`LogicalDevice`
  naming a card (``cuda:i``) or, when the caller asks for it, the CPU.
  Without ``REPRO_HOST_DEVICES`` there is one unit per card;
  ``REPRO_HOST_DEVICES=N`` presents N units of one device, as it presents
  N host devices to the reference.  One H100 offers a non-root process
  neither MIG nor MPS, so units that share a card are logical devices of
  it.
* a :class:`Mesh` holds an ndarray of units, ``axis_names`` and ``shape``
  (a dict, as JAX's).  Its **rows** are its units along every axis but
  ``model``: one row per position of the data axes.

  - A mesh on one card, outside a job's ranks, merges its units: placing
    a leaf under a sharding puts it whole on that card, and a step runs
    the global batch there as one tensor -- the unsharded result of the
    reference's SPMD program over ``(data, model)``.
  - A mesh whose rows are **ranks** of a job (``distributed/procs.py``:
    one process per row) holds that job's process group.  Placing a leaf
    under a spec that names ``data`` gives this rank its share along that
    dimension; a spec without ``data`` stays whole (replicated).  The
    collectives the train step needs are methods of
    :class:`NamedSharding` and :class:`Mesh`.  Inside a worker, a mesh
    over the job's units is such a mesh; outside, a mesh whose rows lie
    on several cards describes the ranks a job will start
    (``train/loop.py``).
  - A ``model`` axis across cards (or ranks) is not implemented and
    raises.
* an :class:`AbstractMesh` holds shape and axis names only
  (``compat.abstract_mesh``'s counterpart; ``launch/mesh.py``'s
  production meshes).

Jobs on disjoint units of one card share its SMs and memory.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed import procs


@dataclass(frozen=True)
class LogicalDevice:
    """One allocation unit: logical device ``id`` on ``device``."""

    id: int
    device: torch.device

    def __repr__(self) -> str:
        return f"unit{self.id}@{self.device}"


def units(device="cuda", count: Optional[int] = None) -> List[LogicalDevice]:
    """The logical units of ``device``: ``count`` of them, else
    ``REPRO_HOST_DEVICES`` of them on the one device, else one per card
    (one for the CPU)."""
    dev = resolve_device(device)
    n = count or int(os.environ.get("REPRO_HOST_DEVICES", "0") or 0)
    if dev.type == "cuda" and dev.index is None:
        if not n:
            return [LogicalDevice(i, torch.device("cuda", i))
                    for i in range(torch.cuda.device_count())]
        dev = torch.device("cuda", torch.cuda.current_device())
    return [LogicalDevice(i, dev) for i in range(n or 1)]


class P(tuple):
    """A partition spec: one entry per dimension, an axis name, a tuple of
    axis names, or ``None`` (the counterpart of JAX's ``PartitionSpec``;
    ``tuple(P(...))`` equals ``tuple(PartitionSpec(...))`` entry for
    entry)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


class AbstractMesh:
    """Axis sizes and names, no devices."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in axis_sizes)))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


class Mesh(AbstractMesh):
    """An ndarray of units with named axes: logical units of one card, or
    one row of units per rank of a job (see the module docstring).

    ``device``: the card (or the CPU) this process computes on; None where
    this process holds no row of the mesh, or outside the ranks of a mesh
    over several cards.  ``ranks``: the job's rank of each row, None on a
    mesh of one process.  ``index``: this process's row, None outside.
    ``group``: the rows' process group where this process is one of them,
    else None."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {tuple(axis_names)}")
        super().__init__(devices.shape, axis_names)
        self.devices = devices
        self.rows: List[Tuple[LogicalDevice, ...]] = self._rows()
        self.ranks: Optional[Tuple[int, ...]] = None
        self.index: Optional[int] = None
        self.group = None
        self.device: Optional[torch.device] = None
        world = procs.current()
        rank_of = world.rank_of() if world is not None else {}
        if rank_of and all(u in rank_of for u in devices.flat):
            self._over_ranks(world, rank_of)
            return
        spanning = [sorted(map(str, c)) for c in ({u.device for u in row} for row in self.rows)
                    if len(c) > 1]
        if spanning:
            raise NotImplementedError(
                f"a model axis across cards ({spanning[0]}) is not implemented: each row of "
                "a mesh (its units along the model axis) lies on one card; the data axis "
                "may span cards, one rank per row")
        if not self.spans_cards:
            self.device = self.rows[0][0].device

    def _over_ranks(self, world, rank_of) -> None:
        ranks = []
        for row in self.rows:
            rs = {rank_of[u] for u in row}
            if len(rs) != 1:
                raise NotImplementedError(
                    f"a model axis across ranks {sorted(rs)} is not implemented: each row "
                    "of a mesh (its units along the model axis) lies on one rank")
            ranks.append(rs.pop())
        if ranks != sorted(set(ranks)):
            raise ValueError(f"the mesh's rows are ranks {ranks}: distinct and increasing")
        self.ranks = tuple(ranks)
        if world.rank in ranks:
            self.index = ranks.index(world.rank)
            self.group = world.group(ranks)
            self.device = world.device

    def _rows(self) -> List[Tuple[LogicalDevice, ...]]:
        if "model" not in self.axis_names:
            return [(u,) for u in self.devices.flat]
        arr = np.moveaxis(self.devices, self.axis_names.index("model"), -1)
        return [tuple(r) for r in arr.reshape(-1, arr.shape[-1])]

    @property
    def spans_cards(self) -> bool:
        """Whether the units lie on more than one card."""
        return len({u.device for u in self.devices.flat}) > 1

    @property
    def lead(self) -> bool:
        """Whether this process writes for the mesh: its first rank, or
        the one process of a mesh without ranks."""
        return self.group is None or self.index == 0

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks (all-reduce); ``t`` itself on a mesh
        of one process."""
        if self.group is None:
            return t
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` averaged over the ranks."""
        return t if self.group is None else self.sum(t) / len(self.ranks)

    def barrier(self) -> None:
        """Wait until every rank has come here: an all-reduce of one
        element on the ranks' own devices, the same for either backend."""
        if self.group is not None:
            self.sum(torch.zeros(1, device=self.device))


# the names torch.distributed gives these two in its newer releases
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh.  On a mesh of one process, placing a tensor puts
    it whole on the mesh's card; on a mesh over ranks, the dimension whose
    entry names the data axes (:attr:`dim`) is split over the ranks."""

    mesh: Mesh
    spec: P

    @property
    def dim(self) -> Optional[int]:
        """The dimension split over the mesh's ranks; None when the spec
        names no data axis or this process is not one of the ranks."""
        if self.mesh.group is None:
            return None
        rows = {a for a in self.mesh.axis_names if a != "model"}
        for i, s in enumerate(self.spec):
            named = set(s) if isinstance(s, tuple) else {s}
            if named & rows:
                if not rows <= named:
                    raise NotImplementedError(
                        f"{self.spec} splits dimension {i} over {sorted(named & rows)} of the "
                        f"rows' axes {sorted(rows)}: a spec splits over all of them or none")
                return i
        return None

    def _share(self, n_dim: int) -> int:
        n = len(self.mesh.ranks)
        if n_dim % n:
            raise ValueError(f"a dimension of {n_dim} does not split over {n} ranks")
        return n_dim // n

    def place(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (the whole leaf) as this process holds it: whole on its
        device, or this rank's share of dimension :attr:`dim` (a copy)."""
        d = self.dim
        if d is None:
            return t.to(self.mesh.device)
        k = self._share(t.shape[d])
        return t.narrow(d, self.mesh.index * k, k).to(
            self.mesh.device, copy=True, memory_format=torch.contiguous_format)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf from the ranks' shares (all-gather); ``t`` itself
        where it is not split."""
        d = self.dim
        if d is None:
            return t
        x = t.movedim(d, 0).contiguous()
        out = x.new_empty((len(self.mesh.ranks) * x.shape[0], *x.shape[1:]))
        _all_gather(out, x, group=self.mesh.group)
        return out.movedim(0, d).contiguous()

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' mean of their whole leaves ``t``, as this process
        holds it: this rank's share where the leaf is split
        (reduce-scatter), the whole mean where it is not (all-reduce);
        summed in ``t``'s type.  ``t`` itself on a mesh of one process."""
        if self.mesh.group is None:
            return t
        n = len(self.mesh.ranks)
        d = self.dim
        if d is None:
            return self.mesh.sum(t) / n
        x = t.movedim(d, 0).contiguous()
        out = x.new_empty((self._share(x.shape[0]), *x.shape[1:]))
        _reduce_scatter(out, x, group=self.mesh.group)
        return (out / n).movedim(0, d).contiguous()


def make_mesh(shape: Sequence[int], axes: Sequence[str], devices=None, *,
              device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``devices`` (default: the first units of
    ``device``)."""
    n = math.prod(shape)
    if devices is None:
        devices = units(device)
        if len(devices) < n:
            raise ValueError(f"mesh {tuple(shape)} needs {n} units, {device} has "
                             f"{len(devices)} (set REPRO_HOST_DEVICES)")
        devices = devices[:n]
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return Mesh(arr.reshape(tuple(shape)), tuple(axes))


def carve_submesh(
    devices: Sequence, start: int, count: int, *, model_axis: int = 0
) -> Mesh:
    """A (data, model) mesh over devices[start:start+count].

    ``model_axis``: requested model-parallel width (defaults to everything
    on one axis).  Used by the co-scheduled launcher: each job gets its own
    contiguous unit block.
    """
    block = list(devices[start : start + count])
    if len(block) != count:
        raise ValueError(f"units [{start}, {start + count}) of {len(devices)}")
    model = model_axis or count
    if count % model:
        raise ValueError(f"{count} units do not divide into model axis {model}")
    return make_mesh((count // model, model), ("data", "model"), devices=block)


# ---------------------------------------------------------------------------
# Pod topology: the scheduler-facing resource model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PodTopology:
    """A multi-accelerator node/pod as EcoSched sees it.

    ``units``            M allocation units (the paper's "GPUs")
    ``chips_per_unit``   chips behind one unit (1 for a GPU node)
    ``domains``          K isolation domains (paper: NUMA sockets); at most
                         K jobs co-run, and a job's units live in
                         contiguous positions
    """

    name: str = "tpu-v5e-pod"
    units: int = 4
    chips_per_unit: int = 64
    domains: int = 2

    @property
    def total_chips(self) -> int:
        return self.units * self.chips_per_unit

    def unit_slice(self, first_unit: int, num_units: int) -> Tuple[int, int]:
        """(device start index, device count) for a contiguous unit range."""
        return first_unit * self.chips_per_unit, num_units * self.chips_per_unit


GPU_NODE_4X = PodTopology(name="gpu-node-4x", units=4, chips_per_unit=1, domains=2)
V5E_POD_256 = PodTopology(name="v5e-pod-256", units=16, chips_per_unit=16, domains=4)

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
  - A mesh whose units are **ranks** of a job (``distributed/procs.py``:
    one process per unit) holds that job's process group.  Placing a
    leaf under a spec that names ``data`` gives this rank its share along
    that dimension; a spec without ``data`` stays whole (replicated).
    Where the ``model`` axis is longer than 1 it spans ranks: tensor
    parallelism, the Megatron layout of the reference's specs.  A spec's
    ``model`` dimension is split over the rank's model group (the ranks
    of its row), its data dimension over its data group (the ranks at its
    position along ``model``); the model code enters and leaves its
    parallel regions through ``distributed/ctx.py``.  The collectives the
    train step needs are methods of :class:`NamedSharding` and
    :class:`Mesh`.  Inside a worker, a mesh over the job's units is such
    a mesh; outside, a mesh whose units lie on several cards describes
    the ranks a job will start (``train/loop.py``: one process per unit).
* an :class:`AbstractMesh` holds shape and axis names only
  (``compat.abstract_mesh``'s counterpart; ``launch/mesh.py``'s
  production meshes).  :func:`rank_view` gives, in one process, the mesh
  one rank of it would hold, over a fake process group (the dry-run's
  count of one rank's collectives).

Jobs on disjoint units of one card share its SMs and memory.
"""
from __future__ import annotations

import contextlib
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
    the units of a job's ranks (see the module docstring).

    ``device``: the card (or the CPU) this process computes on; None where
    this process holds no unit of the mesh, or outside the ranks of a mesh
    over several cards.  ``ranks``: the job's rank of each unit of the
    mesh, in the order of its rows; None on a mesh of one process.
    ``index``: this process's place in ``ranks``, None outside.
    ``group``: the process group over ``ranks`` where this process is one
    of them, else None.

    Over ranks, each process also has two sub-groups: its **data group**
    (``data_group``: the ranks at its position along ``model``, one a row;
    ``data_index`` its row) and, where the ``model`` axis spans ranks, its
    **model group** (``model_group``: the ranks of its row; ``model_index``
    its position along ``model``).  Without tensor parallelism the data
    group is ``group``, ``model_group`` is None and ``model_index`` 0."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {tuple(axis_names)}")
        super().__init__(devices.shape, axis_names)
        self.devices = devices
        self.rows: List[Tuple[LogicalDevice, ...]] = self._rows()
        self.ranks: Optional[Tuple[int, ...]] = None
        self.index: Optional[int] = None
        self.group = self.data_group = self.model_group = None
        self.data_index: Optional[int] = None
        self.model_index: Optional[int] = None
        self.device: Optional[torch.device] = None
        world = procs.current()
        rank_of = world.rank_of() if world is not None else {}
        if rank_of and all(u in rank_of for u in devices.flat):
            self._over_ranks(world, rank_of)
        elif not self.spans_cards:
            self.device = self.rows[0][0].device

    def _over_ranks(self, world, rank_of) -> None:
        row_ranks = [[rank_of[u] for u in row] for row in self.rows]
        ranks = [r for rs in row_ranks for r in rs]
        if ranks != sorted(set(ranks)):
            raise ValueError(f"the mesh's ranks are {ranks}: distinct and increasing")
        self.ranks = tuple(ranks)
        m = len(row_ranks[0])
        # every rank of the mesh creates every sub-group, in this order; a
        # model group of one rank is none
        group = world.group(ranks)
        if m > 1:
            model = [world.group(rs) for rs in row_ranks]
            data = [world.group(col) for col in zip(*row_ranks)]
        if world.rank not in ranks:
            return
        self.index = ranks.index(world.rank)
        self.group = group
        self.device = world.device
        self.data_index, self.model_index = divmod(self.index, m)
        self.data_group = group
        if m > 1:
            self.model_group = model[self.data_index]
            self.data_group = data[self.model_index]

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

    @property
    def n_data(self) -> int:
        """The ranks of a data group: the mesh's rows."""
        return len(self.rows)

    @property
    def n_model(self) -> int:
        """The ranks of a model group: the ``model`` axis where it spans
        ranks, else 1."""
        return 1 if self.model_group is None else self.shape["model"]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over this rank's data group (all-reduce); ``t``
        itself on a mesh of one process."""
        return all_reduce(t, self.data_group, self.n_data)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` averaged over this rank's data group."""
        return t if self.data_group is None else self.sum(t) / self.n_data

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over this rank's model group; ``t`` itself without
        one."""
        return all_reduce(t, self.model_group, self.n_model)

    def barrier(self) -> None:
        """Wait until every rank of the mesh has come here: an all-reduce
        of one element on the ranks' own devices, the same for either
        backend."""
        if self.group is not None:
            all_reduce(torch.zeros(1, device=self.device), self.group, len(self.ranks))


# the names torch.distributed gives these two in its newer releases
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_reduce(t: torch.Tensor, group, n: Optional[int] = None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (a new tensor, in ``t``'s
    type); ``t`` itself without a group, or where ``n``, the group's rank
    count, is 1."""
    if group is None or n == 1:
        return t
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


def gather_dim(t: torch.Tensor, d: int, group, n: int, out=None) -> torch.Tensor:
    """The ``n`` ranks' shares ``t`` of ``group`` joined along dimension
    ``d`` in rank order (all-gather); written into ``out`` where given,
    straight from the collective where ``d`` is its leading dimension."""
    x = t.movedim(d, 0).contiguous()
    if out is not None and d == 0 and out.is_contiguous():
        _all_gather(out, x, group=group)
        return out
    whole = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _all_gather(whole, x, group=group)
    whole = whole.movedim(0, d).contiguous()
    return whole if out is None else out.copy_(whole)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh.  On a mesh of one process, placing a tensor puts
    it whole on the mesh's card; on a mesh over ranks, the dimension whose
    entry names the data axes (:attr:`dim`) is split over the data group
    and, where the ``model`` axis spans ranks, the one naming ``model``
    (:attr:`mdim`) over the model group."""

    mesh: Mesh
    spec: P

    def _named(self, i: int) -> set:
        s = self.spec[i]
        return set(s) if isinstance(s, tuple) else {s}

    @property
    def dim(self) -> Optional[int]:
        """The dimension split over the data group; None when the spec
        names no data axis or this process is not one of the ranks."""
        if self.mesh.group is None:
            return None
        rows = {a for a in self.mesh.axis_names if a != "model"}
        for i in range(len(self.spec)):
            named = self._named(i)
            if named & rows:
                if not rows <= named:
                    raise NotImplementedError(
                        f"{self.spec} splits dimension {i} over {sorted(named & rows)} of the "
                        f"rows' axes {sorted(rows)}: a spec splits over all of them or none")
                if "model" in named and self.mesh.model_group is not None:
                    raise NotImplementedError(
                        f"{self.spec} splits dimension {i} over both the data and the model "
                        "axes")
                return i
        return None

    @property
    def mdim(self) -> Optional[int]:
        """The dimension split over the model group; None when the spec
        names no ``model`` or the ``model`` axis lies within the rank."""
        if self.mesh.model_group is None:
            return None
        for i in range(len(self.spec)):
            if "model" in self._named(i):
                return i
        return None

    @property
    def data_part(self) -> "NamedSharding":
        """This sharding without its ``model`` split: how a model-local
        tensor (the rank's share along ``model``) is split over the data
        group."""
        spec = P(*(None if s == "model" else s for s in self.spec))
        return NamedSharding(self.mesh, spec)

    @staticmethod
    def _share(n_dim: int, n: int) -> int:
        if n_dim % n:
            raise ValueError(f"a dimension of {n_dim} does not split over {n} ranks")
        return n_dim // n

    def place(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (the whole leaf) as this process holds it: whole on its
        device, or this rank's share of dimensions :attr:`dim` and
        :attr:`mdim` (a copy)."""
        mesh = self.mesh
        if mesh.device is None:
            raise RuntimeError(f"this process holds no unit of the mesh {mesh.shape} over "
                               f"{sorted({str(u.device) for u in mesh.devices.flat})}")
        cuts = [(d, i, n) for d, i, n in ((self.dim, mesh.data_index, mesh.n_data),
                                          (self.mdim, mesh.model_index, mesh.n_model))
                if d is not None]
        if not cuts:
            return t.to(mesh.device)
        for d, i, n in cuts:
            k = self._share(t.shape[d], n)
            t = t.narrow(d, i * k, k)
        return t.to(mesh.device, copy=True, memory_format=torch.contiguous_format)

    def gather(self, t: torch.Tensor, out=None) -> torch.Tensor:
        """The whole leaf from the ranks' shares (all-gather over the data
        group, then the model group); ``t`` itself where it is not
        split.  Written into ``out`` where given."""
        mesh = self.mesh
        if self.dim is not None:
            t = gather_dim(t, self.dim, mesh.data_group, mesh.n_data,
                           out=out if self.mdim is None else None)
        if self.mdim is not None:
            t = gather_dim(t, self.mdim, mesh.model_group, mesh.n_model, out=out)
        return t if out is None or t is out else out.copy_(t)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The data group's mean of its ranks' model-local leaves ``t``
        (each rank's gradient of its share along ``model``), as this
        process holds it: this rank's share where the leaf is split over
        the data axes (reduce-scatter), the whole mean where it is not
        (all-reduce); summed in ``t``'s type.  ``t`` itself on a mesh of
        one process."""
        mesh = self.mesh
        if mesh.group is None:
            return t
        n = mesh.n_data
        d = self.dim
        if d is None:
            return mesh.sum(t) / n
        x = t.movedim(d, 0).contiguous()
        out = x.new_empty((self._share(x.shape[0], n), *x.shape[1:]))
        _reduce_scatter(out, x, group=mesh.data_group)
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


@contextlib.contextmanager
def rank_view(mesh: AbstractMesh, device, rank: int = 0):
    """The :class:`Mesh` that rank ``rank`` of a job over ``mesh``'s shape
    holds, built in this process over a fake process group of as many
    ranks (``procs.fake_world``): its group, data group and model group
    made as a worker makes them, its indices, and ``device`` (where the
    caller's fake tensors lie) as its device.  ``NamedSharding.place``
    then gives the rank's shares, and the collectives of its step are
    dispatched and move nothing.  The fake group lasts while entered."""
    n = math.prod(mesh.shape.values())
    us = [LogicalDevice(i, resolve_device(device)) for i in range(n)]
    with procs.fake_world(us, rank):
        yield make_mesh(tuple(mesh.shape.values()), mesh.axis_names, devices=us)


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

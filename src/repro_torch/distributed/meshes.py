"""Logical devices, meshes, sub-mesh carving and the pod topology.

Twin of ``repro.distributed.meshes``.  The reference carves
``jax.devices()`` into contiguous blocks, one per co-scheduled job.  One
H100 offers a non-root process neither MIG nor MPS, so here:

* a **unit** is a logical device: an entry of :func:`units`, which names
  the card (``cuda:0``) or, when the caller asks for it, the CPU.
  ``REPRO_HOST_DEVICES=N`` presents N units, as it presents N host
  devices to the reference; without it there is one unit per card.
* a :class:`Mesh` holds an ndarray of units, ``axis_names`` and ``shape``
  (a dict, as JAX's).  Every unit of a mesh lies on one card, so placing
  a leaf under a sharding puts it on that card, unsharded: what the
  reference's SPMD program computes over a ``(data, model)`` mesh is the
  unsharded result, and a step here runs the global batch as one tensor.
* an :class:`AbstractMesh` holds shape and axis names only
  (``compat.abstract_mesh``'s counterpart; ``launch/mesh.py``'s
  production meshes).

Jobs on disjoint units share the card's SMs and memory.  Running across
several cards (NCCL) is not implemented: a mesh whose units span cards
raises.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


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
    """An ndarray of logical units with named axes, all on one card."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {tuple(axis_names)}")
        super().__init__(devices.shape, axis_names)
        self.devices = devices
        cards = {u.device for u in devices.flat}
        if len(cards) != 1:
            raise NotImplementedError(
                f"a mesh over several cards ({sorted(map(str, cards))}) is not "
                "implemented: every unit of a mesh lies on one card")
        self.device: torch.device = cards.pop()


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh.  Placing a tensor puts it, unsharded, on the
    mesh's card."""

    mesh: Mesh
    spec: P

    def place(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.mesh.device)


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

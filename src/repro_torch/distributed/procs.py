"""One process per rank: start a job's ranks and hand back their results.

Port-only helper (beside ``device.py`` and ``tree.py``).  ``spawn`` starts
one worker per rank with ``torch.multiprocessing``'s ``spawn`` start
method (CUDA cannot fork).  Each worker sets its own device (``cuda:<its
card>``, or the CPU when the caller's units lie there), joins a process
group whose rendezvous is a ``FileStore`` in the job's directory (no TCP
port, so jobs and test workers running side by side cannot collide),
runs ``fn(*args)`` and hands its return value back.

The backend follows placement (:func:`backend_for`): NCCL when each rank
has a card of its own, gloo on the CPU.  Ranks that share a card need
gloo named by the caller, since NCCL refuses two ranks on one device.

A worker that raises fails the whole job: the others are stopped and
``spawn`` raises with that worker's traceback.  Every wait is bounded by
``timeout``: each collective (the process group's timeout) and the job as
a whole.

:func:`fake_world` makes this process one rank of a job over a fake
process group, where collectives are dispatched but move nothing: the
dry-run counts one rank's collectives that way.

Inside a worker, :func:`current` gives the :class:`World` it belongs to,
which ``distributed/meshes.py`` reads to build meshes over ranks.  A rank
holds one unit of a mesh: where the mesh's ``model`` axis is longer than
1 it spans ranks (tensor parallelism), and
:class:`~repro_torch.distributed.meshes.Mesh` gives each rank its model
group and its data group.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


@dataclass(frozen=True)
class World:
    """The job a worker process belongs to: its rank, the unit each rank
    holds (``units[r]``, on rank r's device) and the backend."""

    rank: int
    units: Tuple[Any, ...]
    backend: str

    @property
    def size(self) -> int:
        return len(self.units)

    @property
    def device(self) -> torch.device:
        return self.units[self.rank].device

    def rank_of(self) -> Dict[Any, int]:
        """Each unit's rank."""
        return {u: r for r, u in enumerate(self.units)}

    def group(self, ranks: Sequence[int]):
        """The process group over ``ranks`` (increasing): the job's own
        group when it is all of them, else a group that only its members
        take part in creating (None on the others).  A group is created
        once a process and then reused, so meshes built again over the
        same ranks (a sub-mesh, a rebuild after a failure) share it."""
        ranks = tuple(ranks)
        if ranks == tuple(range(self.size)):
            return dist.group.WORLD
        if ranks not in _GROUPS:
            _GROUPS[ranks] = dist.new_group(list(ranks), use_local_synchronization=True)
        return _GROUPS[ranks]


# seconds a rank that has reported may take to exit before it is stopped
_EXIT_GRACE_S = 10.0

# The world of this worker process; None outside one.  A worker runs one
# job, so this is process state, as torch.distributed's default group is.
_WORLD: Optional[World] = None
# the process groups this worker has created, by their ranks
_GROUPS: Dict[Tuple[int, ...], Any] = {}


def current() -> Optional[World]:
    """The :class:`World` of this worker process, or None outside one."""
    return _WORLD


@contextlib.contextmanager
def fake_world(units: Sequence[Any], rank: int = 0):
    """This process as rank ``rank`` of a job whose ranks hold ``units``,
    over a fake process group (``torch.testing``'s ``"fake"`` backend):
    meshes built over ``units`` are meshes over ranks, with their groups
    made by ``new_group`` as in a worker, and their collectives are
    dispatched (a ``TorchDispatchMode`` sees them) but move nothing.  For
    counting one rank's step on fake tensors (``launch/dryrun.py``).  The
    fake group is destroyed on the way out; raises where a process group
    is already initialised or this is a worker of a job."""
    global _WORLD
    if dist.is_initialized() or _WORLD is not None:
        raise RuntimeError("a process group is already initialised in this process: "
                           "a fake one would replace it")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=len(units))
    try:
        _WORLD = World(rank, tuple(units), "fake")
        yield _WORLD
    finally:
        _WORLD = None
        _GROUPS.clear()
        dist.destroy_process_group()


def backend_for(devices: Sequence[torch.device], backend: Optional[str] = None) -> str:
    """The backend for ranks on ``devices``: gloo on the CPU, NCCL when
    each rank has a card of its own.  ``backend`` names one explicitly;
    ranks that share a card need gloo, since NCCL refuses two ranks on
    one device."""
    cpu = all(d.type == "cpu" for d in devices)
    if not cpu and any(d.type != "cuda" for d in devices):
        raise ValueError(f"ranks on {sorted(map(str, devices))}: all on the CPU or all on cards")
    shared = len(set(devices)) < len(devices)
    if backend is None:
        if cpu:
            return "gloo"
        if shared:
            raise ValueError(
                f"ranks share a card ({[str(d) for d in devices]}): NCCL refuses two ranks "
                "on one device; name backend='gloo'")
        return "nccl"
    if backend == "nccl" and (cpu or shared):
        raise ValueError(f"NCCL needs one card per rank, got {[str(d) for d in devices]}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    return backend


def _worker(rank, units, backend, store_path, run_dir, timeout, threads, fn, args, reports):
    global _WORLD
    try:
        torch.set_num_threads(threads)
        dev = units[rank].device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, len(units)), rank=rank,
            world_size=len(units), timeout=datetime.timedelta(seconds=timeout))
        _WORLD = World(rank, units, backend)
        out = fn(*args)
        if out is not None:
            torch.save(out, os.path.join(run_dir, f"result{rank}.pt"))
    except BaseException:  # reported to the parent, which fails the job with it
        reports.put((rank, traceback.format_exc()))
    else:
        reports.put((rank, None))
    finally:
        _WORLD = None
        _GROUPS.clear()
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, args: tuple = (), *, units: Sequence[Any], jobdir: str,
          backend: Optional[str] = None, timeout: float = 1800.0) -> List[Any]:
    """Run ``fn(*args)`` in one process per entry of ``units`` (rank r
    holds the unit ``units[r]``, on its device) and return each rank's
    return value, by rank (None where it returned None).  ``fn`` and
    ``args`` are pickled, so ``fn`` is a module-level function.  The
    results are loaded onto the CPU.  Raises with the first failing
    rank's traceback, when a rank dies without a result, or after
    ``timeout`` seconds; the job's processes are stopped either way."""
    units = tuple(units)
    backend = backend_for([u.device for u in units], backend)
    world = len(units)
    os.makedirs(jobdir, exist_ok=True)
    run_dir = tempfile.mkdtemp(prefix=".ranks-", dir=jobdir)
    ctx = mp.get_context("spawn")
    reports = ctx.Queue()
    procs = [ctx.Process(
        target=_worker, name=f"rank{r}", daemon=True,
        args=(r, units, backend, os.path.join(run_dir, "store"), run_dir, timeout,
              torch.get_num_threads(), fn, args, reports)) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        done = set()

        def take(block: float) -> None:
            rank, err = reports.get(timeout=block)
            if err is not None:
                raise RuntimeError(f"rank {rank} of {world} ({backend}) failed:\n{err}")
            done.add(rank)

        while len(done) < world:
            try:
                take(min(1.0, max(deadline - time.monotonic(), 0.01)))
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs) if r not in done and p.exitcode is not None]
            if dead:
                try:  # its report may still be in flight
                    while len(done) < world:
                        take(1.0)
                except queue.Empty:
                    raise RuntimeError(
                        f"rank {dead[0]} of {world} exited with code "
                        f"{procs[dead[0]].exitcode} without a result") from None
            elif time.monotonic() > deadline:
                raise TimeoutError(f"the job's {world} ranks ({backend}) did not finish "
                                   f"in {timeout} s")
        for p in procs:  # each has written its result; what is left is teardown
            p.join(_EXIT_GRACE_S)
        out = []
        for r in range(world):
            path = os.path.join(run_dir, f"result{r}.pt")
            # written by this job's own workers
            out.append(torch.load(path, map_location="cpu", weights_only=False)
                       if os.path.exists(path) else None)
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(10.0)
                if p.is_alive():
                    p.kill()
                    p.join(10.0)
        reports.close()
        shutil.rmtree(run_dir, ignore_errors=True)

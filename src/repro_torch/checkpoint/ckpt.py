"""Checkpointing: atomic, restart-safe, mesh-elastic.

Twin of ``repro.checkpoint.ckpt``; the file format is the contract, so a
checkpoint written by either package restores in the other:

* ``arrays.npz``: one array per leaf, named by its path (``params/...``,
  ``opt/m/.../q``, ``opt/count``, ``step``; dict keys sorted, as JAX
  flattens them); bfloat16 leaves as their ``uint16`` bits, since npz
  has no bfloat16 (no ``ml_dtypes`` needed on either side of the copy);
* ``meta.json``: ``{"step", "metadata", "keys" (sorted), "dtype_map"}``,
  ``dtype_map`` naming the bfloat16 leaves.

Writes go to a temporary directory followed by ``os.replace`` (atomic on
POSIX), so a crash mid-save never corrupts the latest checkpoint.  A
restore reads host-side numpy and places each leaf where the restoring
job's sharding says (here: its mesh's card), so a job resumes on fewer or
more units after a failure or a rescale.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile
import threading
import time
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, set_by_path, to_numpy

_BF16 = "bfloat16"


def _host(leaf) -> Tuple[np.ndarray, bool]:
    """A leaf as host numpy, and whether it is bfloat16 bits."""
    if isinstance(leaf, torch.Tensor):
        return to_numpy(leaf), leaf.dtype == torch.bfloat16
    a = np.asarray(leaf)
    if a.dtype.name == _BF16:  # an ml_dtypes array handed over by a caller
        return a.view(np.uint16), True
    return a, False


def _host_tree(tree) -> Dict[str, Tuple[np.ndarray, bool]]:
    return {k: _host(v) for k, v in leaves_with_paths(tree)}


def save(path: str, tree, *, step: int = 0, metadata: Optional[dict] = None) -> None:
    """Atomic checkpoint write of a tree of tensors or numpy arrays."""
    _write(path, _host_tree(tree), step=step, metadata=metadata)


def _write(path: str, flat: Dict[str, Tuple[np.ndarray, bool]], *, step: int,
           metadata: Optional[dict]) -> None:
    arrays = {k: a for k, (a, _) in flat.items()}
    dtype_map = {k: _BF16 for k, (_, bf16) in flat.items() if bf16}
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        meta = {
            "step": int(step), "metadata": metadata or {}, "keys": sorted(arrays),
            "dtype_map": dtype_map,
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _read_meta(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def load_arrays(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """The stored arrays by path and the metadata.  bfloat16 leaves stay
    their ``uint16`` bits; ``meta["dtype_map"]`` names them."""
    meta = _read_meta(path)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, meta


class _NpzReader:
    """Reads the arrays of an ``.npz`` one at a time, each straight from
    its offset in the file with ``np.lib.format.read_array``
    (``np.fromfile`` underneath), not through ``zipfile``'s buffered
    reads.  Both packages write with ``np.savez``, which stores members
    uncompressed; a compressed member is rejected."""

    def __init__(self, path: str):
        with zipfile.ZipFile(path) as zf:
            infos = zf.infolist()
        self._f = open(path, "rb")
        self._at = {}
        try:
            for info in infos:
                if not info.filename.endswith(".npy"):
                    continue
                if info.compress_type != zipfile.ZIP_STORED:
                    raise ValueError(f"{path}: member {info.filename!r} is compressed; "
                                     "checkpoints store their arrays uncompressed")
                self._f.seek(info.header_offset)
                head = self._f.read(30)  # the local file header
                name_len, extra_len = struct.unpack("<HH", head[26:30])
                self._at[info.filename[:-4]] = info.header_offset + 30 + name_len + extra_len
        except BaseException:
            self._f.close()
            raise
        self.files = set(self._at)

    def __getitem__(self, key: str) -> np.ndarray:
        self._f.seek(self._at[key])
        return np.lib.format.read_array(self._f)

    def close(self) -> None:
        self._f.close()


def _leaf_tensor(arr: np.ndarray, bf16: bool) -> torch.Tensor:
    """The array read from the file as a tensor, without a copy."""
    if bf16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(path: str, like, *, shardings=None) -> Tuple[Any, dict]:
    """Restore into the structure of ``like`` (a template tree of tensors,
    ``meta`` ones included: only shapes and types are read).

    Without ``shardings`` each leaf takes the template's type and device
    (the CPU for a ``meta`` template).  ``shardings``: a tree of the same
    structure of ``NamedSharding`` (``distributed.sharding``), which
    places each leaf, in its stored type, on its mesh's card -- the
    elastic path.  Leaves are read and placed one at a time, so the host
    holds one leaf at once.
    """
    meta = _read_meta(path)
    bf16 = set(meta.get("dtype_map", {}))
    shard_of = dict(leaves_with_paths(shardings)) if shardings is not None else None
    out: Dict[str, Any] = {}
    z = _NpzReader(os.path.join(path, "arrays.npz"))
    try:
        stored = z.files
        for key, leaf in leaves_with_paths(like):
            if key not in stored:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = z[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs template "
                                 f"{tuple(leaf.shape)}")
            t = _leaf_tensor(arr, key in bf16)
            if shard_of is not None:
                t = shard_of[key].place(t)
            else:
                dev = leaf.device if leaf.device.type != "meta" else torch.device("cpu")
                t = t.to(device=dev, dtype=leaf.dtype)
            set_by_path(out, key, t)
    finally:
        z.close()
    return out, meta


class CheckpointManager:
    """Rotation + async save + latest-checkpoint discovery.

    ``last_save_s`` is the seconds the last completed write took (host
    snapshot excluded) and ``last_snapshot_s`` the seconds its host
    snapshot took."""

    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_save_s: Optional[float] = None
        self.last_snapshot_s: Optional[float] = None
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.isdir(os.path.join(self.directory, name)):
                if os.path.exists(os.path.join(self.directory, name, "meta.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, metadata: Optional[dict] = None):
        self.wait()
        # snapshot to host memory synchronously; write asynchronously
        t0 = time.perf_counter()
        host_tree = _host_tree(tree)
        self.last_snapshot_s = time.perf_counter() - t0

        def job():
            t1 = time.perf_counter()
            try:
                _write(self._step_dir(step), host_tree, step=step, metadata=metadata)
                self._gc()
            except BaseException as e:  # re-raised by wait() in the caller's thread
                self._error = e
                return
            self.last_save_s = time.perf_counter() - t1

        if self.async_save:
            self._thread = threading.Thread(target=job, daemon=True)
            self._thread.start()
        else:
            job()
            self.wait()

    def restore_latest(self, like, *, shardings=None):
        self.wait()
        step = self.latest_step()
        if step is None:
            return None, None
        return restore(self._step_dir(step), like, shardings=shardings)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

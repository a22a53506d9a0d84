"""Production mesh definition (twin of ``repro.launch.mesh``; functions
only -- importing this module touches no device)."""
from __future__ import annotations

from repro_torch.distributed.meshes import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16×16 single-pod (256 chips) or 2×16×16 multi-pod (512 chips) mesh,
    as an abstract mesh (shape and axis names): the sharding specs are
    functions of it alone.

    Axes: ``data`` = batch/DP (+ZeRO), ``model`` = TP/EP, ``pod`` = DP
    across pods.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)

"""What the benchmark takes from the program under test (the PyTorch and
CUDA port): its configuration registry, model, training step and prefill
entry points, the launch counter of its attention kernel, and for a job
over ranks its rank worker (``procs``), meshes and sharding specs.  Each
cell drives these; the harness calls them through this module, so a test
can put a broken entry point in their place."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import procs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.meshes import LogicalDevice, NamedSharding, make_mesh  # noqa: E402
from repro_torch.kernels import flash_attention as _flash  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig, Constant  # noqa: E402
from repro_torch.train.step import make_prefill, make_train_step  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

def model_config(cfg: dict):
    """The program's config of ``cfg`` (a configuration file): its
    registry entry with every key of the file that names a field of the
    program's config put in, so that the program and the reference run
    one model."""
    pc = get_config(cfg["registry"])
    fields = {f.name for f in dataclasses.fields(pc)}
    return pc.replace(**{k: v for k, v in cfg.items() if k in fields})


def flash_launches() -> int:
    return _flash.STATS["flash_attention"]


def rank_units(devices) -> list:
    """A job's units, one a rank: rank r holds ``devices[r]``."""
    return [LogicalDevice(i, d) for i, d in enumerate(devices)]


__all__ = ["AdamW", "AdamWConfig", "Constant", "NamedSharding", "Runtime", "build_model",
           "flash_launches", "make_mesh", "make_prefill", "make_train_step", "model_config",
           "procs", "rank_units", "sharding", "tree_map"]

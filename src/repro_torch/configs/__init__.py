"""Architecture registry: the 10 assigned archs × their shape cells.

``get_config(name)`` returns the exact published config; ``reduced`` makes
the CPU-smoke variant.  ``grid()`` yields every (arch × shape) cell with its
applicability verdict — the dry-run, roofline table and scheduler workload
pool all iterate this one grid.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

from repro_torch.configs.base import (
    SHAPE_CELLS,
    SHAPES,
    ModelConfig,
    ShapeCell,
    cell_applicable,
    reduced,
)

from repro_torch.configs.qwen3_32b import CONFIG as _qwen3
from repro_torch.configs.granite_8b import CONFIG as _granite
from repro_torch.configs.phi4_mini_3_8b import CONFIG as _phi4
from repro_torch.configs.gemma3_4b import CONFIG as _gemma3
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2moe
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2
from repro_torch.configs.phi3_vision_4_2b import CONFIG as _phi3v
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.whisper_base import CONFIG as _whisper

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _qwen3,
        _granite,
        _phi4,
        _gemma3,
        _arctic,
        _qwen2moe,
        _mamba2,
        _phi3v,
        _hymba,
        _whisper,
    )
}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}") from None


def list_archs() -> list:
    return sorted(ARCHS)


def grid() -> Iterator[Tuple[ModelConfig, ShapeCell, bool, str]]:
    """Yield (config, cell, applicable, reason) over all 40 cells."""
    for name in sorted(ARCHS):
        cfg = ARCHS[name]
        for cell in SHAPE_CELLS:
            ok, why = cell_applicable(cfg, cell)
            yield cfg, cell, ok, why


__all__ = [
    "ARCHS",
    "SHAPES",
    "SHAPE_CELLS",
    "ModelConfig",
    "ShapeCell",
    "cell_applicable",
    "get_config",
    "grid",
    "list_archs",
    "reduced",
]

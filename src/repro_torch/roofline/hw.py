"""Hardware constants for the power models of the calibrated systems.

The GPU entries calibrate the paper-reproduction workload (idle power
70 W/GPU is from the paper §V-C).  Twin of ``repro.roofline.hw`` without
its TPU row, which nothing in this package reads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ChipSpec:
    """Per-chip constants.  ``freq_ratios``/``power_floor`` parameterize the
    DVFS sweet-spot model (core/calibration.py): level ``f`` clocks the chip
    at ``freq_ratios[f]`` × base, dynamic power scales ~cubically with the
    ratio above a ``power_floor`` static fraction, and per-app slowdown is
    sub-linear in the clock drop (memory-bound work barely slows).  A
    single-entry ratio tuple means the chip exposes no DVFS levels."""

    name: str
    peak_flops_bf16: float  # FLOP/s
    hbm_bw: float  # bytes/s
    ici_bw: float  # bytes/s per link (all links combined per chip ~ 2-3x)
    hbm_bytes: float
    power_peak: float  # W, busy at full utilization
    power_idle: float  # W
    freq_ratios: Tuple[float, ...] = (1.0,)  # level f -> clock / base clock
    power_floor: float = 0.30  # static fraction of busy power (no f scaling)

    def freq_time_multiplier(self, f: int, mu: float) -> float:
        """Runtime multiplier at level ``f`` for a workload whose
        memory-bound fraction is ``mu``: compute time stretches as 1/ratio,
        the memory-bound fraction not at all — the classic sub-linear
        slowdown that creates below-base sweet spots."""
        r = self.freq_ratios[f]
        return mu + (1.0 - mu) / r

    def freq_power_multiplier(self, f: int) -> float:
        """Busy-power multiplier at level ``f``: static floor plus a
        cubic-ish dynamic term (P_dyn ∝ V²f with voltage tracking f)."""
        r = self.freq_ratios[f]
        return self.power_floor + (1.0 - self.power_floor) * r**3


# GPU specs for the paper-calibrated systems (F32/TF32 class numbers are not
# needed — the scheduler only uses power and relative-runtime curves).
# DVFS ratio ladders follow the published core-clock ranges (Afzal et al.:
# sweet spots sit well below max clocks on all three generations); level 0
# is always the base clock so count-only callers never see the ladder.
H100 = ChipSpec("h100", 989e12, 3350e9, 450e9, 80e9, 700.0, 70.0,
                freq_ratios=(1.0, 0.86, 0.72, 0.58), power_floor=0.32)
A100 = ChipSpec("a100", 312e12, 2039e9, 300e9, 80e9, 400.0, 55.0,
                freq_ratios=(1.0, 0.84, 0.70, 0.56), power_floor=0.30)
V100 = ChipSpec("v100", 125e12, 900e9, 150e9, 32e9, 300.0, 40.0,
                freq_ratios=(1.0, 0.82, 0.66), power_floor=0.28)

CHIPS = {c.name: c for c in (H100, A100, V100)}

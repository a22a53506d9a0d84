"""Paper-calibrated workload: 17 applications × {H100, A100, V100}.

The paper releases no raw runtimes ("link will be provided after
acceptance"), so the workload is reconstructed from every quantitative
anchor in the text (DESIGN.md §6):

  * Table II    — EcoSched's chosen GPU counts per app per system,
  * Fig. 2      — gpt2 3→2 ≈ 3–8% perf loss / ~24% energy saving;
                  pot3d 4→3; resnet50 4→3,
  * §V-B        — pot3d 4→2 (10%), resnet50 4→3 (5%), gpt2 3→2 (8%),
  * §V-C        — gpt2: 1287 W @3 GPUs vs 946 W @2 (⇒ P(g) = P0·g^0.757);
                  profiling energy gpt2 64 kJ, vgg16 34 kJ, ≤70 kJ each;
                  idle power 70 W/GPU; miniweather V100 4→1: 40% loss /
                  20% energy saving,
  * Fig. 1      — miniweather performance-optimal at 1 on H100, 4 on V100,
  * §V-A        — V100 is compute-bound: most apps scale to 4.

Runtime curves are expressed as speedup tuples (s1..s4), t(g) = t1/s_g;
busy power as P(g) = P0·g^β.  The DRAM-utilization profiling signal is
generated from the bandwidth identity util(g) ∝ 1/(t(g)·g) with a
per-app distortion so Phase I sees a realistic (imperfect) signal.
Free parameters (absolute t1 values) are fixed plausible magnitudes and
held constant across policies — all reported metrics are relative.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.types import JobProfile

BETA_DEFAULT = 0.757  # from gpt2 power anchor: 1287/946 = (3/2)^β

# Table I order — the single scheduling window queue.
APP_ORDER = (
    "conjugateGradient", "MonteCarlo", "simpleP2P", "streamOrderedAllocation",
    "lbm", "cloverleaf", "tealeaf", "minisweep", "pot3d", "miniweather",
    "resnet101", "resnet152", "resnet50", "vgg19", "vgg16", "bert", "gpt2",
)

# solo 1-GPU runtime (s) on H100; A100/V100 scale by system factor.
# Long-running magnitudes (§VI: "ML training workloads commonly run for
# hours") so one-time profiling energy amortizes as in §V-C.
T1_H100 = {
    "conjugateGradient": 1260, "MonteCarlo": 900, "simpleP2P": 720,
    "streamOrderedAllocation": 720, "lbm": 5400, "cloverleaf": 4500,
    "tealeaf": 4200, "minisweep": 2700, "pot3d": 6000, "miniweather": 3200,
    "resnet101": 9000, "resnet152": 10800, "resnet50": 7200,
    "vgg19": 7200, "vgg16": 6300, "bert": 8100, "gpt2": 9000,
}

# 1-GPU busy power (W) on H100
P0_H100 = {
    "conjugateGradient": 380, "MonteCarlo": 310, "simpleP2P": 300,
    "streamOrderedAllocation": 305, "lbm": 430, "cloverleaf": 420,
    "tealeaf": 410, "minisweep": 390, "pot3d": 440, "miniweather": 370,
    "resnet101": 470, "resnet152": 480, "resnet50": 460,
    "vgg19": 450, "vgg16": 440, "bert": 490, "gpt2": 559,
}

PROFILING_KJ = {  # §V-C anchors + bounded ≤70 kJ
    "gpt2": 64.0, "vgg16": 34.0, "bert": 58.0, "resnet152": 52.0,
    "resnet101": 47.0, "resnet50": 41.0, "vgg19": 38.0, "pot3d": 55.0,
    "lbm": 49.0, "cloverleaf": 45.0, "tealeaf": 43.0, "minisweep": 33.0,
    "miniweather": 30.0, "conjugateGradient": 26.0, "MonteCarlo": 22.0,
    "simpleP2P": 20.0, "streamOrderedAllocation": 20.0,
}

# speedup tuples (s1, s2, s3, s4); β overrides in POWER_BETA
STRONG = (1.0, 1.90, 2.70, 3.50)  # compute-bound strong scaler
SPEEDUPS: Dict[str, Dict[str, Tuple[float, float, float, float]]] = {
    "h100": {
        "conjugateGradient": (1.0, 1.80, 2.50, 3.35),
        "MonteCarlo": (1.0, 0.95, 0.92, 0.90),
        "simpleP2P": (1.0, 1.60, 1.58, 1.55),
        "streamOrderedAllocation": (1.0, 1.60, 1.59, 1.56),
        "lbm": STRONG,
        "cloverleaf": (1.0, 1.88, 2.65, 3.46),
        "tealeaf": (1.0, 1.85, 2.60, 3.42),
        "minisweep": (1.0, 1.87, 2.62, 3.42),
        "pot3d": (1.0, 1.750, 1.880, 1.925),  # §V-B: 4→2 = +10%
        "miniweather": (1.0, 0.90, 0.85, 0.80),  # Fig.1: optimal at 1
        "resnet101": (1.0, 1.90, 2.72, 2.66),
        "resnet152": (1.0, 1.90, 2.70, 2.64),
        "resnet50": (1.0, 1.90, 2.67, 2.80),  # §V-B: 4→3 = +5%
        "vgg19": (1.0, 1.17, 1.19, 1.21),
        "vgg16": (1.0, 1.18, 1.20, 1.22),
        "bert": (1.0, 1.88, 2.68, 3.52),
        "gpt2": (1.0, 1.850, 2.000, 1.950),  # opt at 3; 3→2 = +8% (§V-B)
    },
    "a100": {
        "conjugateGradient": (1.0, 1.75, 1.80, 1.85),
        "MonteCarlo": (1.0, 0.96, 0.93, 0.91),
        "simpleP2P": (1.0, 1.62, 1.60, 1.57),
        "streamOrderedAllocation": (1.0, 1.62, 1.61, 1.58),
        "lbm": STRONG,
        "cloverleaf": STRONG,
        "tealeaf": (1.0, 1.88, 2.66, 3.46),
        "minisweep": (1.0, 1.88, 2.64, 3.44),
        "pot3d": (1.0, 1.90, 2.70, 3.50),
        "miniweather": (1.0, 0.92, 0.88, 0.85),
        "resnet101": (1.0, 1.80, 1.92, 1.88),
        "resnet152": (1.0, 1.80, 1.93, 1.89),
        "resnet50": (1.0, 1.90, 2.68, 3.50),
        "vgg19": (1.0, 1.15, 1.20, 1.25),
        "vgg16": (1.0, 1.70, 1.75, 1.80),
        "bert": (1.0, 1.89, 2.68, 3.52),
        "gpt2": (1.0, 1.90, 2.70, 3.50),
    },
    "v100": {
        "conjugateGradient": (1.0, 1.90, 2.65, 3.50),
        "MonteCarlo": (1.0, 0.97, 0.94, 0.92),
        "simpleP2P": (1.0, 1.65, 1.63, 1.60),
        "streamOrderedAllocation": (1.0, 1.65, 1.64, 1.61),
        "lbm": (1.0, 1.92, 2.75, 3.55),
        "cloverleaf": (1.0, 1.92, 2.74, 3.53),
        "tealeaf": (1.0, 1.91, 2.72, 3.52),
        "minisweep": (1.0, 1.90, 2.70, 3.50),
        "pot3d": (1.0, 1.91, 2.73, 3.52),
        "miniweather": (1.0, 1.22, 1.32, 1.40),  # §V-C: 4→1 = +40%
        "resnet101": (1.0, 1.90, 2.72, 2.80),
        "resnet152": (1.0, 1.91, 2.70, 3.50),
        "resnet50": (1.0, 1.90, 2.71, 3.50),
        "vgg19": (1.0, 1.90, 2.68, 3.50),
        "vgg16": (1.0, 1.88, 2.70, 2.78),
        "bert": (1.0, 1.88, 2.72, 2.80),
        "gpt2": (1.0, 1.90, 2.69, 3.50),
    },
}

# Per-app power exponents.  β reflects per-GPU utilization at higher
# counts: strong scalers keep every GPU busy (β ≈ 0.757, the gpt2 anchor);
# flat scalers leave added GPUs underutilized, so total power grows slowly.
BETA_FLAT = 0.45
POWER_BETA: Dict[Tuple[str, str], float] = {
    ("v100", "miniweather"): 0.40,  # §V-C: 4→1 saves ~20% energy
    ("h100", "miniweather"): 0.45,
    ("a100", "miniweather"): 0.45,
    ("h100", "MonteCarlo"): BETA_FLAT,
    ("a100", "MonteCarlo"): BETA_FLAT,
    ("v100", "MonteCarlo"): BETA_FLAT,
    ("h100", "vgg16"): BETA_FLAT,
    ("h100", "vgg19"): BETA_FLAT,
    ("a100", "vgg19"): BETA_FLAT,
    ("h100", "simpleP2P"): 0.55,
    ("h100", "streamOrderedAllocation"): 0.55,
    ("a100", "simpleP2P"): 0.55,
    ("a100", "streamOrderedAllocation"): 0.55,
    ("v100", "simpleP2P"): 0.55,
    ("v100", "streamOrderedAllocation"): 0.55,
}

SYSTEM_SCALE = {  # runtime ×, power ×, idle W/GPU
    "h100": (1.0, 1.00, 70.0),
    "a100": (1.6, 0.60, 55.0),
    "v100": (2.8, 0.45, 40.0),
}

# per-app distortion of the DRAM-util signal (Phase I never sees a perfect
# inverse-runtime signal; compute-bound apps deviate most — Fig. 5 scatter)
_SIGNAL_DISTORTION = {
    "MonteCarlo": 0.03, "miniweather": 0.02, "conjugateGradient": 0.02,
    "bert": 0.02, "gpt2": 0.015, "lbm": 0.01, "pot3d": 0.01,
}

# Memory-bound fraction μ per application — the DVFS slowdown shape
# (Afzal et al.: memory-bound kernels barely slow when the core clock
# drops, so their energy sweet spot sits well below base clock; compute-
# bound kernels slow ~linearly and stay at base).  Bandwidth-dominated
# stencil/streaming codes sit high, dense-GEMM training moderate,
# latency/compute-bound kernels low.
MEMORY_BOUND_MU: Dict[str, float] = {
    "conjugateGradient": 0.55, "MonteCarlo": 0.10, "simpleP2P": 0.70,
    "streamOrderedAllocation": 0.72, "lbm": 0.75, "cloverleaf": 0.62,
    "tealeaf": 0.65, "minisweep": 0.35, "pot3d": 0.68, "miniweather": 0.58,
    "resnet101": 0.30, "resnet152": 0.28, "resnet50": 0.33,
    "vgg19": 0.26, "vgg16": 0.27, "bert": 0.22, "gpt2": 0.20,
}


def freq_curves(
    system: str, app: str, levels: int
) -> Tuple[Dict[int, float], Dict[int, float]]:
    """Analytic DVFS sweet-spot curves for one (chip, app) pair: per-level
    (runtime multiplier, power multiplier) dicts, level 0 = base clock.

    Runtime stretches only in the compute-bound fraction (sub-linear
    slowdown), power falls with the chip's cubic-ish dynamic curve above a
    static floor — so E(f) = T(f)·P(f) has an interior minimum for
    memory-bound apps.  ``levels`` is clamped to the chip's ratio ladder.
    """
    from repro_torch.roofline.hw import CHIPS

    chip = CHIPS[system.lower()]
    mu = MEMORY_BOUND_MU.get(app, 0.3)
    n = max(1, min(int(levels), len(chip.freq_ratios)))
    ft = {f: chip.freq_time_multiplier(f, mu) for f in range(n)}
    fp = {f: chip.freq_power_multiplier(f) for f in range(n)}
    return ft, fp


def build_system(system: str, freq_levels: int = 1) -> Dict[str, JobProfile]:
    """JobProfile table for one platform.  ``freq_levels=1`` (default)
    builds the count-only profiles — bit-identical to the pre-DVFS tables;
    ``freq_levels>1`` attaches the analytic sweet-spot frequency curves
    (clamped to the chip's ratio ladder)."""
    system = system.lower()
    t_scale, p_scale, _idle = SYSTEM_SCALE[system]
    out: Dict[str, JobProfile] = {}
    for app in APP_ORDER:
        s = SPEEDUPS[system][app]
        t1 = T1_H100[app] * t_scale
        runtime = {g: t1 / s[g - 1] for g in (1, 2, 3, 4)}
        beta = POWER_BETA.get((system, app), BETA_DEFAULT)
        p0 = P0_H100[app] * p_scale
        power = {g: p0 * g**beta for g in (1, 2, 3, 4)}
        # profiling signal with deterministic per-(app,g) distortion
        dis = _SIGNAL_DISTORTION.get(app, 0.0)
        seed = int.from_bytes(hashlib.md5(f"{system}|{app}".encode()).digest()[:4], "little")
        rng = np.random.default_rng(seed)
        util = {}
        for g in (1, 2, 3, 4):
            base = 1.0 / (runtime[g] * g)
            draw = float(np.clip(rng.standard_normal(), -1.5, 1.5))
            util[g] = base * (1.0 + dis * draw)
        ft: Dict[int, float] = {}
        fp: Dict[int, float] = {}
        if freq_levels > 1:
            ft, fp = freq_curves(system, app, freq_levels)
        out[app] = JobProfile(
            name=app,
            runtime=runtime,
            busy_power=power,
            dram_util=util,
            profiling_energy=PROFILING_KJ[app] * 1e3 * p_scale,
            profiling_time=60.0,
            freq_time=ft,
            freq_power=fp,
        )
    return out


def idle_power(system: str) -> float:
    return SYSTEM_SCALE[system.lower()][2]


def cross_numa_slowdown(job: str, g: int, co_running) -> float:
    """§V-C residual interference: a 3-unit job on a 2-domain node has one
    GPU in the remote domain (~5%); any co-running pair sees ~2% residual."""
    if g == 3 and co_running:
        return 1.05
    if co_running:
        return 1.02
    return 1.0


# Table II — the paper's reported EcoSched GPU-count choices (validation).
TABLE_II = {
    "bert": {"h100": 4, "a100": 4, "v100": 3},
    "cloverleaf": {"h100": 4, "a100": 4, "v100": 4},
    "conjugateGradient": {"h100": 4, "a100": 2, "v100": 4},
    "gpt2": {"h100": 2, "a100": 4, "v100": 4},
    "lbm": {"h100": 4, "a100": 4, "v100": 4},
    "minisweep": {"h100": 4, "a100": 4, "v100": 4},
    "miniweather": {"h100": 1, "a100": 1, "v100": 1},
    "MonteCarlo": {"h100": 1, "a100": 1, "v100": 1},
    "pot3d": {"h100": 2, "a100": 4, "v100": 4},
    "resnet101": {"h100": 3, "a100": 2, "v100": 3},
    "resnet152": {"h100": 3, "a100": 2, "v100": 4},
    "resnet50": {"h100": 3, "a100": 4, "v100": 4},
    "simpleP2P": {"h100": 2, "a100": 2, "v100": 2},
    "streamOrderedAllocation": {"h100": 2, "a100": 2, "v100": 2},
    "tealeaf": {"h100": 4, "a100": 4, "v100": 4},
    "vgg16": {"h100": 1, "a100": 2, "v100": 3},
    "vgg19": {"h100": 1, "a100": 1, "v100": 4},
}

# Headline results to validate against (paper §V-A).
PAPER_HEADLINE = {
    "h100": {
        "ecosched": {"energy": 0.148, "makespan": 0.301, "edp": 0.404},
        "marble": {"energy": 0.042, "makespan": 0.115},
        "oracle": {"energy": 0.179, "edp": 0.475},
    },
    "v100": {
        "ecosched": {"energy": 0.044, "makespan": 0.141, "edp": 0.179},
        "marble": {"energy": 0.016, "makespan": 0.070, "edp": 0.085},
        "oracle": {"energy": 0.045, "edp": 0.182},
    },
}

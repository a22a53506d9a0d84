"""Phase II scoring — Eq. (1)–(2) of the paper, verbatim.

    S(a)        = R_energy(a) + λ·I(a)
    R_energy(a) = (1/|a|) Σ_{m∈a} (Ê_m^norm − 1)      (0 for the empty action)
    I(a)        = (G_free − G(a)) / M
    a*          = argmin_{a ∈ A_feas} S(a)

``Ê^norm`` is each mode's energy proxy normalized to the job's best mode
(=1 at the predicted-lowest-energy count).  The τ-filter (paper §III-C)
drops modes whose predicted slowdown exceeds (1+τ)·best before scoring.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.types import JobSpec, ModeEstimate


def tau_filter(spec: JobSpec, tau: float) -> JobSpec:
    if not spec.modes:  # nothing to filter; callers must skip modeless jobs
        return spec
    best = min(m.t_norm for m in spec.modes)
    keep = tuple(m for m in spec.modes if m.t_norm <= (1.0 + tau) * best)
    return JobSpec(name=spec.name, modes=keep)


def r_energy(modes: Sequence[ModeEstimate]) -> float:
    if not modes:
        return 0.0
    return sum(m.e_norm - 1.0 for m in modes) / len(modes)


def idle_term(total_g: int, g_free: int, M: int) -> float:
    return (g_free - total_g) / M


def freq_term(modes: Sequence[ModeEstimate]) -> float:
    """Mean frequency level of the action (0 for the empty action and for
    every base-clock action) — the DVFS conservatism axis."""
    if not modes:
        return 0.0
    return sum(m.f for m in modes) / len(modes)


def score(
    modes: Sequence[ModeEstimate],
    *,
    g_free: int,
    M: int,
    lam: float,
    lam_f: float = 0.0,
) -> float:
    """Eq. (1) score, generalized to (count × frequency) actions.

    ``lam_f`` penalizes (positive) or rewards (negative) downclocked modes
    by the action's mean frequency level; at the default 0.0 the joint
    argmin is decided purely by the energy/idle terms and every score is
    bit-identical to the count-only scorer (modes all carry ``f = 0``
    there, so the term vanishes either way).
    """
    total_g = sum(m.g for m in modes)
    s = r_energy(modes) + lam * idle_term(total_g, g_free, M)
    if lam_f:
        s += lam_f * freq_term(modes)
    return s

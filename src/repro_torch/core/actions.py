"""Feasible-action enumeration (paper §III-C) — pure-Python reference.

An action is a set of ⟨job, unit-count, frequency-level⟩ modes
satisfying, under the *current* node state:
  * total units ≤ free units, placeable as contiguous ranges (checked by
    replaying the simulator's domain-spreading first-fit on a copy of the
    node's placement state — counts in descending order, exactly the order
    EcoSched hands launches to the simulator),
  * co-running cap: occupied domains + |a| ≤ K,
  * one mode per job; jobs from the scheduling window only.

For the paper's node (M=4, K=2) exhaustive enumeration is tiny.  For pod
scale (M=16, K=4, 17-job windows) the exact space can exceed 10^5, so
beyond ``exact_limit`` we fall back to beam construction: extend the
current beam of partial actions by every (job, mode), dedupe partials
that reach the same {job → (g, f)} set through different extension orders
(otherwise one good set occupies several beam slots and beam width buys
no diversity), keep the best ``beam`` by score, and collect every partial
generated — greedy-complete in the same spirit as the paper's greedy
local decision strategy.

This module is the *reference oracle*: ``repro_torch.core.engine`` reimplements
both paths with vectorized numpy batches and is parity-locked against it
(identical argmin action, scores within 1e-9) in tests/test_engine.py.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.placement import PlacementState
from repro_torch.core.score import score
from repro_torch.core.types import JobSpec, ModeEstimate, NodeView


def _placeable(
    free_map: List[bool],
    counts: Sequence[int],
    domains: int = 1,
    domain_jobs: Optional[Sequence[int]] = None,
) -> bool:
    """Replay the simulator's allocation for ``counts`` (descending) on a
    copy of the node's placement state."""
    st = PlacementState(len(free_map), domains)
    st.free = list(free_map)
    if domain_jobs:
        st.domain_jobs = list(domain_jobs)
    try:
        for g in sorted(counts, reverse=True):
            st.allocate(g)
    except ValueError:
        return False
    return True


def _space_estimate(per_job: Sequence[int], k_avail: int, exact_limit: int) -> int:
    """Size of the exact action space (capped just above ``exact_limit``)."""
    est = 1
    for size in range(1, min(k_avail, len(per_job)) + 1):
        for combo in itertools.combinations(per_job, size):
            est_c = 1
            for c in combo:
                est_c *= c
            est += est_c
            if est > exact_limit:
                return est
    return est


def enumerate_actions(
    specs: Sequence[JobSpec],
    view: NodeView,
    free_map: List[bool],
    *,
    lam: float,
    lam_f: float = 0.0,
    exact_limit: int = 50_000,
    beam: int = 64,
) -> List[Tuple[float, Tuple[Tuple[JobSpec, ModeEstimate], ...]]]:
    """Returns scored actions [(S(a), ((spec, mode), ...)), ...] incl. empty."""
    k_avail = view.domains - view.occupied_domains
    g_free = view.free_units
    M = view.alive_units  # degraded nodes score over their alive capacity
    domain_jobs = list(view.domain_jobs) or [0] * view.domains
    if k_avail <= 0 or not specs:
        return [(score((), g_free=g_free, M=M, lam=lam, lam_f=lam_f), ())]

    est = _space_estimate([len(s.modes) for s in specs], k_avail, exact_limit)

    def mode_list(a):
        return [m for _, m in a]

    results: List[Tuple[float, Tuple[Tuple[JobSpec, ModeEstimate], ...]]] = []

    def add(action):
        counts = [m.g for _, m in action]
        if sum(counts) > g_free:
            return False
        if action and not _placeable(free_map, counts, view.domains, domain_jobs):
            return False
        s = score(mode_list(action), g_free=g_free, M=M, lam=lam, lam_f=lam_f)
        results.append((s, tuple(action)))
        return True

    add(())

    if est <= exact_limit:
        for size in range(1, min(k_avail, len(specs)) + 1):
            for jobs in itertools.combinations(specs, size):
                for modes in itertools.product(*[j.modes for j in jobs]):
                    add(tuple(zip(jobs, modes)))
        return results

    # --- beam construction -------------------------------------------------
    frontier: List[Tuple[float, Tuple[Tuple[JobSpec, ModeEstimate], ...]]] = [
        (score((), g_free=g_free, M=M, lam=lam, lam_f=lam_f), ())
    ]
    for _ in range(k_avail):
        # dedupe by the {(job, g, f)} set: the same action reached through
        # different extension orders must occupy one beam slot, not many.
        # (g, f) is the joint mode identity; with a single frequency level
        # every f is 0 and the key collapses to the historical (job, g) set.
        seen = {}
        for _, partial in frontier:
            used = {sp.name for sp, _ in partial}
            used_g = sum(m.g for _, m in partial)
            base_key = frozenset((sp.name, m.g, m.f) for sp, m in partial)
            for sp in specs:
                if sp.name in used:
                    continue
                for m in sp.modes:
                    if used_g + m.g > g_free:
                        continue
                    key = base_key | {(sp.name, m.g, m.f)}
                    if key in seen:
                        continue
                    na = partial + ((sp, m),)
                    if not _placeable(
                        free_map, [mm.g for _, mm in na], view.domains, domain_jobs
                    ):
                        continue
                    seen[key] = (
                        score(
                            mode_list(na), g_free=g_free, M=M, lam=lam, lam_f=lam_f
                        ),
                        na,
                    )
        if not seen:
            break
        candidates = list(seen.values())
        candidates.sort(key=lambda kv: kv[0])  # stable: ties keep generation order
        frontier = candidates[:beam]
        results.extend(frontier)
    return results

"""Baseline policies (paper §IV).

* ``sequential_max_gpu``      — each job runs alone with all M units.
* ``sequential_optimal_gpu``  — each job runs alone at its
  performance-optimal count (known offline, as in the paper's setup).
* ``marble``                  — Marble-style co-scheduling [9]: offline
  profiles, every job pinned at its performance-optimal GPU count, FCFS
  first-fit packing under the same domain cap; no energy-aware
  downsizing, no τ-filter.  This reproduces the paper's characterization
  ("assumes performance-oriented GPU counts").

All baselines clamp mode choices to the node's unit count, so they run
unchanged on nodes whose sizes may not cover every profiled mode.

Baselines run on the same event-queue substrate as EcoSched
(``repro_torch.core.events``) but are deliberately **non-elastic**: they never
propose GPU resizing (``propose_resizes`` returns nothing), exactly as the
papers they reproduce commit a count at launch.  Cluster-level migration
still applies to them — it is a dispatcher capability, not a policy one.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from repro_torch.core.types import JobProfile, Launch, NodeView


class NonElasticPolicy:
    """Explicit opt-out of the substrate's resize hook: fixed-count
    policies keep their launch-time GPU counts for the job's lifetime."""

    def propose_resizes(self, view: NodeView, *, frac_of, cfg) -> List[Launch]:
        return []


class SequentialMax(NonElasticPolicy):
    def __init__(self, truth: Dict[str, JobProfile]):
        self.truth = truth

    def name(self) -> str:
        return "sequential_max_gpu"

    def on_event(self, view: NodeView, waiting: Sequence[str]) -> List[Launch]:
        if view.running or not waiting:
            return []
        job = waiting[0]
        fits = [g for g in self.truth[job].feasible_counts if g <= view.alive_units]
        if not fits:
            if view.dead_units:
                return []  # degraded node: wait for repair
            raise ValueError(f"{job}: no feasible mode fits {view.total_units} units")
        return [Launch(job=job, g=max(fits))]


class SequentialOptimal(NonElasticPolicy):
    def __init__(self, truth: Dict[str, JobProfile]):
        self.truth = truth

    def name(self) -> str:
        return "sequential_optimal_gpu"

    def on_event(self, view: NodeView, waiting: Sequence[str]) -> List[Launch]:
        if view.running or not waiting:
            return []
        job = waiting[0]
        if view.dead_units and not any(
            g <= view.alive_units for g in self.truth[job].feasible_counts
        ):
            return []  # degraded node: wait for repair
        return [Launch(job=job, g=self.truth[job].optimal_count(view.alive_units))]


class Marble(NonElasticPolicy):
    def __init__(self, truth: Dict[str, JobProfile]):
        self.truth = truth

    def name(self) -> str:
        return "marble"

    def on_event(self, view: NodeView, waiting: Sequence[str]) -> List[Launch]:
        out: List[Launch] = []
        free = view.free_units
        slots = view.free_domains
        # FCFS first-fit at performance-optimal counts; replay on the real
        # domain state so launches land exactly where the simulator's
        # domain-spreading allocator will place them
        from repro_torch.core.placement import PlacementState

        st = PlacementState(view.total_units, view.domains)
        st.free = list(view.free_map)
        if view.domain_jobs:
            st.domain_jobs = list(view.domain_jobs)
        for job in waiting:
            if slots - len(out) <= 0:
                break
            if not any(
                g <= view.alive_units for g in self.truth[job].feasible_counts
            ):
                continue  # no mode fits the (possibly degraded) capacity
            g = self.truth[job].optimal_count(view.alive_units)
            if g <= free and st.can_allocate(g):
                st.allocate(g)
                out.append(Launch(job=job, g=g))
                free -= g
        return out

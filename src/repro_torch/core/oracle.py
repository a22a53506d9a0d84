"""Offline Oracle: exact branch-and-bound energy minimization (paper §IV).

The paper builds the oracle with CP-SAT over discretized time; OR-Tools is
not available offline, so we solve the same offline problem — each job
picks one ⟨count, placement⟩ mode; minimize active + idle-GPU energy to
completion under capacity/domain/contiguity constraints, with perfect
runtime/power knowledge — by depth-first branch-and-bound over
*non-delay* event-driven schedules:

  state   = (waiting multiset, running set with end times, free map, t,
             accumulated busy/idle energy)
  branch  = every feasible launch-set at the event (incl. "wait" when
            something is running)
  bound   = busy-so-far + idle-so-far + Σ_waiting min-mode busy energy
            (admissible: remaining idle ≥ 0, busy ≥ per-job minimum)

Exact for the window sizes the paper evaluates on a 4-unit node; a time
budget makes it anytime for bigger instances (best incumbent returned,
``exact`` flag in the result notes whether the search completed).
Restricting to non-delay schedules is the one approximation vs. a full
time-indexed CP model; with idle power > 0 delaying is never beneficial
unless it enables a denser future packing, which the λ-style branching
below still explores through "wait" branches.

Twin of ``repro.core.oracle``.
"""
from __future__ import annotations

import heapq
import itertools
import math
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.placement import PlacementState
from repro_torch.core.types import JobProfile, JobRecord, Launch, NodeView, ScheduleResult


def cluster_oracle_bound(specs, truth_for, stream) -> Dict[str, float]:
    """Greedy perfect-knowledge lower bounds for one cluster run.

    The single-node branch-and-bound above cannot scale to trace-driven
    clusters, so the cluster bound relaxes instead of searching: every job
    greedily takes its best ⟨node type, count⟩ with zero waiting and the
    cluster is treated as one pooled capacity.

      * ``energy_lb``   — Σ_j min over feasible (node, g) of busy energy;
        idle energy ≥ 0, so this bounds total energy below.
      * ``makespan_lb`` — max over arrivals i of
        t_i + (Σ_{j: t_j ≥ t_i} min-work_j) / Σ_n units_n   (work submitted
        at or after t_i cannot start earlier and must fit the pooled
        capacity), and t_i + fastest-runtime_i (a job cannot beat its own
        best solo time on the best hardware).
      * ``edp_lb``      — their product (both factors are lower bounds).

    Valid for any dispatcher/per-node policy, elastic or not: preemption
    and migration only ever *add* work (checkpoint + restart overheads).

    ``specs``: ``NodeSpec``-like objects (``name``/``units``);
    ``truth_for(spec)``: app-keyed ``JobProfile`` table on that hardware;
    ``stream``: ``Arrival``s.
    """
    specs = list(specs)
    app_truth = {s.name: truth_for(s) for s in specs}
    total_units = float(sum(s.units for s in specs))
    best: Dict[str, Tuple[float, float, float]] = {}  # app -> (e, work, t)
    rows: List[Tuple[float, float, float, float]] = []
    for a in sorted(stream, key=lambda a: a.t):
        hit = best.get(a.app)
        if hit is None:
            e_b = w_b = t_b = math.inf
            for s in specs:
                prof = app_truth[s.name].get(a.app)
                if prof is None:
                    continue
                for g in prof.feasible_counts:
                    if g > s.units:
                        continue
                    e_b = min(e_b, prof.energy(g))
                    w_b = min(w_b, prof.runtime[g] * g)
                    t_b = min(t_b, prof.runtime[g])
            if not math.isfinite(e_b):
                raise ValueError(f"no node can fit any feasible mode of {a.app}")
            hit = best[a.app] = (e_b, w_b, t_b)
        rows.append((a.t, *hit))
    energy_lb = sum(e for _, e, _, _ in rows)
    makespan_lb = 0.0
    suffix_work = 0.0
    for t, _, work, t_solo in reversed(rows):
        suffix_work += work
        makespan_lb = max(
            makespan_lb, t + suffix_work / total_units, t + t_solo
        )
    return {
        "energy_lb": energy_lb,
        "makespan_lb": makespan_lb,
        "edp_lb": energy_lb * makespan_lb,
    }


class OracleSolver:
    """``engine`` and ``device`` choose the scoring engine of the
    EcoSched schedules that seed the incumbent (the port's ``EcoSched``
    defaults: the card); ``engine="vector"`` keeps the seeding on the
    host, as the reference's default engine does."""

    def __init__(
        self,
        node,
        truth: Dict[str, JobProfile],
        *,
        time_budget_s: float = 20.0,
        max_branch: int = 256,
        engine: str = "torch",
        device="cuda",
    ):
        self.node = node
        self.truth = truth
        self.time_budget_s = time_budget_s
        self.max_branch = max_branch
        self.engine = engine
        self.device = device

    # ------------------------------------------------------------------
    def solve(self, queue: Sequence[str]) -> Tuple[ScheduleResult, bool]:
        from repro_torch.core.ecosched import EcoSched
        from repro_torch.core.perfmodel import OraclePerfModel
        from repro_torch.core.simulator import simulate

        t_start = _time.perf_counter()
        truth = self.truth
        node = self.node
        min_busy = {j: min(truth[j].energy(g) for g in truth[j].runtime) for j in queue}

        best = {"total": float("inf"), "plan": None}
        # Seed the incumbent with a perfect-knowledge EcoSched schedule so
        # the anytime result is never worse than the best known policy.
        # A seed run that fails raises: it is a fault of the policy.
        for lam in (0.25, 0.5, 1.0):
            seed = simulate(
                EcoSched(OraclePerfModel(truth), lam=lam, tau=1.0,
                         engine=self.engine, device=self.device),
                node, truth, queue=list(queue),
            )
            total = seed.busy_energy + seed.idle_energy
            if total < best["total"]:
                best["total"] = total
                best["plan"] = tuple(
                    (r.job, r.g, r.start, r.end) for r in seed.records
                )
        deadline = t_start + self.time_budget_s
        exact = [True]

        def lb(waiting, busy, idle):
            return busy + idle + sum(min_busy[j] for j in waiting)

        def occupancy(running) -> List[int]:
            occ = [0] * node.domains
            for _, _, _, _, dom in running:
                occ[dom] += 1
            return occ

        def recurse(waiting: Tuple[str, ...],
                    running: Tuple[Tuple[float, str, int, Tuple[int, ...], int], ...],
                    free: Tuple[bool, ...], t: float, busy: float, idle: float,
                    plan: Tuple):
            if _time.perf_counter() > deadline:
                exact[0] = False
                return
            if not waiting and not running:
                total = busy + idle
                if total < best["total"]:
                    best["total"] = total
                    best["plan"] = plan
                return
            if lb(waiting, busy, idle) >= best["total"]:
                return

            # enumerate feasible launch sets at this event under the same
            # placement model the simulator enforces (domain-spreading
            # first-fit, co-run cap on *occupied* domains) — anything less
            # and the "oracle" would search a smaller space than the
            # online policies it is supposed to lower-bound
            occ = occupancy(running)
            free_count = sum(free)
            k_avail = node.domains - sum(1 for c in occ if c)
            choices: List[Tuple[Launch, ...]] = []
            if k_avail > 0 and waiting:
                jobs = list(dict.fromkeys(waiting))
                per_job_modes = {j: truth[j].feasible_counts for j in jobs}
                for size in range(1, min(k_avail, len(jobs)) + 1):
                    for combo in itertools.combinations(jobs, size):
                        for modes in itertools.product(*[per_job_modes[j] for j in combo]):
                            if sum(modes) > free_count:
                                continue
                            st2 = PlacementState(node.units, node.domains)
                            st2.free = list(free)
                            st2.domain_jobs = list(occ)
                            ok = True
                            try:
                                for g in modes:  # launch order, as applied
                                    st2.allocate(g)
                            except ValueError:
                                ok = False
                            if ok:
                                choices.append(
                                    tuple(Launch(job=j, g=g) for j, g in zip(combo, modes))
                                )
            if running:
                choices.append(())  # wait for a completion
            if not choices:
                return  # dead end (shouldn't happen: running or launchable)
            if len(choices) > self.max_branch:
                exact[0] = False
                # keep densest + most energy-efficient branches
                def key(ch):
                    if not ch:
                        return (1, 0.0)
                    e = sum(truth[l.job].energy(l.g) for l in ch)
                    return (0, e - 0.1 * sum(l.g for l in ch))
                choices = sorted(choices, key=key)[: self.max_branch]

            # order: denser, lower-energy first for good incumbents
            def order_key(ch):
                if not ch:
                    return (1, 0.0)
                return (0, sum(truth[l.job].energy(l.g) for l in ch)
                        - 1e-3 * sum(l.g for l in ch))

            for ch in sorted(choices, key=order_key):
                new_running = list(running)
                st3 = PlacementState(node.units, node.domains)
                st3.free = list(free)
                st3.domain_jobs = list(occ)
                nbusy = busy
                nplan = plan
                ok = True
                for l in ch:
                    try:
                        ids, dom = st3.allocate(l.g)
                    except ValueError:
                        ok = False
                        break
                    dur = truth[l.job].runtime[l.g]
                    nbusy += truth[l.job].energy(l.g)
                    new_running.append((t + dur, l.job, l.g, ids, dom))
                    nplan = nplan + ((l.job, l.g, t, t + dur),)
                if not ok or not new_running:
                    continue
                new_running.sort()
                end_t, jdone, gdone, ids_done, _ = new_running[0]
                free_now = st3.free_count()
                nidle = idle + free_now * (end_t - t) * node.idle_power_per_unit
                for u in ids_done:
                    st3.free[u] = True
                nwaiting = tuple(j for j in waiting if all(l.job != j for l in ch))
                recurse(
                    nwaiting,
                    tuple(new_running[1:]),
                    tuple(st3.free),
                    end_t,
                    nbusy,
                    nidle,
                    nplan,
                )

        recurse(tuple(queue), (), tuple([True] * node.units), 0.0, 0.0, 0.0, ())

        plan = best["plan"] or ()
        records = [
            JobRecord(job=j, g=g, start=s, end=e,
                      busy_energy=self.truth[j].energy(g))
            for (j, g, s, e) in plan
        ]
        makespan = max((e for (_, _, _, e) in plan), default=0.0)
        busy = sum(r.busy_energy for r in records)
        idle = best["total"] - busy if best["plan"] else 0.0
        result = ScheduleResult(
            policy="oracle",
            makespan=makespan,
            busy_energy=busy,
            idle_energy=idle,
            profiling_energy=0.0,
            records=records,
        )
        return result, exact[0]

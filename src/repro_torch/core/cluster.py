"""Cluster-scale trace-driven simulation (heterogeneous nodes, online jobs).

Generalizes the single ``Node`` of ``simulator.py`` to a ``Cluster`` of
heterogeneous nodes, each typed by a ``ChipSpec`` (H100/A100/V100 power and
relative-runtime scaling — the paper's three evaluation systems as *one*
datacenter).  A job stream (``repro_torch.core.arrivals``) flows through a
two-level policy:

  1. a cluster-level **dispatcher** routes each arriving job to a node,
  2. the node's own per-node policy (EcoSched or any baseline) decides
     when/at what GPU count to launch it — unchanged from the single-node
     reproduction.

Per-node accounting reuses ``NodeSim`` verbatim and the event loop itself
is the shared substrate (``repro_torch.core.events``) — the same
``EventLoop`` that drives single-node ``simulate()`` — so a 1-node cluster
reproduces ``simulate()``'s energy and makespan exactly.

Passing ``elastic=ElasticConfig(...)`` turns on the beyond-static
capabilities: per-node preemption/checkpoint-restart with EcoSched's
elastic GPU resizing, and cluster-level migration — after a completion
the drained node pulls a waiting (possibly checkpointed) job from the
most backlogged node whenever the predicted-wait gap beats the move cost.
A dispatcher can override the default greedy pull by implementing
``select_migration(nm, state, sims, now, cfg) -> (donor, job) | None``.

Passing ``forecast=ForecastConfig(...)`` additionally builds the
forecast-driven control plane (``repro_torch.core.forecast``): per-node
queueing-aware wait forecasts feed the ``PredictiveDispatcher`` and the
migration gap test, a hysteretic burst-risk gate charges elastic actions
an extra margin while arrivals are bursting, and each node policy's
Phase-I estimates refine online toward observed segment runtimes.  With
``forecast=None`` no plane exists and schedules are bit-identical to the
forecast-free substrate.

Routing is array-backed: ``ClusterState`` holds preallocated
numpy columns — per-node outstanding-work sums updated in place on
launch/complete, and per-(node, app) feasibility/best-mode tables built
once per run — so dispatchers route through ``route_indexed`` without
materializing a per-arrival status list.  ``route_indexed(ai, state,
now) -> node index`` is the *only* dispatch protocol: a dispatcher
without ``route_indexed`` is rejected at run construction with a
``TypeError``.  ``simulate(fast_status=False)`` keeps the per-arrival
Python scan as the *reference outstanding computation* — the same
``route_indexed`` dispatch over a state view whose drain proxy is
recomputed by scanning every node.

Fleet-batched staging: at each same-instant ARRIVAL or COMPLETE burst
that spans several nodes, ``ClusterRun`` collects every node's pending
Eq. (1) reduction into one cross-node kernel launch
(``repro_torch.kernels.score_reduce.score_reduce_batch`` for arrivals,
``score_reduce_multi`` for completions) when the node policies run
``EcoSched(engine="torch")``.  Twin of ``repro.core.cluster``: the same
inputs give the same schedules, bit for bit.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.arrivals import Arrival
from repro_torch.core.events import EVT_ARRIVAL, EVT_MIGRATE, ElasticConfig, EventLoop
from repro_torch.core.faults import FaultConfig, FaultInjector
from repro_torch.core.forecast import ForecastConfig, ForecastPlane
from repro_torch.core.simulator import Node, NodeSim, _auto_max_events
from repro_torch.core.types import ClusterResult, JobProfile, RunningJob
from repro_torch.kernels.score_reduce import (
    pack_windows,
    score_reduce_batch,
    score_reduce_multi,
)
from repro_torch.roofline.hw import ChipSpec


@dataclass(frozen=True)
class NodeSpec:
    """One schedulable node: allocation granularity + hardware type."""

    name: str
    chip: ChipSpec
    units: int = 4
    domains: int = 2

    @property
    def idle_power_per_unit(self) -> float:
        return self.chip.power_idle


class ClusterState:
    """Preallocated array view of the cluster for vectorized dispatch.

    Replaces a per-arrival list-of-dataclass status scan: the
    drain proxy becomes three per-node accumulators updated in place —

        outstanding·units = max(Σ end·g − now·Σ g, 0) + Σ waiting min-work

    (every running job's ``end`` is in the future, so the running term
    equals Σ (end − now)·g) — and per-(node, app) feasibility and
    best-mode tables are built **once per run** instead of being rebuilt
    from ``JobProfile`` dicts in the routing hot path.
    """

    def __init__(
        self,
        specs: Sequence[NodeSpec],
        app_truth: Dict[str, Dict[str, JobProfile]],
        apps: Sequence[str],
    ):
        self.names = [s.name for s in specs]
        self.index = {n: i for i, n in enumerate(self.names)}
        self.app_index = {a: i for i, a in enumerate(apps)}
        N, A = len(specs), len(apps)
        self.units = np.array([float(s.units) for s in specs])
        # deterministic tie-break domain: dispatchers
        # resolve score ties by *name rank*, not construction index, so a
        # shuffled spec list yields the identical schedule.  order[r] is
        # the node index at rank r; rank[i] inverts it.
        self.order = np.array(
            sorted(range(N), key=self.names.__getitem__), dtype=np.int64
        )
        self.rank = np.empty(N, dtype=np.int64)
        self.rank[self.order] = np.arange(N, dtype=np.int64)
        self.fits = np.zeros((N, A), dtype=bool)
        self.min_unit_s = np.zeros((N, A))  # cheapest busy unit-seconds
        self.e_best = np.ones((N, A))  # min-energy mode: energy (J)
        self.t_best = np.ones((N, A))  # min-energy mode: runtime (s)
        # fragmentation gauge (à la Lettich et al.): per-node
        # free units, per-app largest-fitting-mode lookup over every
        # possible free level, and the running Σ_i unusable_i(a) column —
        # all updated incrementally so frag_now() is O(A) per event
        self._cap = max((s.units for s in specs), default=1)
        self.free = np.array([s.units for s in specs], dtype=np.int64)
        self.usable = np.zeros((N, self._cap + 1, A), dtype=np.int64)
        self.unusable = np.zeros(A)
        self.wait_by_app = np.zeros(A, dtype=np.int64)
        self.free_total = int(self.free.sum())
        self._fleet: Optional["FleetIndex"] = None
        # kept for the fault plane's capacity refits (set_alive_units)
        self._specs = list(specs)
        self._app_truth = app_truth
        for i, s in enumerate(specs):
            self._fill_node(i, app_truth[s.name], s.units)
        self.unusable[:] = (
            self.free[:, None] - self.usable[np.arange(N), self.free]
        ).sum(axis=0) if N else 0.0
        # in-place accumulators (launch/complete update these, not scans);
        # the counts let drained accumulators snap back to exactly 0.0 —
        # equal empty nodes must compare *equal*, not within float drift,
        # or dispatcher name-rank tie-breaks would depend on churn history
        self.sum_end_g = np.zeros(N)  # Σ end·g over running jobs
        self.sum_g = np.zeros(N)  # Σ g over running jobs
        self.wait_units_s = np.zeros(N)  # Σ min-work over waiting jobs
        self.n_running = np.zeros(N, dtype=np.int64)
        self.n_waiting = np.zeros(N, dtype=np.int64)

    def _fill_node(self, i: int, truth: Dict[str, JobProfile], limit: int) -> None:
        """(Re)build node ``i``'s feasibility/best-mode row for a unit
        budget of ``limit`` (its physical size at construction; its alive
        capacity after a fault-plane refit)."""
        for a, j in self.app_index.items():
            self.fits[i, j] = False
            self.min_unit_s[i, j] = 0.0
            self.e_best[i, j] = 1.0
            self.t_best[i, j] = 1.0
            self.usable[i, :, j] = 0
            prof = truth.get(a)
            if prof is None:
                continue
            counts = [g for g in prof.feasible_counts if g <= limit]
            if not counts:
                continue
            self.fits[i, j] = True
            # largest feasible mode ≤ f, for every free level f — the
            # fragmentation gauge's "usable GPUs" lookup (free − usable
            # is what this app's pending jobs cannot occupy)
            carr = np.asarray(sorted(counts))
            idx = np.searchsorted(carr, np.arange(self._cap + 1), side="right")
            self.usable[i, :, j] = np.where(idx > 0, carr[idx - 1], 0)
            # best modes over the joint (count, frequency) set; a
            # single-level profile reduces every *_at(g, 0) to the
            # count-only curves, so these cells are bit-identical to
            # the pre-DVFS tables there
            levels = prof.freq_levels
            self.min_unit_s[i, j] = min(
                prof.runtime_at(g, f) * g for g in counts for f in levels
            )
            e, t = min(
                (prof.energy_at(g, f), prof.runtime_at(g, f))
                for g in counts
                for f in levels
            )
            self.e_best[i, j], self.t_best[i, j] = e, t

    def set_alive_units(self, ni: int, alive: int) -> None:
        """Refit node ``ni`` to a degraded (or repaired) capacity: the
        feasibility/best-mode tables shrink to modes that fit the alive
        units, so dispatchers stop routing work a failed node can no
        longer host.  ``alive == spec.units`` restores the physical
        tables bit-identically (same deterministic rebuild)."""
        spec = self._specs[ni]
        # the usable table is about to be rebuilt under the new budget:
        # retract this node's stale unusable contribution first, re-add
        # it after (sync_free then corrects the free level itself once
        # the caller reads the placement)
        f = int(self.free[ni])
        self.unusable -= f - self.usable[ni, f]
        self._fill_node(ni, self._app_truth[spec.name], alive)
        self.unusable += f - self.usable[ni, f]
        # drain-proxy divisor: a degraded node spreads its backlog over
        # fewer units (max(1) keeps a fully-dead node's arithmetic finite
        # — its all-False fits row already blocks routing there)
        self.units[ni] = float(max(alive, 1))
        if self._fleet is not None:
            self._fleet.touch_caps(ni)

    def attach_fleet(self, fleet: "FleetIndex") -> None:
        """Hook a pod summary index into the bookkeeping updates: every
        per-node mutation marks its pod dirty for a lazy re-aggregate."""
        self._fleet = fleet

    def sync_free(self, ni: int, free: int) -> None:
        """Move node ``ni``'s free-unit level to ``free``, updating the
        per-app Σ unusable column with one O(A) row delta.  Clamped to
        [0, cap]: the gauge is observational, and synthetic callers may
        push the accumulators past physical capacity."""
        f0 = int(self.free[ni])
        f1 = min(max(int(free), 0), self._cap)
        if f1 == f0:
            return
        self.unusable += (f1 - self.usable[ni, f1]) - (f0 - self.usable[ni, f0])
        self.free_total += f1 - f0
        self.free[ni] = f1

    def frag_now(self) -> float:
        """Unusable-GPU fraction given the pending mix (Lettich-style):
        over pending jobs, the mean fraction of the fleet's free GPUs no
        feasible mode of that job's app can occupy.  0.0 when nothing is
        pending or nothing is free; 1.0 when every free GPU is stranded."""
        wt = int(self.wait_by_app.sum())
        if wt == 0 or self.free_total <= 0:
            return 0.0
        return float(self.wait_by_app @ self.unusable) / (
            wt * self.free_total
        )

    def on_arrive(self, ni: int, ai: int) -> None:
        self.wait_units_s[ni] += self.min_unit_s[ni, ai]
        self.n_waiting[ni] += 1
        self.wait_by_app[ai] += 1
        if self._fleet is not None:
            self._fleet.touch(ni)

    def on_launch(self, ni: int, ai: int, end: float, g: int) -> None:
        self.wait_units_s[ni] -= self.min_unit_s[ni, ai]
        self.n_waiting[ni] -= 1
        if self.n_waiting[ni] == 0:
            self.wait_units_s[ni] = 0.0
        self.sum_end_g[ni] += end * g
        self.sum_g[ni] += g
        self.n_running[ni] += 1
        self.wait_by_app[ai] -= 1
        self.sync_free(ni, int(self.free[ni]) - g)
        if self._fleet is not None:
            self._fleet.touch(ni)

    def on_complete(self, ni: int, end: float, g: int) -> None:
        self.sum_end_g[ni] -= end * g
        self.sum_g[ni] -= g
        self.n_running[ni] -= 1
        if self.n_running[ni] == 0:
            self.sum_end_g[ni] = 0.0
            self.sum_g[ni] = 0.0
        self.sync_free(ni, int(self.free[ni]) + g)
        if self._fleet is not None:
            self._fleet.touch(ni)

    def on_retime(self, ni: int, old_end: float, new_end: float, g: int) -> None:
        """A preemption moved a running job's end (checkpoint supersedes the
        original completion); keep Σ end·g consistent with the new end."""
        self.sum_end_g[ni] += (new_end - old_end) * g
        if self._fleet is not None:
            self._fleet.touch(ni)

    def on_migrate_out(self, ni: int, ai: int) -> None:
        """A waiting job left this node's queue (migration); inverse of
        ``on_arrive``."""
        self.wait_units_s[ni] -= self.min_unit_s[ni, ai]
        self.n_waiting[ni] -= 1
        if self.n_waiting[ni] == 0:
            self.wait_units_s[ni] = 0.0
        self.wait_by_app[ai] -= 1
        if self._fleet is not None:
            self._fleet.touch(ni)

    def outstanding(self, now: float) -> np.ndarray:
        """Per-node committed busy unit-seconds / units (drain proxy)."""
        running = np.maximum(self.sum_end_g - now * self.sum_g, 0.0)
        return (running + self.wait_units_s) / self.units


# ---------------------------------------------------------------------------
# Dispatchers (cluster level — defer launch decisions to the node policy).
# ``route_indexed(ai, state, now) -> node index`` is the single dispatch
# protocol (returns -1 when no node fits).
#
# Score ties break by *name rank*, never construction index: two Cluster()
# calls over the same specs in different list orders produce the identical
# schedule.
# ---------------------------------------------------------------------------


def _node_order(state) -> np.ndarray:
    """Name-rank node ordering; identity for bare states without one."""
    order = getattr(state, "order", None)
    if order is None:
        order = np.arange(len(state.names))
    return order


def _rank_argmin(values: np.ndarray, state) -> int:
    """Argmin over per-node values with ties broken by name rank."""
    order = _node_order(state)
    return int(order[int(np.argmin(values[order]))])


class RoundRobinDispatcher:
    """FIFO routing: cycle over nodes in name order, skipping infeasible
    ones.  The pointer indexes *ranks*, so the cycle is independent of
    spec construction order."""

    def __init__(self):
        self._i = 0

    def name(self) -> str:
        return "rr"

    def reset(self) -> None:
        self._i = 0

    def route_indexed(self, ai: int, state: ClusterState, now: float) -> int:
        n = len(state.names)
        order = _node_order(state)
        seq = order[(self._i + np.arange(n)) % n]
        hits = np.flatnonzero(state.fits[seq, ai])
        if hits.size == 0:
            return -1
        k = int(hits[0])
        self._i = (self._i + k + 1) % n
        return int(seq[k])


class LeastLoadedDispatcher:
    """Route to the feasible node with the shallowest committed backlog."""

    def name(self) -> str:
        return "least-loaded"

    def route_indexed(self, ai: int, state: ClusterState, now: float) -> int:
        load = np.where(state.fits[:, ai], state.outstanding(now), np.inf)
        i = _rank_argmin(load, state)  # ties -> lowest name rank
        return i if state.fits[i, ai] else -1


class EnergyAwareDispatcher:
    """Route to the node minimizing congestion-inflated best-mode energy.

    For each feasible node, take the job's minimum-energy mode on that
    hardware (E*, t*) and score E* · (drain + t*) / t*: on an empty node
    this is the pure energy-optimal hardware choice; as a node's backlog
    grows its score inflates by the queueing slowdown, spilling work onto
    faster (or merely idler) hardware — the EDP tradeoff at cluster level.

    With a forecast plane attached (``forecast=...`` runs) the (E*, t*)
    cells come from ``plane.dispatch_tables()`` — the static priors with
    observed cells re-derived from each node's refined posterior — so
    dispatch and per-node placement score the *same* model.  Unattached,
    scoring reads ``ClusterState`` directly and is bit-identical to the
    pre-plane dispatcher.
    """

    def __init__(self):
        self._plane: Optional[ForecastPlane] = None

    def name(self) -> str:
        return "eco"

    def reset(self) -> None:
        self._plane = None  # re-attached per run by Cluster.simulate

    def attach_forecast(self, plane: ForecastPlane) -> None:
        self._plane = plane

    def _tables(self, state: ClusterState) -> Tuple[np.ndarray, np.ndarray]:
        if self._plane is None:
            return state.e_best, state.t_best
        return self._plane.dispatch_tables()

    def route_indexed(self, ai: int, state: ClusterState, now: float) -> int:
        out = state.outstanding(now)
        e_best, t_best = self._tables(state)
        t = t_best[:, ai]
        score = np.where(
            state.fits[:, ai], e_best[:, ai] * (out + t) / t, np.inf
        )
        i = _rank_argmin(score, state)  # ties -> lowest name rank
        return i if state.fits[i, ai] else -1


class PredictiveDispatcher(EnergyAwareDispatcher):
    """Queueing-aware routing: the EnergyAware score with the
    drain proxy replaced by the forecast plane's *predicted* wait —
    E* · (W_forecast + t*) / t* — where W_forecast inflates committed work
    by the M/G/c heavy-traffic factor from the arrival-rate EWMA.  A node
    that looks shallow right now but sits in a busy routing share gets
    charged the work that will land on it while it drains.

    ``Cluster.simulate`` attaches the plane when ``forecast`` is enabled;
    without one (or with ``queueing`` off, which makes the forecast
    degenerate to the proxy) routing is identical to
    ``EnergyAwareDispatcher``.
    """

    def name(self) -> str:
        return "predictive"

    def route_indexed(self, ai: int, state: ClusterState, now: float) -> int:
        if self._plane is None:
            return super().route_indexed(ai, state, now)
        wait = self._plane.wait_forecast(now)
        e_best, t_best = self._tables(state)
        t = t_best[:, ai]
        score = np.where(
            state.fits[:, ai], e_best[:, ai] * (wait + t) / t, np.inf
        )
        i = _rank_argmin(score, state)  # ties -> lowest name rank
        return i if state.fits[i, ai] else -1


# ---------------------------------------------------------------------------
# Fleet hierarchy: region → pod → node routing at 100–1000+ nodes
# ---------------------------------------------------------------------------


class FleetIndex:
    """Pod-level summary table over ``ClusterState`` (lazy, dirty-tracked).

    Nodes are ordered by name rank and cut into contiguous pods of
    ``pod_size``; pods group into regions of ``pods_per_region``.  Each
    pod keeps the aggregates a router needs to *lower-bound* every
    member's score without touching it:

      - load-skew drain pieces: the exact per-member
        ``outstanding`` minimum at the refresh instant, the fastest
        member drain rate (max Σg/units) and the waiting-work floor
        (min wait/units) — combined into a per-pod lower bound on
        ``outstanding(now)`` that is *tight* right after a refresh and
        decays admissibly between refreshes (a member's backlog can
        shrink no faster than its committed drain rate, and never below
        its waiting work);
      - per-app feasibility (any member fits);
      - per-app min best-mode energy E* and min E*/t* over fitting
        members, giving  score_i = E*_i + (E*_i/t*_i)·out_i
                                 ≥ Emin + EoTmin · out_lb.

    ``ClusterState`` hooks mark the index dirty; ``refresh``
    re-aggregates with a handful of vectorized ``reduceat`` passes over
    the rank-ordered arrays (one memory sweep, no per-pod Python loop).
    Load aggregates (outstanding, drain rate, waiting floor) move on
    every launch/complete and refresh often; the per-app capacity tables
    (fits, E*, E*/t*) only move on capacity events
    (``set_alive_units``) and refresh separately, so steady routing pays
    three reduceats, not six.
    """

    def __init__(self, state: ClusterState, pod_size: int = 16,
                 pods_per_region: int = 8):
        self.state = state
        self.pod_size = int(pod_size)
        N = len(state.names)
        A = len(state.app_index)
        P = max(1, -(-N // self.pod_size))
        self.n_pods = P
        self.pod_lo = np.arange(P, dtype=np.int64) * self.pod_size
        self.pod_hi = np.minimum(self.pod_lo + self.pod_size, N)
        self.pod_of = state.rank // self.pod_size  # node index -> pod
        self.region_lo = np.arange(0, P, int(pods_per_region), dtype=np.int64)
        self.outmin = np.zeros(P)  # min outstanding(t_load) over members
        self.rate_max = np.zeros(P)  # max Σg/units (fastest member drain)
        self.wmin_rate = np.zeros(P)  # min waiting-work/units (floor)
        self._t_load = 0.0  # instant the load aggregates were taken at
        self.pod_fits = np.zeros((P, A), dtype=bool)
        self.emin = np.full((P, A), np.inf)
        self.eot_min = np.full((P, A), np.inf)
        self._load_dirty = True
        self._caps_dirty = True

    def touch(self, ni: int) -> None:
        self._load_dirty = True

    def touch_caps(self, ni: int) -> None:
        """A capacity event (``set_alive_units``): fits/E*/units moved."""
        self._load_dirty = True
        self._caps_dirty = True

    def refresh(self, now: float = 0.0) -> None:
        st = self.state
        if len(st.order) == 0:
            return
        order, lo = st.order, self.pod_lo
        if self._caps_dirty:
            fit = st.fits[order]
            self.pod_fits = np.logical_or.reduceat(fit, lo, axis=0)
            self.emin = np.minimum.reduceat(
                np.where(fit, st.e_best[order], np.inf), lo, axis=0
            )
            self.eot_min = np.minimum.reduceat(
                np.where(fit, st.e_best[order] / st.t_best[order], np.inf),
                lo, axis=0,
            )
            self._caps_dirty = False
        if self._load_dirty:
            # exact per-member outstanding at the refresh instant, so the
            # pod bound is *tight* here (min over members, not a min of
            # sums) — on loaded fleets this is what lets pruning win
            # instead of every pod tying at a slack bound
            self.outmin = np.minimum.reduceat(st.outstanding(now)[order], lo)
            self.rate_max = np.maximum.reduceat(
                st.sum_g[order] / st.units[order], lo
            )
            self.wmin_rate = np.minimum.reduceat(
                st.wait_units_s[order] / st.units[order], lo
            )
            self._t_load = now
            self._load_dirty = False

    def out_lb(self, now: float) -> np.ndarray:
        """Per-pod lower bound on every member's ``outstanding(now)``.

        A member's backlog decays at most at its committed drain rate
        (Σg/units) and never below its waiting work, so
        ``outmin - dt·rate_max`` clipped to the waiting floor stays
        admissible for any ``now >= t_load`` (and for ``now < t_load``
        the dt clamp keeps the stale-but-valid refresh-time bound)."""
        dt = max(now - self._t_load, 0.0)
        return np.maximum(self.outmin - dt * self.rate_max, self.wmin_rate)


class HierarchicalDispatcher:
    """Two-level routing wrapper: region → pod → node, schedule-exact.

    Wraps a built-in dispatcher and reproduces its flat decision *bit for
    bit* — the pod summaries only prune: regions and pods whose score
    lower bound exceeds the best node found so far are skipped; surviving
    pods are scanned with the inner dispatcher's own formula on array
    slices (elementwise-identical IEEE ops), ties broken by name rank
    exactly like the flat path.  Pruning is strict (a pod with
    ``lb == best`` is still scanned), so equal-score ties can never be
    lost to the hierarchy.

    Falls back to the inner dispatcher's flat scan when the state is not
    an array-backed ``ClusterState`` (the ``fast_status=False`` reference
    view) or a forecast plane is attached (posterior tables mutate per
    event; summaries would go stale).
    """

    def __init__(self, inner=None, *, pod_size: int = 16,
                 pods_per_region: int = 8, flat_fallback: int = 4):
        self.inner = inner if inner is not None else EnergyAwareDispatcher()
        self.pod_size = int(pod_size)
        self.pods_per_region = int(pods_per_region)
        # surviving-pod count above which the scored path hands the
        # arrival to the flat vectorized scan instead of per-pod Python
        # scans (result is identical either way; this only bounds cost
        # when the summaries fail to discriminate)
        self.flat_fallback = int(flat_fallback)

    def name(self) -> str:
        return f"hier-{self.inner.name()}"

    def reset(self) -> None:
        if hasattr(self.inner, "reset"):
            self.inner.reset()

    def attach_forecast(self, plane: ForecastPlane) -> None:
        if hasattr(self.inner, "attach_forecast"):
            self.inner.attach_forecast(plane)

    def _fleet(self, state: ClusterState) -> FleetIndex:
        fleet = state._fleet
        if (
            fleet is None
            or fleet.pod_size != self.pod_size
            or fleet.state is not state
        ):
            fleet = FleetIndex(state, self.pod_size, self.pods_per_region)
            state.attach_fleet(fleet)
        return fleet

    def route_indexed(self, ai: int, state, now: float) -> int:
        inner = self.inner
        if not isinstance(state, ClusterState) or (
            getattr(inner, "_plane", None) is not None
        ):
            return inner.route_indexed(ai, state, now)
        fleet = self._fleet(state)
        fleet.refresh(now)
        if isinstance(inner, RoundRobinDispatcher):
            return self._route_rr(ai, state, fleet)
        if isinstance(inner, (LeastLoadedDispatcher, EnergyAwareDispatcher)):
            eco = isinstance(inner, EnergyAwareDispatcher)
            return self._route_scored(ai, state, fleet, now, eco)
        return inner.route_indexed(ai, state, now)

    def _route_rr(self, ai: int, state: ClusterState, fleet: FleetIndex) -> int:
        inner = self.inner
        n = len(state.names)
        if n == 0:
            return -1
        start = inner._i % n
        P = fleet.n_pods
        p0 = start // fleet.pod_size
        # pods in cyclic order from the pointer's pod; the extra final
        # step re-visits p0 for the ranks before the pointer (wrap)
        for step in range(P + 1):
            p = (p0 + step) % P
            lo, hi = int(fleet.pod_lo[p]), int(fleet.pod_hi[p])
            if step == 0:
                lo = start
            elif step == P:
                hi = min(start, hi)
            if lo >= hi or not fleet.pod_fits[p, ai]:
                continue
            nodes = state.order[lo:hi]
            hits = np.flatnonzero(state.fits[nodes, ai])
            if hits.size:
                r = lo + int(hits[0])
                inner._i = (r + 1) % n
                return int(nodes[int(hits[0])])
        return -1

    def _route_scored(self, ai: int, state: ClusterState, fleet: FleetIndex,
                      now: float, eco: bool) -> int:
        out_lb = fleet.out_lb(now)
        ok = fleet.pod_fits[:, ai]
        lb = np.full(fleet.n_pods, np.inf)
        if eco:
            # inner._tables == state tables here (plane-attached runs
            # already fell back to the flat scan); masked assignment keeps
            # the no-fit pods' inf·0 bound from going NaN
            e_best, t_best = self.inner._tables(state)
            lb[ok] = (
                fleet.emin[ok, ai] + fleet.eot_min[ok, ai] * out_lb[ok]
            )
        else:
            lb[ok] = out_lb[ok]
        # one-sided float guard: the tight load-skew bound computes the
        # same quantity as a lone member's score through a *different*
        # rounding path (e + (e/t)·out vs e·(out+t)/t), so reassociation
        # can land lb a few ulps above a tying member — which would prune
        # its pod and break flat parity.  Shaving a relative 1e-12 (three
        # orders above the ~6·eps worst case) keeps the bound admissible
        # in floats too; the cost is only an occasional extra pod scan.
        lb[ok] *= 1.0 - 1e-12
        order = state.order
        sum_end_g, sum_g = state.sum_end_g, state.sum_g
        wait, units, fits = state.wait_units_s, state.units, state.fits
        best_val, best_rank, best_node = np.inf, -1, -1

        def scan(p: int) -> None:
            nonlocal best_val, best_rank, best_node
            lo = int(fleet.pod_lo[p])
            nodes = order[lo:int(fleet.pod_hi[p])]
            out = (
                np.maximum(sum_end_g[nodes] - now * sum_g[nodes], 0.0)
                + wait[nodes]
            ) / units[nodes]
            if eco:
                t = t_best[nodes, ai]
                vals = np.where(
                    fits[nodes, ai], e_best[nodes, ai] * (out + t) / t, np.inf
                )
            else:
                vals = np.where(fits[nodes, ai], out, np.inf)
            k = int(np.argmin(vals))
            v = vals[k]
            if np.isinf(v):
                return
            vr = lo + k  # nodes are rank-ordered: global rank of winner
            if v < best_val or (v == best_val and vr < best_rank):
                best_val, best_rank, best_node = float(v), vr, int(nodes[k])

        # seed with the globally tightest pod (usually the winner: one pod
        # scanned, everything else pruned), then sweep the survivors.  The
        # scan order never affects the result — (best_val, best_rank) is a
        # running min over every node visited, and only pods whose lower
        # bound strictly exceeds best_val are skipped, so equal-score ties
        # always get scanned and break on global name rank exactly like
        # the flat pass.
        p0 = int(np.argmin(lb))
        if np.isinf(lb[p0]):
            return -1
        if int(np.count_nonzero(lb <= lb[p0])) > self.flat_fallback:
            # already more pods tied at the minimum bound than the scan
            # budget: every one of them survives any best_val, so skip
            # straight to the flat pass
            return self.inner.route_indexed(ai, state, now)
        scan(p0)
        surv = lb <= best_val
        surv[p0] = False
        n_surv = int(np.count_nonzero(surv))
        if n_surv == 0:
            return best_node
        if n_surv > self.flat_fallback:
            # the bounds don't discriminate (typical of a homogeneous or
            # lightly loaded fleet, where every idle pod ties): per-pod
            # Python scans would cost more than one vectorized pass, so
            # delegate to the flat scan — bit-identical by the parity
            # construction, and never slower than the flat dispatcher
            return self.inner.route_indexed(ai, state, now)
        rlb = np.minimum.reduceat(lb, fleet.region_lo)
        n_regions = len(fleet.region_lo)
        for r in np.flatnonzero(rlb <= best_val):
            r = int(r)
            plo = int(fleet.region_lo[r])
            phi = (
                int(fleet.region_lo[r + 1])
                if r + 1 < n_regions else fleet.n_pods
            )
            for q in np.flatnonzero(lb[plo:phi] <= best_val):
                p = plo + int(q)
                if surv[p]:
                    scan(p)
        return best_node


class Cluster:
    """Heterogeneous cluster = node specs + per-node truth/policy factories.

    ``truth_for(spec)``  — app-keyed ``JobProfile`` table on that hardware
                           (runtime/power curves differ per ChipSpec).
    ``policy_for(spec, truth)`` — per-node policy over the *instance-keyed*
                           truth table built for one stream.
    ``slowdown_for(spec)`` — optional residual-interference model per node.
    """

    def __init__(
        self,
        specs: Sequence[NodeSpec],
        *,
        truth_for: Callable[[NodeSpec], Dict[str, JobProfile]],
        policy_for: Callable[[NodeSpec, Dict[str, JobProfile]], object],
        dispatcher,
        slowdown_for: Optional[Callable[[NodeSpec], object]] = None,
        label: str = "",
    ):
        if len({s.name for s in specs}) != len(specs):
            raise ValueError("node names must be unique")
        self.specs = list(specs)
        self.truth_for = truth_for
        self.policy_for = policy_for
        self.dispatcher = dispatcher
        self.slowdown_for = slowdown_for
        self.label = label

    def open_run(
        self,
        *,
        apps: Sequence[str],
        jobs: Sequence[Tuple[str, str]] = (),
        elastic: Optional[ElasticConfig] = None,
        forecast: Optional[ForecastConfig] = None,
        faults: Optional[FaultConfig] = None,
        max_events: Optional[int] = None,
        fast_status: bool = True,
        on_transition: Optional[Callable] = None,
    ) -> "ClusterRun":
        """Build an incrementally drivable run over a fixed app universe —
        the control-plane backend entry point.  ``jobs`` seeds
        (name, app) instances known up-front; a daemon adds more later via
        ``ClusterRun.submit``."""
        if hasattr(self.dispatcher, "reset"):
            self.dispatcher.reset()  # stateful dispatchers restart per run
        return ClusterRun(
            self,
            apps=apps,
            jobs=jobs,
            elastic=elastic,
            forecast=forecast,
            faults=faults,
            max_events=max_events,
            fast_status=fast_status,
            on_transition=on_transition,
        )

    def simulate(
        self,
        stream: Sequence[Arrival],
        *,
        charge_profiling: bool = False,
        max_events: Optional[int] = None,
        fast_status: bool = True,
        elastic: Optional[ElasticConfig] = None,
        forecast: Optional[ForecastConfig] = None,
        faults: Optional[FaultConfig] = None,
    ) -> ClusterResult:
        # stable on t only: same-instant arrivals keep submission order
        stream = sorted(stream, key=lambda a: a.t)
        if max_events is None:
            # same 50x-per-job bound as simulate(), cluster-sized floor
            max_events = _auto_max_events(len(stream), floor=1_000_000)
        if hasattr(self.dispatcher, "reset"):
            self.dispatcher.reset()  # stateful dispatchers restart per run
        if len({a.name for a in stream}) != len(stream):
            raise ValueError("arrival instance names must be unique")
        run = ClusterRun(
            self,
            apps=sorted({a.app for a in stream}),
            jobs=[(a.name, a.app) for a in stream],
            elastic=elastic,
            forecast=forecast,
            faults=faults,
            max_events=max_events,
            fast_status=fast_status,
        )
        for arr in stream:
            if arr.t <= 0.0:
                run.route(arr, 0.0)
            else:
                run.loop.queue.push(arr.t, EVT_ARRIVAL, arr)
        run.loop.run()
        return run.finalize(charge_profiling=charge_profiling)


class _ReferenceStateView:
    """``ClusterState`` proxy whose drain proxy is the reference scan:
    ``outstanding(now)`` recomputes every node's committed busy
    unit-seconds by walking its running/waiting lists against the global
    clock instead of reading the in-place accumulators.  Dispatchers see
    the same ``route_indexed`` state interface either way — this is what
    ``simulate(fast_status=False)`` routes through; every other attribute
    delegates to the real state."""

    def __init__(self, run: "ClusterRun"):
        self._run = run

    def __getattr__(self, name):
        return getattr(self._run.state, name)

    def outstanding(self, now: float) -> np.ndarray:
        run = self._run
        out = np.zeros(len(run.specs))
        for i, s in enumerate(run.specs):
            sim = run.sims[s.name]
            # reference scan: remaining work vs the *global* clock —
            # a node's local sim.t lags until its next event, which
            # would inflate its load
            mins = run.min_unit_s[s.name]
            # .get(): a degraded node's refit may have dropped an app a
            # stranded waiter still belongs to — it contributes no
            # schedulable work until the repair restores the entry
            out[i] = (
                sum(max(r.end - now, 0.0) * r.g for r in sim.running)
                + sum(mins.get(run.app_of[j], 0.0) for j in sim.waiting)
            ) / run.state.units[i]
        return out


class _NodeTruth:
    """Instance-keyed truth view on one node's hardware.

    Resolves ``job -> JobProfile`` lazily through the run's shared
    ``app_of`` registry instead of materializing an entry per
    (node, instance) — registering a job is O(1) instead of O(nodes),
    which dominated ``ClusterRun`` construction at fleet scale.  Apps
    this hardware has no profile for are simply absent, exactly like the
    eager per-node dicts it replaces (the dispatcher's ``fits`` refuses
    to route them here).  Supports the mapping subset the simulator and
    perf models actually use: ``[]``, ``in``, ``get``, iteration.
    """

    __slots__ = ("_apps", "_app_of")

    def __init__(self, apps: Dict[str, JobProfile], app_of: Dict[str, str]):
        self._apps = apps      # app -> JobProfile on this hardware
        self._app_of = app_of  # shared instance -> app registry

    def __getitem__(self, job: str) -> JobProfile:
        return self._apps[self._app_of[job]]

    def __contains__(self, job: str) -> bool:
        app = self._app_of.get(job)
        return app is not None and app in self._apps

    def get(self, job: str, default=None):
        app = self._app_of.get(job)
        return self._apps.get(app, default) if app is not None else default

    def __iter__(self):
        return (j for j, a in self._app_of.items() if a in self._apps)

    def __len__(self) -> int:
        return sum(1 for _ in self)


def _reduce_staged(staged: Sequence[Tuple[object, dict]], *, nodes: bool
                   ) -> Tuple[List[int], List[int]]:
    """One kernel launch over staged ``(policy, request)`` pairs, on the
    first policy's device; returns one argmin per request and one guarded
    argmin (-1 for a request without a guard).  ``nodes`` takes
    ``score_reduce_batch`` (a node's whole window each), else
    ``score_reduce_multi`` (backfill and resize windows).  The
    requests pack into one upload rounded as the solo path rounds them
    (float32 planes; float64 bias and scalars to float32), so the result
    is the solo one whichever device runs it."""
    reqs = [req for _, req in staged]
    packed = pack_windows(reqs, staged[0][0].device)
    out = (score_reduce_batch if nodes else score_reduce_multi)(**packed)
    return out[1], (out[2] if len(out) > 2 else [-1] * len(reqs))


class ClusterRun:
    """One live cluster simulation, exposed as a steppable backend.

    ``Cluster.simulate`` is a thin batch wrapper over this class (seed
    every arrival, ``loop.run()``, ``finalize()``); a scheduler daemon
    (``repro_torch.core.service``) instead drives it incrementally: ``submit`` pushes arrivals into the
    live event heap, ``run_until``/``run_to_completion`` advance the
    clock, ``cancel`` drops never-launched jobs, and every lifecycle
    transition is reported through the optional ``on_transition`` callback
    — ``(event, t, job, node, g, end, f)`` with event in {queued, launch,
    done, ckpt, requeue, migrate} — which the daemon journals.

    The app universe (``apps``) is fixed at construction: the
    ``ClusterState`` routing tables are preallocated over it.  Job
    *instances* may keep arriving — per-node truth views and the
    instance->app map grow in place, which is safe because policies and
    perf models read their truth tables lazily per event.
    """

    def __init__(
        self,
        cluster: Cluster,
        *,
        apps: Sequence[str],
        jobs: Sequence[Tuple[str, str]] = (),
        elastic: Optional[ElasticConfig] = None,
        forecast: Optional[ForecastConfig] = None,
        faults: Optional[FaultConfig] = None,
        max_events: Optional[int] = None,
        fast_status: bool = True,
        on_transition: Optional[Callable] = None,
    ):
        self.cluster = cluster
        self.specs = cluster.specs
        self.dispatcher = cluster.dispatcher
        if not hasattr(self.dispatcher, "route_indexed"):
            raise TypeError(
                f"dispatcher {self.dispatcher.name()!r} must implement "
                "route_indexed(ai, state, now)"
            )
        self.elastic = elastic
        self.faults = faults if (faults and faults.enabled) else None
        self.fault_injector = (
            FaultInjector(self.faults) if self.faults is not None else None
        )
        self.fast_status = fast_status
        self.on_transition = on_transition

        self.app_truth: Dict[str, Dict[str, JobProfile]] = {
            s.name: cluster.truth_for(s) for s in self.specs
        }
        self.spec_of = {s.name: s for s in self.specs}
        self.apps = list(apps)
        state = self.state = ClusterState(self.specs, self.app_truth, self.apps)
        # admission decisions must be time-independent: a job that fits a
        # *healthy* node is admittable even while that node is down
        self._fits_healthy = state.fits.copy()
        # per-node per-app minimum busy unit-seconds (legacy-scan form of
        # ClusterState.min_unit_s, for the reference status path)
        self.min_unit_s: Dict[str, Dict[str, float]] = {
            s.name: {
                app: state.min_unit_s[state.index[s.name], state.app_index[app]]
                for app in self.apps
                if state.fits[state.index[s.name], state.app_index[app]]
            }
            for s in self.specs
        }
        # forecast-driven control plane: never built on the default path,
        # so forecast=None is bit-identical to the plane-free substrate
        self.plane: Optional[ForecastPlane] = None
        if forecast is not None and forecast.enabled:
            self.plane = ForecastPlane(
                forecast,
                {s.name: s.units for s in self.specs},
                state=state,
                elastic=elastic,
            )
            if hasattr(self.dispatcher, "attach_forecast"):
                self.dispatcher.attach_forecast(self.plane)
            # posterior-refined dispatch tables
            self.plane.bind_dispatch(self.app_truth)

        # instance-keyed state; grows in place as jobs are added.  Truth
        # views resolve instance -> app profile through the shared
        # ``app_of`` registry instead of copying one dict entry per
        # (node, instance): registration is O(1), not O(nodes) — at 256+
        # nodes the eager copies dominated ClusterRun construction.
        self.app_of: Dict[str, str] = {}
        self._truth_n: Dict[str, _NodeTruth] = {
            s.name: _NodeTruth(self.app_truth[s.name], self.app_of)
            for s in self.specs
        }
        for name, app in jobs:
            self._register(name, app)
        self.n_jobs = len(self.app_of)

        self.sims: Dict[str, NodeSim] = {}
        for s in self.specs:
            # instance-keyed view of the hardware truth for this stream;
            # apps this hardware has no profile for are simply absent (the
            # dispatcher's fits() already refuses to route them here)
            truth_n = self._truth_n[s.name]
            policy = cluster.policy_for(s, truth_n)
            if self.plane is not None and hasattr(policy, "attach_forecast"):
                policy.attach_forecast(self.plane, s.name)
            self.sims[s.name] = NodeSim(
                Node(s.units, s.domains, s.idle_power_per_unit),
                truth_n,
                policy,
                slowdown_model=(
                    cluster.slowdown_for(s) if cluster.slowdown_for else None
                ),
                name=s.name,
                elastic=elastic,
                faults=faults,
                fault_injector=self.fault_injector,
            )

        # fast_status=False swaps in the reference-scan drain proxy; the
        # dispatch protocol itself is route_indexed either way
        self._dispatch_state = (
            state if fast_status else _ReferenceStateView(self)
        )
        self._cancelled: set = set()  # cancelled before their ARRIVAL popped
        self._routed: set = set()  # instances that reached a node queue
        # fragmentation gauge rollup: time-weighted average of
        # ClusterState.frag_now(), sampled at every state transition
        self._frag_area = 0.0
        self._frag_t = 0.0
        self._frag_cur = 0.0
        self._frag_peak = 0.0
        # run-level decision-phase clocks: dispatch routing and
        # cross-node kernel staging are cluster work, not node work — the
        # per-node clocks (launch/resize/migrate) live on each NodeSim
        self._dispatch_time = 0.0
        self._stage_time = 0.0
        if max_events is None:
            max_events = _auto_max_events(self.n_jobs, floor=1_000_000)
        self.loop = EventLoop(
            self.sims,
            arrive=self.route,
            max_events=max_events,
            cap_msg="cluster event cap exceeded (policy deadlock?)",
            elastic=elastic,
            faults=faults,
            fault_injector=self.fault_injector,
            on_launch=self._on_launch,
            on_complete=self._on_complete,
            on_requeue=self._on_requeue,
            on_dequeue=self._on_dequeue,
            on_retime=self._on_retime,
            on_fail=self._on_fail,
            on_retry=self._on_retry,
            on_lost=self._on_lost,
            on_capacity=self._on_capacity,
            migrate_candidate=self._migrate_candidate,
            reroute_waiting=self._reroute_waiting,
            prepare_batch=self._prepare_batch,
            prepare_complete=self._prepare_complete_batch,
        )

    # -- job registry --------------------------------------------------------

    def _register(self, name: str, app: str) -> None:
        if name in self.app_of:
            raise ValueError(f"duplicate job instance {name!r}")
        # every node's _NodeTruth view sees the instance through app_of
        self.app_of[name] = app

    @property
    def now(self) -> float:
        return self.loop.now

    def add_job(self, name: str, app: str) -> None:
        """Register one new instance (daemon path).  Raises when the app
        is outside this run's universe or no node can fit it."""
        ai = self.state.app_index.get(app)
        if ai is None:
            raise ValueError(
                f"unknown application {app!r} (universe: {self.apps})"
            )
        if not bool(self._fits_healthy[:, ai].any()):
            raise ValueError(f"no node can fit any feasible mode of {app}")
        self._register(name, app)
        self.n_jobs += 1
        self.loop.max_events = max(
            self.loop.max_events, _auto_max_events(self.n_jobs, floor=1_000_000)
        )

    def submit(self, name: str, app: str, t: float) -> None:
        """Register + push the ARRIVAL event (daemon path).  ``t`` must not
        precede already-processed events; the service layer clamps."""
        self.add_job(name, app)
        self.loop.queue.push(t, EVT_ARRIVAL, Arrival(t=t, name=name, app=app))

    def cancel(self, name: str) -> bool:
        """Drop a job that has not launched yet.  True on success: either
        the ARRIVAL is still in flight (marked to be dropped at its pop) or
        the job is waiting, never-launched, on some node (dequeued in
        place).  False for anything already running, checkpointed, in
        migration transit, finished, or already cancelled."""
        if name not in self.app_of or name in self._cancelled:
            return False
        if name not in self._routed:
            self._cancelled.add(name)
            return True
        for nm, sim in self.sims.items():
            if name not in sim.waiting:
                continue
            if (
                name in sim.progress
                or name in sim.needs_restart
                or sim._segments.get(name, 0)
            ):
                return False  # has elastic state: not a pure queue entry
            sim.cancel_waiting(name)
            self.state.on_migrate_out(
                self.state.index[nm], self.state.app_index[self.app_of[name]]
            )
            self._cancelled.add(name)
            return True
        return False

    # -- driving -------------------------------------------------------------

    def run_until(self, t: float) -> None:
        self.loop.run_until(t)

    def run_to_completion(self) -> None:
        self.loop.run()

    # -- dispatch + substrate hooks ------------------------------------------

    def _emit(
        self,
        event: str,
        t: float,
        job: str,
        node: str,
        g: int,
        end: float,
        f: int = 0,
    ) -> None:
        if self.on_transition is not None:
            self.on_transition(event, t, job, node, g, end, f)

    def _frag_observe(self, t: float) -> None:
        """Close the previous fragmentation interval at ``t`` and sample
        the gauge after the state change that triggered this call."""
        if t > self._frag_t:
            self._frag_area += self._frag_cur * (t - self._frag_t)
            self._frag_t = t
        cur = self.state.frag_now()
        self._frag_cur = cur
        if cur > self._frag_peak:
            self._frag_peak = cur

    def _prepare_batch(self, names: Sequence[str], t: float) -> None:
        t0 = _time.perf_counter()
        try:
            self._stage_arrival_batch(names, t)
        finally:
            self._stage_time += _time.perf_counter() - t0

    def _prepare_complete_batch(self, pairs, t: float) -> None:
        t0 = _time.perf_counter()
        try:
            self._stage_complete_batch(pairs, t)
        finally:
            self._stage_time += _time.perf_counter() - t0

    def _stage_arrival_batch(self, names: Sequence[str], t: float) -> None:
        """Fleet-batched decision staging: when a same-instant event
        batch touches several nodes, run every pending Eq. (1) reduction as
        ONE cross-node kernel launch (``score_reduce_batch``) and park each
        node's argmin on its policy; the per-node ``_schedule`` pass then
        consumes the staged result instead of launching its own kernel.
        Pure staging: the batched kernel is bitwise equal to the solo
        kernel and each policy re-checks its decision-state signature at
        consumption time, so any drift between staging and scheduling
        (e.g. a capacity change) falls back to the solo recomputation —
        schedules are bit-identical either way."""
        staged: List[Tuple[object, dict]] = []
        seen = set()
        for nm in names:
            if nm in seen:
                continue
            seen.add(nm)
            sim = self.sims[nm]
            pol = sim.policy
            if getattr(pol, "engine", None) != "torch":
                continue
            stage = getattr(pol, "stage_score", None)
            if stage is None:
                continue
            if self.faults is not None and sim.placement.free_count() == 0:
                continue  # _schedule skips fully-dead/occupied nodes
            req = stage(sim.node_view(), list(sim.waiting))
            if req is not None:
                staged.append((pol, req))
        if len(staged) < 2:
            for pol, _ in staged:
                pol.stage_drop()  # a lone decision gains nothing batched
            return
        bests, guarded = _reduce_staged(staged, nodes=True)
        for (pol, _), best, best_g in zip(staged, bests, guarded):
            pol.stage_round1(int(best), int(best_g))

    def _stage_complete_batch(self, pairs, t: float) -> None:
        """COMPLETE-burst decision staging: when a
        same-instant COMPLETE burst spans several nodes, predict each
        node's post-completion view (the completing job's units freed,
        clock at the burst instant) and collect every Eq. (1) reduction
        that view implies — the backfill launch scoring and, where the
        elastic ordering allows, the whole resize candidate table — into
        ONE cross-node multi-window kernel launch
        (``score_reduce_multi``).  Pure staging, exactly
        like the arrival path: the multi-window kernel is bitwise-locked
        to the solo kernel and every policy re-checks its decision-state
        signature at consumption time inside the strictly-ordered
        per-completion processing, so any prediction miss (a fault's
        capacity change, a migration, an earlier completion's backfill
        touching the node) falls back to the solo recomputation —
        schedules are bit-identical either way.

        Resize staging is attempted only when the resize phase will run
        against the post-completion view unchanged: either
        ``resize_before_backfill`` or an empty backfill queue.  In the
        other orderings the backfill launch would invalidate the
        signature anyway, so staging would be pure waste."""
        cfg = self.elastic
        launch_staged: List[Tuple[object, dict]] = []
        resize_staged: List[Tuple[object, List[dict]]] = []
        for nm, rj in pairs:
            sim = self.sims[nm]
            pol = sim.policy
            if getattr(pol, "engine", None) != "torch":
                continue
            if getattr(pol, "stage_score", None) is None or (
                getattr(pol, "_freed_view", None) is None
            ):
                continue
            view = pol._freed_view(sim.node_view(), rj, t=t, scratch=False)
            if sim.waiting:
                req = pol.stage_score(view, list(sim.waiting))
                if req is not None:
                    launch_staged.append((pol, req))
            if (
                cfg is not None
                and cfg.resize
                and (cfg.resize_before_backfill or not sim.waiting)
                and getattr(pol, "stage_resize", None) is not None
            ):
                reqs = pol.stage_resize(
                    view, frac_of=lambda r, _t=t: r.frac_at(_t), cfg=cfg
                )
                if reqs:
                    resize_staged.append((pol, reqs))
        if len(launch_staged) + len(resize_staged) < 2:
            # a lone node's decisions gain nothing from cross-node
            # batching (its resize table is already one multi-window
            # launch inside propose_resizes)
            for pol, _ in launch_staged:
                pol.stage_drop()
            for pol, _ in resize_staged:
                pol.stage_resize_drop()
            return
        pairs_all = list(launch_staged)
        k_launch = len(pairs_all)
        for pol, rl in resize_staged:
            pairs_all.extend((pol, req) for req in rl)
        bests, guarded = _reduce_staged(pairs_all, nodes=False)
        for (pol, _), best, best_g in zip(launch_staged, bests, guarded):
            pol.stage_round1(int(best), int(best_g))
        i = k_launch
        for pol, rl in resize_staged:
            pol.stage_resize_results(bests[i:i + len(rl)])
            i += len(rl)

    def route(self, arr: Arrival, t: float) -> Optional[str]:
        if arr.name in self._cancelled:
            return None  # cancelled between submit and its ARRIVAL pop
        state = self.state
        ai = state.app_index[arr.app]
        t0 = _time.perf_counter()
        ni = self.dispatcher.route_indexed(ai, self._dispatch_state, t)
        self._dispatch_time += _time.perf_counter() - t0
        if ni < 0:
            if self.faults is not None and bool(self._fits_healthy[:, ai].any()):
                # every node that can host this app is currently failed or
                # degraded below its smallest mode: hold the job at the
                # cluster edge and retry after the backoff base — repairs
                # are always scheduled, so this terminates
                self.loop.queue.push(
                    t + self.faults.retry_base_s, EVT_ARRIVAL, arr
                )
                return None
            raise ValueError(
                f"no node can fit any feasible mode of {arr.app}"
            )
        nm = state.names[ni]
        # fits == profile present with a mode that fits the node
        if not state.fits[ni, ai]:
            raise ValueError(
                f"{self.dispatcher.name()} routed {arr.app} to {nm} "
                f"(units={self.spec_of[nm].units}) with no feasible mode"
            )
        self.sims[nm].arrive(arr.name, t)
        state.on_arrive(ni, ai)
        self._frag_observe(t)
        if self.plane is not None:
            self.plane.on_arrival(t, nm)
        self._routed.add(arr.name)
        self._emit("queued", t, arr.name, nm, 0, t)
        return nm

    # array-state bookkeeping hooks the substrate fires on transitions

    def _on_launch(self, nm: str, rj: RunningJob) -> None:
        state = self.state
        state.on_launch(
            state.index[nm], state.app_index[self.app_of[rj.job]], rj.end, rj.g
        )
        self._frag_observe(rj.start)
        if self.plane is not None:
            self.plane.on_launch(nm, rj)
        self._emit("launch", rj.start, rj.job, nm, rj.g, rj.end, rj.f)

    def _on_complete(self, nm: str, rj: RunningJob) -> None:
        self.state.on_complete(self.state.index[nm], rj.end, rj.g)
        self._frag_observe(rj.end)
        if self.plane is not None:
            self.plane.on_complete(nm, rj)
        self._emit(
            "ckpt" if rj.preempted else "done",
            rj.end,
            rj.job,
            nm,
            rj.g,
            rj.end,
            rj.f,
        )

    def _on_requeue(self, nm: str, job: str) -> None:
        state = self.state
        state.on_arrive(state.index[nm], state.app_index[self.app_of[job]])
        self._frag_observe(self.loop.now)
        self._emit("requeue", self.loop.now, job, nm, 0, self.loop.now)

    def _on_dequeue(self, nm: str, job: str) -> None:
        state = self.state
        state.on_migrate_out(state.index[nm], state.app_index[self.app_of[job]])
        self._frag_observe(self.loop.now)
        self._emit("migrate", self.loop.now, job, nm, 0, self.loop.now)

    def _on_retime(self, nm: str, rj: RunningJob, old_end: float) -> None:
        self.state.on_retime(self.state.index[nm], old_end, rj.end, rj.g)

    # fault-plane hooks (repro_torch.core.faults; never fired with faults=None)

    def _on_fail(self, nm: str, rj: RunningJob, old_end: float) -> None:
        """A crash/node failure killed ``rj``: un-book its running term
        with the end the launch (or last retime) booked.  Deliberately NOT
        fed to the forecast plane — a crashed segment's duration says
        nothing about the app's runtime, and posteriors learning from it
        would corrupt every later estimate."""
        self.state.on_complete(self.state.index[nm], old_end, rj.g)
        self._frag_observe(rj.end)
        self._emit("fail", rj.end, rj.job, nm, rj.g, rj.end, rj.f)

    def _on_retry(self, nm: str, job: str) -> None:
        state = self.state
        state.on_arrive(state.index[nm], state.app_index[self.app_of[job]])
        self._frag_observe(self.loop.now)
        self._emit("retry", self.loop.now, job, nm, 0, self.loop.now)

    def _on_lost(self, nm: str, job: str) -> None:
        self._emit("lost", self.loop.now, job, nm, 0, self.loop.now)

    def _on_capacity(self, nm: str) -> None:
        """Node ``nm``'s alive capacity changed (failure or repair):
        refit the routing tables and recompute its waiting-work
        accumulator under the new per-app min-work costs."""
        state = self.state
        ni = state.index[nm]
        sim = self.sims[nm]
        state.set_alive_units(ni, sim.placement.alive_units())
        state.sync_free(ni, sim.placement.free_count())
        state.wait_units_s[ni] = sum(
            state.min_unit_s[ni, state.app_index[self.app_of[j]]]
            for j in sim.waiting
        )
        self._frag_observe(self.loop.now)
        # legacy-scan table (the fast_status=False reference path)
        self.min_unit_s[nm] = {
            app: state.min_unit_s[ni, state.app_index[app]]
            for app in self.apps
            if state.fits[ni, state.app_index[app]]
        }

    def _reroute_waiting(self, nm: str, t: float) -> None:
        """Node ``nm`` went fully dead: move its waiting jobs to live
        nodes through the migration machinery (transit delay charged).
        Without migration enabled the jobs wait out the repair."""
        if self.elastic is None or not self.elastic.migrate:
            return
        sim = self.sims[nm]
        state = self.state
        for job in list(sim.waiting):
            ai = state.app_index[self.app_of[job]]
            ni = self.dispatcher.route_indexed(ai, self._dispatch_state, t)
            if ni < 0 or state.names[ni] == nm:
                continue  # nowhere alive to go; wait for the repair
            dest = state.names[ni]
            mstate = sim.evict(job)
            self._on_dequeue(nm, job)
            self.loop.queue.push(
                t + self.elastic.migration_delay, EVT_MIGRATE, (dest, job, mstate)
            )

    def _migrate_candidate(self, nm: str, t: float):
        """Pull one waiting job from the most backlogged node onto the
        node that just completed, when the predicted-wait gap beats the
        move cost.  With a forecast plane the gap test runs on
        *forecasted* waits (queueing-inflated drain) and, while the
        burst gate is armed, demands an extra risk margin — the
        hysteresis that fixes the eager-migration losing seeds.
        A dispatcher may override via
        ``select_migration(nm, state, sims, now, cfg)``."""
        hook = getattr(self.dispatcher, "select_migration", None)
        if hook is not None:
            return hook(nm, self.state, self.sims, t, self.elastic)
        state = self.state
        sims = self.sims
        plane = self.plane
        elastic = self.elastic
        ni = state.index[nm]
        if sims[nm].placement.free_count() <= 0:
            return None
        # One greedy proposer, two accept tests.  Plane-free path
        # (plane=None): raw drain-proxy gap, job-independent — a
        # checkpointed job pays its restart wherever it relaunches,
        # so only the transit delay counts against the move.
        # Forecast path: the same scan on *forecasted* waits, but a
        # fitting job is only pulled when the move's forecasted
        # cluster-level saving beats the burst-risk penalty —
        #   [(W_fc[donor] − own queued work + t_best[donor]) −
        #    (W_fc[recv] + delay + t_best[recv])]          (the moved job)
        #   + relief · (donor waiters left behind)          (their queue)
        #   > penalty
        # — the per-job term is what kills the eager losing pulls (a job
        # whose best mode on the drained slower node runs thousands of
        # seconds longer never wins the gap test job-blindly won); the
        # relief term is the saturation fix: at high load the
        # donor's remaining waiters each stop waiting behind the moved
        # job's queued work, a cluster-throughput gain the myopic
        # single-job test left on the table.
        if plane is None:
            out = state.outstanding(t)
            penalty = None
        else:
            out = plane.wait_forecast(t)
            penalty = plane.migration_penalty_s(nm, t)
        threshold = out[ni] + elastic.migration_delay + elastic.min_gain_s
        for di in np.argsort(-out, kind="stable"):
            di = int(di)
            if di == ni or state.n_waiting[di] == 0:
                continue
            if out[di] <= threshold:
                break  # donors come in descending order: scan is done
            dsim = sims[state.names[di]]
            for job in dsim.waiting:
                ai2 = state.app_index[self.app_of[job]]
                if not state.fits[ni, ai2]:
                    continue
                if penalty is None:
                    return state.names[di], job
                # the donor backlog includes the candidate's own
                # queued min-work; staying means waiting behind the
                # *rest* of it.  The gap threshold above already
                # charged min_gain_s, so this veto only blocks moves
                # the forecast predicts to be harmful.
                own = state.min_unit_s[di, ai2] / state.units[di]
                gain = (out[di] - own + state.t_best[di, ai2]) - (
                    out[ni] + elastic.migration_delay + state.t_best[ni, ai2]
                )
                relief = (
                    plane.cfg.migration_relief_weight
                    * own
                    * max(int(state.n_waiting[di]) - 1, 0)
                )
                if gain + relief > penalty:
                    return state.names[di], job
                plane.migrations_vetoed += 1
        return None

    # -- results -------------------------------------------------------------

    def finalize(self, *, charge_profiling: bool = False) -> ClusterResult:
        stuck = {
            nm: sim.waiting for nm, sim in self.sims.items() if sim.waiting
        }
        if stuck:
            raise RuntimeError(
                f"cluster run finished with waiting jobs {stuck}"
            )
        per_node = {
            s.name: self.sims[s.name].result(charge_profiling=charge_profiling)
            for s in self.specs
        }
        makespan = max((r.makespan for r in per_node.values()), default=0.0)
        tail_idle = sum(
            (makespan - per_node[s.name].makespan)
            * s.units
            * s.idle_power_per_unit
            for s in self.specs
        )
        label = self.cluster.label or (
            f"{self.dispatcher.name()}:"
            f"{per_node[self.specs[0].name].policy if self.specs else ''}"
        )
        self._frag_observe(makespan)
        frag = {
            "time_avg": (
                self._frag_area / makespan if makespan > 0.0 else 0.0
            ),
            "peak": self._frag_peak,
            "final": self._frag_cur,
        }
        return ClusterResult(
            policy=label,
            per_node=per_node,
            makespan=makespan,
            tail_idle_energy=tail_idle,
            forecast=self.plane.summary() if self.plane is not None else {},
            fragmentation=frag,
            decision_phases={
                "dispatch": self._dispatch_time,
                "launch": sum(r.decision_time_s for r in per_node.values()),
                "resize": sum(r.resize_time_s for r in per_node.values()),
                "migrate": sum(r.migrate_time_s for r in per_node.values()),
                "stage": self._stage_time,
            },
        )

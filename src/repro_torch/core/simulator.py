"""Discrete-event node simulator with energy accounting.

Drives any ``Policy`` through a workload: at t=0, at every job completion
and at every job *arrival* it hands the policy the current ``NodeView`` +
waiting queue and launches whatever the policy returns (validating
capacity, domain and contiguity constraints — a policy bug raises, it
never silently oversubscribes).

Energy integration is exact piecewise-constant:
  busy  = Σ_jobs  P_busy(job, g) · runtime(job, g)
  idle  = Σ_segments  (idle units) · P_idle_unit · dt   until makespan.
Invariant (tested): Σ busy GPU-seconds + Σ idle GPU-seconds = M · makespan.

The per-node state machine lives in ``NodeSim``; the event loop itself is
the shared substrate in ``repro_torch.core.events``.  Twin of
``repro.core.simulator``: the same inputs give the same fingerprints,
makespan and energy, bit for bit.

With an ``ElasticConfig`` the same ``NodeSim`` supports
preemption/checkpoint-restart: a running job can be checkpointed (units
held for the write, energy charged), re-queued with its completed-work
fraction, and relaunched at any feasible count — the relaunch pays the
restart overhead and only the remaining work.  All of it is default-off
and adds nothing to the static path.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.events import EVT_ARRIVAL, ElasticConfig, EventLoop
from repro_torch.core.faults import FaultConfig, FaultInjector
from repro_torch.core.placement import PlacementState
from repro_torch.core.types import (
    JobProfile,
    JobRecord,
    Launch,
    NodeView,
    RunningJob,
    ScheduleResult,
)

# Pre-refactor aliases (the heap tuple kind slots); kept for callers that
# imported the private constants.
_ARRIVAL = EVT_ARRIVAL
_DONE = 1  # EVT_COMPLETE


class Node:
    def __init__(self, units: int, domains: int, idle_power_per_unit: float):
        self.units = units
        self.domains = domains
        self.idle_power_per_unit = idle_power_per_unit


@dataclass(frozen=True)
class MigrantState:
    """Everything a migrating job carries between nodes (MIGRATE payload):
    the original submission time, its completed-work fraction, whether the
    next launch owes a restart, and the per-job counters that must stay
    global across nodes."""

    arrival: float
    progress: float = 0.0
    restart: bool = False
    segment: int = 0
    preempts: int = 0  # checkpoint budget already spent (max_preempts)
    last_g: Optional[int] = None  # last launched count (resize history)
    last_f: Optional[int] = None  # last launched frequency level (retunes)
    queued_at: float = 0.0  # when it last entered a waiting queue (donor)


class NodeSim:
    """Single-node simulation state: placement, running set, waiting queue,
    and exact piecewise-constant energy integration.

    The owner (the ``EventLoop`` built by ``simulate`` or
    ``Cluster.simulate``) runs the event heap and calls
    ``advance``/``arrive``/``complete``/``invoke_policy`` (plus the
    preemption/migration hooks when elastic); this object never sees the
    heap, so the same accounting serves every entry point.
    """

    def __init__(
        self,
        node: Node,
        truth: Dict[str, JobProfile],
        policy,
        *,
        slowdown_model=None,
        name: str = "",
        elastic: Optional[ElasticConfig] = None,
        faults: Optional[FaultConfig] = None,
        fault_injector: Optional[FaultInjector] = None,
    ):
        self.node = node
        self.truth = truth
        self.policy = policy
        self.slowdown_model = slowdown_model
        self.name = name
        self.elastic = elastic
        self.faults = faults if (faults and faults.enabled) else None
        self.fault_injector = (
            fault_injector if self.faults is not None else None
        )
        # segment/progress tracking is needed by both planes; the restart
        # overhead after a kill comes from whichever config supplies one
        self._track = elastic is not None or self.faults is not None
        self._restart_time = (
            elastic.restart_time
            if elastic is not None
            else (self.faults.restart_time if self.faults is not None else 0.0)
        )
        self.placement = PlacementState(node.units, node.domains)
        self.waiting: List[str] = []
        self.running: List[RunningJob] = []
        self.records: List[JobRecord] = []
        self.arrival_of: Dict[str, float] = {}
        self.t = 0.0
        self.busy_energy = 0.0
        self.idle_unit_seconds = 0.0
        self.decision_time = 0.0
        self.decision_events = 0
        self.resize_time = 0.0  # wall-clock inside the resize phase
        self.migrate_time = 0.0  # wall-clock inside the migration phase
        # elastic bookkeeping (inert unless the substrate drives it)
        self.progress: Dict[str, float] = {}  # job -> completed-work fraction
        self.needs_restart: Set[str] = set()  # next launch pays restart_time
        self.preempt_count: Dict[str, int] = {}
        self.preemptions = 0
        self.ckpt_energy = 0.0
        self.migrations_in = 0
        self.migrations_out = 0
        self.resize_history: Dict[str, List[Tuple[float, int, int]]] = {}
        self.freq_history: Dict[str, List[Tuple[float, int, int]]] = {}
        self._last_g: Dict[str, int] = {}
        self._last_f: Dict[str, int] = {}
        self._segments: Dict[str, int] = {}
        self._queued_at: Dict[str, float] = {}  # last (re-)enqueue time
        # fault-plane accounting (inert unless the substrate drives it)
        self.job_crashes = 0
        self.node_failures = 0
        self.fault_kills = 0
        self.fault_retries = 0
        self.lost: List[str] = []

    def node_view(self) -> NodeView:
        return NodeView(
            t=self.t,
            total_units=self.node.units,
            domains=self.node.domains,
            free_units=self.placement.free_count(),
            running=list(self.running),
            free_map=list(self.placement.free),
            domain_jobs=list(self.placement.domain_jobs),
            dead_units=self.placement.dead_count(),
        )

    def advance(self, t: float) -> None:
        """Integrate idle unit-seconds over [self.t, t) and move the clock."""
        assert t >= self.t - 1e-12, (self.name, self.t, t)
        self.idle_unit_seconds += self.placement.free_count() * (t - self.t)
        self.t = t

    def arrive(self, job: str, t: float) -> None:
        self.advance(t)
        self.arrival_of[job] = t
        self._queued_at[job] = t
        self.waiting.append(job)

    def complete(self, rj: RunningJob) -> None:
        """Advance to the completion instant, then free the job's units."""
        self.advance(rj.end)
        self.running.remove(rj)
        self.placement.release(rj.units, rj.domain)

    def frac_of(self, rj: RunningJob) -> float:
        """Completed-work fraction of a running job at the node clock."""
        return rj.frac_at(self.t)

    def invoke_policy(self) -> List[RunningJob]:
        """One scheduling event; returns the newly launched jobs (the owner
        pushes their completion events)."""
        t0 = _time.perf_counter()
        launches: List[Launch] = (
            self.policy.on_event(self.node_view(), list(self.waiting)) or []
        )
        self.decision_time += _time.perf_counter() - t0
        self.decision_events += 1
        out: List[RunningJob] = []
        for ln in launches:
            if ln.job not in self.waiting:
                raise ValueError(
                    f"{self.policy.name()} launched unknown/duplicate job {ln.job}"
                )
            prof = self.truth[ln.job]
            if ln.g not in prof.runtime:
                raise ValueError(f"{ln.job}: infeasible unit count {ln.g}")
            if ln.f not in prof.freq_levels:
                raise ValueError(f"{ln.job}: infeasible frequency level {ln.f}")
            if self.placement.occupied_domains() >= self.node.domains:
                raise ValueError(
                    f"{self.policy.name()} exceeded domain cap K={self.node.domains}"
                )
            units, domain = self.placement.allocate(ln.g)  # raises if impossible
            factor = 1.0
            if self.slowdown_model is not None:
                # domain-aware models additionally see the real placement
                kw = (
                    dict(units=units, domain=domain, running=self.running,
                         total_units=self.node.units, domains=self.node.domains)
                    if getattr(self.slowdown_model, "domain_aware", False)
                    else {}
                )
                factor = float(
                    self.slowdown_model(
                        ln.job, ln.g, [r.job for r in self.running], **kw
                    )
                )
                assert factor >= 1.0
            frac0 = 0.0
            restart = 0.0
            segment = 0
            if self._track:
                frac0 = self.progress.pop(ln.job, 0.0)
                if ln.job in self.needs_restart:
                    self.needs_restart.discard(ln.job)
                    restart = self._restart_time
                segment = self._segments.get(ln.job, 0)
                self._segments[ln.job] = segment + 1
                last = self._last_g.get(ln.job)
                if last is not None and last != ln.g:
                    self.resize_history.setdefault(ln.job, []).append(
                        (self.t, last, ln.g)
                    )
                last_f = self._last_f.get(ln.job)
                if last_f is not None and last_f != ln.f and last == ln.g:
                    # pure frequency retune: the relaunch kept the count
                    # and only moved the DVFS level
                    self.freq_history.setdefault(ln.job, []).append(
                        (self.t, last_f, ln.f)
                    )
                self._last_g[ln.job] = ln.g
                self._last_f[ln.job] = ln.f
            if self.fault_injector is not None:
                # seeded per-(job, segment) straggler slowdown (>= 1.0)
                factor *= self.fault_injector.straggler(ln.job, segment)
            solo = prof.runtime_at(ln.g, ln.f)
            if frac0 == 0.0 and restart == 0.0:
                dur = solo * factor
            else:
                dur = restart + (1.0 - frac0) * solo * factor
            power = prof.power_at(ln.g, ln.f)
            rj = RunningJob(
                job=ln.job, g=ln.g, units=units, domain=domain,
                start=self.t, end=self.t + dur, power=power, f=ln.f,
                factor=factor, frac0=frac0, restart=restart,
            )
            self.waiting.remove(ln.job)
            self.running.append(rj)
            self.busy_energy += power * dur
            rec = JobRecord(
                job=ln.job, g=ln.g, start=self.t, end=rj.end,
                busy_energy=power * dur,
                arrival=self.arrival_of.get(ln.job, 0.0),
                node=self.name,
                domain=domain,
                segment=segment,
                queued=self._queued_at.get(ln.job, self.arrival_of.get(ln.job, 0.0)),
                f=ln.f,
            )
            rj.record = rec
            self.records.append(rec)
            out.append(rj)
        return out

    # -- elastic substrate hooks (repro_torch.core.events) ------------------------

    def begin_preempt(self, rj: RunningJob, t: float, cfg: ElasticConfig) -> float:
        """Checkpoint a running job at decision time ``t``.  Its units stay
        held until the write finishes at ``t + ckpt_time``; the unrun tail
        of its pre-charged busy energy is returned and the write charged at
        ``ckpt_power_scale`` × busy power.  Returns the checkpoint end time
        (the owner pushes the PREEMPT event there)."""
        assert rj in self.running and not rj.preempted
        assert rj.end > t + cfg.ckpt_time, (rj.job, rj.end, t)
        frac = rj.frac_at(t)
        ck_end = t + cfg.ckpt_time
        ck_e = rj.power * cfg.ckpt_power_scale * cfg.ckpt_time
        self.busy_energy -= rj.power * (rj.end - t)  # un-charge the unrun tail
        self.busy_energy += ck_e
        self.ckpt_energy += ck_e
        rec = rj.record
        rec.end = ck_end
        rec.busy_energy = rj.power * (t - rj.start) + ck_e
        rec.kind = "ckpt"
        rec.ckpt_energy = ck_e
        rj.preempted = True
        rj.frac_ckpt = frac
        rj.end = ck_end
        self.preemptions += 1
        self.preempt_count[rj.job] = self.preempt_count.get(rj.job, 0) + 1
        return ck_end

    def finish_preempt(self, rj: RunningJob, t: float) -> None:
        """The checkpoint write finished: free the units and remember the
        completed-work fraction for the relaunch."""
        assert rj.preempted and abs(rj.end - t) < 1e-9
        self.advance(t)
        self.running.remove(rj)
        self.placement.release(rj.units, rj.domain)
        self.progress[rj.job] = rj.frac_ckpt
        self.needs_restart.add(rj.job)

    def requeue(self, job: str, t: float) -> None:
        """A preempted job re-enters this node's waiting queue (RESUME)."""
        self.advance(t)
        self._queued_at[job] = t
        self.waiting.append(job)

    # -- fault plane (repro_torch.core.events / repro_torch.core.faults) ----------------

    def fail_running(self, rj: RunningJob, t: float) -> None:
        """A crash or node failure kills a job mid-flight at ``t``: the
        pre-charged energy of the unrun tail is refunded (the burned
        segment stays charged — that work *was* done, then lost), its
        units free immediately, and the job rolls back to its last
        checkpoint (``frac0``) with a restart obligation.  The caller
        decides retry-or-lost and owns the clock advance ordering."""
        assert rj in self.running
        self.advance(t)
        rec = rj.record
        if rj.preempted:
            # killed mid-checkpoint-write: the partial write is useless,
            # so refund its unwritten tail and fall back to the fraction
            # at the segment start (the write's snapshot never landed)
            scale = self.elastic.ckpt_power_scale if self.elastic else 1.0
            refund = rj.power * scale * (rj.end - t)
            self.ckpt_energy -= refund
            rec.ckpt_energy -= refund
        else:
            refund = rj.power * (rj.end - t)
        self.busy_energy -= refund
        rec.busy_energy -= refund
        rec.end = t
        rec.kind = "fail"
        rj.failed = True
        rj.end = t
        self.running.remove(rj)
        self.placement.release(rj.units, rj.domain)
        self.progress[rj.job] = rj.frac0
        self.needs_restart.add(rj.job)
        self.fault_kills += 1

    def drop_lost(self, job: str) -> None:
        """Retries exhausted: the job leaves the system for good."""
        self.progress.pop(job, None)
        self.needs_restart.discard(job)
        self.lost.append(job)

    def cancel_waiting(self, job: str) -> None:
        """Drop a waiting job that has never launched (control-plane
        cancel).  The caller is responsible for refusing jobs
        that are running, checkpointed or carrying elastic state — this
        only erases the queue entry and its arrival bookkeeping."""
        if job in self.progress or job in self.needs_restart:
            raise ValueError(f"{job}: cannot cancel a checkpointed job")
        if self._segments.get(job, 0):
            raise ValueError(f"{job}: cannot cancel after it has launched")
        self.waiting.remove(job)  # raises if not waiting
        self.arrival_of.pop(job, None)
        self._queued_at.pop(job, None)

    def evict(self, job: str) -> "MigrantState":
        """Detach a waiting job for migration; returns everything that must
        travel with it — original arrival, completed-work fraction, the
        restart obligation, and the per-job counters (segment index,
        checkpoint budget spent, last launched count) so the
        ``max_preempts`` bound and the resize history stay global, not
        per-node."""
        self.waiting.remove(job)
        restart = job in self.needs_restart
        self.needs_restart.discard(job)
        arrival = self.arrival_of.pop(job, 0.0)
        state = MigrantState(
            arrival=arrival,
            progress=self.progress.pop(job, 0.0),
            restart=restart,
            segment=self._segments.pop(job, 0),
            preempts=self.preempt_count.pop(job, 0),
            last_g=self._last_g.pop(job, None),
            last_f=self._last_f.pop(job, None),
            queued_at=self._queued_at.pop(job, arrival),
        )
        self.migrations_out += 1
        return state

    def absorb(self, job: str, t: float, state: "MigrantState") -> None:
        """A migrated job lands here (MIGRATE): waiting time keeps counting
        from its original submission; segment numbering, the checkpoint
        budget and the resize history continue where they left off."""
        self.advance(t)
        self.arrival_of[job] = state.arrival
        # waiting keeps counting from the DONOR's enqueue: queueing time
        # spent there plus the transit is genuine waiting, unlike the
        # running time a preempted job's requeue excludes
        self._queued_at[job] = state.queued_at
        if state.progress:
            self.progress[job] = state.progress
        if state.restart:
            self.needs_restart.add(job)
        if state.segment:
            self._segments[job] = state.segment
        if state.preempts:
            self.preempt_count[job] = state.preempts
        if state.last_g is not None:
            self._last_g[job] = state.last_g
        if state.last_f is not None:
            self._last_f[job] = state.last_f
        self.waiting.append(job)
        self.migrations_in += 1

    def result(self, *, charge_profiling: bool = False) -> ScheduleResult:
        """Finalize. ``self.t`` is the node's last completion (its makespan)."""
        prof_energy = 0.0
        if charge_profiling:
            charged = set()
            for r in self.records:
                if r.job not in charged:  # once per job, not per segment
                    charged.add(r.job)
                    prof_energy += self.truth[r.job].profiling_energy
        return ScheduleResult(
            policy=self.policy.name(),
            makespan=self.t,
            busy_energy=self.busy_energy,
            idle_energy=self.idle_unit_seconds * self.node.idle_power_per_unit,
            profiling_energy=prof_energy,
            records=self.records,
            decision_time_s=self.decision_time,
            decision_events=self.decision_events,
            resize_time_s=self.resize_time,
            migrate_time_s=self.migrate_time,
            preemptions=self.preemptions,
            migrations_in=self.migrations_in,
            migrations_out=self.migrations_out,
            ckpt_energy=self.ckpt_energy,
            resize_history=self.resize_history,
            freq_history=self.freq_history,
            job_crashes=self.job_crashes,
            node_failures=self.node_failures,
            fault_kills=self.fault_kills,
            fault_retries=self.fault_retries,
            lost_jobs=list(self.lost),
        )


def _auto_max_events(n_stream: int, floor: int = 100_000) -> int:
    """Deadlock-guard cap that scales with workload size: every job costs a
    bounded number of events (preemption adds at most 3·max_preempts), so
    50·|stream| with a generous floor never false-trips on large sweeps
    while still catching true deadlocks."""
    return max(floor, 50 * n_stream)


def simulate(
    policy,
    node: Node,
    truth: Dict[str, JobProfile],
    *,
    queue: Optional[Sequence[str]] = None,
    arrivals: Optional[Sequence[Tuple[float, str]]] = None,
    charge_profiling: bool = False,
    slowdown_model=None,
    max_events: Optional[int] = None,
    elastic: Optional[ElasticConfig] = None,
    forecast=None,
    faults: Optional[FaultConfig] = None,
) -> ScheduleResult:
    """Run ``policy`` over the workload; returns exact energy/makespan.

    ``arrivals`` — optional online stream of ``(time, job)`` pairs; jobs
    with time ≤ 0 are waiting at t=0 (identical to passing them in
    ``queue``).  Without it every ``queue`` job waits at t=0, which is the
    paper's static single-window setup.

    ``slowdown_model(job, g, co_running) -> factor ≥ 1`` optionally models
    residual interference.  A model with ``domain_aware = True`` (e.g.
    ``repro_torch.core.perfmodel.DomainInterferenceModel``) additionally receives
    the actual placement (units, home domain, running set) so the penalty
    keys on real domain co-residency instead of the co-runner count.

    ``elastic`` — optional ``ElasticConfig`` enabling preemption/
    checkpoint-restart and (with an elastic-aware policy) GPU resizing on
    completion events; ``None`` reproduces the static loop bit-exactly.

    ``forecast`` — optional ``ForecastConfig`` (repro_torch.core.forecast):
    on a single node this wires online perf-model refinement (COMPLETE
    events feed the posterior, the policy's estimates shrink toward
    observed runtimes) and burst-conditioned resize bias; queueing wait
    forecasts and migration are cluster-level and stay inert here.
    ``None`` (or an all-off config) never builds a plane — bit-identical
    schedules.

    ``faults`` — optional ``FaultConfig`` (repro_torch.core.faults): seeded
    node failures, job crashes, and stragglers with checkpoint-rollback
    recovery and capped-backoff retries; ``None`` (or an all-off config)
    rides the exact pre-fault loop bit-identically.

    ``max_events`` defaults to ``max(100_000, 50·|stream|)`` so large
    sweeps never false-trip the deadlock guard.
    """
    if arrivals is None:
        stream = [(0.0, j) for j in (queue if queue is not None else sorted(truth))]
    else:
        if queue is not None:
            raise ValueError("pass either queue or arrivals, not both")
        stream = sorted(arrivals, key=lambda a: a[0])
    names = [j for _, j in stream]
    if len(set(names)) != len(names):
        raise ValueError("job names must be unique across the workload")
    if max_events is None:
        max_events = _auto_max_events(len(stream))

    injector = (
        FaultInjector(faults) if faults is not None and faults.enabled else None
    )
    sim = NodeSim(node, truth, policy, slowdown_model=slowdown_model,
                  elastic=elastic, faults=faults, fault_injector=injector)

    # forecast plane: never built on the default path, so forecast=None
    # rides the exact plane-free loop
    plane = None
    if forecast is not None and forecast.enabled:
        from repro_torch.core.forecast import ForecastPlane

        plane = ForecastPlane(forecast, {"": node.units}, elastic=elastic)
        if hasattr(policy, "attach_forecast"):
            policy.attach_forecast(plane, "")

    def arrive(job: str, t: float) -> str:
        sim.arrive(job, t)
        if plane is not None:
            plane.on_arrival(t)
        return ""

    loop = EventLoop(
        {"": sim},
        arrive=arrive,
        max_events=max_events,
        cap_msg="simulator event cap exceeded (policy deadlock?)",
        elastic=elastic,
        faults=faults,
        fault_injector=injector,
        on_launch=(plane.on_launch if plane is not None else None),
        on_complete=(plane.on_complete if plane is not None else None),
    )
    for at, job in stream:
        if at <= 0.0:
            sim.arrival_of[job] = 0.0
            sim.waiting.append(job)
            if plane is not None:
                plane.on_arrival(0.0)
        else:
            loop.queue.push(at, EVT_ARRIVAL, job)
    loop.run()

    if sim.waiting:
        raise RuntimeError(
            f"policy {policy.name()} finished with waiting jobs {sim.waiting}"
        )
    result = sim.result(charge_profiling=charge_profiling)
    if plane is not None:
        result.forecast = plane.summary()
    return result

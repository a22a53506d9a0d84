"""Core scheduler datatypes.

The scheduler sees *estimates* (``ModeEstimate`` from Phase I); the
simulator and the Oracle see *ground truth* (``JobProfile``).  Keeping the
two separated is what makes the online-vs-oracle comparison honest.

Units ("GPUs" in the paper) are the node's allocation granularity: one GPU
on a 4-GPU node.  Twin of ``repro.core.types``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class JobProfile:
    """Ground truth for one application (simulator/oracle only).

    ``freq_time``/``freq_power`` are per-frequency-level multipliers on the
    count-indexed runtime/power curves (DVFS third axis): level 0 is the
    base clock and both multipliers are 1.0 there.  Empty dicts mean the
    profile has a single frequency level — every ``*_at(g, f=0)`` helper
    collapses to the count-only curves, which keeps pre-DVFS behavior
    bit-identical.
    """

    name: str
    runtime: Dict[int, float]  # unit-count g -> solo execution seconds
    busy_power: Dict[int, float]  # g -> total active power (W) of the job
    dram_util: Dict[int, float] = field(default_factory=dict)  # profiling signal
    profiling_energy: float = 0.0  # one-time Phase-I cost (J)
    profiling_time: float = 0.0  # s of debug-node time (amortization analysis)
    freq_time: Dict[int, float] = field(default_factory=dict)  # f -> t multiplier
    freq_power: Dict[int, float] = field(default_factory=dict)  # f -> P multiplier

    @property
    def feasible_counts(self) -> Tuple[int, ...]:
        return tuple(sorted(self.runtime))

    @property
    def freq_levels(self) -> Tuple[int, ...]:
        return tuple(sorted(self.freq_time)) if self.freq_time else (0,)

    def optimal_count(self, limit: Optional[int] = None) -> int:
        """Performance-optimal count, optionally capped at ``limit`` units
        (heterogeneous cluster nodes may be smaller than every mode)."""
        counts = [g for g in self.runtime if limit is None or g <= limit]
        if not counts:
            raise ValueError(f"{self.name}: no feasible mode fits {limit} units")
        return min(counts, key=lambda g: (self.runtime[g], g))

    def energy(self, g: int) -> float:
        return self.runtime[g] * self.busy_power[g]

    def runtime_at(self, g: int, f: int = 0) -> float:
        """Solo runtime at count ``g``, frequency level ``f``."""
        t = self.runtime[g]
        return t if not self.freq_time else t * self.freq_time[f]

    def power_at(self, g: int, f: int = 0) -> float:
        """Busy power at count ``g``, frequency level ``f``."""
        p = self.busy_power[g]
        return p if not self.freq_power else p * self.freq_power[f]

    def energy_at(self, g: int, f: int = 0) -> float:
        return self.runtime_at(g, f) * self.power_at(g, f)


@dataclass(frozen=True)
class ModeEstimate:
    """Phase-I output for one (job, unit-count, frequency-level) mode.

    ``f`` is the DVFS frequency level (0 = base clock); profiles with a
    single level only ever produce ``f=0`` modes, which is the pre-DVFS
    mode set exactly.
    """

    g: int
    t_norm: float  # predicted runtime / predicted best runtime (>= 1)
    p_bar: float  # measured average busy power (W)
    e_norm: float  # normalized energy proxy Ẽ = P̄ · T̂norm, min-normalized
    f: int = 0  # DVFS frequency level (0 = base clock)


@dataclass(frozen=True)
class JobSpec:
    """What the scheduler knows about a waiting job."""

    name: str
    modes: Tuple[ModeEstimate, ...]  # τ-filtered happens in the policy

    def __post_init__(self):
        # precomputed (g, f) -> mode map: mode() sits on the resize hot
        # path and the joint DVFS mode set is 4-8x the count-only one
        object.__setattr__(
            self, "_by_gf", {(m.g, m.f): m for m in self.modes}
        )

    def mode(self, g: int, f: int = 0) -> ModeEstimate:
        m = self._by_gf.get((g, f))
        if m is None:
            raise KeyError((self.name, g, f))
        return m


@dataclass(frozen=True)
class Launch:
    """One scheduling decision element: run ``job`` on ``g`` units at
    frequency level ``f``."""

    job: str
    g: int
    f: int = 0


@dataclass
class RunningJob:
    job: str
    g: int
    units: Tuple[int, ...]
    domain: int
    start: float
    end: float
    power: float
    f: int = 0  # DVFS frequency level the segment runs at
    factor: float = 1.0  # interference slowdown applied to this segment
    # elastic substrate state (repro_torch.core.events); inert for static runs
    frac0: float = 0.0  # work fraction completed before this segment
    restart: float = 0.0  # restart overhead charged at this segment's start
    preempted: bool = False  # a PREEMPT event supersedes this job's COMPLETE
    failed: bool = False  # killed by a fault; COMPLETE/PREEMPT become stale
    frac_ckpt: float = 0.0  # work fraction frozen at the checkpoint decision
    record: Optional["JobRecord"] = field(default=None, compare=False, repr=False)

    def frac_at(self, t: float) -> float:
        """Completed-work fraction at time ``t`` (useful work excludes the
        restart overhead at the segment head)."""
        useful = self.end - self.start - self.restart
        if useful <= 0.0:
            return 1.0
        elapsed = min(max(t - self.start - self.restart, 0.0), useful)
        return self.frac0 + (1.0 - self.frac0) * elapsed / useful


@dataclass
class NodeView:
    """Scheduler-visible node state at a scheduling event."""

    t: float
    total_units: int  # M
    domains: int  # K
    free_units: int
    running: List[RunningJob]
    free_map: List[bool] = field(default_factory=list)  # per-unit freedom
    domain_jobs: List[int] = field(default_factory=list)  # per-domain occupancy
    dead_units: int = 0  # units lost to a node failure (fault plane)

    @property
    def alive_units(self) -> int:
        """Schedulable capacity: Eq. (1)'s M on a degraded node."""
        return self.total_units - self.dead_units

    @property
    def occupied_domains(self) -> int:
        """Isolation domains hosting at least one job.  Falls back to the
        running-job count when the view carries no occupancy map (older
        callers); with correct labeling the two coincide."""
        if self.domain_jobs:
            return sum(1 for c in self.domain_jobs if c)
        return len(self.running)

    @property
    def free_domains(self) -> int:
        return self.domains - self.occupied_domains


@dataclass
class JobRecord:
    job: str
    g: int
    start: float
    end: float
    busy_energy: float
    arrival: float = 0.0  # when the job entered the system (0 = static queue)
    node: str = ""  # cluster node id; "" for single-node simulate()
    domain: int = -1  # isolation domain the job was homed in (-1 = unknown)
    segment: int = 0  # run segment index (a preempted job has several)
    kind: str = "run"  # "run" = completed, "ckpt" = checkpointed, "fail" = killed
    ckpt_energy: float = 0.0  # checkpoint-write energy inside busy_energy
    queued: float = 0.0  # when this segment entered a waiting queue
    f: int = 0  # DVFS frequency level the segment ran at

    @property
    def wait(self) -> float:
        """Genuine queueing time before this segment started.  For the
        first segment ``queued`` equals ``arrival``; a resumed/migrated
        segment measures from its re-enqueue instant, so preempted jobs do
        not count their own running time as waiting."""
        return self.start - max(self.queued, self.arrival)


@dataclass
class ScheduleResult:
    policy: str
    makespan: float
    busy_energy: float
    idle_energy: float
    profiling_energy: float
    records: List[JobRecord]
    decision_time_s: float = 0.0  # total wall-clock spent inside the policy
    decision_events: int = 0
    resize_time_s: float = 0.0  # wall-clock inside the elastic resize phase
    migrate_time_s: float = 0.0  # wall-clock inside the migration phase
    # elastic substrate accounting (all zero/empty for static runs)
    preemptions: int = 0  # checkpoints taken on this node
    migrations_in: int = 0  # jobs that arrived via MIGRATE events
    migrations_out: int = 0  # jobs this node handed to another node
    ckpt_energy: float = 0.0  # checkpoint-write energy (inside busy_energy)
    resize_history: Dict[str, List[Tuple[float, int, int]]] = field(
        default_factory=dict
    )  # job -> [(relaunch t, g_old, g_new)]
    freq_history: Dict[str, List[Tuple[float, int, int]]] = field(
        default_factory=dict
    )  # job -> [(relaunch t, f_old, f_new)] — DVFS retunes across segments
    # forecast-plane observability (repro_torch.core.forecast; empty when
    # the run had no plane): final rate estimates, burst-gate state/flips,
    # migrations vetoed by the risk penalty, posterior feed counts
    forecast: Dict[str, float] = field(default_factory=dict)
    # fault-plane accounting (repro_torch.core.faults; all zero without faults)
    job_crashes: int = 0  # JOB_FAIL kills on this node
    node_failures: int = 0  # NODE_FAIL events this node suffered
    fault_kills: int = 0  # jobs killed mid-flight (crashes + node failures)
    fault_retries: int = 0  # backoff retries queued from this node
    lost_jobs: List[str] = field(default_factory=list)  # retries exhausted

    @property
    def total_energy(self) -> float:
        return self.busy_energy + self.idle_energy + self.profiling_energy

    @property
    def resizes(self) -> int:
        return sum(len(v) for v in self.resize_history.values())

    @property
    def retunes(self) -> int:
        """Pure frequency retunes (relaunches that changed f, not g)."""
        return sum(len(v) for v in self.freq_history.values())

    @property
    def edp(self) -> float:
        return self.total_energy * self.makespan


@dataclass
class ClusterResult:
    """Rollup of per-node ``ScheduleResult``s for one cluster run.

    Each node integrates its own idle energy up to its *local* makespan
    (last completion on that node); ``tail_idle_energy`` is the extra idle
    drawn by nodes that drain early, up to the cluster makespan — so
    Σ busy + Σ idle + tail covers exactly Σ_n M_n · makespan unit-seconds.
    """

    policy: str
    per_node: Dict[str, ScheduleResult]
    makespan: float
    tail_idle_energy: float = 0.0
    # forecast-plane observability (repro_torch.core.forecast); empty without one
    forecast: Dict[str, float] = field(default_factory=dict)
    # fleet fragmentation gauge: time_avg / peak / final
    # unusable-GPU fraction given the pending mix, à la Lettich et al.
    fragmentation: Dict[str, float] = field(default_factory=dict)
    # per-phase decision wall-clock breakdown: "dispatch"
    # (routing), "launch" (launch scoring inside on_event), "resize"
    # (elastic resize phase), "migrate" (migration phase), "stage"
    # (cross-node batched kernel staging)
    decision_phases: Dict[str, float] = field(default_factory=dict)

    @property
    def busy_energy(self) -> float:
        return sum(r.busy_energy for r in self.per_node.values())

    @property
    def idle_energy(self) -> float:
        return (
            sum(r.idle_energy for r in self.per_node.values())
            + self.tail_idle_energy
        )

    @property
    def profiling_energy(self) -> float:
        return sum(r.profiling_energy for r in self.per_node.values())

    @property
    def total_energy(self) -> float:
        return self.busy_energy + self.idle_energy + self.profiling_energy

    @property
    def edp(self) -> float:
        return self.total_energy * self.makespan

    @property
    def decision_time_s(self) -> float:
        return sum(r.decision_time_s for r in self.per_node.values())

    @property
    def decision_events(self) -> int:
        return sum(r.decision_events for r in self.per_node.values())

    @property
    def preemptions(self) -> int:
        return sum(r.preemptions for r in self.per_node.values())

    @property
    def migrations(self) -> int:
        """Completed migrations (arrivals on the receiving node)."""
        return sum(r.migrations_in for r in self.per_node.values())

    @property
    def resizes(self) -> int:
        return sum(r.resizes for r in self.per_node.values())

    @property
    def retunes(self) -> int:
        return sum(r.retunes for r in self.per_node.values())

    @property
    def ckpt_energy(self) -> float:
        return sum(r.ckpt_energy for r in self.per_node.values())

    @property
    def job_crashes(self) -> int:
        return sum(r.job_crashes for r in self.per_node.values())

    @property
    def node_failures(self) -> int:
        return sum(r.node_failures for r in self.per_node.values())

    @property
    def fault_kills(self) -> int:
        return sum(r.fault_kills for r in self.per_node.values())

    @property
    def fault_retries(self) -> int:
        return sum(r.fault_retries for r in self.per_node.values())

    @property
    def lost_jobs(self) -> List[str]:
        return sorted(
            j for r in self.per_node.values() for j in r.lost_jobs
        )

    @property
    def records(self) -> List[JobRecord]:
        out = [rec for r in self.per_node.values() for rec in r.records]
        out.sort(key=lambda rec: (rec.start, rec.job))
        return out

    @property
    def mean_wait(self) -> float:
        recs = self.records
        return sum(r.wait for r in recs) / len(recs) if recs else 0.0

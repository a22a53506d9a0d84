"""Durable scheduler control plane.

Everything below ``SchedulerService`` is the batch machinery this repo
already had; this module turns it into a long-running *system*: a daemon
that accepts job submissions over a local API, tracks each job through a
strict lifecycle state machine, journals every input and every lifecycle
transition to an append-only JSONL file (``repro_torch.core.journal``), and —
after a crash — rebuilds its exact state by replaying the journal through
the deterministic event substrate (``repro_torch.core.events``).

Layers:

  * **state machine** — ``SUBMITTED → {ADMITTED, FAILED}``, ``ADMITTED →
    {QUEUED, CANCELLED}``, ``QUEUED → {RUNNING, MIGRATING, CANCELLED}``,
    ``RUNNING → {DONE, PREEMPTED, FAILED, FAILED_RETRYING}``,
    ``PREEMPTED/MIGRATING → QUEUED``, ``FAILED_RETRYING → {QUEUED,
    FAILED}`` (the fault plane's crash-retry leg, repro_torch.core.faults);
    ``DONE``/``CANCELLED``/``FAILED`` are terminal.  Any other
    transition raises ``IllegalTransition`` — a lifecycle bug must never
    be absorbed silently.
  * **admission control** — ``AdmissionGate`` observes every submit
    instant through ``ArrivalRateEWMA`` (repro_torch.core.arrivals) and rejects
    at the edge: a hard pending-queue cap, plus a burst gate that sheds
    load when the short-horizon arrival rate runs ahead of the baseline
    while the backlog is already deep — the same signal the forecast
    plane's hysteresis gates on, applied at the API boundary.
  * **backend protocol** — the service drives anything exposing
    ``submit/cancel/advance/now/result/set_transition_cb``;
    ``ClusterBackend`` adapts ``Cluster.open_run`` (repro_torch.core.cluster),
    and a single node is just a one-node cluster (the substrate makes the
    two bit-identical, locked in tests/test_cluster.py).  A dry-run
    adapter over real nodes plugs in behind the same protocol.  With
    ``EcoSched(engine="torch")`` node policies every launch decision of
    the live run reduces on the ``score_reduce`` kernels, same-instant
    cross-node bursts on ``score_reduce_batch``, and elastic resize
    tables on ``score_reduce_multi``.
  * **durability** — write-ahead journaling of inputs (submit / cancel /
    advance), write-behind journaling of lifecycle transitions.  The
    whole simulation stack is deterministic, so the input records are a
    redo log: ``recover`` replays them through a fresh backend, *verifies*
    the journaled transitions are a prefix of the regenerated stream
    (divergence raises ``RecoveryError`` — a wrong-config or tampered
    journal must not silently produce a different schedule), appends the
    transitions the crash lost, and resumes accepting requests.  The
    crash-parity property — SIGKILL at any journal offset, restart,
    replay, and the final schedule is bit-identical to the uninterrupted
    run — is property-tested in tests/test_torch_service.py.

``serve`` runs the service over a unix-domain socket speaking JSON lines
(one request object per line, one response per line); ``repro_torch.cli`` is
the matching command-line client and daemon launcher.  Requests are
handled strictly sequentially — concurrency would reorder journal inputs
and break replay determinism, and a scheduler tick is microseconds.

Twin of ``repro.core.service``.  The journal it writes is byte for byte
the reference's on the same inputs, and ``ClusterBackend.describe()`` --
the journal header's backend identity, which gates replay -- is the
same string, so a journal written by either package recovers in the
other (tests/test_torch_service.py).
"""
from __future__ import annotations

import os
import socket
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.arrivals import ArrivalRateEWMA
from repro_torch.core.cluster import Cluster, ClusterRun
from repro_torch.core.events import ElasticConfig
from repro_torch.core.faults import FaultConfig
from repro_torch.core.forecast import ForecastConfig
from repro_torch.core.journal import (
    JOURNAL_VERSION,
    Journal,
    JournalError,
    chain_hash,
)

# --------------------------------------------------------------------------
# Job lifecycle state machine
# --------------------------------------------------------------------------

SUBMITTED = "SUBMITTED"
ADMITTED = "ADMITTED"
QUEUED = "QUEUED"
RUNNING = "RUNNING"
PREEMPTED = "PREEMPTED"
MIGRATING = "MIGRATING"
FAILED_RETRYING = "FAILED_RETRYING"
DONE = "DONE"
CANCELLED = "CANCELLED"
FAILED = "FAILED"

JOB_STATES = (
    SUBMITTED, ADMITTED, QUEUED, RUNNING, PREEMPTED, MIGRATING,
    FAILED_RETRYING, DONE, CANCELLED, FAILED,
)

TRANSITIONS: Dict[str, frozenset] = {
    SUBMITTED: frozenset({ADMITTED, FAILED}),
    ADMITTED: frozenset({QUEUED, CANCELLED}),
    QUEUED: frozenset({RUNNING, MIGRATING, CANCELLED}),
    RUNNING: frozenset({DONE, PREEMPTED, FAILED, FAILED_RETRYING}),
    PREEMPTED: frozenset({QUEUED}),
    MIGRATING: frozenset({QUEUED}),
    FAILED_RETRYING: frozenset({QUEUED, FAILED}),
    DONE: frozenset(),
    CANCELLED: frozenset(),
    FAILED: frozenset(),
}

# which lifecycle event moves a job into which state (substrate feed)
_EVENT_STATE = {
    "queued": QUEUED,
    "launch": RUNNING,
    "done": DONE,
    "ckpt": PREEMPTED,
    "requeue": QUEUED,
    "migrate": MIGRATING,
    "fail": FAILED_RETRYING,
    "retry": QUEUED,
    "lost": FAILED,
}

# states that count against the pending-queue admission cap
_PENDING = frozenset({ADMITTED, QUEUED, PREEMPTED, MIGRATING, FAILED_RETRYING})


class IllegalTransition(ValueError):
    """A lifecycle transition outside ``TRANSITIONS``."""


@dataclass
class JobInfo:
    """One job's control-plane view: current state + full history."""

    name: str
    app: str
    state: str = SUBMITTED
    submit_t: float = 0.0
    node: str = ""  # last node the job was queued/launched on
    reason: str = ""  # FAILED detail (admission rejection, ...)
    launches: int = 0
    history: List[Tuple[float, str]] = field(default_factory=list)

    def advance(self, state: str, t: float) -> None:
        if state not in TRANSITIONS:
            raise IllegalTransition(f"{self.name}: unknown state {state!r}")
        if state not in TRANSITIONS[self.state]:
            raise IllegalTransition(
                f"{self.name}: illegal transition {self.state} -> {state}"
            )
        self.state = state
        self.history.append((t, state))

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "app": self.app,
            "state": self.state,
            "submit_t": self.submit_t,
            "node": self.node,
            "reason": self.reason,
            "launches": self.launches,
            "history": [[t, s] for t, s in self.history],
        }


# --------------------------------------------------------------------------
# Admission control (API edge)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class AdmissionConfig:
    """Edge admission knobs.

    ``max_pending`` is the hard backlog cap (ADMITTED/QUEUED/PREEMPTED/
    MIGRATING jobs); ``burst_limit`` sheds load earlier: once the backlog
    exceeds ``burst_pending``, a submit is rejected while the
    short-horizon arrival rate exceeds ``burst_limit`` × the baseline —
    the ``ArrivalRateEWMA`` burst signal applied at the API boundary, so
    a sweep submitted mid-burst queues up somewhere that is not the
    scheduler's own admission queue.  ``burst_limit=0`` disables the
    burst gate; ``max_pending=0`` disables the cap.
    """

    max_pending: int = 256
    burst_limit: float = 3.0
    burst_pending: int = 16
    ewma_horizon: int = 8
    baseline_horizon: int = 64

    def to_dict(self) -> Dict:
        return {
            "max_pending": self.max_pending,
            "burst_limit": self.burst_limit,
            "burst_pending": self.burst_pending,
            "ewma_horizon": self.ewma_horizon,
            "baseline_horizon": self.baseline_horizon,
        }


class AdmissionGate:
    """Stateful admission decision.  ``admit`` must be called for *every*
    submit attempt (accepted or not): the EWMA has to see the full
    arrival process, and replay calls it in the same order so the
    estimator state is reproduced exactly."""

    def __init__(self, cfg: AdmissionConfig):
        self.cfg = cfg
        self.rate = ArrivalRateEWMA(cfg.ewma_horizon, cfg.baseline_horizon)
        self.rejected = 0

    def admit(self, t: float, pending: int) -> Tuple[bool, str]:
        self.rate.observe(t)
        cfg = self.cfg
        if cfg.max_pending and pending >= cfg.max_pending:
            self.rejected += 1
            return False, f"queue full ({pending} pending)"
        if (
            cfg.burst_limit
            and pending >= cfg.burst_pending
            and self.rate.burst_factor() >= cfg.burst_limit
        ):
            self.rejected += 1
            return False, (
                f"burst shed (rate {self.rate.burst_factor():.2f}x baseline, "
                f"{pending} pending)"
            )
        return True, ""


# --------------------------------------------------------------------------
# Backend protocol + the simulator adapter
# --------------------------------------------------------------------------


class ClusterBackend:
    """Drop-in simulation backend: ``Cluster.open_run`` behind the
    service's backend protocol.  A single node is a one-node cluster.

    The backend owns one live ``ClusterRun``; the service drives it with
    ``submit``/``cancel``/``advance`` and receives lifecycle transitions
    through the callback installed with ``set_transition_cb``.
    """

    def __init__(
        self,
        cluster: Cluster,
        *,
        apps: Optional[Sequence[str]] = None,
        elastic: Optional[ElasticConfig] = None,
        forecast: Optional[ForecastConfig] = None,
        faults: Optional[FaultConfig] = None,
        fast_status: bool = True,
    ):
        if apps is None:
            apps = sorted(
                {app for s in cluster.specs for app in cluster.truth_for(s)}
            )
        self._cb: Optional[Callable] = None
        self.faults = faults if (faults is not None and faults.enabled) else None
        self.run: ClusterRun = cluster.open_run(
            apps=apps,
            elastic=elastic,
            forecast=forecast,
            faults=faults,
            fast_status=fast_status,
            on_transition=self._emit,
        )

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
        if self._cb is not None:
            self._cb(event, t, job, node, g, end, f)

    def set_transition_cb(self, cb: Optional[Callable]) -> None:
        self._cb = cb

    @property
    def now(self) -> float:
        return self.run.now

    def describe(self) -> str:
        nodes = ",".join(
            f"{s.name}:{s.units}u{s.domains}d" for s in self.run.specs
        )
        # DVFS-enabled systems journal a distinct identity: a journal
        # written with frequency ladders must not replay through a
        # base-clock-only backend (and vice versa)
        levels = max(
            (
                len(prof.freq_levels)
                for truth in self.run.app_truth.values()
                for prof in truth.values()
            ),
            default=1,
        )
        suffix = f"/f{levels}" if levels > 1 else ""
        # the fault timeline is part of the backend identity: a journal
        # written with failures injected must not replay fault-free
        fsuffix = (
            f"/faults:{self.faults.signature()}" if self.faults is not None else ""
        )
        return f"cluster[{nodes}]/{self.run.dispatcher.name()}{suffix}{fsuffix}"

    def can_run(self, app: str) -> bool:
        # admission consults *healthy* capacity: whether an app is
        # schedulable at all must not flap with transient node failures
        # (and replayed submit decisions must be time-independent)
        ai = self.run.state.app_index.get(app)
        return ai is not None and bool(self.run._fits_healthy[:, ai].any())

    def submit(self, name: str, app: str, t: float) -> None:
        self.run.submit(name, app, t)

    def cancel(self, name: str) -> bool:
        return self.run.cancel(name)

    def advance(self, until: Optional[float]) -> None:
        if until is None:
            self.run.run_to_completion()
        else:
            self.run.run_until(until)

    def result(self):
        return self.run.finalize()


# --------------------------------------------------------------------------
# The service
# --------------------------------------------------------------------------


class RecoveryError(JournalError):
    """Journal replay diverged from the journaled transitions (wrong
    backend/config for this journal, tampering, or lost determinism)."""


class SchedulerService:
    """The daemon core: state machine + admission + journal + recovery.

    ``make_backend`` must build a *fresh, deterministic* backend each
    call — recovery replays the journal through a new instance, so any
    state smuggled in from outside the journal breaks crash parity.

    ``compact_every_bytes`` / ``compact_max_age_s`` arm automatic journal
    compaction: after each mutating operation, if the
    journal has grown past the byte threshold, or the oldest un-compacted
    transition is older than the age threshold (wall-clock), the folded
    ``Journal.snapshot`` runs in place.  Compaction never changes what
    replay reconstructs, so the wall-clock trigger does not break
    determinism — it only bounds how much of the event tail a recovery
    has to re-verify record-by-record.  0 disables either trigger.
    """

    def __init__(
        self,
        make_backend: Callable[[], ClusterBackend],
        *,
        journal_path: Optional[str] = None,
        admission: Optional[AdmissionConfig] = None,
        fsync: bool = False,
        compact_every_bytes: int = 0,
        compact_max_age_s: float = 0.0,
    ):
        self.make_backend = make_backend
        self.compact_every_bytes = int(compact_every_bytes)
        self.compact_max_age_s = float(compact_max_age_s)
        self.auto_compactions = 0
        self._evts_since_snap = 0
        self._snap_age_t = time.monotonic()
        self.admission = admission or AdmissionConfig()
        self.gate = AdmissionGate(self.admission)
        self.jobs: Dict[str, JobInfo] = {}
        self.backend = make_backend()
        self.backend.set_transition_cb(self._on_transition)
        self._clock = 0.0  # monotone input-time watermark
        self._replaying = False
        self._regen: List[Dict] = []
        self.replay_divergences = 0
        self.journal: Optional[Journal] = None
        if journal_path is not None:
            records = (
                Journal.read(journal_path)
                if os.path.exists(journal_path)
                else []
            )
            if records:
                self._recover(records, journal_path)
            else:
                if os.path.exists(journal_path) and os.path.getsize(journal_path):
                    # the crash tore the header line itself: nothing is
                    # recoverable, start the journal over from scratch
                    os.truncate(journal_path, 0)
                self.journal = Journal(journal_path, fsync=fsync)
                self.journal.append(self._header())

    # -- journal plumbing ----------------------------------------------------

    def _header(self) -> Dict:
        return {
            "k": "hdr",
            "v": JOURNAL_VERSION,
            "backend": self.backend.describe(),
            "admission": self.admission.to_dict(),
        }

    def _append(self, rec: Dict) -> None:
        if self.journal is not None:
            self.journal.append(rec)
            if rec.get("k") == "evt":
                if self._evts_since_snap == 0:
                    self._snap_age_t = time.monotonic()  # oldest un-compacted
                self._evts_since_snap += 1

    def _maybe_compact(self) -> None:
        """Run the folded snapshot when either auto-compaction trigger is
        due.  Called after each mutating operation completes — never
        mid-operation, so the journal is quiescent (every write-ahead
        input has its write-behind transitions flushed behind it)."""
        if self.journal is None or self._evts_since_snap == 0:
            return
        due = bool(
            self.compact_every_bytes
            and self.journal.size() >= self.compact_every_bytes
        ) or bool(
            self.compact_max_age_s
            and time.monotonic() - self._snap_age_t >= self.compact_max_age_s
        )
        if due:
            self.journal.snapshot()
            self.auto_compactions += 1
            self._evts_since_snap = 0

    # -- lifecycle transitions (substrate feed) ------------------------------

    def _on_transition(
        self,
        event: str,
        t: float,
        job: str,
        node: str,
        g: int,
        end: float,
        f: int = 0,
    ) -> None:
        rec = {
            "k": "evt", "e": event, "t": t, "job": job,
            "node": node, "g": int(g), "end": end, "f": int(f),
        }
        if self._replaying:
            self._regen.append(rec)
        else:
            self._append(rec)
        info = self.jobs[job]
        info.advance(_EVENT_STATE[event], t)
        if node:
            info.node = node
        if event == "launch":
            info.launches += 1
        elif event == "lost":
            info.reason = "retries exhausted"

    # -- operations (each journals write-ahead, then applies) ----------------

    def _clamp(self, t: Optional[float]) -> float:
        t_eff = self._clock if t is None else max(float(t), self._clock)
        t_eff = max(t_eff, self.backend.now)
        self._clock = t_eff
        return t_eff

    def submit(
        self, name: str, app: str, t: Optional[float] = None
    ) -> Dict:
        if not name or not app:
            return {"ok": False, "error": "submit needs a name and an app"}
        if name in self.jobs:
            # idempotent: a client retrying after a daemon crash must not
            # double-submit; the journaled attempt already decided
            return {"ok": True, "dup": True, "job": self.jobs[name].to_dict()}
        t_eff = self._clamp(t)
        pending = sum(1 for j in self.jobs.values() if j.state in _PENDING)
        if not self.backend.can_run(app):
            ok, reason = False, f"no node can run app {app!r}"
            self.gate.admit(t_eff, pending)  # the EWMA still sees the attempt
        else:
            ok, reason = self.gate.admit(t_eff, pending)
        self._append(
            {
                "k": "sub", "t": t_eff, "name": name, "app": app,
                "ok": ok, "reason": reason,
            }
        )
        self._apply_submit(t_eff, name, app, ok, reason)
        self._maybe_compact()
        return {"ok": ok, "reason": reason, "job": self.jobs[name].to_dict()}

    def _apply_submit(
        self, t: float, name: str, app: str, ok: bool, reason: str
    ) -> None:
        info = JobInfo(name=name, app=app, submit_t=t)
        info.history.append((t, SUBMITTED))
        self.jobs[name] = info
        if ok:
            info.advance(ADMITTED, t)
            self.backend.submit(name, app, t)
        else:
            info.reason = reason
            info.advance(FAILED, t)

    def cancel(self, name: str) -> Dict:
        info = self.jobs.get(name)
        if info is None:
            return {"ok": False, "error": f"unknown job {name!r}"}
        # deterministic decision: only never-launched backlog is cancellable
        ok = info.state in (ADMITTED, QUEUED) and info.launches == 0
        self._append({"k": "cxl", "name": name, "ok": ok})
        applied = self._apply_cancel(name, ok)
        if ok and not applied:  # pragma: no cover - state-machine invariant
            raise RecoveryError(
                f"{name}: backend refused a cancel the state machine allowed"
            )
        self._maybe_compact()
        return {
            "ok": ok,
            "reason": "" if ok else f"not cancellable in state {info.state}",
            "job": info.to_dict(),
        }

    def _apply_cancel(self, name: str, ok: bool) -> bool:
        if not ok:
            return False
        applied = self.backend.cancel(name)
        if applied:
            self.jobs[name].advance(CANCELLED, max(self._clock, self.backend.now))
        return applied

    def advance(self, until: Optional[float] = None) -> Dict:
        until_eff = None if until is None else self._clamp(until)
        self._append({"k": "adv", "until": until_eff})
        self.backend.advance(until_eff)
        self._maybe_compact()
        return {"ok": True, "now": self.backend.now, "stats": self._counts()}

    # -- read-only operations ------------------------------------------------

    def status(self, name: str) -> Dict:
        info = self.jobs.get(name)
        if info is None:
            return {"ok": False, "error": f"unknown job {name!r}"}
        return {"ok": True, "job": info.to_dict()}

    def list_jobs(self) -> Dict:
        return {
            "ok": True,
            "jobs": [self.jobs[n].to_dict() for n in sorted(self.jobs)],
        }

    def _counts(self) -> Dict[str, int]:
        counts = {s: 0 for s in JOB_STATES}
        for j in self.jobs.values():
            counts[j.state] += 1
        return {s: c for s, c in counts.items() if c}

    def stats(self) -> Dict:
        return {
            "ok": True,
            "backend": self.backend.describe(),
            "now": self.backend.now,
            "clock": self._clock,
            "jobs": len(self.jobs),
            "counts": self._counts(),
            "admission": self.admission.to_dict(),
            "rejected": self.gate.rejected,
            "rate_short": self.gate.rate.rate(),
            "rate_baseline": self.gate.rate.baseline_rate(),
            "replay_divergences": self.replay_divergences,
            "journal": self.journal.path if self.journal else "",
            "journal_bytes": self.journal.size() if self.journal else 0,
            "auto_compactions": self.auto_compactions,
            "compact_every_bytes": self.compact_every_bytes,
            "compact_max_age_s": self.compact_max_age_s,
        }

    def compact(self) -> Dict:
        """Fold the journaled transition events into a snapshot record
        (``Journal.snapshot``): bounds journal growth for long-running
        daemons while keeping crash recovery bit-identical — replay still
        regenerates every folded event and verifies the snapshot's chained
        hash."""
        if self.journal is None:
            return {"ok": False, "error": "no journal configured"}
        folded = self.journal.snapshot()
        self._evts_since_snap = 0  # auto-compaction restarts from here
        return {"ok": True, "folded": folded, "journal": self.journal.path}

    def result(self) -> Dict:
        """Final schedule fingerprint; only meaningful after a full drain
        (``advance`` with no bound).  The keyed record list is the
        bit-identity object the crash-parity tests compare."""
        try:
            res = self.backend.result()
        except RuntimeError as exc:
            return {"ok": False, "error": str(exc)}
        return {
            "ok": True,
            "policy": res.policy,
            "makespan": res.makespan,
            "total_energy": res.total_energy,
            "edp": res.edp,
            "records": [
                [r.job, r.node, r.g, r.f, r.start, r.end] for r in res.records
            ],
        }

    # -- crash recovery ------------------------------------------------------

    def _recover(self, records: List[Dict], journal_path: str) -> None:
        """Replay the journaled inputs through the fresh backend, verify
        the journaled transitions prefix-match the regenerated stream,
        then append whatever transitions the crash lost."""
        hdr = records[0]
        if hdr.get("k") != "hdr":
            raise RecoveryError(f"{journal_path}: journal has no header")
        if hdr.get("v") != JOURNAL_VERSION:
            raise RecoveryError(
                f"{journal_path}: journal version {hdr.get('v')!r} != "
                f"{JOURNAL_VERSION}"
            )
        if hdr.get("backend") != self.backend.describe():
            raise RecoveryError(
                f"{journal_path}: journal was written by backend "
                f"{hdr.get('backend')!r}, this daemon runs "
                f"{self.backend.describe()!r}"
            )
        # a snap record (journal compaction) folds the first ``n``
        # transition events into a chained hash; replay regenerates them
        # and verifies the chain instead of comparing records
        snap_n, snap_sha = 0, ""
        if len(records) > 1 and records[1].get("k") == "snap":
            snap_n = int(records[1]["n"])
            snap_sha = str(records[1]["sha"])
        journaled = [r for r in records if r.get("k") == "evt"]
        self._replaying = True
        self._regen = []
        try:
            for rec in records[1:]:
                k = rec.get("k")
                if k in ("evt", "snap"):
                    continue
                elif k == "sub":
                    t = float(rec["t"])
                    self._clock = max(self._clock, t)
                    pending = sum(
                        1 for j in self.jobs.values() if j.state in _PENDING
                    )
                    # re-run the gate for its EWMA state; the *journaled*
                    # decision is the truth (a divergence means the gate
                    # config changed under the journal — count it)
                    ok_now, _ = self.gate.admit(t, pending)
                    if ok_now != rec["ok"]:
                        self.replay_divergences += 1
                    self._apply_submit(
                        t, rec["name"], rec["app"], rec["ok"],
                        rec.get("reason", ""),
                    )
                elif k == "cxl":
                    self._apply_cancel(rec["name"], rec["ok"])
                elif k == "adv":
                    until = rec["until"]
                    if until is not None:
                        self._clock = max(self._clock, float(until))
                    self.backend.advance(until)
                else:
                    raise RecoveryError(
                        f"{journal_path}: unknown record kind {k!r}"
                    )
        finally:
            self._replaying = False
        regen = self._regen
        self._regen = []
        seen = snap_n + len(journaled)
        if len(regen) < snap_n or chain_hash(regen[:snap_n]) != snap_sha:
            raise RecoveryError(
                f"{journal_path}: replay diverged from the snapshot chain "
                f"({snap_n} compacted transitions)"
            )
        if len(journaled) > len(regen) - snap_n or (
            regen[snap_n:seen] != journaled
        ):
            raise RecoveryError(
                f"{journal_path}: replay diverged from the journaled "
                f"transitions ({len(journaled)} journaled, "
                f"{len(regen) - snap_n} regenerated past the snapshot)"
            )
        # the journal verified: amputate any torn tail, reopen for append,
        # and complete the redo — transitions the crash lost are
        # regenerated deterministically
        Journal.repair(journal_path, records)
        self.journal = Journal(journal_path)
        for rec in regen[seen:]:
            self._append(rec)  # counts toward the auto-compaction triggers

    # -- request dispatch (the wire protocol) --------------------------------

    def handle(self, req: Dict) -> Dict:
        """One JSON request -> one JSON response (the socket protocol and
        the in-process test harness both call this)."""
        if not isinstance(req, dict):
            return {"ok": False, "error": "request must be a JSON object"}
        op = req.get("op")
        try:
            if op == "submit":
                return self.submit(
                    req.get("name", ""), req.get("app", ""), req.get("t")
                )
            if op == "cancel":
                return self.cancel(req.get("name", ""))
            if op == "status":
                return self.status(req.get("name", ""))
            if op == "jobs":
                return self.list_jobs()
            if op == "advance":
                return self.advance(req.get("until"))
            if op == "drain":
                return self.advance(None)
            if op == "stats":
                return self.stats()
            if op == "compact":
                return self.compact()
            if op == "result":
                return self.result()
            if op == "ping":
                return {"ok": True, "pong": True}
            if op == "shutdown":
                return {"ok": True, "shutdown": True}
            return {"ok": False, "error": f"unknown op {op!r}"}
        except (ValueError, RuntimeError) as exc:
            return {"ok": False, "error": f"{type(exc).__name__}: {exc}"}

    def close(self) -> None:
        if self.journal is not None:
            self.journal.close()


# --------------------------------------------------------------------------
# Unix-socket server (JSON lines)
# --------------------------------------------------------------------------


# longest request line the daemon will parse; anything beyond is
# answered with an error and drained, never buffered without bound
MAX_LINE = 1 << 20


def serve(
    service: SchedulerService, sock_path: str, *, read_timeout: float = 30.0
) -> None:
    """Serve ``service`` over a unix-domain socket until a ``shutdown``
    request (or KeyboardInterrupt).  One request line -> one response
    line; connections are handled strictly sequentially, which is what
    keeps the journal a total order of inputs.

    Hardened against misbehaving clients: malformed JSON and oversized
    lines (> ``MAX_LINE`` bytes) get an error response instead of killing
    the connection loop, and a client that connects but never sends a
    full line is dropped after ``read_timeout`` seconds — a stuck client
    must not wedge the (sequential) daemon forever."""
    import json

    if os.path.exists(sock_path):
        os.unlink(sock_path)  # stale socket from a killed daemon
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        srv.bind(sock_path)
        srv.listen(8)
        stop = False
        while not stop:
            conn, _ = srv.accept()
            try:
                with conn:
                    conn.settimeout(read_timeout)
                    rfile = conn.makefile("r", encoding="utf-8")
                    while True:
                        line = rfile.readline(MAX_LINE + 1)
                        if not line:
                            break
                        if len(line) > MAX_LINE:
                            # drain the rest of the oversized line so the
                            # stream stays framed, then reject it
                            while line and not line.endswith("\n"):
                                line = rfile.readline(MAX_LINE + 1)
                            resp = {"ok": False, "error": "request too large"}
                            conn.sendall(
                                (json.dumps(resp, sort_keys=True) + "\n").encode()
                            )
                            continue
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            req = json.loads(line)
                        except ValueError:
                            resp = {"ok": False, "error": "malformed JSON request"}
                        else:
                            resp = service.handle(req)
                        conn.sendall(
                            (json.dumps(resp, sort_keys=True) + "\n").encode()
                        )
                        if resp.get("shutdown"):
                            stop = True
                            break
            except OSError:
                # read timeout, reset, broken pipe: drop this client and
                # keep accepting — one bad connection must not take the
                # daemon down
                continue
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
        if os.path.exists(sock_path):
            os.unlink(sock_path)
        service.close()


def request(sock_path: str, req: Dict, *, timeout: float = 30.0) -> Dict:
    """One-shot client: connect, send one request line, read one response
    line.  Used by ``repro_torch.cli`` and ``chip_smoke.py``."""
    import json

    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
        c.settimeout(timeout)
        c.connect(sock_path)
        c.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = c.recv(65536)
            if not chunk:
                break
            buf += chunk
    if not buf:
        raise ConnectionError(f"no response from daemon at {sock_path}")
    return json.loads(buf.decode())


def request_retry(
    sock_path: str,
    req: Dict,
    *,
    retries: int = 5,
    base: float = 0.1,
    timeout: float = 30.0,
) -> Dict:
    """``request`` with capped exponential backoff + jitter on the
    transient failure modes of a daemon that is starting up, recovering
    from a crash, or briefly wedged: connection refused, socket file not
    there yet, read timeout.  Application-level errors (an ``ok: False``
    response) are returned, not retried — the daemon answered.  The last
    attempt re-raises."""
    import random
    import time

    for attempt in range(retries + 1):
        try:
            return request(sock_path, req, timeout=timeout)
        except (ConnectionRefusedError, FileNotFoundError, TimeoutError):
            if attempt == retries:
                raise
            delay = base * (2.0 ** attempt)
            time.sleep(delay * (0.5 + random.random() / 2.0))
    raise AssertionError("unreachable")  # pragma: no cover

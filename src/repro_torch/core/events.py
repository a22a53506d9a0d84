"""Unified event-queue substrate.

One typed event heap + one event loop over ``NodeSim`` accounting,
shared by the single-node ``simulate()`` (repro_torch.core.simulator)
and the cluster-scale ``Cluster.simulate()`` (repro_torch.core.cluster),
which differ only in the hooks they plug in (arrival routing, array-state
bookkeeping, migration candidate selection).  Twin of
``repro.core.events``.

Event kinds, in tie-break order at one instant:

  ARRIVAL  — a job enters the system (batched: all same-instant arrivals
             are absorbed before the policies run, so a completion-driven
             decision always sees the newcomers),
  COMPLETE — a running job finishes and frees its units,
  PREEMPT  — a checkpoint write finishes: the preempted job's units free
             and the job re-enters a queue with its remaining work,
  RESUME   — a preempted job re-enters its node's waiting queue,
  MIGRATE  — a waiting (possibly preempted) job lands on another node
             after the migration delay,
  NODE_FAIL / NODE_RECOVER / JOB_FAIL / RETRY — the fault plane
            : a node loses k of its GPUs (or all of them) and
             is repaired later; a running job crashes; a killed job
             re-enters a waiting queue after capped exponential backoff.

The ARRIVAL < COMPLETE ordering is the reference's contract, so the
substrate pops the identical event sequence and produces bit-identical
schedules — the single-node golden fingerprints of the reference's
tests replay in this package unchanged.

Elastic capabilities (all default-off, ``ElasticConfig``):

  * **preemption / checkpoint-restart** — a running job can be
    checkpointed: its units stay held for ``ckpt_time`` (energy charged at
    ``ckpt_power_scale``·job power), then the job re-enters the waiting
    queue carrying its completed-work fraction; the next launch pays
    ``restart_time`` on top of the remaining work at the new count.
  * **elastic GPU resizing** — on COMPLETE events the node policy may
    propose preempt-and-relaunch of a running job at a now-better unit
    count (``propose_resizes`` hook; EcoSched scores the candidates
    through the batched Eq. (1) engine with a switch-cost bias).  The
    relaunch itself goes through the normal scheduling path, so the
    resized job re-enters the scored window like any other candidate.
  * **job migration** — after a COMPLETE event the cluster may requeue a
    waiting or preempted job from a backlogged node onto the completing
    node when the predicted wait beats the move cost (migration delay,
    plus the restart charge a preempted job will pay anyway).

Every elastic action is bounded: at most one resize and one migration per
COMPLETE event, ``max_preempts`` checkpoints per job, and a job within
``ckpt_time + restart_time`` of finishing is never preempted.

The fault plane (``FaultConfig``, default-off — ``faults=None`` rides
the exact pre-fault path) threads failures through the same heap:

  * a seeded per-node timeline pushes NODE_FAIL/NODE_RECOVER cycles;
    a failure kills every overlapping job (work since its last
    checkpoint is lost and re-done, the unrun energy refunded, the
    burned segment stays charged), marks the lost units dead so
    placement, idle-energy integration, and the Eq. (1) scorers all see
    the degraded capacity, and repairs them at recovery;
  * a per-(job, segment) exponential hazard pushes JOB_FAIL crashes;
  * every kill retries through RETRY events with capped exponential
    backoff (``max_retries``, then the job is *lost* — dropped with an
    ``on_lost`` notification rather than requeued forever).

NODE_FAIL/NODE_RECOVER regenerate forever (the timeline never ends), so
the batch ``run()`` stops when no *work* events or waiting jobs remain;
the heap keeps the timeline, which is exactly what the incremental
control-plane callers need to resume.
"""
from __future__ import annotations

import heapq
import time as _time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.faults import FaultConfig, FaultInjector

# Event kinds.  ARRIVAL/COMPLETE keep the pre-refactor numeric order
# (arrivals sort before same-time completions); the elastic kinds follow,
# then the fault plane's.
EVT_ARRIVAL = 0
EVT_COMPLETE = 1
EVT_PREEMPT = 2
EVT_RESUME = 3
EVT_MIGRATE = 4
EVT_NODE_FAIL = 5
EVT_NODE_RECOVER = 6
EVT_JOB_FAIL = 7
EVT_RETRY = 8

EVENT_NAMES = {
    EVT_ARRIVAL: "ARRIVAL",
    EVT_COMPLETE: "COMPLETE",
    EVT_PREEMPT: "PREEMPT",
    EVT_RESUME: "RESUME",
    EVT_MIGRATE: "MIGRATE",
    EVT_NODE_FAIL: "NODE_FAIL",
    EVT_NODE_RECOVER: "NODE_RECOVER",
    EVT_JOB_FAIL: "JOB_FAIL",
    EVT_RETRY: "RETRY",
}

# the self-regenerating fault timeline: not "work", so an otherwise-idle
# batch run can stop while the heap still carries the next failure cycle
_TIMELINE_KINDS = frozenset((EVT_NODE_FAIL, EVT_NODE_RECOVER))


@dataclass(frozen=True)
class ElasticConfig:
    """Knobs for the beyond-static capabilities.  ``ElasticConfig()`` with
    every switch off is equivalent to ``elastic=None``.

    The checkpoint-cost model: a preemption holds the job's units for
    ``ckpt_time`` seconds at ``ckpt_power_scale`` × the job's busy power
    (charged to busy energy and tracked in ``ckpt_energy``); the next
    launch of that job pays ``restart_time`` seconds of re-execution
    overhead before its remaining work starts.
    """

    resize: bool = False  # EcoSched elastic resizing on COMPLETE events
    migrate: bool = False  # cluster-level waiting/preempted-job migration
    ckpt_time: float = 30.0  # checkpoint write (s); units held throughout
    restart_time: float = 15.0  # relaunch overhead (s) after a preemption
    ckpt_power_scale: float = 1.0  # power during the write, × busy power
    migration_delay: float = 10.0  # s a migrating job spends in transit
    min_gain_s: float = 60.0  # predicted saving must exceed this
    max_preempts: int = 2  # checkpoints per job (bounds churn)
    switch_cost: float = 0.05  # Eq. (1) bias on resize candidates != (g, f)
    # resize-order ablation: evaluate resizes *before*
    # the backfill scheduling pass on COMPLETE events, so a running job's
    # upsize gets first claim on freed units instead of backfill soaking
    # them (resizes otherwise fire mostly at drain tails).  Off by
    # default — the default path backfills first.
    resize_before_backfill: bool = False

    @property
    def any_enabled(self) -> bool:
        return self.resize or self.migrate


class EventQueue:
    """The single heap.  Entries are ``(t, kind, seq, payload)`` — the
    exact tuple shape of the pre-refactor loops, so pop order (time, then
    kind, then push order) is unchanged.

    ``work`` counts the pending non-timeline events (everything except
    NODE_FAIL/NODE_RECOVER, which regenerate forever): the fault-aware
    batch loop stops on ``work == 0`` instead of an empty heap.
    """

    __slots__ = ("_heap", "_seq", "work")

    def __init__(self):
        self._heap: List[Tuple[float, int, int, object]] = []
        self._seq = 0
        self.work = 0

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, t: float, kind: int, payload: object) -> None:
        heapq.heappush(self._heap, (t, kind, self._seq, payload))
        self._seq += 1
        if kind not in _TIMELINE_KINDS:
            self.work += 1

    def pop(self) -> Tuple[float, int, object]:
        t, kind, _, payload = heapq.heappop(self._heap)
        if kind not in _TIMELINE_KINDS:
            self.work -= 1
        return t, kind, payload

    def next_is(self, t: float, kind: int) -> bool:
        """True when the head event is exactly (t, kind) — the arrival
        batching test."""
        return bool(self._heap) and self._heap[0][0] == t and self._heap[0][1] == kind

    def peek_time(self) -> Optional[float]:
        """Head event time, or None when the heap is empty."""
        return self._heap[0][0] if self._heap else None


class EventLoop:
    """Shared loop: pops events, invokes per-node policies, applies the
    elastic hooks.  Owners provide:

      sims       — name -> NodeSim, in scheduling order (t=0 policy pass
                   runs over this order, like the pre-refactor loops),
      arrive     — (payload, t) -> node name: absorb one ARRIVAL payload
                   (single-node: enqueue locally; cluster: route + enqueue).
                   May return None to *drop* the arrival (a job cancelled
                   between submit and its ARRIVAL pop, control-plane path);
                   batch callers always return a name,
      max_events — deadlock-guard cap, counted per popped head event,
      cap_msg    — the RuntimeError message when the cap trips,
      elastic    — ``ElasticConfig`` or None (None = pre-refactor behavior),
      faults     — ``FaultConfig`` or None (None = pre-fault behavior);
                   ``fault_injector`` supplies the shared deterministic
                   draw streams (owners build one so NodeSim stragglers
                   and the loop's timelines share it),
      on_launch / on_complete / on_requeue / on_dequeue / on_retime —
                   optional array-state bookkeeping hooks (ClusterState),
      on_fail / on_retry / on_lost / on_capacity — optional fault hooks:
                   a job was killed (crash or node failure; receives the
                   pre-kill end time for array-state un-booking), a killed
                   job re-entered a waiting queue, a job exhausted its
                   retries, a node's alive capacity changed,
      migrate_candidate — optional (node, t) -> (donor, job) | None: pick a
                   waiting job to pull onto ``node`` (the cluster
                   dispatcher's migration hook),
      reroute_waiting — optional (node, t) hook: a node went fully dead —
                   move its waiting jobs somewhere alive (the cluster
                   implements this through the migration machinery),
      prepare_batch — optional (names, t) hook fired right before a
                   same-instant multi-node scheduling pass (the t=0 pass
                   and arrival batches): owners stage every pending score
                   reduction as one cross-node kernel launch;
                   pure staging, ``_schedule`` behaves identically
                   without it,
      prepare_complete — optional (pairs, t) hook fired once per
                   same-instant COMPLETE burst, at the first completion's
                   pop and *before* any of the burst is processed:
                   ``pairs`` is [(node, running_job)] with one entry per
                   distinct node (stale completions skipped).  Owners
                   stage the burst's backfill-launch and elastic-resize
                   reductions as one cross-node kernel launch.
                   Unlike arrivals, completions are never drained
                   together — each is still processed strictly in heap
                   order against the live state, and staged results are
                   signature-guarded predictions, so schedules are
                   bit-identical with the hook absent.
    """

    def __init__(
        self,
        sims: Dict[str, "NodeSim"],  # noqa: F821 (repro_torch.core.simulator)
        *,
        arrive: Callable[[object, float], str],
        max_events: int,
        cap_msg: str,
        elastic: Optional[ElasticConfig] = None,
        faults: Optional[FaultConfig] = None,
        fault_injector: Optional[FaultInjector] = None,
        on_launch: Optional[Callable] = None,
        on_complete: Optional[Callable] = None,
        on_requeue: Optional[Callable] = None,
        on_dequeue: Optional[Callable] = None,
        on_retime: Optional[Callable] = None,
        on_fail: Optional[Callable] = None,
        on_retry: Optional[Callable] = None,
        on_lost: Optional[Callable] = None,
        on_capacity: Optional[Callable] = None,
        migrate_candidate: Optional[Callable] = None,
        reroute_waiting: Optional[Callable] = None,
        prepare_batch: Optional[Callable[[List[str], float], None]] = None,
        prepare_complete: Optional[Callable] = None,
    ):
        self.sims = sims
        self.queue = EventQueue()
        self.arrive = arrive
        self.max_events = max_events
        self.cap_msg = cap_msg
        self.elastic = elastic if (elastic and elastic.any_enabled) else None
        self.faults = faults if (faults and faults.enabled) else None
        if self.faults is not None and fault_injector is None:
            fault_injector = FaultInjector(self.faults)
        self.injector = fault_injector if self.faults is not None else None
        self.on_launch = on_launch
        self.on_complete = on_complete
        self.on_requeue = on_requeue
        self.on_dequeue = on_dequeue
        self.on_retime = on_retime
        self.on_fail = on_fail
        self.on_retry = on_retry
        self.on_lost = on_lost
        self.on_capacity = on_capacity
        self.migrate_candidate = migrate_candidate
        self.reroute_waiting = reroute_waiting
        # fleet-batched decision staging: invoked with the list
        # of touched node names right before a same-instant multi-node
        # scheduling pass, so an owner can run every pending score
        # reduction as one cross-node kernel launch.  Pure staging — the
        # per-node ``_schedule`` calls behave identically without it.
        self.prepare_batch = prepare_batch
        # COMPLETE-burst staging: fired once per same-instant
        # completion burst with the *predicted* (node, job) pairs, before
        # any of them is processed.  ``_staged_complete_t`` marks the
        # instant already staged so later pops of the same burst skip it.
        self.prepare_complete = prepare_complete
        self._staged_complete_t: Optional[float] = None
        # global per-job retry counts: a job killed on node A and rerouted
        # to node B keeps burning the same budget
        self._fault_retry: Dict[str, int] = {}
        # stepping state (control-plane incremental driving):
        # ``now`` advances to each popped head-event time, ``events`` is the
        # per-head-event cap counter, ``started`` guards the t=0 pass.
        self.now = 0.0
        self.events = 0
        self.started = False

    # -- scheduling ---------------------------------------------------------

    def _schedule(self, nm: str) -> None:
        """One policy invocation on node ``nm``; launched jobs get their
        COMPLETE events pushed (and, with faults, their crash draws)."""
        sim = self.sims[nm]
        if self.faults is not None and sim.placement.free_count() == 0:
            # a fully-dead (or fully-occupied) node has nothing to offer;
            # policies written against the pre-fault invariant
            # "idle => all units free" must not be consulted here
            return
        for rj in sim.invoke_policy():
            if self.on_launch is not None:
                self.on_launch(nm, rj)
            self.queue.push(rj.end, EVT_COMPLETE, (nm, rj))
            if self.faults is not None:
                t_c = rj.start + self.injector.crash_offset(
                    rj.job, rj.record.segment
                )
                if t_c < rj.end:
                    self.queue.push(t_c, EVT_JOB_FAIL, (nm, rj))

    # -- main loop ----------------------------------------------------------

    def start(self) -> None:
        """The t=0 scheduling pass (node order = spec order).  Idempotent,
        so incremental callers can call it defensively before stepping."""
        if self.started:
            return
        self.started = True
        if self.prepare_batch is not None and len(self.sims) > 1:
            self.prepare_batch(list(self.sims), 0.0)
        for nm in self.sims:
            self._schedule(nm)
        if self.faults is not None and self.faults.node_mtbf_s > 0:
            for nm, sim in self.sims.items():
                up, down, k = self.injector.next_cycle(nm, sim.node.units)
                self.queue.push(up, EVT_NODE_FAIL, (nm, k, down))

    def step(self) -> bool:
        """Pop and process one head event (plus its same-instant arrival
        batch).  Returns False when the queue is empty.  Event counting and
        the cap check are per head event — exactly ``run()``'s accounting."""
        q = self.queue
        if not len(q):
            return False
        self.events += 1
        if self.events > self.max_events:
            raise RuntimeError(self.cap_msg)
        t, kind, payload = q.pop()
        self.now = t
        self._dispatch(t, kind, payload)
        return True

    def run_until(self, t_max: float) -> None:
        """Drain every event with time <= ``t_max`` (the control plane's
        ``advance`` verb).  ``now`` ends at the last processed event."""
        self.start()
        while True:
            head = self.queue.peek_time()
            if head is None or head > t_max:
                return
            self.step()

    def idle(self) -> bool:
        """True when only the self-regenerating fault timeline remains:
        no pending work events, no waiting jobs anywhere.  Without faults
        the heap simply drains, so this is never consulted."""
        if self.faults is None:
            return False
        return self.queue.work == 0 and not any(
            sim.waiting for sim in self.sims.values()
        )

    def run(self) -> None:
        self.start()
        while not self.idle() and self.step():
            pass

    def _dispatch(self, t: float, kind: int, payload: object) -> None:
        q = self.queue
        if kind == EVT_ARRIVAL:
            touched: List[Optional[str]] = [self.arrive(payload, t)]
            while q.next_is(t, EVT_ARRIVAL):
                nm = self.arrive(q.pop()[2], t)
                if nm not in touched:
                    touched.append(nm)
            if self.prepare_batch is not None and len(touched) > 1:
                self.prepare_batch([nm for nm in touched if nm is not None], t)
            for nm in touched:
                if nm is not None:  # None = arrival dropped (cancelled job)
                    self._schedule(nm)
        elif kind == EVT_COMPLETE:
            nm, rj = payload
            if rj.preempted or rj.failed:
                return  # superseded by a PREEMPT event / killed by a fault
            if (
                self.prepare_complete is not None
                and t != self._staged_complete_t
                and q.next_is(t, EVT_COMPLETE)
            ):
                # first pop of a same-instant COMPLETE burst: peek (never
                # pop) the rest of the burst and stage the cross-node
                # reductions once.  Only the first completion per node is
                # staged — later ones see a state this prediction cannot
                # cover and recompute solo via the signature guard.
                self._staged_complete_t = t
                pairs = [(nm, rj)]
                seen = {nm}
                for tt, kk, _, p in q._heap:
                    if tt != t or kk != EVT_COMPLETE:
                        continue
                    nm2, rj2 = p
                    if nm2 in seen or rj2.preempted or rj2.failed:
                        continue
                    seen.add(nm2)
                    pairs.append((nm2, rj2))
                if len(pairs) > 1:
                    self.prepare_complete(pairs, t)
            sim = self.sims[nm]
            sim.complete(rj)
            if self.on_complete is not None:
                self.on_complete(nm, rj)
            if self.elastic is None:
                if sim.waiting:
                    self._schedule(nm)
            else:
                self._post_complete(nm, t)
        elif kind == EVT_PREEMPT:
            nm, rj = payload
            if rj.failed:
                return  # the node died mid-checkpoint-write
            self.sims[nm].finish_preempt(rj, t)
            if self.on_complete is not None:
                self.on_complete(nm, rj)  # rj.end == t after retiming
            q.push(t, EVT_RESUME, (nm, rj.job))
        elif kind == EVT_RESUME:
            nm, job = payload
            self.sims[nm].requeue(job, t)
            if self.on_requeue is not None:
                self.on_requeue(nm, job)
            self._schedule(nm)
        elif kind == EVT_MIGRATE:
            to, job, state = payload
            self.sims[to].absorb(job, t, state)
            if self.on_requeue is not None:
                self.on_requeue(to, job)
            self._schedule(to)
        elif kind == EVT_JOB_FAIL:
            nm, rj = payload
            sim = self.sims[nm]
            if rj.preempted or rj.failed or rj not in sim.running:
                return  # stale draw: resized/checkpointed/done before it hit
            sim.job_crashes += 1
            self._kill(nm, rj, t)
            if sim.waiting and sim.placement.free_count() > 0:
                self._schedule(nm)  # the freed units can serve the queue
        elif kind == EVT_NODE_FAIL:
            nm, k, down = payload
            self._node_fail(nm, k, down, t)
        elif kind == EVT_NODE_RECOVER:
            nm, ids = payload
            self._node_recover(nm, ids, t)
        elif kind == EVT_RETRY:
            nm, job = payload
            sim = self.sims[nm]
            sim.requeue(job, t)
            if self.on_retry is not None:
                self.on_retry(nm, job)
            if (
                self.reroute_waiting is not None
                and sim.placement.dead_count() >= sim.node.units
            ):
                # retried onto a node that is still fully down: move it
                self.reroute_waiting(nm, t)
            if job in sim.waiting and sim.placement.free_count() > 0:
                self._schedule(nm)
        else:  # pragma: no cover - defensive
            raise RuntimeError(f"unknown event kind {kind}")

    # -- fault plane --------------------------------------------------------

    def _kill(self, nm: str, rj, t: float) -> None:
        """One job dies at ``t`` (crash or node failure): the node refunds
        the unrun energy and rolls the job back to its last checkpoint,
        then the job either retries (backoff) or is lost."""
        sim = self.sims[nm]
        old_end = rj.end
        sim.fail_running(rj, t)
        if self.on_fail is not None:
            self.on_fail(nm, rj, old_end)
        self._fault_requeue(nm, rj.job, t)

    def _fault_requeue(self, nm: str, job: str, t: float) -> None:
        cfg = self.faults
        count = self._fault_retry.get(job, 0)
        sim = self.sims[nm]
        if count >= cfg.max_retries:
            sim.drop_lost(job)
            if self.on_lost is not None:
                self.on_lost(nm, job)
            return
        self._fault_retry[job] = count + 1
        sim.fault_retries += 1
        self.queue.push(t + self.injector.retry_delay(count), EVT_RETRY, (nm, job))

    def _node_fail(self, nm: str, k: int, down: float, t: float) -> None:
        sim = self.sims[nm]
        sim.advance(t)
        sim.node_failures += 1
        alive = [u for u in range(sim.node.units) if not sim.placement.dead[u]]
        victims = set(alive[-k:]) if k < len(alive) else set(alive)
        for rj in [r for r in sim.running if set(r.units) & victims]:
            self._kill(nm, rj, t)
        sim.placement.mark_dead(sorted(victims))
        if self.on_capacity is not None:
            self.on_capacity(nm)
        if (
            self.reroute_waiting is not None
            and sim.placement.dead_count() >= sim.node.units
        ):
            self.reroute_waiting(nm, t)
        if sim.waiting and sim.placement.free_count() > 0:
            self._schedule(nm)  # partial failure: survivors may backfill
        self.queue.push(t + down, EVT_NODE_RECOVER, (nm, sorted(victims)))

    def _node_recover(self, nm: str, ids: List[int], t: float) -> None:
        sim = self.sims[nm]
        sim.advance(t)
        sim.placement.revive(ids)
        if self.on_capacity is not None:
            self.on_capacity(nm)
        if sim.waiting:
            self._schedule(nm)
        up, down, k = self.injector.next_cycle(nm, sim.node.units)
        self.queue.push(t + up, EVT_NODE_FAIL, (nm, k, down))

    # -- elastic hooks (resize + migration), bounded per COMPLETE event -----

    def _post_complete(self, nm: str, t: float) -> None:
        """Backfill + elastic actions after one COMPLETE.  The default
        order backfills waiting jobs before evaluating resizes;
        ``resize_before_backfill`` swaps the two so a resize gets first
        claim on the freed units (ablation)."""
        cfg = self.elastic
        sim = self.sims[nm]
        if cfg.resize and cfg.resize_before_backfill:
            t0 = _time.perf_counter()
            self._try_resize(nm, t)
            sim.resize_time += _time.perf_counter() - t0
        if sim.waiting:
            self._schedule(nm)
        if cfg.resize and not cfg.resize_before_backfill:
            t0 = _time.perf_counter()
            self._try_resize(nm, t)
            sim.resize_time += _time.perf_counter() - t0
        if cfg.migrate and self.migrate_candidate is not None:
            t0 = _time.perf_counter()
            self._try_migrate(nm, t)
            sim.migrate_time += _time.perf_counter() - t0

    def _try_resize(self, nm: str, t: float) -> None:
        sim = self.sims[nm]
        propose = getattr(sim.policy, "propose_resizes", None)
        if propose is None:
            return
        cfg = self.elastic
        for ln in propose(sim.node_view(), frac_of=sim.frac_of, cfg=cfg)[:1]:
            rj = next(
                (r for r in sim.running if r.job == ln.job and not r.preempted),
                None,
            )
            if rj is None:
                continue
            if sim.preempt_count.get(ln.job, 0) >= cfg.max_preempts:
                continue
            if rj.end - t <= cfg.ckpt_time + cfg.restart_time:
                continue  # finishing soon: a checkpoint can never pay off
            old_end = rj.end
            ck_end = sim.begin_preempt(rj, t, cfg)
            if self.on_retime is not None:
                self.on_retime(nm, rj, old_end)
            self.queue.push(ck_end, EVT_PREEMPT, (nm, rj))

    def _try_migrate(self, nm: str, t: float) -> None:
        cand = self.migrate_candidate(nm, t)
        if not cand:
            return
        donor, job = cand
        dsim = self.sims[donor]
        if job not in dsim.waiting:
            return
        state = dsim.evict(job)  # MigrantState: arrival/progress/counters
        if self.on_dequeue is not None:
            self.on_dequeue(donor, job)
        self.queue.push(
            t + self.elastic.migration_delay, EVT_MIGRATE, (nm, job, state)
        )

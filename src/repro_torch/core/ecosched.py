"""EcoSched — the paper's online energy-aware co-scheduler (§III).

Window-based event loop: at every scheduling event (t=0 and each job
completion), build the scheduling window, τ-filter each job's modes
(Phase I estimates, computed once per job), enumerate feasible joint
actions under GPU-capacity + domain constraints, score with Eq. (1), and
launch the argmin.  The empty action participates in scoring (its
R_energy is 0 and it pays the full idle term), which is exactly the λ
tradeoff: launching an energy-regretful mode must beat idling.  A
deadlock guard forces the best non-empty action when the node is
completely idle.

Scoring backends (``engine=``):
  * ``"vector"`` — the batched numpy engine
    (``repro_torch.core.engine``): one vector expression scores the whole
    candidate space, bitmask replay checks placement; the decision stays
    lightweight at pod scale (M=16, K=4, 17-job windows).
  * ``"torch"`` (default) — same cached enumeration, but the Eq. (1)
    score reduction and masked argmin run through the hand-written CUDA
    kernels (``repro_torch.kernels.score_reduce``) on ``device`` (default
    ``"cuda"``; ``device="cpu"`` runs their plain PyTorch versions).  It
    takes the place of the reference's ``"jax"`` engine and gives the same
    schedules.
  * ``"python"`` — the pure-Python reference (``repro_torch.core.actions``),
    parity-locked against the engine in tests/test_engine.py.

Repeated decisions are incremental (``cache=True``, the default for the
array backends): τ-filtered specs are computed once per job, and a
``DecisionCache`` reuses spec tables, placement-oracle memos and whole
scored batches across events keyed on name-free window structure + the
placement bitmask — consecutive events that share a window, and instances
of the same application, skip enumeration entirely.  Caching is pure: the
schedule is bit-identical with the cache off (tests/test_decision_cache.py).

Launches are returned largest-count first — the same order the
feasibility replay allocated them — so the simulator's placement is
guaranteed to succeed and land on the checked units.

Beyond-paper options (all default-off; §Perf ablations):
  * ``lookahead``  — penalize actions whose predicted completion times
    diverge (tail fragmentation), a lightweight fix for the greedy
    policy's myopia.
  * elastic resizing — when the simulator runs with an ``ElasticConfig``
    (repro_torch.core.events), the substrate calls ``propose_resizes`` on
    COMPLETE events: running jobs may be checkpointed and relaunched at a
    now-better count, with the candidates scored through the same batched
    Eq. (1) path plus a switch-cost bias.
  * forecast plane — with a ``ForecastConfig`` (repro_torch.core.forecast)
    the entry points call ``attach_forecast``: the perf model becomes an
    online-refined posterior (τ-filtered specs re-derive when it bumps
    its ``version``) and the resize switch-cost bias scales with
    forecasted queue pressure.  Never attached on the default path.

A fleet coordinator (``repro_torch.core.cluster.ClusterRun``) may stage
a node's decision: ``stage_score``/``stage_round1`` and
``stage_resize``/``stage_resize_results`` park the argmins of one
cross-node kernel launch (an idle node's guard included), consumed only
when the decision state still matches.  Twin of ``repro.core.ecosched``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.actions import enumerate_actions
from repro_torch.core.engine import DecisionCache, _mask_of, enumerate_scored
from repro_torch.core.score import tau_filter
from repro_torch.core.types import JobSpec, Launch, NodeView, RunningJob
from repro_torch.device import resolve_device
from repro_torch.kernels.score_reduce import (
    pack_windows,
    score_reduce,
    score_reduce_multi,
)


class EcoSched:
    def __init__(
        self,
        perf_model,
        *,
        lam: float = 0.5,
        tau: float = 0.35,
        lam_f: float = 0.0,
        window: Optional[int] = None,
        exact_limit: int = 50_000,
        beam: int = 64,
        lookahead: float = 0.0,
        engine: str = "torch",
        cache=True,
        resize_batch: bool = True,
        launch_share: bool = True,
        device="cuda",
    ):
        if engine not in ("vector", "python", "torch"):
            raise ValueError(f"unknown scoring engine {engine!r}")
        # the torch engine's kernels run where its tensors lie: a CUDA
        # device launches them or raises, never a quiet CPU fallback
        self.device = (resolve_device(device) if engine == "torch"
                       else torch.device(device))
        self.perf_model = perf_model
        self.lam = lam
        self.tau = tau
        # DVFS conservatism weight: λ_f penalizes (or, negative, rewards)
        # the mean frequency level of an action.  0.0 — the default — makes
        # the joint argmin purely energy-driven and keeps single-frequency
        # scores bit-identical to the count-only scorer.
        self.lam_f = lam_f
        self.window = window
        self.exact_limit = exact_limit
        self.beam = beam
        self.lookahead = lookahead
        self.engine = engine
        # ``cache`` accepts a shared ``DecisionCache`` instance:
        # every cache key is name-free and structure-interned, so policies
        # on identically-shaped nodes can pool one cache and serve each
        # other's first-sight enumerations — at fleet scale each node sees
        # only a handful of jobs, so private caches never warm up.  The
        # decision is a pure function of the key either way: sharing
        # changes hit rates, never schedules.
        if isinstance(cache, DecisionCache):
            self._cache = cache if engine != "python" else None
        else:
            self._cache = (
                DecisionCache() if (cache and engine != "python") else None
            )
        self._filtered: Dict[str, JobSpec] = {}  # job -> τ-filtered spec
        # launch-level memo layers (stored *in* the DecisionCache, so fleet
        # peers pooling one cache replay each other's decisions too):
        #   * raw layer — exact decision state (token order included) ->
        #     final launch pairs; the chosen action is a pure function of
        #     the (name-free) state, so a repeat skips scoring outright.
        #   * tie-frontier layer (fast path, ``launch_share``) —
        #     *canonical* (token-sorted) state -> every argmin-optimal row
        #     (min score, max total count) in canonical slot form.  A
        #     permuted window re-breaks the tie in its own reference
        #     enumeration order (size, then ascending position tuple, then
        #     mode tuple) — exactly what its cold argmin would do — so the
        #     replay is bit-identical to scoring from scratch while
        #     skipping the enumeration *and* the kernel launch.  A
        #     single-winner canonical entry is unsound: exact
        #     cross-structure ties are structural here (normalized best
        #     modes all score dev=0) and the winner depends on window
        #     order.  ``launch_share=False`` disables the layer (the
        #     bench's pre-batching reference leg).
        self.launch_share = launch_share
        self.launch_hits = 0
        self.frontier_hits = 0
        # (batch, used_nonempty, chosen row) of the engine decision that
        # produced the current action — the frontier store reads it right
        # after engine dispatch; None when the python reference ran
        self._last_decision = None
        # fleet-batched decision staging: a fleet coordinator may pre-run
        # this node's Eq. (1) reduction inside one cross-node kernel launch
        # and park the result here; ``_best_torch`` consumes it when the
        # decision state still matches, else recomputes solo.
        # ``stage_served`` counts consumed stagings.
        self._staged: Optional[dict] = None
        self.stage_served = 0
        # batched elastic resize scoring: collect every
        # eligible running job's candidate window and score them through
        # one multi-window kernel launch instead of one launch per job.
        # ``resize_batch=False`` keeps the per-job loop (the measured
        # pre-batching baseline; schedules are bit-identical either way).
        self.resize_batch = resize_batch
        self._staged_resize: Optional[dict] = None
        self.resize_stage_served = 0
        # scratch free-unit mask for the resize hot path (_freed_view):
        # reused across candidates instead of allocating a fresh list +
        # per-unit Python loop per candidate per COMPLETE event
        self._free_scratch: Optional[np.ndarray] = None
        self._pm_version = 0
        # forecast plane (repro_torch.core.forecast): attached by the
        # simulation entry points when a ForecastConfig is enabled; None
        # otherwise
        self._plane = None
        self._node = ""

    def name(self) -> str:
        return "ecosched" if not self.lookahead else "ecosched+lookahead"

    def cache_stats(self) -> Dict[str, float]:
        """Decision-cache hit/miss counters (empty when caching is off).
        ``event_hit_rate`` counts a scheduling event as a hit when either
        the launch memo or the scored-batch layer served it."""
        if self._cache is None:
            return {}
        s = self._cache.stats()
        s["launch_hits"] = self.launch_hits
        s["frontier_hits"] = self.frontier_hits
        h = self.launch_hits + self.frontier_hits + s["decision_hits"]
        m = s["decision_misses"]
        s["event_hit_rate"] = h / (h + m) if h + m else 0.0
        return s

    def attach_forecast(self, plane, node: str = "") -> None:
        """Wire the forecast plane (repro_torch.core.forecast.ForecastPlane):
        wraps the perf model with the plane's refined posterior (online
        refinement) and conditions the resize switch-cost bias on
        forecasted queue pressure.  Called by the simulation entry points
        before any event fires."""
        self._plane = plane
        self._node = node
        self.perf_model = plane.refined_model(node, self.perf_model)

    def _spec(self, job: str) -> JobSpec:
        """τ-filtered Phase-I spec, computed once per job and reused across
        events (the estimates themselves are per-job constants, §III-B —
        unless an online-refined model bumps its ``version``, which drops
        the filtered cache so decisions see the posterior)."""
        v = getattr(self.perf_model, "version", 0)
        if v != self._pm_version:
            self._filtered.clear()
            self._pm_version = v
        s = self._filtered.get(job)
        if s is None:
            if len(self._filtered) >= 100_000:
                self._filtered.clear()  # bound endless-stream growth
            s = tau_filter(self.perf_model.spec(job), self.tau)
            self._filtered[job] = s
        return s

    def on_event(self, view: NodeView, waiting: Sequence[str]) -> List[Launch]:
        window_jobs = list(waiting[: self.window] if self.window else waiting)
        if not window_jobs or view.free_domains <= 0 or view.free_units <= 0:
            return []
        specs = [self._spec(j) for j in window_jobs]
        # a job whose mode list is empty (nothing feasible survives the
        # filter) can never launch; drop it rather than crash the scorer
        specs = [s for s in specs if s.modes]
        if not specs:
            return []
        key = ckey = order = None
        if self._cache is not None and view.domain_jobs:
            toks = tuple(self._cache.spec_token(s) for s in specs)
            rest = (
                _mask_of(view.free_map),
                tuple(view.domain_jobs),
                bool(view.running),  # the deadlock guard reads this
                view.total_units,
                view.dead_units,  # degraded capacity changes the argmin
                view.domains,
            )
            # raw (order-sensitive) layer first: the chosen action breaks
            # exact score ties by window position, so a permuted window is
            # a *different* decision — a single-winner canonical key here
            # replayed the producer's tie order, which diverged from a cold
            # evaluation whenever two structures tied exactly
            key = (toks,) + rest
            hit = self._cache.launch(key)
            if hit is not None:
                self.launch_hits += 1
                return [
                    Launch(job=specs[p].name, g=g, f=f) for p, g, f in hit
                ]
            if self.launch_share:
                # canonical tie-frontier layer: permuted windows share the
                # full optimal set and re-break the tie in *this* window's
                # enumeration order — pure, unlike a single stored winner
                order = DecisionCache.canonical_order(toks)
                ckey = (
                    toks if order is None else tuple(toks[i] for i in order),
                ) + rest
                cands = self._cache.frontier(ckey)
                if cands is not None:
                    self.frontier_hits += 1
                    pairs = _replay_frontier(cands, order, specs)
                    self._cache.store_launch(key, pairs)
                    return [
                        Launch(job=specs[p].name, g=g, f=f)
                        for p, g, f in pairs
                    ]
        self._last_decision = None
        if self.engine == "python":
            action = self._best_python(specs, view)
        elif self.engine == "torch":
            action = self._best_torch(specs, view)
        else:
            action = self._best_vector(specs, view)
        # descending count — the order the feasibility replay allocated;
        # equal counts break toward the earlier window position
        pos_of = {id(sp): i for i, sp in enumerate(specs)}
        pairs = sorted(
            ((pos_of[id(sp)], m.g, m.f) for sp, m in action),
            key=lambda pg: (-pg[1], pg[0]),
        )
        if key is not None:
            self._cache.store_launch(key, tuple(pairs))
            if ckey is not None and self._last_decision is not None:
                self._store_frontier(ckey, order, *self._last_decision)
        return [Launch(job=specs[p].name, g=g, f=f) for p, g, f in pairs]

    def _store_frontier(self, ckey, order, batch, used_nonempty, chosen):
        """Store the decision's full argmin frontier — every row attaining
        (min biased score, max total count), restricted to non-empty rows
        when the idle-node guard re-scored — keyed on the canonical decision
        state.  Scores, totals and the frontier *set* are order-free; only
        the tie-break among members depends on window order, so the replay
        (`_replay_frontier`) re-breaks it per consumer.  Skipped for beam
        batches (their row *set* is window-order dependent) and when the
        engine's winner is not the frontier's producer-order minimum (a
        float32 kernel argmin diverging from the float64 frontier would
        make replay unsound — never observed, but cheap to guard)."""
        if not getattr(batch, "exact", False):
            return
        sc = batch.scores
        if self.lookahead:
            sc = sc + self.lookahead * batch.spread
        if used_nonempty:
            idxs = np.flatnonzero(batch.n_jobs > 0)
            if idxs.size == 0:
                return
            sub = sc[idxs]
            tie = idxs[sub == sub.min()]
        else:
            tie = np.flatnonzero(sc == sc.min())
        tot = batch.total_g[tie]
        frontier = tie[tot == tot.max()]
        if frontier.size > 64 or int(frontier[0]) != chosen:
            return
        J = len(batch.specs)
        slot_of = list(range(J))
        if order is not None:
            for c, p in enumerate(order):
                slot_of[p] = c
        cands = tuple(
            tuple(sorted((slot_of[p], m) for p, m in batch.row_pairs(int(r))))
            for r in frontier
        )
        self._cache.store_frontier(ckey, cands)

    def _enumerate(self, specs, view: NodeView):
        # free_map is only read (mask/bitmask replay) — no defensive copy
        return enumerate_scored(
            specs, view, view.free_map,
            lam=self.lam, lam_f=self.lam_f,
            exact_limit=self.exact_limit, beam=self.beam,
            cache=self._cache,
        )

    def _best_vector(self, specs, view: NodeView):
        try:
            batch = self._enumerate(specs, view)
        except OverflowError:
            # windows too wide for the engine's int64 action-set keys
            # (never the pod-scale target); the reference path has no limit
            return self._best_python(specs, view)
        used_nonempty = False
        i = batch.best_cached(self.lookahead)
        # row 0 is always the empty action; any other row is non-empty
        if i == 0 and not view.running:
            j = batch.best_cached(self.lookahead, nonempty=True)
            if j is not None:
                i = j
                used_nonempty = True
        self._last_decision = (batch, used_nonempty, int(i))
        return batch.action(i)

    # -- fleet-batched decisions -------------------------------------------

    def _stage_sig(self, view: NodeView, specs) -> Tuple:
        """Everything the kernel decision is a pure function of.  A staged
        result is only consumed when this matches at ``on_event`` time, so
        any drift between staging and consumption (a capacity event, a
        perf-model refinement, a reordered queue) falls back to the solo
        recomputation instead of serving a stale argmin."""
        return (
            tuple(s.name for s in specs),
            _mask_of(view.free_map),
            tuple(view.domain_jobs),
            bool(view.running),
            view.total_units,
            view.dead_units,
            view.domains,
            view.free_units,
            view.t,
            getattr(self.perf_model, "version", 0),
        )

    def stage_score(self, view: NodeView, waiting: Sequence[str]):
        """Phase 1 of a fleet-coordinated decision: replicate
        ``on_event``'s window/enumeration prefix (same caches, same spec
        tokens — so the imminent solo invocation behaves bit-identically
        whether or not staging happened) and return the kernel request
        dict for ``score_reduce_batch`` (the numpy request shape of
        ``pack_windows``); on an idle node it carries the deadlock guard
        (``guard``: the non-empty rows), whose winner comes back from the
        same launch.  Returns None when this event would not launch
        a solo kernel anyway (non-torch engine, empty or un-placeable
        window, launch-memo hit, overflow fallback)."""
        self._staged = None
        if self.engine != "torch":
            return None
        window_jobs = list(waiting[: self.window] if self.window else waiting)
        if not window_jobs or view.free_domains <= 0 or view.free_units <= 0:
            return None
        specs = [self._spec(j) for j in window_jobs]
        specs = [s for s in specs if s.modes]
        if not specs:
            return None
        if self._cache is not None and view.domain_jobs:
            toks = tuple(self._cache.spec_token(s) for s in specs)
            rest = (
                _mask_of(view.free_map),
                tuple(view.domain_jobs),
                bool(view.running),
                view.total_units,
                view.dead_units,
                view.domains,
            )
            if self._cache.launch((toks,) + rest) is not None:
                return None  # on_event replays the memo; no kernel runs
            if self.launch_share:
                order = DecisionCache.canonical_order(toks)
                ckey = (
                    toks if order is None else tuple(toks[i] for i in order),
                ) + rest
                if self._cache.frontier(ckey) is not None:
                    return None  # on_event re-breaks the frontier tie
        try:
            batch = self._enumerate(specs, view)
        except OverflowError:
            return None  # on_event falls back to the python reference
        # the solo path's inputs before its upload: float32 planes from
        # padded_cols/padded_f, and the float64 bias that pack_windows
        # rounds to float32 exactly as ``_bias`` does
        dev, g, n = batch.padded_cols()
        fcol = batch.padded_f() if self.lam_f else None
        bias = (self.lookahead * batch.spread) if self.lookahead else None
        req = dict(
            dev=dev, g=g, n=n, lam=self.lam, g_free=view.free_units,
            M=view.alive_units, f=fcol, lam_f=self.lam_f, bias=bias,
        )
        if not view.running:  # the idle-node guard rides in the launch
            req["guard"] = batch.n_jobs > 0
        self._staged = {
            "sig": self._stage_sig(view, specs),
            "batch": batch,
            "best": None,
        }
        return req

    def stage_round1(self, best: int, best_guard: int) -> None:
        """Phase 2: record the batched argmin and, for an idle node, its
        guard's winner from the same launch: when the empty action (row
        0) wins on an idle node, the best non-empty action is taken
        instead, as ``_best_torch`` does."""
        st = self._staged
        if st is None:
            return
        st["best"] = int(best)
        if best == 0 and best_guard >= 0:  # only an idle node has a guard
            st["best"] = int(best_guard)
            st["nonempty"] = True  # the guard chose this row

    def stage_drop(self) -> None:
        self._staged = None

    def _bias(self, bias: np.ndarray) -> torch.Tensor:
        """A float64 host bias column as the kernels' float32 device input
        (rounded as the reference rounds it)."""
        return torch.from_numpy(bias.astype(np.float32)).to(self.device)

    def _best_torch(self, specs, view: NodeView):
        staged, self._staged = self._staged, None
        if (
            staged is not None
            and staged["best"] is not None
            and staged["sig"] == self._stage_sig(view, specs)
        ):
            self.stage_served += 1
            i = staged["best"]
            if i >= 0:
                self._last_decision = (
                    staged["batch"], staged.get("nonempty", False), int(i)
                )
                return staged["batch"].action(i)
            return ()
        try:
            batch = self._enumerate(specs, view)
        except OverflowError:
            return self._best_python(specs, view)
        # the f plane only shifts scores through λ_f; skip uploading it
        # when the weight is 0 (a missing plane contributes exactly +0.0)
        cols = batch.device_cols(self.device, with_f=bool(self.lam_f))
        bias = (
            self._bias(self.lookahead * batch.spread) if self.lookahead else None
        )
        kw = dict(
            lam=self.lam, g_free=view.free_units, M=view.alive_units,
            f=cols["f"], lam_f=self.lam_f, bias=bias,
        )
        # on an idle node the guard's winner (the best non-empty action)
        # comes from the same launch, taken when row 0, the empty action,
        # wins: the reference's second, non-empty-masked call
        guard = None if view.running else cols["nonempty"]
        out = score_reduce(cols["dev"], cols["g"], cols["n"], guard=guard, **kw)
        i = out[1]
        if i < 0:  # unreachable: the empty action is always feasible
            return ()
        used_nonempty = False
        if i == 0 and guard is not None and out[2] >= 0:
            i = out[2]
            used_nonempty = True
        self._last_decision = (batch, used_nonempty, int(i))
        return batch.action(i)

    def _best_python(self, specs, view: NodeView):
        scored = enumerate_actions(
            specs, view, list(view.free_map),
            lam=self.lam, lam_f=self.lam_f,
            exact_limit=self.exact_limit, beam=self.beam,
        )
        if self.lookahead:
            scored = [(s + self._lookahead_penalty(a, view), a) for s, a in scored]
        scored.sort(key=lambda kv: (kv[0], -sum(m.g for _, m in kv[1])))
        best_s, best_a = scored[0]
        if not best_a and not view.running:
            nonempty = [sa for sa in scored if sa[1]]
            if nonempty:
                best_s, best_a = nonempty[0]
        return best_a

    # -- elastic GPU resizing ----------------------------------------------
    def propose_resizes(self, view: NodeView, *, frac_of, cfg) -> List[Launch]:
        """Substrate hook (``repro_torch.core.events``): on a COMPLETE event,
        propose preempt-and-relaunch of one running job at a now-better
        (count, frequency) mode — a pure frequency retune rides the same
        checkpoint/relaunch mechanics as a count resize.

        Each running job's alternative (g, f) modes are scored through the
        same batched Eq. (1) path as launch decisions — a single-job window
        on the hypothetical node state with the job's units freed — with
        ``cfg.switch_cost`` added to every candidate that changes the
        joint mode, so a resize must beat staying put by the switch margin
        on the same scale the scheduler already optimizes.  On top of the
        score win, the predicted remaining-time saving (via the Phase-I
        t_norm ratio) must exceed the checkpoint + restart overhead by
        ``cfg.min_gain_s`` — energy-better-but-slower moves never degrade
        makespan.  Returns at most one proposal (the largest predicted
        gain); the substrate enforces its own guards on top.

        With ``resize_batch`` (the default for the array engines) every
        candidate window is scored in ONE kernel/vector reduction instead
        of one per running job, and a fleet coordinator may have pre-run
        the whole reduction inside a cross-node COMPLETE-burst launch
        (``stage_resize``) — consumed only on an exact decision-state
        signature match, so schedules are bit-identical either way.
        """
        staged, self._staged_resize = self._staged_resize, None
        if view.free_units <= 0 or not view.running:
            return []
        # forecast-conditioned switch cost: under burst risk / queue
        # pressure the freed units are about to be needed, so changing a
        # count must clear a larger margin (identical to cfg.switch_cost
        # when no plane is attached)
        switch_cost = (
            cfg.switch_cost
            if self._plane is None
            else self._plane.resize_switch_cost(self._node, cfg.switch_cost, view.t)
        )
        if (
            staged is not None
            and staged["bests"] is not None
            and staged["sig"] == self._resize_sig(view, switch_cost, cfg)
        ):
            self.resize_stage_served += 1
            return self._pick_resize(staged["cands"], staged["bests"], cfg)
        if not self.resize_batch or self.engine == "python":
            return self._propose_solo(view, frac_of, cfg, switch_cost)
        cands = self._resize_candidates(view, frac_of, cfg)
        if not cands:
            return []
        reqs = self._resize_requests(cands, switch_cost)
        if self.engine == "torch":
            _, bests = score_reduce_multi(**pack_windows(reqs, self.device))
        else:  # vector: the same per-window argmin, batched numpy
            bests = [
                c["batch"].best_index(
                    c["batch"].scores + c["bias"], nonempty=True
                )
                for c in cands
            ]
        return self._pick_resize(cands, bests, cfg)

    def _propose_solo(
        self, view: NodeView, frac_of, cfg, switch_cost: float
    ) -> List[Launch]:
        """The pre-batching per-job loop: one enumeration + one scoring
        reduction per eligible running job (kept as the reference/baseline
        leg; also the ``python`` engine's path)."""
        best: Optional[Tuple[float, Launch]] = None
        overhead = cfg.ckpt_time + cfg.restart_time
        for rj in view.running:
            if rj.preempted or frac_of(rj) >= 1.0:
                continue
            rem_t = rj.end - view.t  # wall time to completion as-is
            # only the useful-work tail scales with the count: a freshly
            # resumed job's restart head must not inflate the prediction
            useful_rem = rj.end - max(view.t, rj.start + rj.restart)
            if useful_rem <= overhead + cfg.min_gain_s:
                continue
            spec = self._spec(rj.job)
            if len(spec.modes) < 2:
                continue
            try:
                cur = spec.mode(rj.g, rj.f)
            except KeyError:
                continue  # current mode fell to the τ-filter; leave it be
            hypo = self._freed_view(view, rj)
            new = self._best_resize_mode(spec, hypo, switch_cost, rj.g, rj.f)
            if new is None or new == (rj.g, rj.f):
                continue
            g_new, f_new = new
            pred_rem = overhead + useful_rem * (
                spec.mode(g_new, f_new).t_norm / cur.t_norm
            )
            gain = rem_t - pred_rem
            if gain <= cfg.min_gain_s:
                continue
            if best is None or gain > best[0]:
                best = (gain, Launch(job=rj.job, g=g_new, f=f_new))
        return [best[1]] if best is not None else []

    def _resize_candidates(self, view: NodeView, frac_of, cfg) -> List[dict]:
        """The guard prefix of the per-job loop, shared by the batched and
        staged paths: collect every eligible running job's candidate
        window (same guards, same order) with its enumeration done but the
        scoring deferred."""
        overhead = cfg.ckpt_time + cfg.restart_time
        cands: List[dict] = []
        for rj in view.running:
            if rj.preempted or frac_of(rj) >= 1.0:
                continue
            rem_t = rj.end - view.t
            useful_rem = rj.end - max(view.t, rj.start + rj.restart)
            if useful_rem <= overhead + cfg.min_gain_s:
                continue
            spec = self._spec(rj.job)
            if len(spec.modes) < 2:
                continue
            try:
                cur = spec.mode(rj.g, rj.f)
            except KeyError:
                continue
            hypo = self._freed_view(view, rj)
            try:
                batch = self._enumerate([spec], hypo)
            except OverflowError:  # pragma: no cover - single-job windows
                continue
            # single-job window: each non-empty row's total_g IS its count
            # and slot 0 of the padded f plane IS its frequency level
            moved = (batch.total_g != rj.g) | (
                batch.padded_f()[:, 0].astype(np.int64) != rj.f
            )
            cands.append(
                dict(
                    rj=rj, cur=cur, batch=batch, moved=moved,
                    rem_t=rem_t, useful_rem=useful_rem,
                    g_free=hypo.free_units, M=hypo.alive_units,
                )
            )
        return cands

    def _resize_requests(
        self, cands: List[dict], switch_cost: float
    ) -> List[dict]:
        """Kernel request dict per candidate window (the
        ``score_reduce_multi`` shape); also materializes each window's
        switch-cost bias on the candidate entry."""
        reqs = []
        for c in cands:
            batch = c["batch"]
            bias = np.where(
                c["moved"] & (batch.n_jobs > 0), switch_cost, 0.0
            )
            c["bias"] = bias
            dev, g, n = batch.padded_cols()
            reqs.append(
                dict(
                    dev=dev, g=g, n=n, lam=self.lam,
                    g_free=c["g_free"], M=c["M"],
                    f=batch.padded_f() if self.lam_f else None,
                    lam_f=self.lam_f, bias=bias, mask=batch.n_jobs > 0,
                )
            )
        return reqs

    def _pick_resize(
        self, cands: List[dict], bests: Sequence[Optional[int]], cfg
    ) -> List[Launch]:
        """Apply the post-score guards (joint-mode identity, predicted
        min-gain) to the per-window argmins and keep the largest-gain
        proposal — the exact tail of the per-job loop."""
        best: Optional[Tuple[float, Launch]] = None
        overhead = cfg.ckpt_time + cfg.restart_time
        for c, i in zip(cands, bests):
            if i is None or i < 0:
                continue
            action = c["batch"].action(int(i))
            if not action:
                continue
            m = action[0][1]
            rj = c["rj"]
            if (m.g, m.f) == (rj.g, rj.f):
                continue
            pred_rem = overhead + c["useful_rem"] * (
                m.t_norm / c["cur"].t_norm
            )
            gain = c["rem_t"] - pred_rem
            if gain <= cfg.min_gain_s:
                continue
            if best is None or gain > best[0]:
                best = (gain, Launch(job=rj.job, g=m.g, f=m.f))
        return [best[1]] if best is not None else []

    # -- COMPLETE-burst staging --------------------------------------------

    def _resize_sig(self, view: NodeView, switch_cost: float, cfg) -> Tuple:
        """Everything the resize decision is a pure function of: the node
        state the candidate windows were built from, every running job's
        mode/timing fields (candidacy guards and gain predictions read
        them), the effective switch cost (forecast planes condition it on
        mutable queue-pressure state), the cfg knobs, and the perf-model
        version (spec tables).  A staged result is consumed only on an
        exact match, so any drift between the predicted post-COMPLETE
        state and the real one falls back to the solo recomputation."""
        return (
            view.t,
            _mask_of(view.free_map),
            tuple(view.domain_jobs),
            view.total_units,
            view.dead_units,
            view.domains,
            view.free_units,
            tuple(
                (rj.job, rj.g, rj.f, rj.end, rj.start, rj.restart,
                 rj.frac0, rj.preempted, rj.failed, rj.domain,
                 tuple(rj.units))
                for rj in view.running
            ),
            switch_cost,
            (cfg.ckpt_time, cfg.restart_time, cfg.min_gain_s,
             cfg.switch_cost),
            getattr(self.perf_model, "version", 0),
        )

    def stage_resize(self, view: NodeView, *, frac_of, cfg):
        """Phase 1 of a fleet-coordinated COMPLETE burst: build this
        node's resize candidate windows against the *predicted*
        post-completion view and return their kernel requests for the
        coordinator's single cross-node ``score_reduce_multi`` launch.
        Returns None when the imminent solo pass would not launch kernels
        anyway (non-torch engine, batching off, no eligible candidates)."""
        self._staged_resize = None
        if self.engine != "torch" or not self.resize_batch:
            return None
        if view.free_units <= 0 or not view.running:
            return None
        switch_cost = (
            cfg.switch_cost
            if self._plane is None
            else self._plane.resize_switch_cost(self._node, cfg.switch_cost, view.t)
        )
        cands = self._resize_candidates(view, frac_of, cfg)
        if not cands:
            return None
        reqs = self._resize_requests(cands, switch_cost)
        self._staged_resize = {
            "sig": self._resize_sig(view, switch_cost, cfg),
            "cands": cands,
            "bests": None,
        }
        return reqs

    def stage_resize_results(self, bests: Sequence[int]) -> None:
        """Phase 2: park the batched per-window argmins for consumption
        by the next ``propose_resizes`` call (signature-guarded)."""
        st = self._staged_resize
        if st is not None:
            st["bests"] = [int(b) for b in bests]

    def stage_resize_drop(self) -> None:
        self._staged_resize = None

    def _freed_view(
        self, view: NodeView, rj: RunningJob, t: Optional[float] = None,
        scratch: bool = True,
    ) -> NodeView:
        """Hypothetical node state with ``rj``'s units and home domain
        freed — what the node looks like the instant the resize relaunches
        (or, with ``t``, the predicted post-COMPLETE state a burst
        coordinator stages against).  With ``scratch`` (the resize hot
        path) the returned ``free_map`` aliases a per-policy numpy buffer
        and is valid only until the next scratch call — candidates are
        built and enumerated one at a time; pass ``scratch=False`` for a
        view that must outlive the loop."""
        if scratch:
            nu = view.total_units
            buf = self._free_scratch
            if buf is None or buf.shape[0] < nu:
                buf = self._free_scratch = np.empty(nu, dtype=bool)
            free_map = buf[:nu]
            free_map[:] = view.free_map
            for u in rj.units:
                free_map[u] = True
        else:
            free_map = list(view.free_map)
            for u in rj.units:
                free_map[u] = True
        occ = list(view.domain_jobs) if view.domain_jobs else [0] * view.domains
        if occ and 0 <= rj.domain < len(occ) and occ[rj.domain] > 0:
            occ[rj.domain] -= 1
        return NodeView(
            t=view.t if t is None else t,
            total_units=view.total_units,
            domains=view.domains,
            free_units=view.free_units + rj.g,
            running=[r for r in view.running if r is not rj],
            free_map=free_map,
            domain_jobs=occ,
            dead_units=view.dead_units,
        )

    def _best_resize_mode(
        self,
        spec: JobSpec,
        hypo: NodeView,
        switch_cost: float,
        g_cur: int,
        f_cur: int,
    ) -> Optional[Tuple[int, int]]:
        """Best (count, frequency) mode for one job on the freed node
        state, switch-cost biased, scored through whichever backend the
        policy runs on.  "Staying put" is joint-mode identity: a candidate
        at the same count but a different DVFS level pays the switch cost
        too (it still costs a checkpoint/relaunch)."""
        if self.engine == "python":
            scored = enumerate_actions(
                [spec], hypo, list(hypo.free_map),
                lam=self.lam, lam_f=self.lam_f,
                exact_limit=self.exact_limit, beam=self.beam,
            )
            best = None
            for s, a in scored:
                if not a:
                    continue
                m = a[0][1]
                moved = m.g != g_cur or m.f != f_cur
                key = (s + (switch_cost if moved else 0.0), -m.g)
                if best is None or key < best[0]:
                    best = (key, (m.g, m.f))
            return best[1] if best else None
        try:
            batch = self._enumerate([spec], hypo)
        except OverflowError:  # pragma: no cover - single-job windows are tiny
            return None
        # single-job window: each non-empty row's total_g IS its count and
        # slot 0 of the padded f plane IS its frequency level
        moved = (batch.total_g != g_cur) | (
            batch.padded_f()[:, 0].astype(np.int64) != f_cur
        )
        bias = np.where(moved & (batch.n_jobs > 0), switch_cost, 0.0)
        if self.engine == "torch":
            cols = batch.device_cols(self.device, with_f=bool(self.lam_f))
            _, i = score_reduce(
                cols["dev"], cols["g"], cols["n"],
                lam=self.lam, g_free=hypo.free_units, M=hypo.alive_units,
                f=cols["f"], lam_f=self.lam_f, bias=self._bias(bias),
                mask=cols["nonempty"],
            )
            if i < 0:
                return None
        else:
            i = batch.best_index(batch.scores + bias, nonempty=True)
            if i is None:
                return None
        action = batch.action(int(i))
        if not action:
            return None
        m = action[0][1]
        return (m.g, m.f)

    # -- beyond-paper: completion-alignment lookahead ----------------------
    def _lookahead_penalty(self, action, view: NodeView) -> float:
        if len(action) < 2:
            return 0.0
        # t_norm is relative within a job; as a *proxy* for alignment we
        # penalize spread of (t_norm · g) across co-launched jobs.
        loads = [m.t_norm * m.g for _, m in action]
        spread = (max(loads) - min(loads)) / max(max(loads), 1e-9)
        return self.lookahead * spread


def _replay_frontier(cands, order, specs) -> Tuple:
    """Re-break a stored tie frontier in the consumer window's order.

    ``cands`` holds every argmin-optimal action of the decision in
    canonical slot form; the cold argmin picks whichever of them the
    consumer's reference enumeration generates first — rows enumerate by
    ascending action size, then lexicographically by (ascending position
    tuple, mode tuple) — so mapping slots onto this window's positions
    (slot ``c`` holds position ``order[c]``) and taking the minimum of
    that key reproduces the cold choice exactly.  Returns the launch-memo
    pair tuple ((position, g, f), ...) sorted the way ``on_event`` emits
    launches (descending count, then position)."""
    best_key = best = None
    for cand in cands:
        mapped = sorted((c if order is None else order[c], m) for c, m in cand)
        k = (
            len(mapped),
            tuple(p for p, _ in mapped),
            tuple(m for _, m in mapped),
        )
        if best_key is None or k < best_key:
            best_key, best = k, mapped
    return tuple(
        sorted(
            ((p, specs[p].modes[m].g, specs[p].modes[m].f) for p, m in best),
            key=lambda pg: (-pg[1], pg[0]),
        )
    )

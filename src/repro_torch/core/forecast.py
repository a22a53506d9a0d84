"""Forecast-driven control plane.

Elastic actions (migration, resizing) are the dominant lever
under bursty arrivals — and that *eager* point-in-time heuristics lose on
some seeds: a drained node pulls a waiting job an instant before the next
burst lands on it.  This module centralizes the lightweight online
signals the paper's thesis calls for, so every decision layer conditions
on the same forecasts instead of its own point-in-time proxy:

  * **online perf-model refinement** (``RefinedPerfModel``) — Phase-I
    estimates become *priors* that shrink toward observed segment
    runtimes as jobs complete.  The posterior is keyed on the app's
    ground-truth profile object, so every instance of one application —
    across the whole stream — shares one posterior, exactly like the
    Phase-I sharing in ``ProfiledPerfModel``.
  * **queueing-aware wait forecasts** (``ForecastPlane.wait_forecast``) —
    the drain proxy (committed busy unit-seconds per unit, from the
    ``ClusterState`` accumulators) inflated by the M/G/c heavy-traffic
    factor ``1 / (1 - rho)``: while a node drains its backlog, new work
    keeps arriving at rate ``lambda_node = lambda * share``, each job
    bringing ``E[unit-work]`` seconds — the *forecasted* wait, not the
    current one.  ``lambda`` comes from the arrival-rate EWMA
    (``repro_torch.core.arrivals.ArrivalRateEWMA``).
  * **burst risk with hysteresis** (``ForecastPlane.burst_risk``) — the
    short/long rate ratio arms a gate at ``1 + hysteresis_margin`` times
    the baseline and releases it only below ``1 + hysteresis_margin/4``;
    while armed, elastic actions pay a risk penalty (migration demands a
    bigger forecasted-wait gap, resizes a bigger switch-cost margin).
    The hysteresis band is what keeps the gate from chattering between
    consecutive completions of one burst.

Consumers (all rewired through this plane):

  * ``PredictiveDispatcher`` (repro_torch.core.cluster) routes arrivals on
    forecasted wait + energy instead of the raw drain proxy,
  * ``Cluster.simulate``'s default ``migrate_candidate`` replaces the raw
    wait-gap test with forecasted-wait-gap minus the burst-risk penalty
    (the fix for the eager-migration losing seeds),
  * ``EcoSched.propose_resizes`` scales its switch-cost bias by the
    forecasted queue pressure (``resize_switch_cost``) — churn gets more
    expensive exactly when freed units are about to be needed.

Everything is **default-off**: ``forecast=None`` (or a ``ForecastConfig``
with every switch off) never builds a plane, so cluster and single-node
schedules stay bit-identical to the plane-free substrate.  Twin of
``repro.core.forecast``.

Knobs (``ForecastConfig``): ``ewma_horizon`` / ``baseline_horizon`` set
the arrival-rate EWMA windows (effective sample counts),
``hysteresis_margin`` the burst-gate arming band, ``posterior_weight``
the prior strength of the Phase-I estimates in pseudo-segments.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.arrivals import ArrivalRateEWMA
from repro_torch.core.perfmodel import _mk_spec
from repro_torch.core.types import JobSpec, RunningJob


@dataclass(frozen=True)
class ForecastConfig:
    """Knobs for the forecast-driven control plane.  With every switch off
    (or ``forecast=None``) no plane is built and schedules are
    bit-identical to the forecast-free substrate.

    ``posterior_weight`` is the Phase-I prior strength in
    pseudo-segments: an observed segment runtime at count g moves the
    estimate to ``(w·prior + n·observed) / (w + n)`` — small w trusts
    observations quickly, large w keeps the profile-driven prior.

    ``hysteresis_margin`` m sets the burst gate band: arm when the short
    arrival rate exceeds ``(1+m)`` × baseline, release only below
    ``(1+m/4)`` × baseline.  ``risk_horizon_s`` converts armed risk into
    seconds of expected extra drain charged against elastic actions.
    """

    refine: bool = True  # online runtime-posterior refinement
    queueing: bool = True  # M/G/c wait inflation on the drain proxy
    burst_gate: bool = True  # hysteretic burst-risk gating of elastic acts
    # dispatch consumers of the refined posteriors (both are no-ops
    # unless ``refine`` built per-node models):
    # dispatch_refine — EnergyAware/Predictive dispatchers read
    # posterior-blended (E*, t*) tables instead of the static priors, so
    # dispatch and per-node placement see the *same* model;
    # migration_relief_weight — the migrate accept additionally credits
    # the freeing of the donor's queue (each remaining waiter's forecasted
    # wait drops by the moved job's drain seconds), weighted by this —
    # 0 restores the myopic single-job gain.
    dispatch_refine: bool = True
    migration_relief_weight: float = 1.0
    posterior_weight: float = 4.0  # Phase-I prior strength (pseudo-segments)
    ewma_horizon: int = 4  # short-horizon arrival-rate EWMA (samples)
    baseline_horizon: int = 64  # long-run baseline EWMA (samples)
    hysteresis_margin: float = 0.5  # burst gate arms at (1+m)×baseline rate
    risk_horizon_s: float = 600.0  # horizon burst work is charged over
    pressure_gain: float = 1.0  # switch-cost inflation per unit pressure
    rho_cap: float = 0.75  # forecasted-utilization clamp in out·(1+rho)
    # sustained-load clamp for the queueing forecast: rho uses
    # min(lambda_short, clamp × lambda_baseline).  Within a same-instant
    # burst the short rate spikes orders of magnitude above anything
    # sustainable — that spike is the *burst gate's* signal; feeding it to
    # the M/G/c term would double-count members already sitting in the
    # drain proxy and over-spread routing
    lambda_clamp: float = 2.0

    @property
    def enabled(self) -> bool:
        return self.refine or self.queueing or self.burst_gate


class RefinedPerfModel:
    """Wraps a Phase-I perf model; observed segment runtimes shrink the
    prior toward the truth (tentpole part (a)).

    The base model's normalized estimates ``t_norm(g)`` are the prior
    *shape*; observations are absolute seconds.  The blend anchors the
    prior to the observed scale — ``s`` is the observation-weighted mean
    of ``observed(g) / t_norm(g)`` — then shrinks each observed count:

        t_post(g) = (w · s·t_norm(g) + n_g · mean_obs(g)) / (w + n_g)

    with ``w = posterior_weight`` pseudo-segments.  Unobserved counts
    keep the prior shape (scaled by ``s``, which cancels under
    ``_mk_spec``'s renormalization), so one observation at g=2 improves
    the *relative* estimate of every other count only through the ratios
    that were actually measured.  Power blends the same way from the
    observed draw.

    Posteriors are keyed on the app's ground-truth ``JobProfile`` object
    (the same aliasing ``ProfiledPerfModel`` uses for its noise-free mode
    sharing), so every instance of an application shares one posterior;
    a base model without a ``truth`` table falls back to per-job keys.

    ``version`` bumps on every accepted observation — policies that cache
    τ-filtered specs (EcoSched) invalidate on it.
    """

    def __init__(self, base, *, weight: float = 4.0):
        assert weight > 0.0
        self.base = base
        self.weight = weight
        self.version = 0
        self._truth = getattr(base, "truth", None)
        # profile-key -> {(g, f): (n_t, mean_t, n_p, mean_p)} — keyed on
        # the joint (count, frequency-level) mode so DVFS runs refine each
        # operating point separately; power keeps its own count so t-only
        # observations never dilute the power mean
        self._obs: Dict[
            object, Dict[Tuple[int, int], Tuple[int, float, int, float]]
        ] = {}
        self._ver_of: Dict[object, int] = {}
        self._profiles: List[object] = []  # pin ids while keyed on them
        self._spec_cache: Dict[str, Tuple[int, JobSpec]] = {}

    def _key(self, job: str):
        if self._truth is not None:
            prof = self._truth.get(job)
            if prof is not None:
                return id(prof)
        return job

    def observe(
        self, job: str, g: int, t_obs: float, p_obs: float = 0.0, f: int = 0
    ) -> None:
        """One completed segment: solo-equivalent full runtime ``t_obs``
        seconds at count ``g`` and frequency level ``f`` (and the observed
        busy power, if known)."""
        if t_obs <= 0.0:
            return
        key = self._key(job)
        if key not in self._obs and self._truth is not None:
            self._profiles.append(self._truth.get(job))
        d = self._obs.setdefault(key, {})
        n, mt, np_, mp = d.get((g, f), (0, 0.0, 0, 0.0))
        n += 1
        mt += (t_obs - mt) / n
        if p_obs > 0.0:
            np_ += 1
            mp += (p_obs - mp) / np_
        d[(g, f)] = (n, mt, np_, mp)
        self._ver_of[key] = self._ver_of.get(key, 0) + 1
        self.version += 1

    def spec(self, job: str) -> JobSpec:
        base_spec = self.base.spec(job)
        key = self._key(job)
        obs = self._obs.get(key)
        if not obs:
            return base_spec  # no observations: the prior passes through
        ver = self._ver_of[key]
        hit = self._spec_cache.get(job)
        if hit is not None and hit[0] == ver:
            return hit[1]
        prior_t = {(m.g, m.f): m.t_norm for m in base_spec.modes}
        prior_p = {(m.g, m.f): m.p_bar for m in base_spec.modes}
        seen = [(k, n, mt) for k, (n, mt, _, _) in obs.items() if k in prior_t]
        if not seen:
            return base_spec  # observed modes all fell outside the prior
        # anchor the relative prior to the observed absolute scale
        n_tot = sum(n for _, n, _ in seen)
        s = sum(n * (mt / prior_t[k]) for k, n, mt in seen) / n_tot
        w = self.weight
        t_post, p_post = {}, {}
        for m in base_spec.modes:
            k = (m.g, m.f)
            n, mt, np_, mp = obs.get(k, (0, 0.0, 0, 0.0))
            t_post[k] = (w * s * prior_t[k] + n * mt) / (w + n)
            p_post[k] = (
                (w * prior_p[k] + np_ * mp) / (w + np_)
                if np_
                else prior_p[k]
            )
        spec = _mk_spec(job, t_post, p_post)
        self._spec_cache[job] = (ver, spec)
        if len(self._spec_cache) > 100_000:
            self._spec_cache.clear()  # bound endless-stream growth
        return spec

    def profiling_energy(self, job: str) -> float:
        return self.base.profiling_energy(job)

    def posterior_curves(
        self, prof, *, limit: Optional[int] = None
    ) -> Optional[Dict[Tuple[int, int], Tuple[float, float]]]:
        """Posterior (runtime s, busy power W) per feasible (count,
        frequency-level) mode for the app whose ground-truth profile is
        ``prof``, blending the caller's absolute prior (the profile
        itself) toward this node's observed segments with the usual
        ``(w·prior + n·obs) / (w + n)`` shrink.  ``None`` when this node
        has no observations of the app — callers keep their static
        tables.  This is the dispatch-table feed
        (``ForecastPlane.dispatch_tables``): unlike ``spec()``, the prior
        here is the dispatcher's calibrated truth, not the Phase-I noisy
        estimate, because that is the table being corrected."""
        obs = self._obs.get(id(prof))
        if not obs:
            return None
        w = self.weight
        out: Dict[Tuple[int, int], Tuple[float, float]] = {}
        for g in prof.feasible_counts:
            if limit is not None and g > limit:
                continue
            for f in prof.freq_levels:
                n, mt, np_, mp = obs.get((g, f), (0, 0.0, 0, 0.0))
                t_post = (w * prof.runtime_at(g, f) + n * mt) / (w + n)
                p_post = (
                    (w * prof.power_at(g, f) + np_ * mp) / (w + np_)
                    if np_
                    else prof.power_at(g, f)
                )
                out[(g, f)] = (t_post, p_post)
        return out or None


class ForecastPlane:
    """The shared online-signal state for one simulation run.

    Owns the arrival-rate EWMA, per-node routing shares and service-work
    EWMAs, the hysteretic burst gate, and the per-node refined perf
    models.  The event substrate feeds it (``on_arrival`` /
    ``on_launch`` / ``on_complete``); dispatchers, the migration gate and
    EcoSched's resize bias read it.  Built by ``simulate`` /
    ``Cluster.simulate`` when ``forecast`` is enabled; never constructed
    on the default path.
    """

    def __init__(
        self,
        cfg: ForecastConfig,
        units: Dict[str, int],
        *,
        state=None,  # ClusterState (cluster runs) or None (single node)
        elastic=None,  # ElasticConfig, for checkpoint-segment accounting
    ):
        self.cfg = cfg
        self.units = {nm: float(u) for nm, u in units.items()}
        self.state = state
        self.elastic = elastic
        self.rate = ArrivalRateEWMA(cfg.ewma_horizon, cfg.baseline_horizon)
        self._alpha = 2.0 / (cfg.ewma_horizon + 1)
        self._work: Dict[str, float] = {}  # EWMA busy unit-s per launch
        self._routed: Dict[str, int] = {nm: 0 for nm in units}
        self._models: Dict[str, RefinedPerfModel] = {}
        self._armed = False
        # dispatch-table overlay state (bind_dispatch / dispatch_tables)
        self._dispatch_truth: Optional[Dict[str, Dict[str, object]]] = None
        self._tables: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._tables_ver: Optional[Tuple[int, ...]] = None
        # observability counters (surfaced via summary())
        self.gate_flips = 0
        self.migrations_vetoed = 0
        self.refinements = 0

    # -- wiring --------------------------------------------------------------

    def refined_model(self, nm: str, base):
        """Wrap one node policy's perf model; pass-through when refinement
        is off (so ``attach_forecast`` is always safe to call)."""
        if not self.cfg.refine:
            return base
        if isinstance(base, RefinedPerfModel):  # idempotent attach
            self._models[nm] = base
            return base
        model = RefinedPerfModel(base, weight=self.cfg.posterior_weight)
        self._models[nm] = model
        return model

    def bind_dispatch(self, app_truth: Dict[str, Dict[str, object]]) -> None:
        """Give the plane the dispatcher's per-node app->JobProfile tables
        so ``dispatch_tables`` can rebuild (E*, t*) cells from posteriors.
        Called by the cluster run when a plane exists; harmless otherwise."""
        self._dispatch_truth = app_truth
        self._tables = None
        self._tables_ver = None

    def dispatch_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-(node, app) best-mode (energy, runtime) tables for the
        dispatchers, with every cell a node has *observed* re-derived from
        that node's refined posterior — dispatch and per-node placement see
        the same model.  Falls back to the static
        ``ClusterState`` priors when refinement (or ``dispatch_refine``)
        is off or nothing has been observed.  Rebuilds are cached keyed on
        the tuple of per-node model versions, so the arrays are only
        recomputed after an accepted observation."""
        st = self.state
        assert st is not None, "dispatch_tables needs a ClusterState"
        if (
            not (self.cfg.refine and self.cfg.dispatch_refine)
            or self._dispatch_truth is None
            or not self._models
        ):
            return st.e_best, st.t_best
        ver = tuple(m.version for m in self._models.values())
        if self._tables is not None and self._tables_ver == ver:
            return self._tables
        e = np.array(st.e_best)
        t = np.array(st.t_best)
        for nm, model in self._models.items():
            ni = st.index.get(nm)
            truth = self._dispatch_truth.get(nm)
            if ni is None or not truth:
                continue
            for app, ai in st.app_index.items():
                if not st.fits[ni, ai]:
                    continue
                prof = truth.get(app)
                if prof is None:
                    continue
                curves = model.posterior_curves(prof, limit=int(st.units[ni]))
                if curves is None:
                    continue
                eb, tb = min((tt * pp, tt) for tt, pp in curves.values())
                e[ni, ai] = eb
                t[ni, ai] = tb
        self._tables = (e, t)
        self._tables_ver = ver
        return self._tables

    # -- substrate feeds -----------------------------------------------------

    def on_arrival(self, t: float, nm: Optional[str] = None) -> None:
        self.rate.observe(t)
        if nm is not None and nm in self._routed:
            self._routed[nm] += 1
        # arm/release the burst gate at arrival instants with the raw
        # (uncensored) EWMA ratio: a burst is only *visible* while its
        # members land — a lazy decision-time check would consistently
        # sample the post-burst silence and never arm
        if self.cfg.burst_gate:
            self._update_gate(self.rate.burst_factor())

    def on_launch(self, nm: str, rj: RunningJob) -> None:
        w = (rj.end - rj.start) * rj.g  # committed busy unit-seconds
        prev = self._work.get(nm)
        self._work[nm] = w if prev is None else prev + self._alpha * (w - prev)

    def on_complete(self, nm: str, rj: RunningJob) -> None:
        """A segment finished (COMPLETE, or the PREEMPT checkpoint-write
        end): convert its wall time back to a solo-equivalent full runtime
        at its count and feed the posterior.  The launch-time interference
        factor is divided out — the simulator re-applies it to whatever
        the policy launches next, so leaving it in would double-count
        co-schedule slowdown for counts that co-run more often."""
        if not self.cfg.refine:
            return
        model = self._models.get(nm)
        if model is None:
            return
        if rj.preempted:
            if self.elastic is None:
                return
            # rj.end was retimed to the checkpoint-write end; the run
            # segment itself spans [start + restart, end - ckpt_time]
            useful = (rj.end - self.elastic.ckpt_time) - rj.start - rj.restart
            frac = rj.frac_ckpt - rj.frac0
        else:
            useful = rj.end - rj.start - rj.restart
            frac = 1.0 - rj.frac0
        if frac <= 1e-9 or useful <= 0.0:
            return
        solo = useful / frac / max(rj.factor, 1.0)
        model.observe(rj.job, rj.g, solo, rj.power, rj.f)
        self.refinements += 1

    # -- forecasts -----------------------------------------------------------

    def _rho(self, nm: str, now: float) -> float:
        """Forecasted utilization of node ``nm``: sustained incoming work
        rate (jobs/s × the node's routed share × E[unit-work]) per unit.
        The rate is the short-horizon EWMA clamped at ``lambda_clamp`` ×
        the baseline — reactive to regime shifts, blind to the
        within-burst spike (see ``ForecastConfig.lambda_clamp``)."""
        lam = self.rate.rate(now)
        base = self.rate.baseline_rate()
        if base > 0.0:
            lam = min(lam, self.cfg.lambda_clamp * base)
        if lam <= 0.0:
            return 0.0
        w = self._work.get(nm)
        if w is None:
            return 0.0  # no launches observed here yet: no inflation
        total = sum(self._routed.values())
        share = (self._routed[nm] + 1.0) / (total + len(self._routed))
        return min(lam * share * w / self.units[nm], self.cfg.rho_cap)

    def wait_forecast(self, now: float) -> np.ndarray:
        """Per-node forecasted wait (s): the ClusterState drain proxy
        inflated by the work expected to land while the backlog drains —
        ``out · (1 + rho)``, the first-order M/G/c heavy-traffic
        correction.  (The full ``1/(1-rho)`` geometric form over-commits
        here: same-instant burst members are already *in* the proxy as
        they route, so the resolvent double-counts exactly when rho
        spikes; the bounded first-order term does better from sparse to
        saturated load.)
        Falls back to the raw proxy with ``queueing`` off (or before
        warm-up)."""
        assert self.state is not None, "wait_forecast needs a ClusterState"
        out = self.state.outstanding(now)
        if not self.cfg.queueing:
            return out
        fc = np.array(out, dtype=float)
        for i, nm in enumerate(self.state.names):
            rho = self._rho(nm, now)
            if rho > 0.0:
                fc[i] = out[i] * (1.0 + rho)
        return fc

    def _update_gate(self, f: float) -> None:
        """Hysteresis: arm above ``(1+m)`` × baseline, release only below
        ``(1+m/4)`` — the band keeps the gate from chattering between
        consecutive completions of one burst."""
        m = self.cfg.hysteresis_margin
        if self._armed:
            if f < 1.0 + 0.25 * m:
                self._armed = False
                self.gate_flips += 1
        elif f >= 1.0 + m:
            self._armed = True
            self.gate_flips += 1

    def burst_risk(self, now: float) -> float:
        """Hysteretic burst signal in [0, 1].  0 while the gate is
        released; while armed, scales with how far the *censored*
        short-horizon rate still sits above the release threshold — so
        an armed gate decays through post-burst silence instead of
        latching forever."""
        if not self.cfg.burst_gate:
            return 0.0
        f = self.rate.burst_factor(now)
        self._update_gate(f)
        if not self._armed:
            return 0.0
        m = self.cfg.hysteresis_margin
        lo = 1.0 + 0.25 * m
        hi = 1.0 + m
        return float(min(1.0, max(f - lo, 0.0) / max(hi - lo, 1e-9)))

    def migration_penalty_s(self, nm: str, now: float) -> float:
        """Extra forecasted-wait gap (s) a migration onto ``nm`` must
        clear while the burst gate is armed: the work a burst is expected
        to deliver to this node over ``risk_horizon_s``, in drain
        seconds.  0 when the gate is released."""
        risk = self.burst_risk(now)
        if risk <= 0.0:
            return 0.0
        lam = self.rate.rate(now)
        works = [w for w in self._work.values() if w > 0.0]
        if lam <= 0.0 or not works:
            return 0.0
        inflow = lam * (sum(works) / len(works)) / self.units[nm]
        return risk * min(inflow, 2.0) * self.cfg.risk_horizon_s

    def resize_switch_cost(self, nm: str, base: float, now: float) -> float:
        """Switch-cost bias conditioned on forecasted queue pressure:
        churn gets more expensive as burst risk and the node's forecasted
        utilization rise (tentpole consumer (c))."""
        pressure = self.burst_risk(now) + (
            self._rho(nm, now) if self.cfg.queueing else 0.0
        )
        return base * (1.0 + self.cfg.pressure_gain * pressure)

    # -- observability -------------------------------------------------------

    def summary(self) -> Dict[str, float]:
        """Forecast-state rollup attached to results (types.py)."""
        refined_apps = sum(len(m._obs) for m in self._models.values())
        return {
            "arrivals_observed": float(self.rate.n_gaps + 1 if self.rate.last_t is not None else 0),
            "rate_short": self.rate.rate(),
            "rate_baseline": self.rate.baseline_rate(),
            "burst_factor": self.rate.burst_factor(),
            "burst_armed": float(self._armed),
            "gate_flips": float(self.gate_flips),
            "migrations_vetoed": float(self.migrations_vetoed),
            "refinements": float(self.refinements),
            "refined_apps": float(refined_apps),
        }

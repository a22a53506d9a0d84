"""Phase I — lightweight online performance modeling (paper §III-B).

The paper profiles each queued application *briefly* at every feasible GPU
count on debug nodes, recording GPU DRAM utilization and power, then maps
utilization to **normalized** runtime — never absolute runtime.

``ProfiledPerfModel`` reproduces that faithfully in simulation: the only
ground-truth it reads is the profiling *signal* (``dram_util`` and busy
power, both measurable in seconds of profiling), plus multiplicative
measurement noise.  The runtime estimator inverts the bandwidth identity

    runtime(g) ∝ mem_work / (util(g) · g · BW_unit)

whose unknown per-app constant cancels under normalization — exactly why
the paper's relative-not-absolute modeling works.  Estimates are computed
once per job and cached (paper: "this profiling stage only needs to be
performed once").

``_mk_spec`` is the shared spec constructor both models normalize
through.  Twin of ``repro.core.perfmodel``; the numpy generators are
seeded exactly as there, so both packages draw the same estimates.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.types import JobProfile, JobSpec, ModeEstimate

def _stable_seed(*parts) -> int:
    import hashlib

    h = hashlib.md5("|".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:4], "little")



def _key_gf(k) -> tuple:
    """Normalize a mode key: a bare count ``g`` means (g, base clock);
    a ``(g, f)`` tuple names the joint (count, frequency-level) mode."""
    if isinstance(k, tuple):
        return int(k[0]), int(k[1])
    return int(k), 0


def _mk_spec(name: str, t_hat: Dict, p_hat: Dict) -> JobSpec:
    """Shared spec constructor over the joint mode set.  Keys are bare
    counts (single-frequency — today's behavior, bit-identical) or
    ``(g, f)`` tuples; sorted key order puts modes in (g, f) order, which
    collapses to the historical g order when every key is a bare count."""
    t_min = min(t_hat.values())
    e_raw = {k: p_hat[k] * (t_hat[k] / t_min) for k in t_hat}
    e_min = min(e_raw.values())
    modes = []
    for k in sorted(t_hat):
        g, f = _key_gf(k)
        modes.append(
            ModeEstimate(
                g=g,
                t_norm=t_hat[k] / t_min,
                p_bar=p_hat[k],
                e_norm=e_raw[k] / e_min,
                f=f,
            )
        )
    return JobSpec(name=name, modes=tuple(modes))


class DomainInterferenceModel:
    """Residual-interference slowdown keyed on *actual* domain co-residency
    (``JobRecord.domain`` records it).

    The count-only proxy (``calibration.cross_numa_slowdown``) charges a
    flat penalty whenever *anything* co-runs and a fixed cross-domain
    penalty for g=3 — it cannot distinguish a clean one-job-per-domain
    placement from two jobs squeezed into one domain.  This model reads
    the real placement the simulator just made (``domain_aware = True``
    makes ``NodeSim`` pass it) and composes three effects:

      * ``shared``   — the launched job's home domain already hosts
        another job's home (CPU-side resources genuinely contended),
      * ``span``     — the job's contiguous unit range crosses a domain
        boundary while anything co-runs (remote-domain traffic; the
        paper's 3-GPU case),
      * ``residual`` — co-running in fully disjoint domains (shared
        fabric/power residuals; near 1 with NUMA-aware placement).

    Factors compose multiplicatively; a solo job is always 1.0.
    """

    domain_aware = True

    def __init__(
        self,
        *,
        shared: float = 1.08,
        span: float = 1.05,
        residual: float = 1.02,
    ):
        assert min(shared, span, residual) >= 1.0
        self.shared = shared
        self.span = span
        self.residual = residual

    def __call__(
        self,
        job: str,
        g: int,
        co_running,
        *,
        units=None,
        domain=None,
        running=None,
        total_units=None,
        domains=None,
    ) -> float:
        if not co_running:
            return 1.0
        if units is None or running is None:  # legacy call: count-only info
            return self.residual
        from repro_torch.core.placement import domains_of_units

        factor = self.residual
        if any(r.domain == domain for r in running):
            factor *= self.shared
        if len(domains_of_units(units, total_units, domains)) > 1:
            factor *= self.span
        return factor


class ProfiledPerfModel:
    """Paper-faithful Phase I (simulated brief profiling)."""

    def __init__(
        self,
        truth: Dict[str, JobProfile],
        *,
        noise: float = 0.03,
        seed: int = 0,
    ):
        self.truth = truth
        self.noise = noise
        self.seed = seed
        self._cache: Dict[str, JobSpec] = {}
        # noise-free mode tuples shared per profile *object*: cluster truth
        # tables alias one JobProfile across every instance of an app, so
        # Phase I runs once per app, not once per arriving instance.  The
        # profile list pins the ids the dict is keyed on.
        self._noiseless: Dict[int, tuple] = {}
        self._noiseless_refs: list = []

    def spec(self, job: str) -> JobSpec:
        hit = self._cache.get(job)
        if hit is not None:
            return hit
        prof = self.truth[job]
        if self.noise == 0.0:
            modes = self._noiseless.get(id(prof))
            if modes is None:
                t_hat, p_hat = self._estimate(prof, None)
                modes = _mk_spec(job, t_hat, p_hat).modes
                self._noiseless[id(prof)] = modes
                self._noiseless_refs.append(prof)
            spec = JobSpec(name=job, modes=modes)
        else:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, _stable_seed(job)])
            )
            t_hat, p_hat = self._estimate(prof, rng)
            spec = _mk_spec(job, t_hat, p_hat)
        self._cache[job] = spec
        return spec

    def _estimate(self, prof: JobProfile, rng):
        t_hat, p_hat = {}, {}
        levels = prof.freq_levels
        multi = len(levels) > 1
        for g in prof.feasible_counts:
            util = prof.dram_util.get(g)
            if util:
                # bandwidth-identity estimator from the profiling signal
                t_rel = 1.0 / (util * g)
            else:
                t_rel = prof.runtime[g]  # degenerate fallback (tests)
            eps = 1.0 + (rng.normal(0.0, self.noise) if rng is not None else 0.0)
            p_eps = 1.0 + (
                rng.normal(0.0, self.noise / 2) if rng is not None else 0.0
            )
            if not multi:
                t_hat[g] = t_rel * max(eps, 0.5)
                p_hat[g] = prof.busy_power[g] * p_eps
            else:
                # the frequency response is the chip's analytic curve, so
                # one profiling draw per count fans out across its levels
                # (the noise models count-profiling error, not DVFS)
                for f in levels:
                    t_hat[(g, f)] = t_rel * prof.freq_time[f] * max(eps, 0.5)
                    p_hat[(g, f)] = prof.power_at(g, f) * p_eps
        return t_hat, p_hat

    def profiling_energy(self, job: str) -> float:
        return self.truth[job].profiling_energy


class OraclePerfModel:
    """Perfect-knowledge estimates (used by the Oracle and for ablations)."""

    def __init__(self, truth: Dict[str, JobProfile]):
        self.truth = truth
        self._cache: Dict[str, JobSpec] = {}

    def spec(self, job: str) -> JobSpec:
        if job not in self._cache:
            prof = self.truth[job]
            if len(prof.freq_levels) > 1:
                t_hat = {
                    (g, f): prof.runtime_at(g, f)
                    for g in prof.feasible_counts
                    for f in prof.freq_levels
                }
                p_hat = {
                    (g, f): prof.power_at(g, f)
                    for g in prof.feasible_counts
                    for f in prof.freq_levels
                }
                self._cache[job] = _mk_spec(job, t_hat, p_hat)
            else:
                self._cache[job] = _mk_spec(
                    job, dict(prof.runtime), dict(prof.busy_power)
                )
        return self._cache[job]

    def profiling_energy(self, job: str) -> float:
        return 0.0


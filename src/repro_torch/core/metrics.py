"""Evaluation metrics (paper §IV): energy saving, makespan improvement,
EDP saving, per-application performance loss."""
from __future__ import annotations

from typing import Dict

from repro_torch.core.types import JobProfile, ScheduleResult


def energy_saving(base: ScheduleResult, x: ScheduleResult) -> float:
    return 1.0 - x.total_energy / base.total_energy


def makespan_improvement(base: ScheduleResult, x: ScheduleResult) -> float:
    return 1.0 - x.makespan / base.makespan


def edp_saving(base: ScheduleResult, x: ScheduleResult) -> float:
    return 1.0 - x.edp / base.edp


def perf_loss(result: ScheduleResult, truth: Dict[str, JobProfile]) -> Dict[str, float]:
    """Per-job runtime increase vs. solo execution at the performance-optimal
    count (the paper's Fig. 9 metric).  Preempted jobs have several run
    segments (repro_torch.core.events); their occupied time is summed, so the
    checkpoint/restart overhead shows up as performance loss."""
    occupied: Dict[str, float] = {}
    for r in result.records:
        occupied[r.job] = occupied.get(r.job, 0.0) + (r.end - r.start)
    out = {}
    for job, busy in occupied.items():
        prof = truth[job]
        best = prof.runtime[prof.optimal_count()]
        out[job] = busy / best - 1.0
    return out


def elastic_summary(result) -> Dict[str, float]:
    """Elastic-substrate counters for a ``ScheduleResult`` or
    ``ClusterResult``: checkpoints taken, completed migrations, count
    resizes, and the checkpoint-write energy (already inside busy energy)."""
    migrations = getattr(result, "migrations", None)
    if migrations is None:
        migrations = result.migrations_in
    return {
        "preemptions": result.preemptions,
        "migrations": migrations,
        "resizes": result.resizes,
        "ckpt_energy": result.ckpt_energy,
    }


def summarize(base: ScheduleResult, x: ScheduleResult) -> Dict[str, float]:
    return {
        "energy_saving": energy_saving(base, x),
        "makespan_improvement": makespan_improvement(base, x),
        "edp_saving": edp_saving(base, x),
    }

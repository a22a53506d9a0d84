"""Seeded, deterministic fault injection for the cluster simulator.

The fault plane threads node failures, partial GPU
degradation, job crashes, and straggler slowdowns through the typed
event substrate (`core/events.py`).  This module holds the *model*:
``FaultConfig`` describes the fault process, ``FaultInjector`` draws
from it deterministically.

Determinism is the whole game — the daemon's crash-recovery contract
(replay the journal through a fresh backend, require bit-identical
transitions) only survives faults if every draw is a pure function of
``(seed, stream key)``, never of wall-clock, iteration order, or
Python's per-process hash randomization.  So every stream derives its
RNG from ``sha256(f"{seed}:{key}")``:

  * per-node uptime/downtime cycles keyed by node name,
  * per-(job, segment) crash offsets — an exponential time-to-crash
    hazard, so *exposure time* matters and checkpoints genuinely bound
    the loss (the draw is schedule-independent, which keeps seeded
    fault traces identical across the python/vector/torch engines),
  * per-(job, segment) straggler draws.

The substrate's checkpoint/restart + migration machinery is the
recovery primitive.  Twin of ``repro.core.faults``: the sha256-keyed
streams are drawn exactly as there, so both packages see one fault trace.
"""
from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass
from typing import Tuple

__all__ = ["FaultConfig", "FaultInjector"]


@dataclass(frozen=True)
class FaultConfig:
    """The fault process.  All rates default *off*: ``FaultConfig()``
    is inert, and ``faults=None`` everywhere rides the exact pre-fault
    code path bit-identically.

    ``node_mtbf_s``     mean time between node failures (0 = never).
    ``node_mttr_s``     mean time to repair a failed node.
    ``degrade_frac``    probability a node failure is *partial*: the
                        node loses ``degrade_units`` GPUs instead of
                        all of them, and keeps scheduling on the rest.
    ``degrade_units``   GPUs lost in a partial failure.
    ``job_mtbf_s``      mean time to crash per running job (0 = never);
                        an exponential hazard over *execution* time, so
                        a job checkpointed often loses little per crash.
    ``straggler_prob``  per-(job, segment) probability of a straggler
                        slowdown (factor multiplied into the segment's
                        interference factor).
    ``straggler_factor`` the slowdown when it hits.
    ``max_retries``     crash/kill retries before a job is marked lost.
    ``retry_base_s``    first retry delay; doubles (``retry_mult``) per
                        retry, capped at ``retry_cap_s``.
    ``restart_time``    relaunch overhead charged when a killed job
                        restarts and no ``ElasticConfig`` supplies one.
    """

    seed: int = 0
    node_mtbf_s: float = 0.0
    node_mttr_s: float = 600.0
    degrade_frac: float = 0.0
    degrade_units: int = 1
    job_mtbf_s: float = 0.0
    straggler_prob: float = 0.0
    straggler_factor: float = 1.5
    max_retries: int = 3
    retry_base_s: float = 30.0
    retry_mult: float = 2.0
    retry_cap_s: float = 1800.0
    restart_time: float = 15.0

    @property
    def enabled(self) -> bool:
        return (
            self.node_mtbf_s > 0
            or self.job_mtbf_s > 0
            or self.straggler_prob > 0
        )

    def signature(self) -> str:
        """Compact deterministic identity for ``describe()`` — two
        backends with different fault processes must not share a
        journal."""
        return (
            f"s{self.seed}"
            f":n{self.node_mtbf_s:g}/{self.node_mttr_s:g}"
            f":d{self.degrade_frac:g}x{self.degrade_units}"
            f":j{self.job_mtbf_s:g}"
            f":g{self.straggler_prob:g}x{self.straggler_factor:g}"
            f":r{self.max_retries}"
        )


def _stream(seed: int, key: str) -> random.Random:
    """A named RNG stream: stable across processes and engine
    backends (sha256, *not* ``hash()`` which is salted per-process)."""
    digest = hashlib.sha256(f"{seed}:{key}".encode()).digest()
    return random.Random(int.from_bytes(digest[:8], "big"))


def _exp(rng: random.Random, mean: float) -> float:
    # inline expovariate on the u-draw so the stream stays stable even
    # if random.Random.expovariate's implementation shifts
    u = rng.random()
    while u <= 1e-12:  # pragma: no cover - astronomically unlikely
        u = rng.random()
    return -mean * math.log(u)


class FaultInjector:
    """Deterministic draws from a ``FaultConfig``.

    Node streams are stateful iterators (cycle after cycle); job
    streams are pure functions of ``(job, segment)`` so the same
    segment always gets the same crash offset regardless of when, or
    on which engine backend, it is scheduled.
    """

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self._node_rng = {}

    # -- per-node failure timeline ------------------------------------
    def next_cycle(self, node: str, units: int) -> Tuple[float, float, int]:
        """``(up_dt, down_dt, k_lost)`` for the node's next failure:
        fail after ``up_dt`` healthy seconds, losing ``k_lost`` GPUs,
        repaired ``down_dt`` seconds later."""
        rng = self._node_rng.get(node)
        if rng is None:
            rng = self._node_rng[node] = _stream(self.cfg.seed, f"node:{node}")
        up = _exp(rng, self.cfg.node_mtbf_s)
        down = _exp(rng, self.cfg.node_mttr_s)
        if rng.random() < self.cfg.degrade_frac:
            k = min(self.cfg.degrade_units, units)
        else:
            k = units
        return up, down, k

    # -- per-(job, segment) crash hazard ------------------------------
    def crash_offset(self, job: str, segment: int) -> float:
        """Exponential time-to-crash for this execution segment,
        measured from its launch.  ``inf`` when the hazard is off."""
        if self.cfg.job_mtbf_s <= 0:
            return math.inf
        rng = _stream(self.cfg.seed, f"job:{job}:{segment}")
        return _exp(rng, self.cfg.job_mtbf_s)

    # -- per-(job, segment) straggler ----------------------------------
    def straggler(self, job: str, segment: int) -> float:
        """Slowdown factor for this segment (1.0 = healthy)."""
        if self.cfg.straggler_prob <= 0:
            return 1.0
        rng = _stream(self.cfg.seed, f"straggle:{job}:{segment}")
        if rng.random() < self.cfg.straggler_prob:
            return self.cfg.straggler_factor
        return 1.0

    # -- retry/backoff --------------------------------------------------
    def retry_delay(self, count: int) -> float:
        """Capped exponential backoff for a job's ``count``-th retry
        (0-based)."""
        return min(
            self.cfg.retry_base_s * self.cfg.retry_mult ** count,
            self.cfg.retry_cap_s,
        )

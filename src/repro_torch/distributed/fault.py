"""Fault tolerance: failure injection, straggler detection, elastic rescale.

A copy of ``repro.distributed.fault`` (pure Python).

On a real pod these signals come from the runtime (missing heartbeats,
slow all-reduce participants); here they are injectable so the recovery
paths are *testable on CPU*:

* ``FailureInjector``   — raises ``DeviceFailure`` at a chosen step; the
  Trainer catches it, shrinks the mesh to the surviving devices, restores
  the last checkpoint with the new shardings, and resumes (checkpoints
  are mesh-elastic by construction — checkpoint/ckpt.py).
* ``StragglerMonitor``  — EMA step-time watchdog; sustained deviation
  triggers a re-schedule callback (EcoSched re-invokes its window and can
  rescale the job at the next checkpoint boundary).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


class DeviceFailure(RuntimeError):
    def __init__(self, message: str, failed_devices: Optional[List[int]] = None):
        super().__init__(message)
        self.failed_devices = failed_devices or []


@dataclass
class FailureInjector:
    """Deterministic failure schedule: {step: number of devices lost}."""

    schedule: dict = field(default_factory=dict)
    fired: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.schedule and step not in self.fired:
            self.fired.add(step)
            n = self.schedule[step]
            raise DeviceFailure(f"injected failure at step {step}: lost {n} device(s)",
                                failed_devices=list(range(n)))


@dataclass
class StragglerMonitor:
    """EMA step-time watchdog (straggler mitigation hook).

    ``on_straggle(step, ratio)`` fires when a step exceeds ``threshold`` ×
    the EMA for ``patience`` consecutive steps.
    """

    alpha: float = 0.1
    threshold: float = 1.8
    patience: int = 3
    on_straggle: Optional[Callable[[int, float], None]] = None

    _ema: float = 0.0
    _strikes: int = 0
    events: List[int] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self._ema == 0.0:
            self._ema = dt
            return False
        ratio = dt / self._ema
        slow = ratio > self.threshold
        self._strikes = self._strikes + 1 if slow else 0
        # slow steps should not drag the EMA up (they are anomalies)
        if not slow:
            self._ema = (1 - self.alpha) * self._ema + self.alpha * dt
        if self._strikes >= self.patience:
            self._strikes = 0
            self.events.append(step)
            if self.on_straggle is not None:
                self.on_straggle(step, ratio)
            return True
        return False

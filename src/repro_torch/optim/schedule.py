"""Learning-rate schedules (pure functions of the step counter).

Twin of ``repro.optim.schedule``: the rate is a float32 scalar tensor on
the step counter's device (the CPU for a Python int)."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


@dataclass(frozen=True)
class WarmupCosine:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    final_frac: float = 0.1

    def __call__(self, step) -> torch.Tensor:
        step = _step_f32(step)
        warm = self.peak_lr * step / max(self.warmup_steps, 1)
        prog = torch.clamp(
            (step - self.warmup_steps) / max(self.decay_steps - self.warmup_steps, 1),
            0.0, 1.0,
        )
        cos = self.final_frac + (1 - self.final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < self.warmup_steps, warm, self.peak_lr * cos)


@dataclass(frozen=True)
class Constant:
    lr: float = 1e-4

    def __call__(self, step) -> torch.Tensor:
        dev = step.device if isinstance(step, torch.Tensor) else None
        return torch.full((), self.lr, dtype=torch.float32, device=dev)

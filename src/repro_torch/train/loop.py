"""Training loop: checkpoint/restart, failure recovery, straggler watch.

Twin of ``repro.train.loop``.  The Trainer owns the (sub-)mesh of
logical units, the state placed under its shardings, the step, a
CheckpointManager, a FailureInjector hook (tests, chaos) and the
StragglerMonitor.  On ``DeviceFailure`` it rebuilds a smaller mesh from
the surviving units, restores the latest checkpoint under the new
shardings (elastic restore) and continues.  Every unit lies on one card
(``distributed/meshes.py``), so each step runs the global batch there as
one tensor: the unsharded result that the reference's SPMD step
computes over its mesh.
"""
from __future__ import annotations

import logging
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data import SyntheticLM
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.ctx import sharding_rules
from repro_torch.distributed.fault import DeviceFailure, FailureInjector, StragglerMonitor
from repro_torch.distributed.meshes import NamedSharding, P, make_mesh, units
from repro_torch.models import Model
from repro_torch.optim import AdamW
from repro_torch.train.step import init_state, make_train_step
from repro_torch.tree import eval_shape, tree_map

log = logging.getLogger("repro_torch.train")


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_keep: int = 3
    log_every: int = 10
    seed: int = 0
    zero: bool = True
    grad_accum: int = 1
    compress: bool = False


class Trainer:
    """``devices``: logical units (``distributed.meshes.units``); by
    default every unit of ``device`` (``"cuda"``; ``"cpu"`` for the plain
    versions on the CPU)."""

    def __init__(
        self,
        cfg: ModelConfig,
        model: Model,
        optimizer: AdamW,
        schedule: Callable,
        dataset: SyntheticLM,
        tcfg: TrainerConfig,
        *,
        devices: Optional[List] = None,
        model_par: int = 1,
        failure_injector: Optional[FailureInjector] = None,
        device="cuda",
    ):
        self.cfg = cfg
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.dataset = dataset
        self.tcfg = tcfg
        self.devices = list(devices if devices is not None else units(device))
        self.model_par = model_par
        self.failure_injector = failure_injector
        self.straggler = StragglerMonitor()
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        self.metrics_history: List[Dict[str, float]] = []
        self.recoveries = 0
        self._build(self.devices)

    # ------------------------------------------------------------------
    def _state_shape(self):
        return eval_shape(lambda: init_state(self.model, self.optimizer, self.tcfg.seed,
                                             compress=self.tcfg.compress, device="cpu"))

    def _build(self, devices: List):
        """(Re)build mesh, shardings and the step on ``devices``."""
        n = len(devices)
        mp = self.model_par if n % self.model_par == 0 else 1
        self.mesh = make_mesh((n // mp, mp), ("data", "model"), devices=devices)
        self.active_devices = devices

        state_shape = self._state_shape()
        pspecs = shd.param_specs(self.cfg, self.mesh, state_shape["params"])
        ospecs = shd.opt_state_specs(self.cfg, self.mesh, state_shape["opt"], zero=self.tcfg.zero)
        self.state_specs = {"params": pspecs, "opt": ospecs, "step": P()}
        if self.tcfg.compress:
            self.state_specs["residuals"] = pspecs
        self.state_shardings = shd.named(self.mesh, self.state_specs)
        gshards = None
        if self.tcfg.zero:
            gshards = tree_map(
                lambda sp, leaf: NamedSharding(
                    self.mesh, shd.zero_extend(sp, tuple(leaf.shape), self.mesh)),
                pspecs, state_shape["params"],
            )
        self._step = make_train_step(
            self.model, self.optimizer, self.schedule,
            compress=self.tcfg.compress, grad_accum=self.tcfg.grad_accum,
            grad_shardings=gshards,
        )
        self._rules = shd.activation_rules(self.cfg, self.mesh, self.dataset.batch)

    def _init_or_restore(self):
        restored, meta = self.ckpt.restore_latest(self._state_shape(),
                                                  shardings=self.state_shardings)
        if restored is not None:
            log.info("restored checkpoint at step %s", meta["step"])
            return restored, int(meta["step"])
        state = init_state(self.model, self.optimizer, self.tcfg.seed,
                           compress=self.tcfg.compress, device=self.mesh.device)
        return state, 0

    def _place_batch(self, batch: Dict[str, np.ndarray]):
        specs = shd.batch_specs(self.cfg, self.mesh, {k: v.shape for k, v in batch.items()})
        return {k: NamedSharding(self.mesh, specs[k]).place(torch.from_numpy(v))
                for k, v in batch.items()}

    # ------------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        """Train to ``total_steps``.  The result holds the reference's
        keys, ``state`` (the final state) and the end checkpoint's host
        snapshot and write seconds."""
        state, start = self._init_or_restore()
        step = start
        while step < self.tcfg.total_steps:
            try:
                t0 = time.perf_counter()
                if self.failure_injector is not None:
                    self.failure_injector.check(step)
                batch = self._place_batch(self.dataset.global_batch(step))
                with sharding_rules(self._rules):
                    state, metrics = self._step(state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                self.straggler.observe(step, dt)
                self.metrics_history.append({"step": step, "loss": loss, "dt": dt})
                if step % self.tcfg.log_every == 0:
                    log.info("step %d loss %.4f (%.2fs)", step, loss, dt)
                step += 1
                if step % self.tcfg.ckpt_every == 0:
                    self.ckpt.save(step, state)
            except DeviceFailure as e:
                log.warning("device failure: %s — recovering", e)
                self.recoveries += 1
                failed = set(e.failed_devices)
                survivors = [d for i, d in enumerate(self.active_devices) if i not in failed]
                if not survivors:
                    raise
                self.ckpt.wait()
                state = None  # the lost units' state goes with them
                self._build(survivors)
                state, step = self._init_or_restore()
        self.ckpt.save(step, state)
        self.ckpt.wait()
        return {
            "final_step": step,
            "final_loss": self.metrics_history[-1]["loss"] if self.metrics_history else None,
            "history": self.metrics_history,
            "recoveries": self.recoveries,
            "straggler_events": list(self.straggler.events),
            "state": state,
            "ckpt_snapshot_s": self.ckpt.last_snapshot_s,
            "ckpt_write_s": self.ckpt.last_save_s,
        }

    # ------------------------------------------------------------------
    # EcoSched-Elastic hook: rescale this job onto a new unit set at a
    # checkpoint boundary (launch/coschedule.py).
    # ------------------------------------------------------------------
    def rescale(self, devices: List):
        self.ckpt.wait()
        self._build(devices)

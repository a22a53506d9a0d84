"""Training loop: checkpoint/restart, failure recovery, straggler watch.

Twin of ``repro.train.loop``.  The Trainer owns the (sub-)mesh of
units, the state placed under its shardings, the step, a
CheckpointManager, a FailureInjector hook (tests, chaos) and the
StragglerMonitor.  On ``DeviceFailure`` it rebuilds a smaller mesh from
the surviving units, restores the latest checkpoint under the new
shardings (elastic restore) and continues.

Where the mesh lies on one card (``distributed/meshes.py``), each step
runs the global batch there as one tensor: the unsharded result that the
reference's SPMD step computes over its mesh.  Where its rows lie on
several cards, or the caller names a ``backend``, ``run()`` starts one
process per unit (``distributed/procs.py``) and trains data-parallel
over the ``data`` axis: each rank takes its share of the batch,
gradients are reduced to the reference's ZeRO layout, the optimizer
state is split over the ranks and checkpoints are gathered whole.  With
``model_par`` above 1 the ``model`` axis spans ranks too: tensor
parallelism in the Megatron layout of the reference's specs, each rank
holding its share of every leaf along both axes (``train/step.py``).
On ``DeviceFailure`` (raised on every rank at the same step) the ranks
wait for the last checkpoint to land; the lost ranks leave, and the
survivors form new groups (the model and data groups too) and restore
under their shardings.  ``run()`` returns the first surviving rank's
result, its state gathered to the host.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.ckpt import tree_from_host
from repro_torch.configs.base import ModelConfig
from repro_torch.data import SyntheticLM
from repro_torch.distributed import procs
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
    # a run over ranks: how long any collective, and the run as a whole,
    # may take before its ranks are stopped
    timeout_s: float = 1800.0


class Trainer:
    """``devices``: units (``distributed.meshes.units``); by default every
    unit of ``device`` (``"cuda"``, one unit per card; ``"cpu"`` for the
    plain versions on the CPU).  ``backend``: asks for one rank per unit
    over that backend even where the units lie on one card or the CPU
    (ranks that share a card need gloo); units on several cards run as
    ranks without it, over the backend their placement gives
    (``distributed.procs.backend_for``).  ``model_par``: the ``model``
    axis; over ranks, tensor parallelism."""

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
        backend: Optional[str] = None,
    ):
        self.cfg = cfg
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.dataset = dataset
        self.tcfg = tcfg
        self.devices = list(devices if devices is not None else units(device))
        self.backend = backend
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
        gspecs = pspecs
        if self.tcfg.zero:
            gspecs = tree_map(lambda sp, leaf: shd.zero_extend(sp, tuple(leaf.shape), self.mesh),
                              pspecs, state_shape["params"])
        self._step = make_train_step(
            self.model, self.optimizer, self.schedule,
            compress=self.tcfg.compress, grad_accum=self.tcfg.grad_accum,
            grad_shardings=shd.named(self.mesh, gspecs),
            opt_shardings=self.state_shardings["opt"], donate=True,
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
        if self.mesh.group is not None:  # this rank's shares
            state = tree_map(lambda s, t: s.place(t), self.state_shardings, state)
        return state, 0

    def _place_batch(self, batch: Dict[str, np.ndarray]):
        n = self.mesh.n_data if self.mesh.group is not None else 1
        a, rows = self.tcfg.grad_accum, self.dataset.batch
        if n > 1 and a > 1 and rows % n == 0:
            if rows % (a * n):
                raise ValueError(f"a batch of {rows} does not split into {a} microbatches "
                                 f"over {n} ranks")
            # rank r's rows are its share of every microbatch, in order, so
            # microbatch i is the same rows as on one process
            batch = {k: v.reshape(a, n, -1, *v.shape[1:]).swapaxes(0, 1).reshape(v.shape)
                     for k, v in batch.items()}
        specs = shd.batch_specs(self.cfg, self.mesh, {k: v.shape for k, v in batch.items()})
        return {k: NamedSharding(self.mesh, specs[k]).place(torch.from_numpy(v))
                for k, v in batch.items()}

    # ------------------------------------------------------------------
    def run(self) -> Optional[Dict[str, Any]]:
        """Train to ``total_steps``.  The result holds the reference's
        keys, ``state`` (the final state) and the end checkpoint's host
        snapshot and write seconds.  A run over ranks returns the first
        surviving rank's result, its ``state`` gathered whole on the CPU;
        inside a rank, the ranks that do not lead (or have left) return
        None."""
        if self._spawns():
            return self._run_ranks()
        if self.mesh.ranks is not None and self.mesh.group is None:
            return None  # a rank that holds no row of the mesh
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
                    self.ckpt.save(step, state, shardings=self._ranked_shardings())
            except DeviceFailure as e:
                log.warning("device failure: %s — recovering", e)
                self.recoveries += 1
                failed = set(e.failed_devices)
                survivors = [d for i, d in enumerate(self.active_devices) if i not in failed]
                if not survivors:
                    raise
                self.ckpt.wait()
                state = None  # the lost units' state goes with them
                if self.mesh.group is not None:
                    # every rank, the lost ones too: the lead's last
                    # checkpoint has landed before anyone restores
                    self.mesh.barrier()
                    world = procs.current()
                    if world.units[world.rank] not in survivors:
                        return None  # this rank was lost: it leaves the job
                self._build(survivors)
                state, step = self._init_or_restore()
        host = self.ckpt.save(step, state, shardings=self._ranked_shardings())
        self.ckpt.wait()
        if not self.mesh.lead:
            return None
        return {
            "final_step": step,
            "final_loss": self.metrics_history[-1]["loss"] if self.metrics_history else None,
            "history": self.metrics_history,
            "recoveries": self.recoveries,
            "straggler_events": list(self.straggler.events),
            "state": tree_from_host(host) if self.mesh.group is not None else state,
            "ckpt_snapshot_s": self.ckpt.last_snapshot_s,
            "ckpt_write_s": self.ckpt.last_save_s,
        }

    def _spawns(self) -> bool:
        """Whether ``run()`` starts the job's ranks: its mesh, outside
        them, lies on several cards or the caller named a backend."""
        return self.mesh.ranks is None and (self.mesh.spans_cards or self.backend is not None)

    def _ranked_shardings(self):
        return self.state_shardings if self.mesh.group is not None else None

    def _run_ranks(self) -> Dict[str, Any]:
        """``run()`` in one process per unit of the mesh, in the order of
        its rows; this Trainer takes over the first surviving rank's
        history, recoveries, monitors and units."""
        kw = dict(cfg=self.cfg, model=self.model, optimizer=self.optimizer,
                  schedule=self.schedule, dataset=self.dataset, tcfg=self.tcfg,
                  devices=self.active_devices, model_par=self.model_par,
                  failure_injector=self.failure_injector)
        carry = (self.metrics_history, self.recoveries,
                 dataclasses.replace(self.straggler, on_straggle=None))
        results = procs.spawn(_run_rank, (kw, carry),
                              units=[u for row in self.mesh.rows for u in row],
                              jobdir=self.tcfg.ckpt_dir, backend=self.backend,
                              timeout=self.tcfg.timeout_s)
        out, devices, straggler, self.failure_injector = next(r for r in results if r is not None)
        self.straggler = dataclasses.replace(straggler, on_straggle=self.straggler.on_straggle)
        self.metrics_history, self.recoveries = out["history"], out["recoveries"]
        self._build(devices)
        return out

    # ------------------------------------------------------------------
    # EcoSched-Elastic hook: rescale this job onto a new unit set at a
    # checkpoint boundary (launch/coschedule.py).
    # ------------------------------------------------------------------
    def rescale(self, devices: List):
        """Rebuild the mesh on ``devices``.  Over ranks, the next ``run()``
        starts a group over the new rows and restores the latest
        checkpoint under its shardings (inside a rank, the rows it keeps
        form a new group)."""
        self.ckpt.wait()
        self._build(devices)


def _run_rank(kw: dict, carry: tuple):
    """One rank of ``Trainer._run_ranks``: the Trainer rebuilt in this
    process (its mesh over the job's ranks), given the caller's history,
    recoveries and straggler monitor, run to its end."""
    tr = Trainer(**kw)
    tr.metrics_history, tr.recoveries, tr.straggler = carry
    out = tr.run()
    if out is None:
        return None
    return out, tr.active_devices, tr.straggler, tr.failure_injector

"""EcoSched-driven co-scheduled launcher: the paper's loop driving real
training jobs on carved unit blocks (twin of ``repro.launch.coschedule``).

    REPRO_HOST_DEVICES=4 PYTHONPATH=src python -m repro_torch.launch.coschedule \\
        --jobs granite-8b,mamba2-2.7b,phi4-mini-3.8b --steps 20

Each job is a reduced-config training run.  Phase I profiles every job
briefly (a few measured steps per feasible unit count; t̂ is the median
step's seconds), Phase II picks the joint action with Eq. (1) --
``EcoSched(engine="torch")``, whose decisions launch the ``score_reduce``
kernel on the card -- and launched jobs train concurrently in threads,
each on its own contiguous block of units.  Every completion re-invokes
the policy.  Without ``REPRO_HOST_DEVICES`` a unit is a card
(``distributed/meshes.py``): a job on g units of g cards runs as a g-rank
data-parallel group over NCCL inside its thread (``train/loop.py``), and
Phase I measures t̂ for each g on g cards.  With it, the units are
logical devices of one card: jobs on disjoint units share its SMs and
memory, and Phase I measures whatever that gives.  The power model is the
reference's stand-in, 60 + 140·g W.

Runs on the card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it exits 2.  As in the reference, the loop
wakes at the first completion or after a one-second poll, whichever comes
first, takes every completion that has arrived by then, and re-invokes
the policy while jobs wait; a job that raises ends the run with its
error.
"""
from __future__ import annotations

import argparse
import copy
import os
import queue
import statistics
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.configs import get_config, reduced
from repro_torch.core.ecosched import EcoSched
from repro_torch.core.perfmodel import _mk_spec
from repro_torch.core.placement import PlacementState
from repro_torch.core.types import JobSpec, NodeView, RunningJob
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed.meshes import units
from repro_torch.models import Runtime, build_model
from repro_torch.optim import AdamW, AdamWConfig, WarmupCosine
from repro_torch.train.loop import Trainer, TrainerConfig


class MeasuredPerfModel:
    """Phase I by real measurement: time a few steps per unit count.
    ``t_hat[name]`` keeps each job's median step seconds by g (the step
    alone, so a job that starts g processes is not charged their start)."""

    def __init__(self, jobs: Dict[str, dict], devices, profile_steps: int = 3, *,
                 ckpt_root: str):
        self.jobs = jobs
        self.devices = devices
        self.profile_steps = profile_steps
        self.ckpt_root = ckpt_root
        self.t_hat: Dict[str, Dict[int, float]] = {}
        self._cache: Dict[str, JobSpec] = {}

    def spec(self, name: str) -> JobSpec:
        if name in self._cache:
            return self._cache[name]
        job = self.jobs[name]
        t_hat, p_hat = {}, {}
        for g in job["counts"]:
            out = _make_trainer(job, self.devices[:g], steps=self.profile_steps,
                                tag=f"prof{g}", ckpt_root=self.ckpt_root).run()
            t_hat[g] = statistics.median(h["dt"] for h in out["history"])
            p_hat[g] = 60.0 + 140.0 * g  # the reference's power stand-in
        self.t_hat[name] = t_hat
        self._cache[name] = _mk_spec(name, t_hat, p_hat)
        return self._cache[name]

    def profiling_energy(self, name: str) -> float:
        return 0.0


def _make_trainer(job: dict, devices, steps: int, tag: str, ckpt_root: str) -> Trainer:
    cfg = job["cfg"]
    model = build_model(cfg, Runtime(remat="none"))
    opt = AdamW(AdamWConfig())
    sched = WarmupCosine(peak_lr=1e-3, warmup_steps=2, decay_steps=steps)
    data = SyntheticLM(cfg, job["batch"], job["seq"])
    return Trainer(
        cfg, model, opt, sched, data,
        TrainerConfig(
            total_steps=steps, ckpt_every=10**9, log_every=10**9,
            ckpt_dir=os.path.join(ckpt_root, f"{job['name']}_{tag}"),
        ),
        devices=list(devices),
    )


class ThreadedJobs:
    """Each started job runs ``run_job(name, g, units)`` in its own thread;
    ``next_done`` waits up to ``timeout`` seconds (None: without end) for
    one to finish and returns (name, result), or None if none did."""

    def __init__(self, run_job: Callable):
        self._run_job = run_job
        self._done: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []

    def start(self, name: str, g: int, units) -> None:
        def body():
            try:
                out = self._run_job(name, g, units)
            except BaseException as e:  # handed to the loop, which re-raises
                out = e
            self._done.put((name, out))

        th = threading.Thread(target=body, name=f"job-{name}", daemon=True)
        self._threads.append(th)
        th.start()

    def next_done(self, timeout: Optional[float] = None):
        try:
            name, out = self._done.get(timeout=timeout)
        except queue.Empty:
            return None
        if isinstance(out, BaseException):
            raise RuntimeError(f"job {name} failed") from out
        return name, out

    def join(self) -> None:
        for th in self._threads:
            th.join()


def coschedule(names: List[str], policy, total_units: int, domains: int, jobs, *,
               clock: Callable[[], float] = time.perf_counter, poll_s: float = 1.0,
               record: Optional[list] = None) -> dict:
    """EcoSched's online loop over ``names``: at every event (the start,
    then each wake-up: the first completion or ``poll_s`` seconds, as the
    reference's ``lock.wait(timeout=1.0)``) the policy sees the node and
    the waiting list, and its launches are placed (``PlacementState``) and
    started through ``jobs`` (``start(name, g, units)``,
    ``next_done(timeout) -> (name, result) | None``).  A wake-up takes
    every completion that has arrived.  ``record`` gets ``(view, waiting,
    launches, placed)`` for each ``on_event`` call.  Returns the timeline,
    each job's result and the makespan on ``clock``."""
    placement = PlacementState(total_units, domains)
    waiting = list(names)
    running: Dict[str, dict] = {}
    results: Dict[str, dict] = {}
    timeline: List[str] = []
    t_start = clock()
    while waiting or running:
        if waiting:
            view = NodeView(
                t=clock() - t_start, total_units=total_units, domains=domains,
                free_units=placement.free_count(),
                running=[RunningJob(n, r["g"], r["units"], r["domain"], 0, 0, 0)
                         for n, r in running.items()],
                free_map=list(placement.free),
                domain_jobs=list(placement.domain_jobs),
            )
            seen = copy.deepcopy(view) if record is not None else None
            asked = list(waiting)
            launches = policy.on_event(view, list(asked))
            placed = []
            for ln in launches:
                unit_ids, dom = placement.allocate(ln.g)
                placed.append((ln.job, ln.g, tuple(unit_ids), dom))
                waiting.remove(ln.job)
                running[ln.job] = {"g": ln.g, "units": tuple(unit_ids), "domain": dom}
                timeline.append(f"t={clock() - t_start:8.3f}s  launch {ln.job} "
                                f"g={ln.g} on units {list(unit_ids)}")
                jobs.start(ln.job, ln.g, tuple(unit_ids))
            if record is not None:
                record.append((seen, asked, list(launches), placed))
        if not running:
            raise RuntimeError(f"deadlock: nothing running, queue {waiting}")
        done = jobs.next_done(timeout=poll_s)
        while done is not None:
            name, out = done
            results[name] = out
            r = running.pop(name)
            placement.release(list(r["units"]), r["domain"])
            loss = out.get("final_loss") if isinstance(out, dict) else None
            timeline.append(f"t={clock() - t_start:8.3f}s  finish {name}"
                            + (f" (loss {loss:.3f})" if loss is not None else ""))
            done = jobs.next_done(timeout=0)
    return {"timeline": timeline, "results": results, "makespan": clock() - t_start}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", default="granite-8b,mamba2-2.7b,phi4-mini-3.8b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--domains", type=int, default=2)
    ap.add_argument("--lam", type=float, default=0.35)
    ap.add_argument("--tau", type=float, default=0.45)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_cosched"))
    args = ap.parse_args(argv)

    devices = units(args.device)
    M = len(devices)
    counts = tuple(g for g in (1, 2, 4, 8) if g <= M)
    jobs = {}
    for name in args.jobs.split(","):
        cfg = reduced(get_config(name.strip()))
        jobs[cfg.name] = {
            "name": cfg.name, "cfg": cfg, "batch": args.batch,
            "seq": args.seq, "counts": counts, "steps": args.steps,
        }

    cards = sorted({str(u.device) for u in devices})
    print(f"coschedule: {len(jobs)} jobs on {M} units of {', '.join(cards)}, "
          f"K={args.domains}")
    pm = MeasuredPerfModel(jobs, devices, ckpt_root=args.ckpt_dir)
    t_prof = time.perf_counter()
    for name in jobs:
        spec = pm.spec(name)
        print(f"  profiled {name}: " + " ".join(
            f"g={m.g}:t̂={m.t_norm:.2f}/ê={m.e_norm:.2f}" for m in spec.modes))
    phase1_s = time.perf_counter() - t_prof
    print(f"  (Phase I took {phase1_s:.1f}s)")

    policy = EcoSched(pm, lam=args.lam, tau=args.tau, engine="torch", device=args.device)

    def run_job(name, g, unit_ids):
        return _make_trainer(jobs[name], [devices[u] for u in unit_ids], steps=args.steps,
                             tag="run", ckpt_root=args.ckpt_dir).run()

    record: list = []
    runner = ThreadedJobs(run_job)
    out = coschedule(list(jobs), policy, M, args.domains, runner, record=record)
    runner.join()
    print("timeline:")
    for line in out["timeline"]:
        print("  " + line)
    print(f"makespan {out['makespan']:.1f}s")
    out.update(events=record, t_hat=pm.t_hat, phase1_s=phase1_s,
               specs={n: pm.spec(n) for n in jobs}, units=M)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    try:
        resolve_device(ap.parse_known_args()[0].device)
    except RuntimeError as exc:
        print(f"repro_torch.launch.coschedule: {exc}", file=sys.stderr)
        sys.exit(2)
    main()

"""The port's co-scheduled launcher (``repro_torch.launch.coschedule``) on
the CPU.

* Its loop, ``coschedule``, driven with a fixed perf model (``_mk_spec``
  over a given t̂ table, the 60 + 140·g power stand-in) and stub jobs that
  finish on a virtual clock, launches the same (job, g, units, domain)
  sequence as the reference's ``EcoSched`` + ``PlacementState`` driven
  through the same events (the reference launcher's loop body: a wake-up
  at the first completion or after a one-second poll, taking every
  completion that has arrived).  The port's policy runs ``engine="torch"`` on the
  CPU (the plain ``score_reduce``).
* ``python -m repro_torch.launch.coschedule --device cpu --steps 3`` with
  ``REPRO_HOST_DEVICES=4`` finishes, and ``python -m
  repro_torch.launch.train --smoke --device cpu --steps 6 --fail-at 3``
  on 2 logical units recovers once; without a card and without
  ``--device cpu`` both exit 2.
"""
import heapq
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_parity import one_torch_thread  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
POWER = {g: 60.0 + 140.0 * g for g in (1, 2, 4, 8)}


class VirtualJobs:
    """Stub jobs: a job started at g finishes ``durations[name][g]``
    seconds later on a virtual clock; ``next_done(timeout)`` takes the
    earliest if it finishes within ``timeout``, else moves the clock on by
    ``timeout`` and returns None."""

    def __init__(self, durations):
        self.durations = durations
        self.now = 0.0
        self._heap = []
        self._seq = 0

    def clock(self):
        return self.now

    def start(self, name, g, units):
        self._seq += 1
        heapq.heappush(self._heap, (self.now + self.durations[name][g], self._seq, name))

    def next_done(self, timeout):
        if not self._heap or self._heap[0][0] > self.now + timeout:
            self.now += timeout
            return None
        t, _, name = heapq.heappop(self._heap)
        self.now = max(self.now, t)
        return name, {"final_loss": 1.0}


class Specs:
    def __init__(self, mk_spec, table):
        self.table = table
        self.mk = mk_spec

    def spec(self, name):
        return self.mk(name, self.table[name], {g: POWER[g] for g in self.table[name]})

    def profiling_energy(self, name):
        return 0.0


def _table(seed, n_jobs, counts):
    rng = np.random.default_rng(seed)
    table = {}
    for i in range(n_jobs):
        t1 = float(rng.uniform(20, 200))
        a = float(rng.uniform(0.0, 1.0))  # 0: no speedup, 1: linear
        table[f"job{i}"] = {g: t1 / g ** a for g in counts}
    return table


def _reference_launches(table, M, K, lam, tau):
    """The reference launcher's loop body over the reference's EcoSched
    and PlacementState on the virtual clock: ``lock.wait(timeout=1.0)``
    wakes at the first completion or after a second, and by then every
    job that has finished has released its units."""
    from repro.core.ecosched import EcoSched
    from repro.core.perfmodel import _mk_spec
    from repro.core.placement import PlacementState
    from repro.core.types import NodeView, RunningJob

    policy = EcoSched(Specs(_mk_spec, table), lam=lam, tau=tau, engine="vector")
    placement = PlacementState(M, K)
    jobs = VirtualJobs(table)
    waiting, running, out = list(table), {}, []
    while waiting or running:
        if waiting:
            view = NodeView(
                t=jobs.clock(), total_units=M, domains=K, free_units=placement.free_count(),
                running=[RunningJob(n, r["g"], r["units"], r["domain"], 0, 0, 0)
                         for n, r in running.items()],
                free_map=list(placement.free), domain_jobs=list(placement.domain_jobs))
            for ln in policy.on_event(view, list(waiting)):
                units, dom = placement.allocate(ln.g)
                waiting.remove(ln.job)
                running[ln.job] = {"g": ln.g, "units": tuple(units), "domain": dom}
                out.append((ln.job, ln.g, tuple(units), dom))
                jobs.start(ln.job, ln.g, units)
        done = jobs.next_done(1.0)
        while done is not None:
            r = running.pop(done[0])
            placement.release(list(r["units"]), r["domain"])
            done = jobs.next_done(0.0)
    return out


@pytest.mark.parametrize("seed,n_jobs,M,K", [(0, 3, 4, 2), (1, 6, 4, 2), (2, 8, 8, 4),
                                             (3, 5, 8, 2)])
def test_loop_launches_match_reference(seed, n_jobs, M, K):
    from repro_torch.core.ecosched import EcoSched
    from repro_torch.core.perfmodel import _mk_spec
    from repro_torch.launch.coschedule import coschedule

    counts = tuple(g for g in (1, 2, 4, 8) if g <= M)
    table = _table(seed, n_jobs, counts)
    want = _reference_launches(table, M, K, 0.35, 0.45)
    policy = EcoSched(Specs(_mk_spec, table), lam=0.35, tau=0.45, engine="torch",
                      device="cpu")
    jobs = VirtualJobs(table)
    record = []
    out = coschedule(list(table), policy, M, K, jobs, clock=jobs.clock, record=record)
    got = [p for _, _, _, placed in record for p in placed]
    assert got == want
    assert sorted(out["results"]) == sorted(table)
    assert out["makespan"] == jobs.now
    # a recorded event replays to the same launches on the vector engine
    vec = EcoSched(Specs(_mk_spec, table), lam=0.35, tau=0.45, engine="vector")
    for view, asked, launches, _ in record:
        assert [(x.job, x.g) for x in vec.on_event(view, list(asked))] == \
            [(x.job, x.g) for x in launches]


def test_a_failing_job_ends_the_run():
    from repro_torch.launch.coschedule import ThreadedJobs

    def run_job(name, g, units):
        raise ValueError("boom")

    jobs = ThreadedJobs(run_job)
    jobs.start("a", 1, (0,))
    with pytest.raises(RuntimeError, match="job a failed"):
        jobs.next_done()
    jobs.join()


def _run(module, args, devices, tmp_path, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_HOST_DEVICES=str(devices), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_coschedule_launcher_on_the_cpu(tmp_path):
    proc = _run("repro_torch.launch.coschedule",
                ["--device", "cpu", "--steps", "3", "--ckpt-dir", str(tmp_path / "ck")],
                4, tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "coschedule: 3 jobs on 4 units of cpu" in proc.stdout
    assert proc.stdout.count(" finish ") == 3 and "makespan" in proc.stdout


def test_train_launcher_recovers_on_the_cpu(tmp_path):
    proc = _run("repro_torch.launch.train",
                ["--smoke", "--device", "cpu", "--steps", "6", "--fail-at", "3",
                 "--ckpt-every", "2", "--batch", "4", "--seq", "32",
                 "--ckpt-dir", str(tmp_path / "ck")], 2, tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "done: step=6" in proc.stdout and "recoveries=1" in proc.stdout


@pytest.mark.parametrize("module", ["repro_torch.launch.train", "repro_torch.launch.coschedule"])
def test_launchers_without_a_card_exit_2(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(module, ["--steps", "1"], 1, tmp_path, timeout=120)
    assert proc.returncode == 2 and "no CUDA device" in proc.stderr

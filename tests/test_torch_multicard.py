"""The port's jobs over several ranks (``repro_torch.distributed.procs``),
on the CPU over gloo, with 2 and 4 spawned ranks.

* The reference's sub-mesh check from ``tests/test_multidevice.py`` at
  model_par 1: two disjoint carved blocks of 2 ranks, sums 384.0 and
  768.0; and over all 4 ranks at model_par 2, each rank holding a 4 x 8
  share of the ones, sum 384.0 over both groups.
* One train step of reduced granite-8b (vocab 512, float32, B 8 x S 32)
  on 4 ranks and on each of two 2-rank blocks, against the one-process
  port step from the same state (the reference's initial parameters
  carried over with ``core/carry.py``, two one-process steps on): loss and
  grad norm within rel. 1e-5, every parameter max |Δ| / max |p| < 1e-5;
  each rank holds 1/world of the moments' bytes, apart from the leaves
  ZeRO leaves whole, which are counted.  The same on 4 ranks for reduced
  mamba2-2.7b (leaves ZeRO leaves whole), 2 microbatches, gradient
  compression, and int8 moments (its elements on a zero second-moment
  code counted).
* The reference's elastic scenario at model_par 1: 30 steps, a checkpoint
  every 8, 2 of 4 ranks lost at step 18, then ``rescale`` onto 2; step 30
  after one recovery, the loss history within rel. 1e-4 of the
  reference's run on 4 XLA host devices (a subprocess, as
  ``tests/test_multidevice.py`` runs it) from the same initial state.
* Checkpoints that cross over: a one-process checkpoint resumed on 4
  ranks, theirs resumed in one process, against an uninterrupted run.
* A g = 2 co-scheduled job on two gloo ranks; the decisions replay
  through ``engine="vector"`` to the same launches.
* World size 1 over gloo equals the one-process Trainer bit for bit.
* A planted fault, one rank skipping the gradient reduction, fails the
  job.

The jobs start together (a module fixture) so that their processes start
side by side.  Every spawn has its own hard timeout
(``TrainerConfig.timeout_s`` / ``spawn(timeout=)``), as does the
reference's subprocess.
"""
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks as TR  # noqa: E402
from repro_torch.distributed import procs  # noqa: E402
from repro_torch.distributed.fault import FailureInjector  # noqa: E402
from repro_torch.distributed.meshes import units  # noqa: E402
from repro_torch.optim.adamw import _dq8  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402
from repro_torch.train.step import init_state  # noqa: E402
from repro_torch.tree import leaves_with_paths, tree_map  # noqa: E402
from torch_parity import flat_np, one_torch_thread  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
WARM = 2  # one-process steps before the compared one (Adam's first step is ill-conditioned)
SPAWN_S = 120


def ref_state_np():
    """The reference's initial train state (reduced granite-8b, float32,
    master weights) as numpy."""
    import jax
    from repro.configs import get_config, reduced
    from repro.models import Runtime, build_model
    from repro.optim import AdamW, AdamWConfig as RAC
    from repro.train.step import init_state

    cfg = reduced(get_config("granite-8b")).replace(vocab_size=512, dtype="float32")
    st = init_state(build_model(cfg, Runtime(remat="none")), AdamW(RAC(master_weights=True)),
                    jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, st)


def warm(tr, state=None):
    """``state`` (default: ``tr``'s own initial state) after WARM
    one-process steps of ``tr``, as tensors and as numpy."""
    if state is None:
        state = init_state(tr.model, tr.optimizer, 0, device="cpu",
                           compress=tr.tcfg.compress)
    for s in range(WARM):
        state, _ = tr._step(state, tr._place_batch(tr.dataset.global_batch(s)))
    return state, tree_map(lambda t: t.numpy(), state)


REF_ELASTIC = r"""
import json, os, shutil, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import jax
from repro.configs import get_config, reduced
from repro.data import SyntheticLM
from repro.distributed.fault import FailureInjector
from repro.models import Runtime, build_model
from repro.optim import AdamW, AdamWConfig, WarmupCosine
from repro.train.loop import Trainer, TrainerConfig

assert len(jax.devices()) == 4
ref_dir, port_dir, marker = sys.argv[1:4]
cfg = reduced(get_config("granite-8b")).replace(vocab_size=512, dtype="float32")

def trainer(steps, injector=None):
    return Trainer(cfg, build_model(cfg, Runtime(remat="none")),
                   AdamW(AdamWConfig(master_weights=True)),
                   WarmupCosine(peak_lr=2e-3, warmup_steps=3, decay_steps=30),
                   SyntheticLM(cfg, batch=8, seq_len=32),
                   TrainerConfig(total_steps=steps, ckpt_every=8, ckpt_dir=ref_dir,
                                 log_every=1000),
                   model_par=1, failure_injector=injector)

trainer(0).run()  # the step-0 state, which both runs start from
shutil.copytree(os.path.join(ref_dir, "step_0000000000"),
                os.path.join(port_dir, "step_0000000000"))
open(marker, "w").close()
out = trainer(30, FailureInjector(schedule={18: 2})).run()
print(json.dumps({"losses": [h["loss"] for h in out["history"]],
                  "final_step": out["final_step"], "recoveries": out["recoveries"]}))
"""


def four_ranks(tmp):
    """``torch_ranks.four_ranks`` in 4 ranks, and the one-process results
    it is held to: each case's step from its state after WARM one-process
    steps (granite-8b's from the reference's initial state, carried over
    with ``core/carry.py``; the others from the port's own)."""
    from repro_torch.core.carry import state_from_numpy

    cases, want, states = {}, {}, {}
    for name, kw in TR.CASES.items():
        tr = TR.make_trainer(tmp / name, units("cpu", count=1), **kw)
        start = state_from_numpy(ref_state_np(), device="cpu") if name == "granite-8b" else None
        states[name], state_np = warm(tr, start)
        cases[name] = (kw, state_np)
        want[name] = TR.one_step(tr, state_np, WARM)
    v = dict(leaves_with_paths(states["int8"]["opt"]["v"]))
    v_zero = {k: (_dq8({"q": v[f"{k}/q"], "scale": v[f"{k}/scale"]}, p.shape) == 0).numpy()
              for k, p in leaves_with_paths(states["int8"]["params"])}
    # the one-process checkpoint the 4 ranks resume, and its
    # uninterrupted continuation
    cross = tmp / "cross"
    TR.make_trainer(cross, units("cpu", count=1), steps=WARM + 1, ckpt_every=WARM + 1).run()
    full = TR.make_trainer(tmp / "full", units("cpu", count=1), steps=WARM + 5).run()
    got = procs.spawn(TR.four_ranks, (cases, WARM, cross, WARM + 3),
                      units=units("cpu", count=4), jobdir=str(tmp),
                      timeout=SPAWN_S)
    return {"want": want, "got": got, "cross": cross, "full": full, "int8_v_zero": v_zero}


def elastic_on_ranks(tmp, marker, ref):
    """The elastic scenario on 4 gloo ranks from the reference's step-0
    state (once its subprocess has written it), then ``rescale`` onto 2."""
    deadline = time.monotonic() + SPAWN_S
    while not marker.exists():
        if ref.poll() is not None:
            raise RuntimeError("the reference's elastic run ended before its step-0 state")
        if time.monotonic() > deadline:
            raise TimeoutError("the reference wrote no step-0 state")
        time.sleep(0.2)
    us = units("cpu", count=4)
    tr = TR.make_trainer(tmp, us, injector=FailureInjector(schedule={18: 2}), backend="gloo")
    out = tr.run()
    mesh_after = dict(tr.mesh.shape)
    tr.rescale(us[:2])  # onto 2 new ranks: they restore step 30
    return out, mesh_after, tr.run()


def world_size_one(tmp):
    kw = dict(steps=10, ckpt_every=4)
    want = TR.make_trainer(tmp / "one", units("cpu", count=1), **kw).run()
    got = TR.make_trainer(tmp / "rank", units("cpu", count=1), backend="gloo", **kw).run()
    return want, got


class Table:
    """A perf model whose job scales, so EcoSched launches it at g = 2."""

    def spec(self, name):
        from repro_torch.core.perfmodel import _mk_spec

        return _mk_spec(name, {1: 10.0, 2: 4.0}, {1: 200.0, 2: 340.0})

    def profiling_energy(self, name):
        return 0.0


def cosched_on_ranks(tmp):
    """``coschedule`` with one job on 2 CPU units, the job training on gloo
    ranks in its thread."""
    from repro_torch.core.ecosched import EcoSched
    from repro_torch.launch.coschedule import ThreadedJobs, coschedule

    us = units("cpu", count=2)
    placed = []

    def run_job(name, g, unit_ids):
        placed.append((name, g, unit_ids))
        return TR.make_trainer(tmp, [us[u] for u in unit_ids], steps=3,
                               backend="gloo").run()

    record = []
    runner = ThreadedJobs(run_job)
    out = coschedule(["granite"], EcoSched(Table(), lam=0.35, tau=0.45, engine="torch",
                                           device="cpu"), 2, 1, runner, record=record)
    runner.join()
    return "granite", placed, out, record


def skipped_reduction(tmp):
    tr = TR.make_trainer(tmp / "init", units("cpu", count=1))
    state_np = tree_map(lambda t: t.numpy(), init_state(tr.model, tr.optimizer, 0, device="cpu"))
    t0 = time.perf_counter()
    try:
        procs.spawn(TR.skip_reduction_on, (1, state_np, 0, tmp / "f"),
                    units=units("cpu", count=2), jobdir=str(tmp), timeout=60)
    except RuntimeError as e:
        return e, time.perf_counter() - t0
    return None, time.perf_counter() - t0


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every job of this file, started together: futures by name, and the
    reference's elastic subprocess."""
    tmp = tmp_path_factory.mktemp("jobs")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    marker = tmp / "init_written"
    (tmp / "elastic").mkdir()
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_ELASTIC, str(tmp / "ref"), str(tmp / "elastic"), str(marker)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pool = ThreadPoolExecutor(5)
    try:
        jobs = {"elastic": pool.submit(elastic_on_ranks, tmp / "elastic", marker, ref)}
        for name, fn in (("four", four_ranks), ("world1", world_size_one),
                         ("cosched", cosched_on_ranks), ("fault", skipped_reduction)):
            (tmp / name).mkdir()
            jobs[name] = pool.submit(fn, tmp / name)
        yield jobs, ref
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        ref.kill()
        ref.wait()
        torch.set_num_threads(n)


def result(jobs, name):
    return jobs[0][name].result(timeout=4 * SPAWN_S)


def check_step(want, got):
    for k in ("loss", "grad_norm"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got[k], want[k])
    for k, w in want["params"].items():
        err = np.abs(got["params"][k] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err < 1e-5, (k, err)


def test_submesh_blocks_are_disjoint_ranks(jobs):
    got = result(jobs, "four")["got"]
    assert {r["submesh"] for r in got} == {(0, (4, 16), 384.0), (1, (4, 16), 768.0)}
    assert all(r["model_across_ranks"] == ((4, 8), 384.0) for r in got)


@pytest.mark.parametrize("case,world", [("granite-8b", 2), ("granite-8b", 4),
                                        ("mamba2-2.7b", 4), ("accum2", 4), ("compress", 4)])
def test_one_step_matches_one_process(jobs, case, world):
    """mamba2 has leaves ZeRO leaves whole; accum2 takes 2 microbatches, each
    rank holding its share of each; compress all-reduces, compresses and
    then splits."""
    four = result(jobs, "four")
    for r in four["got"]:
        check_step(four["want"][case], r[f"{case}/{world}"])


@pytest.mark.parametrize("arch,world,n_whole", [("granite-8b", 2, 0), ("granite-8b", 4, 0),
                                                  ("mamba2-2.7b", 4, 10)])
def test_zero_shards_the_moments(jobs, arch, world, n_whole):
    """Each rank holds 1/world of each moment leaf that ZeRO splits and all
    of each leaf it leaves whole (counted: the bytes equation holds leaf
    by leaf; mamba2's 5 SSM head leaves stay whole at 4 ranks, in m and
    v, and they are few bytes)."""
    for r in result(jobs, "four")["got"]:
        moments = r[f"{arch}/{world}"]["moments"]
        assert sum(whole for _, _, whole in moments.values()) == n_whole
        for k, (mine, full, rep) in moments.items():
            assert mine == (full if rep else full // world), (k, mine, full)
        total = sum(full for _, full, _ in moments.values())
        rep = sum(full for _, full, whole in moments.values() if whole)
        assert sum(m for m, _, _ in moments.values()) == (total - rep) // world + rep
        assert rep <= 0.01 * total, [k for k, v in moments.items() if v[2]]


def test_int8_moments_on_ranks(jobs):
    """Int8 moments keep their ZeRO layout on 4 ranks: the codes of a leaf
    split alike are updated on the rank's share, the others (a norm's
    block axis split across ranks) whole; the step equals one process's."""
    four = result(jobs, "four")
    want = four["want"]["int8"]
    for r in four["got"]:
        got = r["int8/4"]
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got[k], want[k])
        # where v's code is 0, v is (1 - b2) g² after the step and Adam's
        # step g-ish / |g| swings on the gradient's last bits (the limit of
        # Adam's first step, ROADMAP.md section 3): counted, held to 1e-3
        swung = 0
        for k, w in want["params"].items():
            err = np.abs(got["params"][k] - w) / max(np.abs(w).max(), 1e-30)
            v0 = four["int8_v_zero"][k]
            assert (err[~v0] < 1e-5).all() and (err[v0] < 1e-3).all(), (k, err.max())
            swung += int((err[v0] >= 1e-5).sum())
        assert swung <= 1e-4 * sum(w.size for w in want["params"].values()), swung
        moments = got["moments"]
        assert {k.rsplit("/", 1)[1] for k in moments} == {"q", "scale"}
        for k, (mine, full, rep) in moments.items():
            assert mine == (full if rep else full // 4), (k, mine, full)
        assert any(not rep for _, _, rep in moments.values())


def test_checkpoints_cross_between_ranks_and_one_process(jobs):
    """One process -> 4 ranks -> one process equals one process all along."""
    four = result(jobs, "four")
    got = next(r["cross"] for r in four["got"] if r["cross"] is not None)
    assert len(got) == 2
    back = TR.make_trainer(four["cross"], units("cpu", count=1), steps=WARM + 5).run()
    assert back["final_step"] == WARM + 5
    want = [h["loss"] for h in four["full"]["history"]]
    np.testing.assert_allclose(got, want[WARM + 1:WARM + 3], rtol=1e-5)
    np.testing.assert_allclose([h["loss"] for h in back["history"]], want[WARM + 3:], rtol=1e-5)
    full = flat_np(four["full"]["state"])
    for k, w in flat_np(back["state"]).items():
        assert np.abs(w - full[k]).max() <= 1e-4 * max(np.abs(full[k]).max(), 1e-30), k


def test_elastic_four_ranks_match_reference_on_four_host_devices(jobs):
    import json

    out, mesh_after, again = result(jobs, "elastic")
    assert out["final_step"] == 30 and out["recoveries"] == 1
    assert mesh_after == {"data": 2, "model": 1}
    assert [h["step"] for h in out["history"]] == list(range(18)) + list(range(16, 30))
    assert again["final_step"] == 30 and again["history"] == out["history"]
    ref = jobs[1]
    stdout, stderr = ref.communicate(timeout=SPAWN_S)
    assert ref.returncode == 0, stderr[-3000:]
    want = json.loads(stdout.strip().splitlines()[-1])
    assert want["final_step"] == 30 and want["recoveries"] == 1
    np.testing.assert_allclose([h["loss"] for h in out["history"]], want["losses"], rtol=1e-4)


def test_cosched_job_on_two_gloo_ranks(jobs):
    """EcoSched launches the job at g = 2, it trains on two gloo ranks in
    its thread, and every decision replays through the vector engine."""
    from repro_torch.core.ecosched import EcoSched

    name, placed, out, record = result(jobs, "cosched")
    assert placed == [(name, 2, (0, 1))]
    res = out["results"][name]
    assert res["final_step"] == 3 and np.isfinite(res["final_loss"])
    assert len(res["history"]) == 3
    vec = EcoSched(Table(), lam=0.35, tau=0.45, engine="vector")
    for view, asked, launches, _ in record:
        assert [(x.job, x.g, x.f) for x in vec.on_event(view, list(asked))] == \
            [(x.job, x.g, x.f) for x in launches]


def test_world_size_one_is_bitwise_the_one_process_trainer(jobs):
    want, got = result(jobs, "world1")
    assert [h["loss"] for h in got["history"]] == [h["loss"] for h in want["history"]]
    ws = dict(leaves_with_paths(want["state"]))
    for k, t in leaves_with_paths(got["state"]):
        assert t.dtype == ws[k].dtype and torch.equal(t, ws[k]), k


def test_a_rank_skipping_the_gradient_reduction_fails_the_job(jobs):
    err, seconds = result(jobs, "fault")
    assert isinstance(err, RuntimeError) and re.search(r"rank \d of 2 ", str(err)), err
    assert seconds < 60


def test_mesh_over_cards():
    """A mesh across cards describes a job's ranks (no device, no group
    outside them), its data axis alone or its model axis too."""
    from repro_torch.distributed.meshes import LogicalDevice, make_mesh

    cards = [LogicalDevice(i, torch.device("cuda", i)) for i in range(4)]
    m = make_mesh((4, 1), ("data", "model"), devices=cards)
    assert m.spans_cards and m.device is None and m.group is None and m.ranks is None
    assert m.rows == [(u,) for u in cards]
    m = make_mesh((2, 2), ("data", "model"), devices=cards)
    assert m.spans_cards and m.device is None and m.group is None and m.ranks is None
    assert m.rows == [tuple(cards[:2]), tuple(cards[2:])]
    two_a_card = [LogicalDevice(i, torch.device("cuda", i // 2)) for i in range(4)]
    m = make_mesh((2, 2), ("data", "model"), devices=two_a_card)
    assert m.rows == [tuple(two_a_card[:2]), tuple(two_a_card[2:])] and m.spans_cards


def test_default_trainer_on_a_node_of_cards(tmp_path, monkeypatch):
    """The repaired fault: on a node of 4 cards (no REPRO_HOST_DEVICES) the
    launchers' default Trainer raised building its mesh.  Now it is a mesh
    over 4 cards whose run starts one NCCL rank a card, at model_par 2
    too (tensor parallelism, a rank a card)."""
    monkeypatch.delenv("REPRO_HOST_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    tr = TR.make_trainer(tmp_path, None)
    assert tr.mesh.shape == {"data": 4, "model": 1} and tr.mesh.spans_cards
    assert [row[0].device for row in tr.mesh.rows] == [torch.device("cuda", i) for i in range(4)]
    assert procs.backend_for([row[0].device for row in tr.mesh.rows]) == "nccl"
    tp = Trainer(tr.cfg, tr.model, tr.optimizer, tr.schedule, tr.dataset, tr.tcfg, model_par=2)
    assert tp.mesh.shape == {"data": 2, "model": 2} and tp._spawns()
    assert [u.device for row in tp.mesh.rows for u in row] == \
        [torch.device("cuda", i) for i in range(4)]


def test_backend_follows_placement():
    cpu, c0, c1 = torch.device("cpu"), torch.device("cuda", 0), torch.device("cuda", 1)
    assert procs.backend_for([cpu, cpu]) == "gloo"
    assert procs.backend_for([c0, c1]) == "nccl"
    assert procs.backend_for([c0, c0], "gloo") == "gloo"
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        procs.backend_for([c0, c0])
    with pytest.raises(ValueError):
        procs.backend_for([c0, c0], "nccl")
    with pytest.raises(ValueError):
        procs.backend_for([cpu, cpu], "nccl")

"""Tensor parallelism over a ``model`` axis across ranks for the SSM family
(mamba2-2.7b) and the hybrid family (hymba-1.5b), the Megatron layout of
the reference's specs (``src/repro/distributed/sharding.py``), on the CPU
over gloo with 2 and 4 spawned ranks, float32.  The cases
(``torch_tp_ssm_ranks.CASES``): reduced mamba2 (8 SSD heads, a tied head),
reduced hymba (attention, SSM, FFN and vocabulary split at 2), hymba's
full-width layout at 2 (5 heads and a vocabulary of 257 whole, SSM and FFN
split) and at 4 (6 SSD heads whole, only the FFN split).

* One train step of each case on (1, 2) and (2, 2) meshes, and of mamba2
  and hymba's 4-way layout on (1, 4), against the one-process step from
  the same state (as ``test_torch_tensor_parallel.py``): loss and grad
  norm within rel. 1e-5; every leaf's mean gradient and new parameter,
  gathered whole, within 1e-5 of the leaf's max |value|.  The gated
  norm's mean square over the whole ``d_inner`` is summed over the model
  group both ways (``distributed.ctx.model_sum``); with an identity
  backward the gradients here are off.
* Each rank holds its share: the leaves split over ``model`` are exactly
  those the reference's ``param_spec_for`` splits, ``wbc``, ``conv_bc``
  and ``conv_bbc`` among the whole ones.
* Prefill plus 8 decode steps of each case at model_par 2 (and the 4-way
  ones at 4): the logits within 1e-5 of one process; the cache holds the
  rank's SSM heads of ``h`` and its channels of ``x`` beside the whole
  ``B|C`` in ``conv``.  mamba2 and hymba's 2-way layout also against the
  reference's GSPMD run on a (1, 2) mesh of 2 XLA host devices in a
  subprocess, from its weights and fed its greedy tokens: within 1e-5 of
  its largest |logit|.
* Reduced hymba at model_par 2 over 4 ranks, 30 steps with 2 units lost
  at step 18, against the reference's run on 4 XLA host devices from the
  same step-0 state: every loss within rel. 1e-4, step 30 after one
  recovery.
* Two planted faults on rank 1 fail the comparison with one process by
  more than 1e-2: the SSM mixer keeping its partial sums (skipping the
  all-reduce out of the region), and the gated norm over the rank's own
  channels.

The jobs start together (a module fixture); each has its own timeout.
"""
import json
import os
import pickle
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_ranks as TP  # noqa: E402
import torch_tp_ssm_ranks as SR  # noqa: E402
from repro_torch.distributed import procs  # noqa: E402
from repro_torch.distributed.fault import FailureInjector  # noqa: E402
from repro_torch.distributed.meshes import units  # noqa: E402
from repro_torch.train.step import init_state  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from test_torch_tensor_parallel import REF_ELASTIC, REF_SERVE, SPAWN_S, TOL, WARM, rel  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
ELASTIC_CASE = "hymba"
# (case, job, result key, (data, model)) of every train step held to one process
TRAIN = [(c, "two", f"train/{c}", (1, 2)) for c in SR.CASES] + \
    [(c, "four", f"train/{c}/mp2", (2, 2)) for c in SR.CASES] + \
    [(c, "four", f"train/{c}/mp4", (1, 4)) for c in SR.WIDE]
TRAIN_IDS = [f"{c}-{d}x{m}" for c, _, _, (d, m) in TRAIN]
# (case, job, result key, model_par) of every serving held to one process
SERVE = [(c, "two", f"serve/{c}", 2) for c in SR.CASES] + \
    [(c, "four", f"serve4/{c}", 4) for c in SR.WIDE]
SERVE_IDS = [f"{c}-mp{m}" for c, _, _, m in SERVE]


def warm(case, tmp):
    """The port's initial state of ``case`` after WARM one-process steps,
    as numpy, and the one-process step from it."""
    tr = SR.make_trainer(case, tmp / f"one_{case}", units("cpu", count=1))
    state = init_state(tr.model, tr.optimizer, 0, device="cpu")
    for s in range(WARM):
        state, _ = tr._step(state, tr._place_batch(tr.dataset.global_batch(s)))
    state_np = tree_map(lambda t: t.numpy(), state)
    return state_np, TP.one_step(tr, state_np, WARM)


def reference_serving(tmp, env):
    """The reference's serving subprocess on the REF_SERVE cases."""
    cases = {c: (*SR.CASES[c], TP.serve_batch_np(SR.serve_cfg(c))) for c in SR.REF_SERVE}
    with open(tmp / "ref_serve_in.pkl", "wb") as f:
        pickle.dump((cases, (SR.SERVE_P, SR.SERVE_STEPS, SR.SERVE_CAP), {}), f)
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SERVE, str(tmp / "ref_serve_in.pkl"),
         str(tmp / "ref_serve.pkl")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return ref, tmp / "ref_serve.pkl"


def ranks_job(tmp, ref_serving):
    """The 2- and 4-rank jobs (side by side) and the one-process results
    they are held to."""
    cases, want = {}, {}
    for case in SR.CASES:
        cases[case], want[case] = warm(case, tmp)
    ref, path = ref_serving
    _, stderr = ref.communicate(timeout=4 * SPAWN_S)
    if ref.returncode:
        raise RuntimeError(f"the reference's serving failed:\n{stderr[-3000:]}")
    with open(path, "rb") as f:
        given = pickle.load(f)
    serve_want = {c: SR.serve(c, None, given.get(c)) for c in SR.CASES}
    serve_want.update({f"seeded/{c}": SR.serve(c, None) for c in SR.WIDE})
    with ThreadPoolExecutor(2) as pool:
        two = pool.submit(procs.spawn, SR.two_ranks, (cases, WARM, tmp, given),
                          units=units("cpu", count=2), jobdir=str(tmp / "j2"),
                          timeout=2 * SPAWN_S)
        four = pool.submit(procs.spawn, SR.four_ranks, (cases, WARM, tmp),
                           units=units("cpu", count=4), jobdir=str(tmp / "j4"),
                           timeout=2 * SPAWN_S)
        two, four = two.result(), four.result()
    return {"want": want, "serve_want": serve_want, "two": two, "four": four,
            "reference": given}


def elastic_on_ranks(tmp, marker, ref):
    """Reduced hymba's scenario on 4 gloo ranks at model_par 2 from the
    reference's step-0 state (once its subprocess has written it)."""
    deadline = time.monotonic() + 2 * SPAWN_S
    while not marker.exists():
        if ref.poll() is not None:
            raise RuntimeError("the reference's elastic run ended before its step-0 state")
        if time.monotonic() > deadline:
            raise TimeoutError("the reference wrote no step-0 state")
        time.sleep(0.2)
    tr = SR.make_trainer(ELASTIC_CASE, tmp, units("cpu", count=4), model_par=2,
                         injector=FailureInjector(schedule={18: 2}), backend="gloo")
    return tr.run(), dict(tr.mesh.shape)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_ssm")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    (tmp / "ranks").mkdir()
    (tmp / "elastic").mkdir()
    ref_serving = reference_serving(tmp, env)
    marker = tmp / "elastic_init_written"
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_ELASTIC, str(tmp / "ref_elastic"), str(tmp / "elastic"),
         str(marker), SR.CASES[ELASTIC_CASE][0]],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pool = ThreadPoolExecutor(2)
    try:
        futures = {"elastic": pool.submit(elastic_on_ranks, tmp / "elastic", marker, ref),
                   "ranks": pool.submit(ranks_job, tmp / "ranks", ref_serving)}
        yield futures, ref
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        for p in (ref, ref_serving[0]):
            p.kill()
            p.wait()
        torch.set_num_threads(n)


def result(jobs, name):
    return jobs[0][name].result(timeout=6 * SPAWN_S)


@pytest.mark.parametrize("case,job,key,mesh", TRAIN, ids=TRAIN_IDS)
def test_train_step_matches_one_process(jobs, case, job, key, mesh):
    """Loss, grad norm, and leaf for leaf the mean gradient and the new
    parameters: a gradient of ``wbc``/``conv_bc``/``conv_bbc`` not summed
    over the model group, or of the gated norm's mean square, shows."""
    res = result(jobs, "ranks")
    want = res["want"][case]
    for r in res[job]:
        got = r[key]
        if "mesh" in got:
            assert got["mesh"] == {"data": mesh[0], "model": mesh[1]}
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - want[k]) <= TOL * abs(want[k]), (k, got[k], want[k])
        for tree in ("grads", "params"):
            assert set(got[tree]) == set(want[tree])
            for k, w in want[tree].items():
                assert rel(got[tree][k], w) < TOL, (tree, k, rel(got[tree][k], w))


@pytest.mark.parametrize("case,job,key,mesh", TRAIN, ids=TRAIN_IDS)
def test_each_rank_holds_its_share(jobs, case, job, key, mesh):
    """A leaf split over ``model`` is 1/model a rank (and 1/(data x
    model) where ZeRO splits it over data too); the leaves split over
    ``model`` are exactly the reference's specs', and ``wbc``,
    ``conv_bc`` and ``conv_bbc`` stay whole."""
    from repro.configs import get_config, reduced
    from repro.distributed.sharding import param_spec_for

    res = result(jobs, "ranks")
    arch, kw = SR.CASES[case]
    cfg = reduced(get_config(arch)).replace(
        dtype="float32", **dict(kw, vocab_size=SR.train_cfg(case).vocab_size))
    ref_mesh = SimpleNamespace(shape={"data": mesh[0], "model": mesh[1]})
    shapes = {k: np.asarray(v).shape for k, v in res["want"][case]["params"].items()}
    want_split = {k for k, shape in shapes.items()
                  if "model" in tuple(param_spec_for(cfg, ref_mesh, k, shape))}
    assert {"blocks/ssm/wbc", "blocks/ssm/conv_bc", "blocks/ssm/conv_bbc"}.isdisjoint(want_split)
    for r in res[job]:
        got = r[key]
        for k, (mine, whole, ways) in got["held"].items():
            assert mine * ways == whole, (k, mine, whole, ways)
        assert set(got["model_split"]) == want_split, (case, mesh,
                                                       set(got["model_split"]) ^ want_split)
        for k in want_split:
            mine, whole, _ = got["held"][f"params/{k}"]
            assert mine * mesh[1] <= whole, (k, mine, whole)


def ssm_state_shapes(case, m):
    """(h, conv) of a rank's SSM cache at model_par ``m``: its heads and
    pre-conv ``x`` channels where the specs split the mixer, beside the
    whole ``B|C``."""
    cfg = SR.serve_cfg(case)
    w = m if cfg.ssm_heads % m == 0 and cfg.d_inner % m == 0 else 1
    L, B = cfg.num_layers, TP.SERVE_B
    return ((L, B, cfg.ssm_heads // w, cfg.ssm_head_dim, cfg.ssm_state),
            (L, B, cfg.ssm_conv - 1, cfg.d_inner // w + 2 * cfg.ssm_state))


@pytest.mark.parametrize("case,job,key,m", SERVE, ids=SERVE_IDS)
def test_serving_matches_one_process(jobs, case, job, key, m):
    res = result(jobs, "ranks")
    want = res["serve_want"][case if job == "two" else f"seeded/{case}"]
    V = SR.serve_cfg(case).vocab_size
    h, conv = ssm_state_shapes(case, m)
    for r in res[job]:
        got = r[key]
        assert len(got["logits"]) == len(want["logits"]) == 1 + SR.SERVE_STEPS
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            assert g.shape == w.shape == (TP.SERVE_B, 1, V), (case, i, g.shape)
            assert rel(g, w) < TOL, (case, i, rel(g, w))
        st = got["state"]
        for shapes in (st, st["decoded"], st["init_cache"]):
            assert (shapes["h"], shapes["conv"]) == (h, conv), (case, m, st)


@pytest.mark.parametrize("case", SR.REF_SERVE)
def test_serving_matches_reference_on_two_host_devices(jobs, case):
    """The ranks' prefill and decode logits against the reference's GSPMD
    run on a (1, 2) mesh, from its weights and fed its greedy tokens."""
    res = result(jobs, "ranks")
    ref = res["reference"][case]
    assert len(ref["logits"]) == 1 + SR.SERVE_STEPS
    for r in res["two"]:
        got = r[f"serve/{case}"]["logits"]
        for i, (g, w) in enumerate(zip(got, ref["logits"])):
            assert g.shape == w.shape, (case, i, g.shape, w.shape)
            assert rel(g, w) < TOL, (case, i, rel(g, w))
        for i, tok in enumerate(ref["tokens"]):
            assert np.array_equal(got[i][:, -1].argmax(-1)[:, None], tok), (case, i)


@pytest.mark.parametrize("fault", SR.FAULTS)
def test_planted_faults_fail_the_comparison(jobs, fault):
    """Rank 1 keeping its SSM mixers' partial sums, or normalising the
    gated norm over its own channels: both ranks' logits are off."""
    res = result(jobs, "ranks")
    want = res["serve_want"]["mamba2"]["logits"][0]
    for r in res["two"]:
        assert rel(r[f"fault/{fault}"]["logits"][0], want) > 1e-2, fault


def test_hybrid_elastic_tensor_parallel_matches_reference_on_four_host_devices(jobs):
    """Reduced hymba-1.5b (attention, SSM and FFN split) at model_par 2
    over 4 ranks, through a recovery onto 2."""
    out, mesh_after = result(jobs, "elastic")
    assert out["final_step"] == 30 and out["recoveries"] == 1
    assert mesh_after == {"data": 1, "model": 2}
    assert [h["step"] for h in out["history"]] == list(range(18)) + list(range(16, 30))
    ref = jobs[1]
    stdout, stderr = ref.communicate(timeout=4 * SPAWN_S)
    assert ref.returncode == 0, stderr[-3000:]
    want = json.loads(stdout.strip().splitlines()[-1])
    assert want["final_step"] == 30 and want["recoveries"] == 1
    np.testing.assert_allclose([h["loss"] for h in out["history"]], want["losses"], rtol=1e-4)

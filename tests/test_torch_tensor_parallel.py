"""Tensor parallelism over a ``model`` axis across ranks (the Megatron
layout of the reference's specs), on the CPU over gloo with 2 and 4
spawned ranks, float32.

* One train step of reduced qwen3-32b (4 heads over 1 KV head: ``wk``/
  ``wv`` stay whole, and with ``q_norm``/``k_norm`` their gradients are
  partial on each rank) and reduced granite-8b, vocab 512, on (1, 2) and
  (2, 2) meshes, against the one-process step from the same state (two
  one-process steps on from the port's initial state): loss and grad norm
  within rel. 1e-5; every leaf's mean gradient and new parameter,
  gathered whole, within 1e-5 of the leaf's max |value|.
* Each rank holds its share of every leaf along both axes: the bytes of
  its share are the whole leaf's over the ranks its spec splits it over
  (parameters and both moments).
* Prefill plus 8 decode steps of reduced granite-8b, gemma3-4b (a tied
  head, a window), phi-3-vision-4.2b, whisper-base (cross-attention over
  a replicated encoder output) and whisper-base at its own vocabulary of
  51,865 (which does not divide 2: the tied head stays whole and its
  logits are not gathered) at model_par 2: the logits, of the whole
  vocabulary, within 1e-5 of one process; the decode cache holds the
  rank's KV heads.  gemma3-4b and whisper-base at 51,865 also against the
  reference's GSPMD run of the same configuration, prefill and decode on
  a (1, 2) mesh of 2 XLA host devices in a subprocess: the port runs the
  reference's weights (carried over by ``carry.params_from_numpy``) on
  the same numpy batch, fed the reference's greedy tokens, and its
  logits lie within 1e-5 of the reference's largest |logit|.
* The reference's ``tests/test_multidevice.py`` scenario on 4 ranks
  (2 x 2, model_par 2, 30 steps, a checkpoint every 8, 2 units lost at
  step 18, then going on at (1, 2)) against the reference's own run on 4
  XLA host devices in a subprocess from the same step-0 state (float32,
  so the tolerance holds): every loss within rel. 1e-4, step 30 after one
  recovery.
* A checkpoint written over (2, 2) restores bit-exact in one process,
  and one written in one process restores bit-exact over (2, 2).
* The SSM and hybrid families' Trainer builds and steps over 4 ranks at
  model_par 2 (``tests/test_torch_tp_ssm.py`` holds them to one process).
* A planted fault, one rank keeping its attention sublayers' partial sums
  (it skips the model group's all-reduce out of the region), fails the
  comparison with one process.

The jobs start together (a module fixture); each has its own timeout.
"""
import json
import os
import pickle
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_ranks as TP  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.distributed import procs  # noqa: E402
from repro_torch.distributed.fault import FailureInjector  # noqa: E402
from repro_torch.distributed.meshes import units  # noqa: E402
from repro_torch.train.step import init_state  # noqa: E402
from repro_torch.tree import leaves_with_paths, tree_map  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
WARM = 2  # one-process steps before the compared one (Adam's first step is ill-conditioned)
SPAWN_S = 150
TOL = 1e-5
# the elastic runs held to the reference's: job name -> arch
ELASTIC = {"elastic": "qwen3-32b", "elastic_moe": "qwen2-moe-a2.7b"}

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
ref_dir, port_dir, marker, arch = sys.argv[1:5]
cfg = reduced(get_config(arch)).replace(vocab_size=512, dtype="float32")

def trainer(steps, injector=None):
    return Trainer(cfg, build_model(cfg, Runtime(remat="none")),
                   AdamW(AdamWConfig(master_weights=True)),
                   WarmupCosine(peak_lr=2e-3, warmup_steps=3, decay_steps=30),
                   SyntheticLM(cfg, batch=8, seq_len=32),
                   TrainerConfig(total_steps=steps, ckpt_every=8, ckpt_dir=ref_dir,
                                 log_every=1000),
                   model_par=2, failure_injector=injector)

trainer(0).run()  # the step-0 state, which both runs start from
shutil.copytree(os.path.join(ref_dir, "step_0000000000"),
                os.path.join(port_dir, "step_0000000000"))
open(marker, "w").close()
out = trainer(30, FailureInjector(schedule={18: 2})).run()
print(json.dumps({"losses": [h["loss"] for h in out["history"]],
                  "final_step": out["final_step"], "recoveries": out["recoveries"]}))
"""


REF_SERVE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, "src")
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get_config, reduced
from repro.distributed import sharding as shd
from repro.distributed.ctx import mesh_context, sharding_rules
from repro.distributed.meshes import make_mesh
from repro.models import Runtime, build_model
from repro.models import moe as RM

assert len(jax.devices()) == 2
with open(sys.argv[1], "rb") as f:
    cases, (P, steps, cap), ep_cases = pickle.load(f)
mesh = make_mesh((1, 2), ("data", "model"))
out = {"ep": {}}
for arch, cf in ep_cases.items():
    cfg = reduced(get_config(arch)).replace(dtype="float32", num_experts=8)
    p = RM.moe_init(jax.random.key(3), cfg, jnp.float32)
    x = np.random.default_rng(11).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    y = RM.moe_apply_ep(p, jnp.asarray(x), cfg, mesh, capacity_factor=cf)
    out["ep"][arch] = {"params": jax.tree_util.tree_map(np.asarray, p), "x": x,
                       "y": np.asarray(y), "cf": cf}
for name, (arch, kw, batch) in cases.items():
    cfg = reduced(get_config(arch)).replace(dtype="float32", **kw)
    model = build_model(cfg, Runtime(remat="none"))
    params = model.init(jax.random.key(0))
    B = batch["tokens"].shape[0]
    with mesh, sharding_rules(shd.activation_rules(cfg, mesh, B)), mesh_context(mesh):
        p_in = jax.device_put(params, shd.named(mesh, shd.param_specs(cfg, mesh, params)))
        b_in = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, shd.named(
            mesh, shd.batch_specs(cfg, mesh, {k: v.shape for k, v in batch.items()})))
        logits, cache = jax.jit(model.prefill)(p_in, b_in)
        cache = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, cap - v.shape[2]), (0, 0), (0, 0)])
                     if k in ("k", "v") else v) for k, v in cache.items()}
        cache = jax.device_put(cache, shd.named(
            mesh, shd.cache_specs(cfg, mesh, {k: v.shape for k, v in cache.items()})))
        decode = jax.jit(model.decode_step)
        lgs, toks = [np.asarray(logits)], []
        for i in range(steps):
            tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
            toks.append(np.asarray(tok))
            logits, cache = decode(p_in, cache, tok, jnp.int32(P + i))
            lgs.append(np.asarray(logits))
    out[name] = {"params": jax.tree_util.tree_map(np.asarray, params), "batch": batch,
                 "tokens": toks, "logits": lgs}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def reference_serving(tmp, env):
    """The reference's serving subprocess on the REF_SERVE cases' numpy
    batches (written first, for it to read), and the path of its output."""
    cases = {c: (*TP.SERVE_CASES[c], TP.serve_batch_np(TP.serve_cfg(c))) for c in TP.REF_SERVE}
    with open(tmp / "ref_serve_in.pkl", "wb") as f:
        pickle.dump((cases, (TP.SERVE_P, TP.SERVE_STEPS, TP.SERVE_CAP), TP.EP_CASES), f)
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SERVE, str(tmp / "ref_serve_in.pkl"),
         str(tmp / "ref_serve.pkl")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return ref, tmp / "ref_serve.pkl"


def warm(arch, tmp):
    """The port's initial state of ``arch`` after WARM one-process steps,
    as numpy, and the one-process step from it."""
    tr = TP.make_trainer(tmp / f"one_{arch}", units("cpu", count=1), arch=arch)
    state = init_state(tr.model, tr.optimizer, 0, device="cpu")
    for s in range(WARM):
        state, _ = tr._step(state, tr._place_batch(tr.dataset.global_batch(s)))
    state_np = tree_map(lambda t: t.numpy(), state)
    return state_np, TP.one_step(tr, state_np, WARM)


def ranks_job(tmp, ref_serving):
    """The 2- and 4-rank jobs (started side by side) and the one-process
    results they are held to; the reference's serving, once its
    subprocess has ended, gives the REF_SERVE cases' weights and tokens."""
    cases, want = {}, {}
    for arch in TP.TRAIN_ARCHS:
        cases[arch], want[arch] = warm(arch, tmp)
    ref, path = ref_serving
    _, stderr = ref.communicate(timeout=4 * SPAWN_S)
    if ref.returncode:
        raise RuntimeError(f"the reference's serving failed:\n{stderr[-3000:]}")
    with open(path, "rb") as f:
        given = pickle.load(f)
    serve_want = {c: TP.serve(c, None, given.get(c)) for c in TP.SERVE_ARCHS}
    serve_want.update({f"seeded/{c}": TP.serve(c, None) for c in TP.MOE})
    # the one-process checkpoint the 4 ranks restore: qwen3's warm state
    ckpt_in = tmp / "ckpt_in"
    CheckpointManager(str(ckpt_in), async_save=False).save(
        5, tree_map(torch.from_numpy, cases["qwen3-32b"]))
    ckpt_out = tmp / "ckpt_out"
    with ThreadPoolExecutor(2) as pool:
        two = pool.submit(procs.spawn, TP.two_ranks, (cases, WARM, 1, tmp, given),
                          units=units("cpu", count=2), jobdir=str(tmp / "j2"),
                          timeout=2 * SPAWN_S)
        four = pool.submit(procs.spawn, TP.four_ranks, (cases, WARM, ckpt_in, ckpt_out),
                           units=units("cpu", count=4), jobdir=str(tmp / "j4"),
                           timeout=2 * SPAWN_S)
        two, four = two.result(), four.result()
    return {"cases": cases, "want": want, "serve_want": serve_want, "two": two,
            "four": four, "ckpt_out": ckpt_out, "reference": given}


def elastic_on_ranks(tmp, marker, ref, arch):
    """The scenario of ``arch`` on 4 gloo ranks at model_par 2 from the
    reference's step-0 state (once its subprocess has written it)."""
    deadline = time.monotonic() + 2 * SPAWN_S
    while not marker.exists():
        if ref.poll() is not None:
            raise RuntimeError("the reference's elastic run ended before its step-0 state")
        if time.monotonic() > deadline:
            raise TimeoutError("the reference wrote no step-0 state")
        time.sleep(0.2)
    tr = TP.make_trainer(tmp, units("cpu", count=4), arch=arch, model_par=2,
                         injector=FailureInjector(schedule={18: 2}), backend="gloo")
    out = tr.run()
    return out, dict(tr.mesh.shape)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    (tmp / "ranks").mkdir()
    ref_serving = reference_serving(tmp, env)
    refs, futures = {}, {}
    pool = ThreadPoolExecutor(1 + len(ELASTIC))
    try:
        for name, arch in ELASTIC.items():
            marker = tmp / f"{name}_init_written"
            (tmp / name).mkdir()
            refs[name] = ref = subprocess.Popen(
                [sys.executable, "-c", REF_ELASTIC, str(tmp / f"ref_{name}"), str(tmp / name),
                 str(marker), arch],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            futures[name] = pool.submit(elastic_on_ranks, tmp / name, marker, ref, arch)
        futures["ranks"] = pool.submit(ranks_job, tmp / "ranks", ref_serving)
        yield futures, refs
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        for p in (*refs.values(), ref_serving[0]):
            p.kill()
            p.wait()
        torch.set_num_threads(n)


def result(jobs, name):
    return jobs[0][name].result(timeout=6 * SPAWN_S)


def rel(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("arch", TP.TRAIN_ARCHS)
@pytest.mark.parametrize("world", [2, 4])
def test_train_step_matches_one_process(jobs, arch, world):
    """Loss, grad norm, and leaf for leaf the mean gradient and the new
    parameters; a missing model-group sum of ``wk``/``wv``/``q_norm``/
    ``k_norm`` (qwen3) shows in their gradients."""
    res = result(jobs, "ranks")
    want = res["want"][arch]
    for r in res["two" if world == 2 else "four"]:
        got = r[f"train/{arch}"]
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - want[k]) <= TOL * abs(want[k]), (k, got[k], want[k])
        for tree in ("grads", "params"):
            assert set(got[tree]) == set(want[tree])
            for k, w in want[tree].items():
                assert rel(got[tree][k], w) < TOL, (tree, k, rel(got[tree][k], w))


def split_and_whole(case):
    """The leaves (their last two path parts) the specs split over
    ``model`` in training case ``case``, and some they keep whole."""
    split = {"attn/wq", "attn/wo", "params/embed", "params/lm_head"}
    if case not in TP.MOE:  # reduced qwen3 and granite: 1 KV head
        return split | {"mlp/gate", "mlp/up", "mlp/down"}, {
            "attn/wk", "attn/wv", "attn/q_norm", "attn/k_norm"}
    split |= {"experts/gate", "experts/up", "experts/down"}
    if TP.TRAIN_CASES[case][0] == "arctic-480b":
        return split | {"dense_ffn/gate", "dense_ffn/up", "dense_ffn/down"}, {"moe/router"}
    return split | {"shared/gate", "shared/up", "shared/down"}, {"moe/router",
                                                                "moe/shared_gate"}


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_its_share_along_both_axes(jobs, world):
    """A leaf split over both axes is 1/(data x model) a rank; over
    ``model`` alone 1/model; and every leaf the specs split over ``model``
    (attention heads, FFN columns, the vocabulary; a MoE layer's experts,
    or their hidden columns, and its shared experts' or dense FFN's
    columns) is split, the router and the shared-expert gate whole."""
    res = result(jobs, "ranks")
    m = 2
    for r in res["two" if world == 2 else "four"]:
        assert r["mesh"][:2] == (world // m, m)
        for arch in TP.TRAIN_ARCHS:
            held = r[f"train/{arch}"]["held"]
            for k, (mine, whole, ways) in held.items():
                assert mine * ways == whole, (k, mine, whole, ways)
            params = {k: v for k, v in held.items() if k.startswith("params/")}
            split = {"/".join(k.split("/")[-2:]) for k, (_, _, ways) in params.items()
                     if ways % m == 0}
            want_split, want_whole = split_and_whole(arch)
            assert want_split <= split, (arch, split)
            assert want_whole.isdisjoint(split), (arch, split)
            mb = sum(mine for mine, _, _ in params.values())
            assert mb < sum(whole for _, whole, _ in params.values()) / 1.5


@pytest.mark.parametrize("arch", TP.SERVE_ARCHS)
def test_serving_matches_one_process(jobs, arch):
    res = result(jobs, "ranks")
    want = res["serve_want"][arch]
    V = TP.serve_cfg(arch).vocab_size
    for r in res["two"]:
        got = r[f"serve/{arch}"]
        assert len(got["logits"]) == len(want["logits"]) == 1 + TP.SERVE_STEPS
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            assert g.shape == w.shape == (TP.SERVE_B, 1, V), (arch, i, g.shape)
            assert rel(g, w) < TOL, (arch, i, rel(g, w))
        # the rank's KV heads: half of them where the specs split them
        assert got["kv_heads"] == got["init_cache_kv_heads"]
        assert got["kv_heads"] == max(want["kv_heads"] // 2, 1)


@pytest.mark.parametrize("arch", TP.REF_SERVE)
def test_serving_matches_reference_on_two_host_devices(jobs, arch):
    """The ranks' prefill and decode logits against the reference's GSPMD
    run on a (1, 2) mesh, from its weights and fed its greedy tokens (so
    the ranks' own greedy choice is the reference's too)."""
    res = result(jobs, "ranks")
    ref = res["reference"][arch]
    assert len(ref["logits"]) == 1 + TP.SERVE_STEPS
    for r in res["two"]:
        got = r[f"serve/{arch}"]["logits"]
        for i, (g, w) in enumerate(zip(got, ref["logits"])):
            assert g.shape == w.shape, (arch, i, g.shape, w.shape)
            assert rel(g, w) < TOL, (arch, i, rel(g, w))
        for i, tok in enumerate(ref["tokens"]):
            assert np.array_equal(got[i][:, -1].argmax(-1)[:, None], tok), (arch, i)


def test_planted_fault_fails_the_comparison(jobs):
    """One rank keeping its attention sublayers' partial sums: both ranks'
    logits (each gathers the other's vocabulary columns) are off."""
    res = result(jobs, "ranks")
    want = res["serve_want"]["granite-8b"]["logits"][0]
    for r in res["two"]:
        assert rel(r["fault"]["logits"][0], want) > 1e-2


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", TP.MOE)
def test_moe_replicated_leaves_gradients_match_one_process(jobs, case, world):
    """By name, the leaves a MoE layer's region reads whole: ``router``
    and ``shared_gate`` (each rank's gradient of them partial, summed by
    the region's entry) and ``moe_ln`` (through the normed input, which
    enters it): each gradient and new value within 1e-5 of its max, and
    not zero."""
    res = result(jobs, "ranks")
    want = res["want"][case]
    names = ["blocks/moe/router", "blocks/moe_ln"]
    if "blocks/moe/shared_gate" in want["grads"]:
        names.append("blocks/moe/shared_gate")
    for r in res["two" if world == 2 else "four"]:
        got = r[f"train/{case}"]
        for k in names:
            assert np.abs(want["grads"][k]).max() > 0, k
            assert rel(got["grads"][k], want["grads"][k]) < TOL, (k, rel(got["grads"][k],
                                                                         want["grads"][k]))
            assert rel(got["params"][k], want["params"][k]) < TOL, k


@pytest.mark.parametrize("case", TP.MOE)
def test_moe_ranks_agree_on_routing(jobs, case):
    """Every rank of the model group picks the same top-k experts for
    every token in every routing (prefill and decode layers), on 2 and on
    4 ranks, and in float32 they are one process's."""
    res = result(jobs, "ranks")
    want = res["serve_want"][f"seeded/{case}"]["routes"]
    assert len(want) == TP.serve_cfg(case).num_layers * (1 + TP.SERVE_STEPS)
    for job, key in (("two", f"serve/{case}"), ("four", f"serve4/{case}")):
        ranks = [r[key]["routes"] for r in res[job]]
        for routes in ranks:
            assert len(routes) == len(want)
            for a, b in zip(routes, ranks[0]):
                assert np.array_equal(a, b), (job, case)
    for a, b in zip(res["four"][0][f"serve4/{case}"]["routes"], want):
        assert np.array_equal(a, b), case


@pytest.mark.parametrize("case", TP.MOE)
def test_moe_serving_over_four_ranks_matches_one_process(jobs, case):
    """The MoE cases at model_par 4 (one expert a rank; E 3 split by
    its hidden columns): logits within 1e-5 of one process."""
    res = result(jobs, "ranks")
    want = res["serve_want"][f"seeded/{case}"]["logits"]
    for r in res["four"]:
        got = r[f"serve4/{case}"]["logits"]
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert rel(g, w) < TOL, (case, i, rel(g, w))


@pytest.mark.parametrize("arch", list(TP.EP_CASES))
def test_moe_apply_ep_over_ranks_matches_reference_on_two_host_devices(jobs, arch):
    """``moe_impl="ep"``'s layer over 2 ranks, each holding its 4 of 8
    experts and computing its own column alone, against the reference's
    ``moe_apply_ep`` on a (1, 2) mesh of host devices: rel. 1e-5 (the
    capacity per data shard, qwen2-moe at capacity factor 1.0 dropping
    slots); both ranks route alike."""
    res = result(jobs, "ranks")
    want = res["reference"]["ep"][arch]["y"]
    ranks = [r["ep"][arch] for r in res["two"]]
    for got in ranks:
        assert got["experts"] == 4
        assert rel(got["y"], want) < TOL, (arch, rel(got["y"], want))
        for a, b in zip(got["routes"], ranks[0]["routes"]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("fault", ["moe_leave", "every_expert"])
def test_moe_planted_faults_fail_the_comparison(jobs, fault):
    """Rank 1 keeping its MoE layers' partial sums (skipping the region's
    all-reduce), or computing every expert rather than its own: both
    ranks' logits are off one process's."""
    res = result(jobs, "ranks")
    want = res["serve_want"]["seeded/qwen2-moe-a2.7b"]["logits"][0]
    for r in res["two"]:
        assert rel(r[f"fault/{fault}"]["logits"][0], want) > 1e-2, fault


def test_checkpoints_cross_between_ranks_and_one_process(jobs):
    res = result(jobs, "ranks")
    whole = {k: torch.from_numpy(v) for k, v in leaves_with_paths(res["cases"]["qwen3-32b"])}
    for r in res["four"]:  # one process's checkpoint, restored over (2, 2) and gathered
        step, got = r["restored"]
        assert step == 5 and set(got) == set(whole)
        for k, t in got.items():
            assert t.dtype == whole[k].dtype and torch.equal(t, whole[k]), k
    # (2, 2)'s checkpoint, restored in one process
    tr = TP.make_trainer(res["ckpt_out"], units("cpu", count=1))
    state, meta = tr.ckpt.restore_latest(tr._state_shape())
    assert int(meta["step"]) == 7
    for k, t in leaves_with_paths(state):
        assert t.dtype == whole[k].dtype and torch.equal(t, whole[k]), k


def check_elastic(jobs, name):
    """Job ``name``'s elastic run on 4 ranks against the reference's."""
    out, mesh_after = result(jobs, name)
    assert out["final_step"] == 30 and out["recoveries"] == 1
    assert mesh_after == {"data": 1, "model": 2}
    assert [h["step"] for h in out["history"]] == list(range(18)) + list(range(16, 30))
    ref = jobs[1][name]
    stdout, stderr = ref.communicate(timeout=4 * SPAWN_S)
    assert ref.returncode == 0, stderr[-3000:]
    want = json.loads(stdout.strip().splitlines()[-1])
    assert want["final_step"] == 30 and want["recoveries"] == 1
    np.testing.assert_allclose([h["loss"] for h in out["history"]], want["losses"], rtol=1e-4)


def test_elastic_tensor_parallel_matches_reference_on_four_host_devices(jobs):
    check_elastic(jobs, "elastic")


def test_moe_elastic_tensor_parallel_matches_reference_on_four_host_devices(jobs):
    """qwen2-moe-a2.7b (experts, shared experts, the balance loss) at
    model_par 2 over 4 ranks, through a recovery onto 2."""
    check_elastic(jobs, "elastic_moe")


def trainer_args(arch, tmp_path, steps=2):
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Runtime, build_model
    from repro_torch.optim import AdamW, WarmupCosine
    from repro_torch.train.loop import TrainerConfig

    cfg = reduced(get_config(arch))
    return (cfg, build_model(cfg, Runtime(remat="none")), AdamW(),
            WarmupCosine(peak_lr=1e-3, warmup_steps=1, decay_steps=2),
            SyntheticLM(cfg, batch=4, seq_len=16),
            TrainerConfig(total_steps=steps, ckpt_every=100, ckpt_dir=str(tmp_path),
                          log_every=1000, timeout_s=120))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
def test_ssm_hybrid_trainer_builds_and_steps_at_model_par_2_over_four_ranks(tmp_path, arch):
    """The SSM and hybrid families' Trainer over 4 gloo ranks at model_par 2
    (refused before their mixers ran across ranks): it builds, and two
    steps give finite losses, with the SSM mixer split over the model
    group (``tests/test_torch_tp_ssm.py`` holds them to one process)."""
    from repro_torch.train.loop import Trainer

    tr = Trainer(*trainer_args(arch, tmp_path), devices=units("cpu", count=4), model_par=2,
                 backend="gloo", device="cpu")
    assert dict(tr.mesh.shape) == {"data": 2, "model": 2}
    spec = tr.state_shardings["params"]["blocks"]["ssm"]["wx"].spec
    assert "model" in tuple(spec), spec
    out = tr.run()
    assert out["final_step"] == 2 and len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])


def test_moe_trainer_builds_and_steps_at_model_par_2_over_four_ranks(tmp_path):
    """MoE's Trainer over 4 gloo ranks at model_par 2 (refused before the
    MoE layer ran across ranks): it builds, and two steps give finite
    losses, with the experts split over the model group."""
    from repro_torch.train.loop import Trainer

    tr = Trainer(*trainer_args("qwen2-moe-a2.7b", tmp_path), devices=units("cpu", count=4),
                 model_par=2, backend="gloo", device="cpu")
    assert dict(tr.mesh.shape) == {"data": 2, "model": 2}
    spec = tr.state_shardings["params"]["blocks"]["moe"]["experts"]["gate"].spec
    assert tuple(spec) == (None, "model", None, None)
    out = tr.run()
    assert out["final_step"] == 2 and len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])

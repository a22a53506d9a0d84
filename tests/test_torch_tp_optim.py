"""Int8 AdamW moments and gradient compression with the ``model`` axis
across ranks, in the reference's state layout (``opt_state_specs``: a
leaf split over ``model`` along a leading dimension has its codes split
along it; one split along its last dimension has codes whole along
``model``; the compression residuals follow the parameters' specs), on
the CPU over gloo with 2 and 4 spawned ranks, float32.

* One step of reduced granite-8b, qwen2-moe-a2.7b and mamba2-2.7b (vocab
  512) at model_par 2 on (1, 2) and (2, 2) meshes, with int8 moments,
  with compression, and with both (master weights on), from one carried
  state (two one-process steps of the port with both), against the
  one-process step: loss and grad norm within rel. 1e-5; the mean
  gradient within 1e-5 of its leaf's max |g|; every parameter and master
  copy within 1e-5 of its leaf's max |p| plus lr times the difference of
  the two Adam steps, each computed in float64 from its own side's
  gradient (``adam_swing``; an int8 second moment that decodes to 0
  leaves Adam's step as m / |g|, which swings with the last bits of a
  small gradient: such elements are counted as ``ill``, at most 1e-2 of
  them); every int8 code equal except codes on a rounding boundary (the
  one-process moment within 0.01 of a half step), which differ by one and
  are counted; scales within 1e-5 of the leaf's largest (2e-5 for the
  second moment's: a square doubles its gradient's relative error, and
  the grad norm's clip scale enters it squared); residuals within
  1e-5 of the leaf's largest compressed gradient, except elements whose
  compressed code sits on a rounding boundary (their residuals swap sign,
  as ``torch_parity.check_train_step`` finds them), counted.
* The same step of the reference (``repro.train.step``, jitted, in a
  subprocess) from the same carried state, for granite-8b in each mode and
  for qwen2-moe-a2.7b and mamba2-2.7b with both: the one-process port and
  every rank held to it by the same rules.
* Each rank's codes, scales and residuals are its slice, under the
  reference's ``opt_state_specs`` and ``param_specs`` (numpy slicing by
  the rank's data and model index), of the one-process state; a
  column-split leaf's codes are whole along ``model`` and the same on
  every rank of the model group.
* Planted faults on rank 1, quantizing its own columns in blocks of its
  own where the blocks of 256 cross ranks, fail the code check (int8
  moments) and the residual check (compression).
* The reference's multi-device scenario with int8 moments and compression
  at model_par 2 (reduced granite-8b, B 8 x S 32, peak lr 1e-4, 30 steps,
  a checkpoint every 8, 2 units lost at step 18): the port's Trainer on 4
  gloo ranks against the reference's on 4 XLA host devices in a
  subprocess from the same step-0 state: the same steps and recovery, the
  first three losses within rel. 1e-4 (later ones part: see the test);
  steps 16-17, run again on (1, 2) after the recovery, within rel. 1e-5
  of the first run's; each surviving rank's restored state bit for bit
  its slice of the step-16 checkpoint under the reference's specs; the
  final checkpoint restores bit for bit in both directions (the port's
  in the reference, the reference's in the port).

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

import torch_tp_optim_ranks as OR  # noqa: E402
from repro_torch.distributed import procs  # noqa: E402
from repro_torch.distributed.meshes import units  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402
from torch_parity import _block_absmax, one_torch_thread  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
SPAWN_S = 150
TOL = 1e-5
B1, B2, EPS = 0.9, 0.95, 1e-8  # AdamWConfig's defaults
COUNT = OR.WARM + 1  # the compared step's Adam count
# the reference's step from the carried state: arch -> modes
REF_MODES = {"granite-8b": tuple(OR.MODES), "qwen2-moe-a2.7b": ("both",),
             "mamba2-2.7b": ("both",)}
# the elastic run's peak learning rate, and the steps whose losses it holds
# to the reference's (``test_elastic_int8_compression_recovers_as_the_reference_does``)
ELASTIC_LR = 1e-4
DRIFT_FROM = 3
FAIL_AT, CKPT_BEFORE = 18, 16  # the step that loses 2 units, and the checkpoint restored
CASES = [(a, m) for a in OR.ARCHS for m in OR.MODES]
STEPS = [(a, m, w) for a, m in CASES for w in (2, 4)]
STEP_IDS = [f"{a}-{m}-x{w}" for a, m, w in STEPS]

REF_STEP = r"""
import pickle, sys
sys.path.insert(0, "src")
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get_config, reduced
from repro.data import SyntheticLM
from repro.models import Runtime, build_model
from repro.optim import AdamW, AdamWConfig, WarmupCosine
from repro.train.step import make_train_step

with open(sys.argv[1], "rb") as f:
    starts, warm, ref_modes, modes = pickle.load(f)

def flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{pre}{k}/"))
        else:
            out[f"{pre}{k}"] = np.asarray(v)
    return out

out = {}
for arch, names in ref_modes.items():
    cfg = reduced(get_config(arch)).replace(vocab_size=512, dtype="float32")
    model = build_model(cfg, Runtime(remat="none"))
    batch = {k: jnp.asarray(v) for k, v in SyntheticLM(cfg, 8, 32).global_batch(warm).items()}
    for mode in names:
        int8, compress = modes[mode]
        opt = AdamW(AdamWConfig(state_dtype="int8" if int8 else "float32", master_weights=True))
        step = jax.jit(make_train_step(
            model, opt, WarmupCosine(peak_lr=2e-3, warmup_steps=3, decay_steps=30),
            compress=compress))
        new, met = step(jax.tree_util.tree_map(jnp.asarray, starts[(arch, mode)]), batch)
        out[(arch, mode)] = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
                             "lr": float(met["lr"]), "state": flat(new)}
    params = jax.tree_util.tree_map(jnp.asarray, starts[(arch, names[0])]["params"])
    _, grads = jax.jit(jax.value_and_grad(lambda p: model.loss(p, batch)[0]))(params)
    for mode in names:
        out[(arch, mode)]["grads"] = flat(grads)
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""

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
ref_dir, port_dir, marker, peak_lr = sys.argv[1:5]
cfg = reduced(get_config("granite-8b")).replace(vocab_size=512, dtype="float32")

def trainer(steps, injector=None):
    return Trainer(cfg, build_model(cfg, Runtime(remat="none")),
                   AdamW(AdamWConfig(state_dtype="int8", master_weights=True)),
                   WarmupCosine(peak_lr=float(peak_lr), warmup_steps=3, decay_steps=30),
                   SyntheticLM(cfg, batch=8, seq_len=32),
                   TrainerConfig(total_steps=steps, ckpt_every=8, ckpt_dir=ref_dir,
                                 log_every=1000, compress=True),
                   model_par=2, failure_injector=injector)

trainer(0).run()  # the step-0 state, which both runs start from
shutil.copytree(os.path.join(ref_dir, "step_0000000000"),
                os.path.join(port_dir, "step_0000000000"))
open(marker, "w").close()
out = trainer(30, FailureInjector(schedule={18: 2})).run()
print(json.dumps({"losses": [h["loss"] for h in out["history"]],
                  "final_step": out["final_step"], "recoveries": out["recoveries"]}))
"""


def reference_steps(tmp, starts, env):
    """The reference's steps from the carried states, in a subprocess;
    the path it writes."""
    with open(tmp / "ref_in.pkl", "wb") as f:
        pickle.dump((starts, OR.WARM, REF_MODES, OR.MODES), f)
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_STEP, str(tmp / "ref_in.pkl"), str(tmp / "ref_out.pkl")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp / "ref_out.pkl"


def elastic_on_ranks(tmp, marker, ref):
    """The scenario on 4 gloo ranks at model_par 2 from the reference's
    step-0 state (once its subprocess has written it): the lead's result,
    the mesh it ended on, and what each rank restored after the
    recovery."""
    deadline = time.monotonic() + 2 * SPAWN_S
    while not marker.exists():
        if ref.poll() is not None:
            raise RuntimeError("the reference's elastic run ended before its step-0 state")
        if time.monotonic() > deadline:
            raise TimeoutError("the reference wrote no step-0 state")
        time.sleep(0.2)
    res = procs.spawn(OR.elastic, (str(tmp), ELASTIC_LR, FAIL_AT), units=units("cpu", count=4),
                      jobdir=str(tmp), backend="gloo", timeout=2 * SPAWN_S)
    out, mesh_after, _ = next(r for r in res if r[0] is not None)
    return out, mesh_after, [r[2] for r in res]


def ranks_job(tmp, env):
    """The one-process steps, the reference's steps and the 2- and 4-rank
    jobs, side by side."""
    starts, one = {}, {}
    for arch in OR.ARCHS:
        both = OR.warm_start(arch, tmp)
        for mode in OR.MODES:
            starts[(arch, mode)] = OR.mode_start(both, mode)
    ref, path = reference_steps(tmp, {k: v for k, v in starts.items() if k[1] in
                                      REF_MODES[k[0]]}, env)
    try:
        for key, start in starts.items():
            one[key] = OR.one_process(*key, start, tmp)
        cases = {k: (starts[k], one[k]["state"]) for k in CASES}
        with ThreadPoolExecutor(2) as pool:
            two = pool.submit(procs.spawn, OR.ranks, (cases, tmp, 1),
                              units=units("cpu", count=2), jobdir=str(tmp / "j2"),
                              timeout=2 * SPAWN_S)
            four = pool.submit(procs.spawn, OR.ranks, (cases, tmp),
                               units=units("cpu", count=4), jobdir=str(tmp / "j4"),
                               timeout=2 * SPAWN_S)
            two, four = two.result(), four.result()
        _, stderr = ref.communicate(timeout=4 * SPAWN_S)
        if ref.returncode:
            raise RuntimeError(f"the reference's steps failed:\n{stderr[-3000:]}")
    finally:
        ref.kill()
        ref.wait()
    with open(path, "rb") as f:
        reference = pickle.load(f)
    return {"starts": starts, "one": one, "two": two, "four": four, "reference": reference}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_optim")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    for d in ("ranks", "elastic"):
        (tmp / d).mkdir()
    marker = tmp / "elastic_init_written"
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_ELASTIC, str(tmp / "ref_elastic"), str(tmp / "elastic"),
         str(marker), str(ELASTIC_LR)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pool = ThreadPoolExecutor(2)
    try:
        futures = {"elastic": pool.submit(elastic_on_ranks, tmp / "elastic", marker, ref),
                   "ranks": pool.submit(ranks_job, tmp / "ranks", env)}
        yield futures, ref, tmp
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        ref.kill()
        ref.wait()
        torch.set_num_threads(n)


def result(jobs, name):
    return jobs[0][name].result(timeout=6 * SPAWN_S)


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------


def flat_start(start):
    return {k: np.asarray(v) for k, v in leaves_with_paths(start)}


def decoded(flat, k, shape):
    """Leaf ``k`` of a moment tree (flat), decoded to ``shape`` in float64."""
    if f"{k}/q" not in flat:
        return flat[k].astype(np.float64)
    blocks = flat[f"{k}/q"].astype(np.float64) * flat[f"{k}/scale"]
    return blocks.reshape(*blocks.shape[:-2], -1)[..., :shape[-1]].reshape(shape)


def compressed(side, start, k):
    """The gradient the step handed AdamW for leaf ``k`` on ``side``: the
    mean gradient, through the compression where there is one (the
    gradient plus the old residual less the new)."""
    g = side["grads"][k].astype(np.float64)
    if f"residuals/{k}" in start:
        g = g + start[f"residuals/{k}"] - side["state"][f"residuals/{k}"]
    return g


def fed_gradient(side, start, k):
    """``compressed`` times the clip scale of the side's grad norm."""
    return compressed(side, start, k) * min(1.0, 1.0 / max(side["grad_norm"], 1e-9))


def adam_step(side, start, k):
    """Adam's step (without decay) for leaf ``k`` on ``side``, in float64,
    from the carried moments and the side's own fed gradient."""
    shape = start[f"params/{k}"].shape
    g = fed_gradient(side, start, k)
    m = B1 * decoded(start, f"opt/m/{k}", shape) + (1 - B1) * g
    v = B2 * decoded(start, f"opt/v/{k}", shape) + (1 - B2) * g * g
    return (m / (1 - B1 ** COUNT)) / (np.sqrt(v / (1 - B2 ** COUNT)) + EPS)


def residual_flips(got, want):
    """Residual elements whose compressed code sits on a rounding boundary:
    the residual swaps sign (``torch_parity.check_train_step``'s rule)."""
    d = np.abs(got - want)
    return (np.abs(got + want) <= 0.01 * d) & (d > 0.5 * _block_absmax(want))


def boundary(floats, key, scale):
    """Whether each element of moment ``key`` (one process, before
    rounding) lies within 0.01 of a half step of its block's scale."""
    x = floats[key]
    pad = (-x.shape[-1]) % 256
    xb = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)]).reshape(*x.shape[:-1], -1, 256)
    y = np.abs(xb / np.maximum(scale, np.float32(1e-12)))
    return np.abs(y - np.floor(y) - 0.5) < 0.01


def blocked(mask):
    """An element mask of a leaf laid out as its int8 codes (blocks of 256
    along the last axis, padded)."""
    pad = (-mask.shape[-1]) % 256
    m = np.pad(mask, [(0, 0)] * (mask.ndim - 1) + [(0, pad)])
    return m.reshape(*mask.shape[:-1], -1, 256)


def code_problems(got_q, want_q, near):
    """Problems of int8 codes ``got_q`` against ``want_q``: a code off by
    more than one, or off where ``near`` (on a boundary) is false; and the
    count of boundary flips."""
    d = np.abs(got_q.astype(np.int32) - want_q.astype(np.int32))
    out = []
    if (d > 1).any():
        out.append(f"{int((d > 1).sum())} codes off by more than one")
    off = (d == 1) & ~near
    if off.any():
        out.append(f"{int(off.sum())} codes off by one away from a rounding boundary")
    return out, int((d == 1).sum())


def compare(got, want, start, floats):
    """``got`` (a side: loss, grad_norm, state, grads) against ``want`` by
    the rules of the module docstring.  Returns the problems and the
    counts of code flips, residual flips and ill-conditioned elements."""
    probs = []
    for k in ("loss", "grad_norm"):
        if abs(got[k] - want[k]) > TOL * abs(want[k]):
            probs.append(f"{k} {got[k]} against {want[k]}")
    for k, w in want["grads"].items():
        off = np.abs(got["grads"][k] - w).max() / np.abs(w).max()
        if off > TOL:
            probs.append(f"gradient of {k} off by {off:.3g} of the largest")
    gs, ws = got["state"], want["state"]
    assert set(gs) == set(ws)
    lr = want["lr"]
    counts = {"code_flips": 0, "residual_flips": 0, "ill": 0}
    skip = {}
    for k in [k for k in ws if k.startswith("residuals/")]:
        leaf = k.split("/", 1)[1]
        f = residual_flips(gs[k], ws[k])
        skip[leaf] = f
        counts["residual_flips"] += int(f.sum())
        g = compressed(want, start, leaf)
        over = (np.abs(gs[k] - ws[k]) > TOL * np.abs(g).max()) & ~f
        if over.any():
            probs.append(f"{k}: {int(over.sum())} residuals off")
    n = 0
    for k in [k for k in ws if k.startswith("params/")]:
        leaf = k.split("/", 1)[1]
        swing = lr * np.abs(adam_step(got, start, leaf) - adam_step(want, start, leaf))
        for tree in (k, f"opt/master/{leaf}"):
            tol = TOL * np.abs(ws[tree]).max()
            over = np.abs(gs[tree] - ws[tree]) > tol + swing
            if over.any():
                probs.append(f"{tree}: {int(over.sum())} elements off")
        counts["ill"] += int((swing > TOL * np.abs(ws[k]).max()).sum())
        n += ws[k].size
        for mo in ("m", "v"):
            key = f"opt/{mo}/{leaf}"
            if f"{key}/q" in ws:
                sc = ws[f"{key}/scale"]
                off = np.abs(gs[f"{key}/scale"] - sc).max() / np.abs(sc).max()
                if off > (TOL if mo == "m" else 2 * TOL):  # v: a square
                    probs.append(f"{key}/scale off by {off:.3g} of the largest")
                near = boundary(floats, f"{mo}/{leaf}", sc)
                if leaf in skip:  # a compressed code that flipped moves its moments
                    near |= blocked(skip[leaf])
                p, c = code_problems(gs[f"{key}/q"], ws[f"{key}/q"], near)
                probs += [f"{key}/q: {x}" for x in p]
                counts["code_flips"] += c
            else:
                keep = ~skip.get(leaf, np.zeros(ws[key].shape, bool))
                over = (np.abs(gs[key] - ws[key]) > 1e-4 * np.abs(ws[key]).max()) & keep
                if over.any():
                    probs.append(f"{key}: {int(over.sum())} elements off")
    if counts["ill"] > 1e-2 * n:
        probs.append(f"{counts['ill']} ill-conditioned elements of {n}")
    if counts["code_flips"] + counts["residual_flips"] > 1e-3 * n:
        probs.append(f"{counts['code_flips']} + {counts['residual_flips']} flips of {n}")
    return probs, counts


def side(res, key, world, rank):
    job = res["two" if world == 2 else "four"]
    return job[rank][key]


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,mode,world", STEPS, ids=STEP_IDS)
def test_step_matches_one_process(jobs, arch, mode, world):
    res = result(jobs, "ranks")
    one = res["one"][(arch, mode)]
    start = flat_start(res["starts"][(arch, mode)])
    for rank in range(world):
        got = side(res, (arch, mode), world, rank)
        assert got["mesh"][:2] == (world // 2, 2)
        probs, counts = compare(got, one, start, one["floats"])
        print(f"{arch} {mode} x{world} rank {rank} against one process: {counts}")
        assert not probs, (rank, probs[:6], counts)


@pytest.mark.parametrize("arch,mode", [(a, m) for a, ms in REF_MODES.items() for m in ms])
def test_step_matches_reference(jobs, arch, mode):
    """The one-process port and every rank of both jobs against the
    reference's step from the same carried state."""
    res = result(jobs, "ranks")
    ref = res["reference"][(arch, mode)]
    one = res["one"][(arch, mode)]
    start = flat_start(res["starts"][(arch, mode)])
    assert abs(one["lr"] - ref["lr"]) <= TOL * ref["lr"]
    sides = [("one", one)] + [(f"x{w}r{r}", side(res, (arch, mode), w, r))
                              for w in (2, 4) for r in range(w)]
    for name, got in sides:
        probs, counts = compare(got, ref, start, one["floats"])
        print(f"{arch} {mode} {name} against the reference: {counts}")
        assert not probs, (name, probs[:6], counts)


def ref_spec_slices(arch, want, mesh_idx):
    """{leaf: the rank's slice} of the one-process state's moments and
    residuals under the reference's ``opt_state_specs`` and
    ``param_specs`` on a (data, 2) mesh, by numpy slicing; and the
    reference's spec of each."""
    from repro.configs import get_config, reduced
    from repro.distributed import sharding as RS

    n_data, n_model = mesh_idx[:2]
    mesh = SimpleNamespace(axis_names=("data", "model"), shape={"data": n_data, "model": n_model})
    cfg = reduced(get_config(arch)).replace(vocab_size=512, dtype="float32")
    opt = OR.unflatten({k[4:]: v for k, v in want.items()
                        if k.startswith(("opt/m/", "opt/v/", "opt/count"))})
    params = OR.unflatten({k[7:]: v for k, v in want.items() if k.startswith("params/")})
    specs = {f"opt/{k}": tuple(s) for k, s in leaves_with_paths(
        RS.opt_state_specs(cfg, mesh, opt))}
    pspecs = {k: tuple(s) for k, s in leaves_with_paths(RS.param_specs(cfg, mesh, params))}
    specs.update({f"residuals/{k}": s for k, s in pspecs.items()})
    out = {}
    for k, spec in specs.items():
        if k not in want or k == "opt/count":
            continue
        out[k] = (rank_slice(want[k], spec, mesh_idx), spec)
    return out, pspecs


def rank_slice(x, spec, mesh_idx):
    """The share of ``x`` that the rank at ``mesh_idx`` (n_data, n_model,
    data index, model index) holds under ``spec``."""
    n_data, n_model, di, mi = mesh_idx
    for d, part in enumerate(spec):
        n, i = {"data": (n_data, di), "model": (n_model, mi)}.get(part, (1, 0))
        w = x.shape[d] // n
        x = x.take(range(i * w, (i + 1) * w), axis=d)
    return x


def padded(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


@pytest.mark.parametrize("arch,mode,world", STEPS, ids=STEP_IDS)
def test_each_rank_holds_its_slice_of_the_reference_layout(jobs, arch, mode, world):
    res = result(jobs, "ranks")
    one = res["one"][(arch, mode)]
    ranks = [side(res, (arch, mode), world, r) for r in range(world)]
    for got in ranks:
        slices, pspecs = ref_spec_slices(arch, one["state"], got["mesh"])
        assert set(got["held"]) == set(slices)
        for k, (held, port_want, port_spec) in got["held"].items():
            want, spec = slices[k]
            assert padded(port_spec, held.ndim) == padded(spec, held.ndim), (k, port_spec, spec)
            assert held.shape == want.shape and np.array_equal(port_want, want), k
            if k.endswith("/q"):
                d = np.abs(held.astype(np.int32) - want.astype(np.int32))
                assert d.max() <= 1 and (d > 0).sum() <= 1e-3 * d.size, (k, int(d.max()))
            elif k.endswith("/scale"):
                tol = TOL * (2 if k.startswith("opt/v/") else 1)  # v: a square
                assert np.abs(held - want).max() <= tol * np.abs(want).max(), k
            elif k.startswith("residuals/"):
                # 1e-5 of the largest gradient the blocks carry (127 steps
                # of the largest scale, each residual at most half a step)
                bad = np.abs(held - want) > TOL * 254 * np.abs(want).max()
                assert not (bad & ~residual_flips(held, want)).any(), k
    # a column-split leaf's codes: whole along model, equal on the group's ranks
    whole_along_model = 0
    for k, (held, _, spec) in ranks[0]["held"].items():
        if not k.endswith("/q"):
            continue
        leaf = k.split("/", 2)[2].rsplit("/", 1)[0]
        if padded(pspecs[leaf], held.ndim - 1)[-1] != "model":
            continue
        assert "model" not in spec, (k, spec)
        whole_along_model += 1
        for a, b in ((0, 1), (2, 3))[:world // 2]:
            assert np.array_equal(ranks[a]["held"][k][0], ranks[b]["held"][k][0]), k
    assert whole_along_model > 0 or not OR.MODES[mode][0]


@pytest.mark.parametrize("mode", ["int8", "compress"])
def test_planted_straddle_fault_fails(jobs, mode):
    """Rank 1 quantizing its own columns in blocks of its own, where the
    blocks of 256 run across the ranks: the code check (int8) or the
    residual check (compression) fails."""
    res = result(jobs, "ranks")
    one = res["one"][("granite-8b", mode)]
    start = flat_start(res["starts"][("granite-8b", mode)])
    what = "/q:" if mode == "int8" else "residuals/"
    for rank in range(2):
        got = res["two"][rank][("fault", mode)]
        probs, _ = compare(got, one, start, one["floats"])
        assert any(what in p for p in probs), (rank, probs[:4])


def test_elastic_int8_compression_recovers_as_the_reference_does(jobs):
    """Both runs reach step 30 after one recovery through the same steps,
    onto a (1, 2) mesh, with finite losses; the first DRIFT_FROM losses
    (the common step-0 state, then the model-split steps with the first
    int8 updates) within rel. 1e-4 of the reference's.  Later losses are
    not held: with int8 moments an element whose second moment decodes
    to 0 takes Adam's step m / |g|, and a code one step either side of 0
    moves it by orders of magnitude, so trajectories that differ in the
    last bits part within a few steps, the port's one-process run and
    the reference's one-device run too (``ROADMAP.md`` §3)."""
    out, mesh_after, _ = result(jobs, "elastic")
    assert out["final_step"] == 30 and out["recoveries"] == 1
    assert mesh_after == {"data": 1, "model": 2}
    assert [h["step"] for h in out["history"]] == (list(range(FAIL_AT))
                                                   + list(range(CKPT_BEFORE, 30)))
    ref = jobs[1]
    stdout, stderr = ref.communicate(timeout=4 * SPAWN_S)
    assert ref.returncode == 0, stderr[-3000:]
    want = json.loads(stdout.strip().splitlines()[-1])
    assert want["final_step"] == 30 and want["recoveries"] == 1
    got = np.array([h["loss"] for h in out["history"]])
    assert len(got) == len(want["losses"]) and np.isfinite(got).all()
    np.testing.assert_allclose(got[:DRIFT_FROM], want["losses"][:DRIFT_FROM], rtol=1e-4)


def test_elastic_recovery_resumes_from_the_checkpoint(jobs):
    """After the recovery the port's run repeats steps 16-17 on the (1, 2)
    mesh from the step-16 checkpoint and the same batches: their losses
    within rel. 1e-5 (float32 over ranks) of the first run's on (2, 2);
    and each surviving rank's restored state is, bit for bit, its slice of
    the step-16 checkpoint under the reference's ``param_specs`` and
    ``opt_state_specs`` on (1, 2) (numpy slicing; the int8 codes of a
    column-split leaf whole), parameters, master copies, codes, scales,
    residuals and step alike."""
    import jax
    from repro.checkpoint import ckpt as RC
    from repro.configs import get_config, reduced
    from repro.distributed import sharding as RS
    from repro.models import Runtime, build_model
    from repro.optim import AdamW, AdamWConfig
    from repro.train.step import init_state

    out, _, restored = result(jobs, "elastic")
    losses = [h["loss"] for h in out["history"]]
    again = FAIL_AT - CKPT_BEFORE
    np.testing.assert_allclose(losses[FAIL_AT:FAIL_AT + again],
                               losses[CKPT_BEFORE:FAIL_AT], rtol=TOL)
    cfg = reduced(get_config("granite-8b")).replace(vocab_size=512, dtype="float32")
    like = jax.eval_shape(lambda: init_state(
        build_model(cfg, Runtime(remat="none")),
        AdamW(AdamWConfig(state_dtype="int8", master_weights=True)), jax.random.key(0),
        compress=True))
    whole, meta = RC.restore(str(jobs[2] / "elastic" / f"step_{CKPT_BEFORE:010d}"), like)
    assert int(meta["step"]) == CKPT_BEFORE
    mesh = SimpleNamespace(axis_names=("data", "model"), shape={"data": 1, "model": 2})
    pspecs = RS.param_specs(cfg, mesh, whole["params"])
    specs = {"params": pspecs, "opt": RS.opt_state_specs(cfg, mesh, whole["opt"]),
             "residuals": pspecs, "step": ()}
    specs = {k: tuple(s) for k, s in leaves_with_paths(specs)}
    whole = {k: np.asarray(v) for k, v in leaves_with_paths(whole)}
    survivors = [r for r in restored if r]
    assert len(survivors) == 2 and sorted(r[0][2][3] for r in survivors) == [0, 1]
    for (step, held, idx), in survivors:
        assert step == CKPT_BEFORE and idx[:2] == (1, 2)
        assert set(held) == set(whole)
        for k, v in held.items():
            want = rank_slice(whole[k], specs.get(k, ()), idx)
            assert v.dtype == want.dtype and np.array_equal(v, want), (idx, k)


def test_final_checkpoint_restores_bitwise_across_packages(jobs):
    """The port's final checkpoint (its codes whole along ``model`` where
    the leaf's columns are split) read by the reference equals the port's
    final state, and the reference's read by the port equals what the
    reference reads of it."""
    import jax
    from repro.checkpoint import CheckpointManager as RefCkpt
    from repro.configs import get_config, reduced
    from repro.models import Runtime, build_model
    from repro.optim import AdamW, AdamWConfig
    from repro.train.step import init_state
    from repro_torch.checkpoint import CheckpointManager

    out, _, _ = result(jobs, "elastic")
    ref = jobs[1]
    ref.communicate(timeout=4 * SPAWN_S)
    assert ref.returncode == 0
    tmp = jobs[2]
    cfg = reduced(get_config("granite-8b")).replace(vocab_size=512, dtype="float32")
    model = build_model(cfg, Runtime(remat="none"))
    like = jax.eval_shape(lambda: init_state(
        model, AdamW(AdamWConfig(state_dtype="int8", master_weights=True)),
        jax.random.key(0), compress=True))
    port_final = {k: t.numpy() for k, t in leaves_with_paths(out["state"])}
    got, meta = RefCkpt(str(tmp / "elastic")).restore_latest(like)
    assert int(meta["step"]) == 30
    got = {k: np.asarray(v) for k, v in leaves_with_paths(got)}
    assert set(got) == set(port_final)
    for k, v in port_final.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    tr = OR.make_trainer(tmp / "unused", units("cpu", count=1), mode="both")
    mine, meta = CheckpointManager(str(tmp / "ref_elastic")).restore_latest(tr._state_shape())
    assert int(meta["step"]) == 30
    theirs, _ = RefCkpt(str(tmp / "ref_elastic")).restore_latest(like)
    theirs = {k: np.asarray(v) for k, v in leaves_with_paths(theirs)}
    mine = {k: t.numpy() for k, t in leaves_with_paths(mine)}
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        assert mine[k].dtype == v.dtype and np.array_equal(mine[k], v), k


def test_remat_recomputes_under_the_forward_mesh_in_another_thread():
    """A card's backward pass runs in autograd's own thread, which has
    none of the caller's contexts: the checkpointed layers (``remat``
    full) of rank 0's shares of reduced granite-8b at model_par 2 (a fake
    process group) recompute under the mesh the forward ran under, and
    their gradients equal those of a backward pass in the caller's
    thread."""
    import threading

    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.ctx import mesh_context
    from repro_torch.distributed.meshes import AbstractMesh, rank_view
    from repro_torch.models import Runtime, build_model
    from repro_torch.tree import leaves, tree_map

    cfg = OR.train_cfg("granite-8b")
    model = build_model(cfg, Runtime(remat="full"))
    params = model.init(0, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in OR.SyntheticLM(cfg, 2, 16).global_batch(0).items()}
    with rank_view(AbstractMesh((1, 2), ("data", "model")), "cpu") as rm:
        specs = shd.named(rm, shd.param_specs(cfg, rm, params))
        share = tree_map(lambda s, t: s.place(t).requires_grad_(), specs, params)
        grads = []
        for thread in (False, True):
            with mesh_context(rm):
                loss, _ = model.loss(share, batch)
            out, err = {}, []

            def backward():
                try:
                    out["g"] = torch.autograd.grad(loss, leaves(share))
                except Exception as e:  # reported below
                    err.append(e)

            if thread:
                t = threading.Thread(target=backward)
                t.start()
                t.join()
            else:
                with mesh_context(rm):
                    backward()
            assert not err, err
            grads.append(out["g"])
    for a, b in zip(*grads):
        assert torch.equal(a, b)

"""Shared helpers of the ``test_torch_*`` files: export the reference
package's inputs as plain data and carry them into the port, so both run
on identical inputs.  Not a test module (no ``test_`` prefix)."""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.core import carry
from repro_torch.core.types import NodeView as PortNodeView


def fp_records(records):
    """The reference tests' fingerprint (tests/test_events.py), plus the
    DVFS level, so frequency choices are compared too."""
    s = ";".join(
        f"{r.job}|{r.g}|{r.f}|{r.start!r}|{r.end!r}|{r.node}|{r.domain}"
        for r in records
    )
    return hashlib.md5(s.encode()).hexdigest()


def export_profiles(truth):
    """Reference ``{app: JobProfile}`` -> plain nested dicts."""
    return {app: dataclasses.asdict(p) for app, p in truth.items()}


def carry_profiles(truth):
    return carry.profiles_from_arrays(export_profiles(truth))


def export_specs(specs):
    """Reference ``[JobSpec]`` -> per-mode numpy columns."""
    return [
        {
            "name": s.name,
            "g": np.array([m.g for m in s.modes], dtype=np.int64),
            "f": np.array([m.f for m in s.modes], dtype=np.int64),
            "t_norm": np.array([m.t_norm for m in s.modes]),
            "p_bar": np.array([m.p_bar for m in s.modes]),
            "e_norm": np.array([m.e_norm for m in s.modes]),
        }
        for s in specs
    ]


def carry_specs(specs):
    return carry.specs_from_arrays(export_specs(specs))


def carry_view(view):
    """A reference ``NodeView`` of a synthetic window (no running-job
    objects the decision reads) as the port's."""
    return PortNodeView(
        t=view.t, total_units=view.total_units, domains=view.domains,
        free_units=view.free_units, running=list(view.running),
        free_map=list(view.free_map), domain_jobs=list(view.domain_jobs),
        dead_units=view.dead_units,
    )


def tensors(*arrays):
    """numpy -> CPU float32 tensors (None stays None)."""
    return tuple(
        None if a is None
        else torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        for a in arrays
    )


def schedule_key(res):
    return (fp_records(res.records), res.makespan, res.total_energy)


def pod_table(n_jobs, *, M=16, levels=4, seed=7):
    """Seeded synthetic pod-scale truth table as plain dicts: sublinear
    speedups and power-law busy power over the counts that fit ``M`` (the
    shape of ``benchmarks/bench_decision_overhead.synth_window``), with
    the H100 DVFS ladder's sweet-spot curves at a per-job memory-bound
    fraction.  Returns (table, arrival stream)."""
    ratios = (1.0, 0.86, 0.72, 0.58)[:levels]
    floor = 0.32
    rng = np.random.default_rng(seed)
    counts = [g for g in (1, 2, 3, 4, 6, 8, 12, 16) if g <= M]
    table, stream, t = {}, [], 0.0
    for i in range(n_jobs):
        name = f"job{i}"
        t1 = float(rng.uniform(600.0, 6000.0))
        a = float(rng.uniform(0.35, 0.95))
        p0 = float(rng.uniform(250.0, 500.0))
        b = float(rng.uniform(0.6, 0.9))
        mu = float(rng.uniform(0.1, 0.75))
        runtime = {g: t1 / g ** a for g in counts}
        table[name] = dict(
            runtime=runtime,
            busy_power={g: p0 * g ** b for g in counts},
            dram_util={g: 1.0 / (runtime[g] * g) for g in counts},
            freq_time={f: mu + (1.0 - mu) / r for f, r in enumerate(ratios)},
            freq_power={f: floor + (1.0 - floor) * r ** 3
                        for f, r in enumerate(ratios)},
        )
        stream.append((t, name))
        t += float(rng.exponential(120.0))
    return table, stream


# ---------------------------------------------------------------------------
# Training: one train step of both packages from one carried state
# ---------------------------------------------------------------------------

_REF_STEPS = {}


def ref_train_step(name, grad_accum, compress, *, lr=1e-3):
    """The reference's jitted ``make_train_step`` for reduced ``name`` in
    float32 (AdamW defaults, WarmupCosine without warmup), compiled once
    per process, and its model and config."""
    import jax
    from repro.configs import get_config, reduced
    from repro.models import Runtime, build_model
    from repro.optim import AdamW, WarmupCosine
    from repro.train.step import make_train_step

    key = (name, grad_accum, compress, lr)
    if key not in _REF_STEPS:
        cfg = reduced(get_config(name)).replace(dtype="float32")
        model = build_model(cfg, Runtime(remat="none"))
        step = jax.jit(make_train_step(
            model, AdamW(), WarmupCosine(peak_lr=lr, warmup_steps=0, decay_steps=50),
            compress=compress, grad_accum=grad_accum))
        _REF_STEPS[key] = (cfg, model, step)
    return _REF_STEPS[key]


def port_train_step(name, grad_accum, compress, *, lr=1e-3, remat="none"):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Runtime, build_model
    from repro_torch.optim import AdamW, WarmupCosine
    from repro_torch.train.step import make_train_step

    cfg = reduced(get_config(name)).replace(dtype="float32")
    model = build_model(cfg, Runtime(remat=remat))
    return make_train_step(model, AdamW(), WarmupCosine(peak_lr=lr, warmup_steps=0,
                                                        decay_steps=50),
                           compress=compress, grad_accum=grad_accum)


def np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def flat_np(tree):
    """{path: numpy} of a port tree of tensors or a reference tree of
    arrays (floating leaves as float32)."""
    from repro_torch.tree import leaves_with_paths

    out = {}
    for k, v in leaves_with_paths(tree):
        if isinstance(v, torch.Tensor):
            v = v.detach().float().numpy() if v.is_floating_point() else v.numpy()
        else:
            v = np.asarray(v)
            v = v.astype(np.float32) if v.dtype.kind == "V" or v.dtype.name == "bfloat16" else v
        out[k] = v
    return out


def _block_absmax(a, block=256):
    """Each element's block (256 along the last axis, as the int8
    compression blocks it) largest magnitude."""
    a = np.abs(a.reshape(a.shape or (1,)))
    last = a.shape[-1]
    pad = (-last) % block
    b = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
    b = b.reshape(*b.shape[:-1], -1, block).max(axis=-1, keepdims=True)
    return np.broadcast_to(b, b.shape[:-1] + (block,)).reshape(
        *b.shape[:-2], -1)[..., :last].reshape(a.shape)


def check_train_step(name, grad_accum, compress, *, warm_steps):
    """One train step of both packages from one state: the reference's
    state after ``warm_steps`` of its own steps from its init (at 0, its
    init), carried with ``carry.state_from_numpy``.  Loss and grad norm
    within rel. 1e-5; every updated parameter within 1e-5 of its leaf's
    largest magnitude, and the new first moments (0.1 of the clipped
    gradient at step 0) within 1e-4 of theirs, except at two kinds of
    element, each counted and returned:

    * ``flips``: with compression, a gradient element whose int8 code sits
      on a rounding boundary can round the other way in one package (its
      input differs in the last bits) and move by one quantization step.
      Its residuals swap sign (+s/2 against -s/2, s the block's step),
      which is how it is found.
    * ``ill``: at the first step (count 1) Adam's step is g / (|g| + eps)
      (v̂ = ĝ² = m̂²), which swings with the last bits of a gradient whose
      magnitude is near eps (a norm's gradient is a sum that cancels to
      about 1e-7 of its terms).  There each parameter is held to 1e-5 of
      its leaf's magnitude plus lr times the difference of the two steps,
      each computed from its own package's first moment (g = m / 0.1), so
      none is left out and the gradients themselves are held by the first
      moments' bound.  ``ill`` counts the elements where that difference
      is the larger term.  Mid-run, v carries earlier gradients and the
      bound is 1e-5 alone.
    """
    import jax
    import jax.numpy as jnp
    from repro.data import SyntheticLM
    from repro.optim import AdamW
    from repro.train.step import init_state
    from repro_torch.core.carry import state_from_numpy

    cfg, model, rstep = ref_train_step(name, grad_accum, compress)
    data = SyntheticLM(cfg, 4, 32)
    st = init_state(model, AdamW(), jax.random.key(0), compress=compress)
    for s in range(warm_steps):
        st, _ = rstep(st, {k: jnp.asarray(v) for k, v in data.global_batch(s).items()})
    st_np = np_tree(st)
    pst = state_from_numpy(st_np, device="cpu")
    batch = data.global_batch(warm_steps)
    r2, rm = rstep(jax.tree_util.tree_map(jnp.asarray, st_np),
                   {k: jnp.asarray(v) for k, v in batch.items()})
    p2, pm = port_train_step(name, grad_accum, compress)(
        pst, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm", "lr"):
        a, b = float(rm[k]), float(pm[k])
        assert abs(a - b) <= 1e-5 * abs(a), (k, a, b)
    assert int(p2["step"]) == warm_steps + 1 and p2["step"].dtype == torch.int32
    skip, flips, ill = {}, {}, {}
    if compress:
        rr, pr = flat_np(r2["residuals"]), flat_np(p2["residuals"])
        for k, a in rr.items():
            d = np.abs(pr[k] - a)
            f = (np.abs(pr[k] + a) <= 0.01 * d) & (d > 0.5 * _block_absmax(a))
            skip[k], flips[k] = f, int(f.sum())
    swing = {}  # lr x |step_port - step_ref| at count 1
    if warm_steps == 0:
        lr = float(rm["lr"])
        rmom, pmom = flat_np(r2["opt"]["m"]), flat_np(p2["opt"]["m"])

        def adam_step(m):
            g = m.astype(np.float64) / (1.0 - 0.9)
            return g / (np.abs(g) + 1e-8)

        for k, m in rmom.items():
            swing[k] = lr * np.abs(adam_step(pmom[k]) - adam_step(m))
    for tree in ("params", "m"):
        want = flat_np(r2["params"] if tree == "params" else r2["opt"]["m"])
        got = flat_np(p2["params"] if tree == "params" else p2["opt"]["m"])
        for k, w in want.items():
            keep = ~skip[k] if k in skip else np.ones(w.shape, bool)
            scale = max(np.abs(w).max(), 1e-30)
            tol = (1e-5 if tree == "params" else 1e-4) * scale
            if tree == "params" and k in swing:
                ill[k] = int((swing[k] > tol).sum())
                tol = tol + swing[k]
            over = (np.abs(got[k] - w) > tol) & keep
            assert not over.any(), (tree, k, float((np.abs(got[k] - w) / scale)[over].max()))
    n = sum(w.size for w in flat_np(r2["params"]).values())
    assert sum(flips.values()) <= 1e-3 * n and sum(ill.values()) <= 1e-2 * n
    return {"flips": {k: v for k, v in flips.items() if v}, "ill": {k: v for k, v in ill.items() if v}}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread for the test, restored after.  The
    reduced models' ops are small; with the suite's workers sharing the
    cores, torch's intra-op thread pools oversubscribe them (a 1 s test
    took 33 s).  Imported by the training test files, which use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)

"""The port's data pipeline, schedules, gradient compression and AdamW
(``repro_torch.data`` / ``repro_torch.optim``) against the reference's,
on the CPU.

* ``SyntheticLM``: batches bitwise equal for every (seed, step), host
  slices, patch and source embeddings included (the port's module is a
  numpy copy).
* Schedules: within rel. 1e-6 over steps 0-200.
* ``compress_grads``: quantized gradients and residuals bitwise equal on
  float32 inputs over 3 steps of error feedback (blocks of 256 along the
  last axis, ragged last blocks, round half to even at exact ties).
* ``AdamW`` (float32 / bfloat16 / int8 moments, master weights on and
  off), 3 updates fed the same gradients: parameters and float32 moments
  within rel. 1e-6 of their leaf's largest magnitude (bf16 moments within
  one bf16 ulp), int8 codes equal; ``grad_norm`` within rel. 1e-6 of
  the exact (float64) norm, and of the reference's within rel. 1e-6 plus
  the reference's own distance from the exact norm.  Once on dyadic
  gradients (exact sums of squares, so both clip scales agree) and once
  on general float32 and bf16 gradients (moments then also within that
  distance; see the test for the bf16 moments it rounds the other way).
* Mirrors of ``tests/test_substrate.py``'s data and optimizer cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduced  # noqa: E402
from repro.data import DataConfig, SyntheticLM  # noqa: E402
from repro.optim import AdamW, AdamWConfig, Constant, WarmupCosine  # noqa: E402
from repro.optim import compress_grads, init_residuals  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch import data as PD  # noqa: E402
from repro_torch import optim as PO  # noqa: E402
from repro_torch.core.carry import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as PA  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    """{path: numpy} of a reference tree (jax) or a port tree (torch)."""
    if any(isinstance(v, torch.Tensor) for _, v in leaves_with_paths(tree)):
        return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                for k, v in leaves_with_paths(tree)}
    return {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
            for k, v in leaves_with_paths(_np_tree(tree))}


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["granite-8b", "phi-3-vision-4.2b", "whisper-base"])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batches_bitwise(name, seed):
    rcfg, pcfg = reduced(get_config(name)), PC.reduced(PC.get_config(name))
    ref = SyntheticLM(rcfg, 8, 48, DataConfig(seed=seed, noise_p=0.3))
    port = PD.SyntheticLM(pcfg, 8, 48, PD.DataConfig(seed=seed, noise_p=0.3))
    for step in (0, 1, 17, 10_000):
        a, b = ref.global_batch(step), port.global_batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, step, k)
        for i in range(4):
            sa, sb = ref.host_slice(step, i, 4), port.host_slice(step, i, 4)
            assert all(np.array_equal(sa[k], sb[k]) for k in sa)
    if rcfg.frontend == "patch_stub":
        assert "patch_embeds" in b
    if rcfg.is_encoder_decoder:
        assert "src_embeds" in b


def test_make_dataset_matches():
    from repro.configs.base import ShapeCell
    from repro.data import make_dataset
    from repro_torch.configs.base import ShapeCell as PCell

    cfg, pcfg = reduced(get_config("granite-8b")), PC.reduced(PC.get_config("granite-8b"))
    cell = ShapeCell(name="t", seq_len=32, global_batch=4, kind="train")
    pcell = PCell(name="t", seq_len=32, global_batch=4, kind="train")
    a = make_dataset(cfg, cell, seed=5).global_batch(2)["tokens"]
    b = PD.make_dataset(pcfg, pcell, seed=5).global_batch(2)["tokens"]
    assert np.array_equal(a, b)


def test_data_deterministic_and_shardable():
    cfg = PC.reduced(PC.get_config("granite-8b"))
    ds = PD.SyntheticLM(cfg, batch=8, seq_len=32, dcfg=PD.DataConfig(seed=3))
    b1 = ds.global_batch(5)
    np.testing.assert_array_equal(b1["tokens"], ds.global_batch(5)["tokens"])
    assert not np.array_equal(b1["tokens"], ds.global_batch(6)["tokens"])
    parts = [ds.host_slice(5, i, 4)["tokens"] for i in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts, 0), b1["tokens"])


def test_data_has_learnable_structure():
    cfg = PC.reduced(PC.get_config("granite-8b")).replace(vocab_size=64)
    ds = PD.SyntheticLM(cfg, batch=4, seq_len=256, dcfg=PD.DataConfig(seed=0, noise_p=0.2))
    t = ds.global_batch(0)["tokens"]
    assert ((t[:, 1:] == (t[:, :-1] * 3 + 7) % 64).mean()) > 0.6


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(peak_lr=3e-4, warmup_steps=100, decay_steps=10_000),
    dict(peak_lr=1e-3, warmup_steps=10, decay_steps=100, final_frac=0.05),
    dict(peak_lr=2e-3, warmup_steps=0, decay_steps=30),
    dict(peak_lr=1e-3, warmup_steps=7, decay_steps=7),
])
def test_warmup_cosine_matches(kw):
    ref, port = WarmupCosine(**kw), PO.WarmupCosine(**kw)
    steps = np.arange(201)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps, jnp.int32)))
    got = np.array([float(port(torch.tensor(s, dtype=torch.int32))) for s in steps])
    assert port(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_constant_matches():
    for s in (0, 5, 200):
        got = PO.Constant(3e-4)(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == float(Constant(3e-4)(s))


def test_schedule_shapes():
    sch = PO.WarmupCosine(peak_lr=1e-3, warmup_steps=10, decay_steps=100)
    assert float(sch(0)) == 0.0
    assert float(sch(10)) == pytest.approx(1e-3, rel=1e-5)
    assert float(sch(100)) == pytest.approx(1e-4, rel=1e-2)


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------


def _grads(rng, scale=1.0):
    g = {
        "w": rng.normal(size=(3, 300)) * scale,  # ragged last block
        "b": rng.normal(size=(256,)) * scale,
        "e": {"x": rng.normal(size=(2, 5, 512)) * scale, "y": rng.normal(size=(7,))},
    }
    # exact ties: a block whose max is 127 holds integers and half-integers
    tie = np.arange(-127, 129, dtype=np.float64)
    tie[1::4] += 0.5
    tie[-1] = 127.0
    g["t"] = tie
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), g)


def test_compress_grads_bitwise_with_error_feedback():
    rng = np.random.default_rng(0)
    g0 = _grads(rng)
    r_res = init_residuals(jax.tree_util.tree_map(jnp.asarray, g0))
    p_res = PO.init_residuals(params_from_numpy(g0, device="cpu"))
    for step in range(3):
        g = _grads(rng, scale=10.0 ** (step - 1))
        rq, r_res = compress_grads(jax.tree_util.tree_map(jnp.asarray, g), r_res)
        pq, p_res = PO.compress_grads(params_from_numpy(g, device="cpu"), p_res)
        for want, got in ((_flat(rq), _flat(pq)), (_flat(r_res), _flat(p_res))):
            for k in want:
                assert want[k].dtype == got[k].dtype == np.float32
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"step {step} {k}")


def test_compression_error_feedback_identity():
    rng = np.random.default_rng(0)
    grads = {"w": torch.from_numpy(rng.normal(size=(300,)).astype(np.float32))}
    q, res = PO.compress_grads(grads, PO.init_residuals(grads))
    np.testing.assert_allclose((q["w"] + res["w"]).numpy(), grads["w"].numpy(), atol=1e-6)
    assert float(res["w"].abs().max()) <= float(grads["w"].abs().max()) / 127.0 + 1e-6


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _params(rng, dtype):
    p = {
        "w": rng.normal(size=(64, 300)) * 0.5,
        "b": rng.normal(size=(300,)) * 0.1,  # ndim 1: no decay
        "blocks": {"e": rng.normal(size=(3, 17, 260)), "s": rng.normal(size=(3, 5))},
    }
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), p)


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_updates_match(state_dtype, master):
    """The gradients are small integers times a power of two, so every
    float32 sum of their squares is exact in any order and the clipping
    scale (every step here clips, norms 22-360) is the same number in
    both packages: the comparison isolates the update's arithmetic.  On
    general bf16 gradients XLA's float32 sum of squares is up to 2.6e-6 off
    the exact sum (the port's 1e-7), which moves the clip scale, hence
    the moments, and int8 codes that sit at a rounding boundary."""
    rng = np.random.default_rng(1)
    pdt = jnp.bfloat16 if master else jnp.float32
    cfg = dict(state_dtype=state_dtype, master_weights=master)
    ref, port = AdamW(AdamWConfig(**cfg)), PO.AdamW(PO.AdamWConfig(**cfg))
    rp = _params(rng, pdt)
    rs = ref.init(rp)
    pp = params_from_numpy(_np_tree(rp), device="cpu")
    ps = port.init(pp)
    for i in range(3):
        g = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.round(rng.normal(size=x.shape) * 8) * 2.0 ** (2 * i - 6),
                                  x.dtype), rp)
        lr = 1e-2 / (i + 1)
        rp, rs, rm = ref.update(g, rs, rp, jnp.float32(lr))
        pp, ps, pm = port.update(params_from_numpy(_np_tree(g), device="cpu"), ps, pp,
                                 torch.tensor(lr, dtype=torch.float32))
        # the norm within 1e-6 of the exact one, and of the reference's
        # within the reference's own rounding (XLA's float32 sum of squares
        # is up to 2.6e-6 off the exact sum over bf16 gradients here)
        exact = np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2)
                            for x in jax.tree_util.tree_leaves(_np_tree(
                                jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), g)))))
        got_n, want_n = float(pm["grad_norm"]), float(rm["grad_norm"])
        assert abs(got_n - exact) <= 1e-6 * exact
        assert abs(got_n - want_n) <= abs(want_n - exact) + 1e-6 * exact
        want, got = _flat(rp), _flat(pp)
        for k in want:
            assert got[k].shape == want[k].shape
            err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
            assert err <= 1e-6, (i, k, err)
        rstate, pstate = dict(leaves_with_paths(_np_tree(rs))), dict(leaves_with_paths(ps))
        assert sorted(rstate) == sorted(pstate)
        for k, a in rstate.items():
            b = pstate[k]
            if k == "count":
                assert b.dtype == torch.int32 and int(b) == int(a) == i + 1
            elif k.endswith("/q"):  # int8 codes: equal
                assert b.dtype == torch.int8
                np.testing.assert_array_equal(b.numpy(), a, err_msg=k)
            else:  # moments (bf16 ones to a bf16 ulp) and scales, to the leaf's magnitude
                bf16 = a.dtype == jnp.bfloat16
                assert b.dtype == (torch.bfloat16 if bf16 else torch.float32)
                a32, b32 = a.astype(np.float32), b.float().numpy()
                err = np.abs(b32 - a32).max() / max(np.abs(a32).max(), 1e-30)
                assert err <= (2 ** -7 if bf16 else 1e-6), (i, k, err)


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_updates_match_general_gradients(state_dtype, grad_dtype):
    """General (normal) gradients on float32 parameters.  The packages'
    clip scales may differ by the reference's own distance from the exact
    float64 norm, d; the parameters are held to 1e-6 of each leaf's
    magnitude, the first moments to 1e-6 + d and the second to 1e-6 + 2d,
    d the largest of the steps so far.  bf16 moments are held to a bf16
    ulp: a clip scale off by d can round one the other way, and the
    parameter at such an element moves by that ulp's share of its step
    from then on, so it is left out of the 1e-6 bound.  A moment shifted
    by d to 2d lies that close to a bf16 rounding boundary (2^-8 apart)
    with odds of about 1e-3 a step, so the flipped elements, counted over
    two moments and three steps, are held to at most 1e-2 of them."""
    rng = np.random.default_rng(2)
    cfg = dict(state_dtype=state_dtype)
    ref, port = AdamW(AdamWConfig(**cfg)), PO.AdamW(PO.AdamWConfig(**cfg))
    rp = _params(rng, jnp.float32)
    rs = ref.init(rp)
    pp = params_from_numpy(_np_tree(rp), device="cpu")
    ps = port.init(pp)
    d, flips = 0.0, {}  # flips: elements whose bf16 moments have differed at any step
    for i in range(3):
        g = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape) * 10.0 ** (i - 1), grad_dtype), rp)
        lr = 1e-2 / (i + 1)
        rp, rs, rm = ref.update(g, rs, rp, jnp.float32(lr))
        pp, ps, pm = port.update(params_from_numpy(_np_tree(g), device="cpu"), ps, pp,
                                 torch.tensor(lr, dtype=torch.float32))
        exact = np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2)
                            for x in jax.tree_util.tree_leaves(_np_tree(
                                jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), g)))))
        got_n, want_n = float(pm["grad_norm"]), float(rm["grad_norm"])
        assert abs(got_n - exact) <= 1e-6 * exact
        d = max(d, abs(want_n - exact) / exact)
        rstate, pstate = dict(leaves_with_paths(_np_tree(rs))), dict(leaves_with_paths(ps))
        assert sorted(rstate) == sorted(pstate)
        want, got = _flat(rp), _flat(pp)
        for k in want:
            flip = flips.setdefault(k, np.zeros(want[k].shape, bool))
            if state_dtype == "bfloat16":
                for mom in ("m/", "v/"):
                    flip |= rstate[mom + k].astype(np.float32) != pstate[mom + k].float().numpy()
            err = np.abs(got[k] - want[k])[~flip].max(initial=0.0) / np.abs(want[k]).max()
            assert err <= 1e-6, (i, k, err)
        n_flips = sum(int(f.sum()) for f in flips.values())
        assert n_flips <= 1e-2 * sum(w.size for w in want.values()), n_flips
        for k, a in rstate.items():
            if k == "count":
                assert int(pstate[k]) == int(a) == i + 1
                continue
            a32, b32 = a.astype(np.float32), pstate[k].float().numpy()
            err = np.abs(b32 - a32).max() / max(np.abs(a32).max(), 1e-30)
            tol = 2 ** -7 if a.dtype == jnp.bfloat16 else 1e-6 + (2 if k.startswith("v/") else 1) * d
            assert err <= tol, (i, k, err, d)


def test_q8_codes_round_half_to_even():
    """Codes at exact ties (x / scale = n + 0.5) go to the even code in
    both packages."""
    from repro.optim import adamw as RA

    x = np.arange(-127, 129, dtype=np.float32)
    x[1::4] += 0.5
    x[-1] = 127.0
    x = x.reshape(1, 256)
    want = RA._q8(jnp.asarray(x))
    got = PA._q8(torch.from_numpy(x))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    back = PA._dq8(got, x.shape)
    np.testing.assert_array_equal(back.numpy(), np.asarray(RA._dq8(want, x.shape)))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_descends(state_dtype):
    opt = PO.AdamW(PO.AdamWConfig(state_dtype=state_dtype, weight_decay=0.0))
    params = {"w": torch.tensor([3.0, -2.0, 1.5]), "b": torch.tensor([[1.0, -1.0]] * 2)}
    state = opt.init(params)

    def loss(p):
        return sum(torch.sum(torch.square(x)) for x in p.values())

    l0 = float(loss(params))
    for _ in range(50):
        grads = {k: 2 * v for k, v in params.items()}
        params, state, _ = opt.update(grads, state, params, torch.tensor(0.05))
    assert float(loss(params)) < 0.2 * l0


def test_adamw_master_weights_bf16_params():
    opt = PO.AdamW(PO.AdamWConfig(master_weights=True, weight_decay=0.0))
    params = {"w": torch.ones((64,), dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state["master"]["w"].dtype == torch.float32
    for _ in range(30):
        g = {"w": 2 * params["w"].float()}
        params, state, _ = opt.update(g, state, params, torch.tensor(0.03))
    assert params["w"].dtype == torch.bfloat16
    assert float(torch.sum(torch.square(params["w"].float()))) < 10.0


def test_int8_state_bytes():
    for sd in ("float32", "bfloat16", "int8"):
        assert (PO.AdamW(PO.AdamWConfig(state_dtype=sd)).state_bytes_per_param()
                == AdamW(AdamWConfig(state_dtype=sd)).state_bytes_per_param())
    assert PO.AdamW(PO.AdamWConfig(state_dtype="int8")).state_bytes_per_param() < 2.2

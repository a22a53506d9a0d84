"""The port's model zoo against the reference, on the CPU.

For every arch, MoE (qwen2-moe-a2.7b, arctic-480b) included,
``reduced(cfg)`` in float32 with the reference's parameters carried over
by ``carry.params_from_numpy``: ``prefill`` logits and every cache leaf,
then three ``decode_step``s, match the reference's ``Model`` at atol/rtol
1e-4 under ``attn_impl`` "pallas" and "auto", and so does ``loss`` (with
the MoE load-balancing term); ``ssd_forward(use_pallas=True)`` matches
the reference's; the port's own prefill + decode equals its forward (rel
< 2e-3, as ``tests/test_decode_consistency.py`` asserts of the
reference, MoE at its no-drop capacity as there); one bfloat16 case
within 2e-2 of the reference in max |difference| over max |reference|
(the measure ``chip_smoke.py``'s serving check uses); without a mesh,
``moe_impl="auto"`` takes the dense dispatch and ``"ep"`` raises, as in
the reference.  ``tests/test_torch_moe.py`` holds the MoE layer itself.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models import Runtime, build_model  # noqa: E402
from repro.models import ssd as RS  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.core.carry import params_from_numpy  # noqa: E402
from repro_torch.models import Runtime as PRuntime  # noqa: E402
from repro_torch.models import build_model as p_build_model  # noqa: E402
from repro_torch.models import ssd as PS  # noqa: E402
from repro_torch.train import make_decode_step, make_prefill  # noqa: E402

S, B, STEPS = 32, 2, 3
NAMES = sorted(ARCHS)
MOE = sorted(n for n, c in ARCHS.items() if c.uses_moe)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, seed=7):
    """Prompt batch and the STEPS tokens decoded after it, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    batch = {"tokens": toks[:, :S]}
    if cfg.frontend == "patch_stub":
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return batch, toks


def _pad_kv(cache, n, pad):
    return {k: (pad(v, n) if k in ("k", "v") else v) for k, v in cache.items()}


def _jpad(v, n):
    return jnp.pad(v, [(0, 0), (0, 0), (0, n), (0, 0), (0, 0)])


def _tpad(v, n):
    return F.pad(v, (0, 0, 0, 0, 0, n))


@functools.lru_cache(maxsize=None)
def reference(name, impl, dtype="float32"):
    """The reference's parameters and serving outputs, as numpy: prefill
    logits and cache, then each decode step's logits and the last cache."""
    cfg = reduced(ARCHS[name]).replace(dtype=dtype)
    model = build_model(cfg, Runtime(attn_impl=impl, remat="none"))
    params = model.init(jax.random.key(1))
    batch, toks = _batch(cfg)
    logits, cache = jax.jit(model.prefill)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    out = {"params": _np(params), "prefill": (_np(logits), _np(cache)), "steps": []}
    cache = _pad_kv(cache, STEPS, _jpad)
    decode = jax.jit(model.decode_step)
    for i in range(STEPS):
        logits, cache = decode(params, cache, jnp.asarray(toks[:, S + i:S + i + 1]),
                               jnp.int32(S + i))
        out["steps"].append(_np(logits))
    out["cache"] = _np(cache)
    return out


def _port(name, impl, dtype="float32"):
    ref = reference(name, impl, dtype)
    cfg = PC.reduced(PC.get_config(name)).replace(dtype=dtype)
    model = p_build_model(cfg, PRuntime(attn_impl=impl, remat="none"))
    params = params_from_numpy(ref["params"], device="cpu")
    batch, toks = _batch(cfg)
    return ref, model, params, {k: torch.from_numpy(v) for k, v in batch.items()}, toks


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _rel_close(got, want, tol):
    want = np.asarray(want, np.float32)
    rel = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert rel < tol, rel


@pytest.mark.parametrize("impl", ["pallas", "auto"])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_reference(name, impl):
    ref, model, params, batch, _ = _port(name, impl)
    with torch.inference_mode():
        logits, cache = make_prefill(model)(params, batch)
    want_logits, want_cache = ref["prefill"]
    _close(logits, want_logits)
    assert set(cache) == set(want_cache)
    for k, v in cache.items():
        assert tuple(v.shape) == want_cache[k].shape, k
        _close(v, want_cache[k])


@pytest.mark.parametrize("impl", ["pallas", "auto"])
@pytest.mark.parametrize("name", NAMES)
def test_decode_steps_match_reference(name, impl):
    ref, model, params, batch, toks = _port(name, impl)
    step = make_decode_step(model)
    with torch.inference_mode():
        _, cache = model.prefill(params, batch)
        cache = _pad_kv(cache, STEPS, _tpad)
        for i in range(STEPS):
            logits, cache = step(params, cache,
                                 torch.from_numpy(toks[:, S + i:S + i + 1]), S + i)
            _close(logits, ref["steps"][i])
    for k, v in cache.items():
        _close(v, ref["cache"][k])


@pytest.mark.parametrize("name", NAMES)
def test_prefill_then_decode_equals_forward(name):
    """prefill(t[:S]) + decode(t[S]) == forward(t[:S+1])[S], on the port
    alone, through the kernels' route (``attn_impl="pallas"``).  MoE runs
    at no-drop capacity: capacity dropping depends on the sequence
    length, so teacher-forced forward differs from decode by design."""
    _, model, params, batch, toks = _port(name, "pallas")
    if model.cfg.uses_moe:
        model = p_build_model(model.cfg, PRuntime(
            attn_impl="pallas", remat="none",
            capacity_factor=float(model.cfg.num_experts)))
    full = dict(batch, tokens=torch.from_numpy(toks[:, :S + 1]))
    with torch.inference_mode():
        want = model.forward(params, full)[:, S]
        _, cache = model.prefill(params, batch)
        got, _ = model.decode_step(params, _pad_kv(cache, 1, _tpad),
                                   torch.from_numpy(toks[:, S:S + 1]), S)
    rel = float((got[:, 0] - want).abs().max()) / (float(want.abs().max()) + 1e-9)
    assert rel < 2e-3, (name, rel)


@pytest.mark.parametrize("name", NAMES)
def test_loss_matches_reference(name):
    ref, model, params, batch, _ = _port(name, "pallas")
    cfg = reduced(ARCHS[name]).replace(dtype="float32")
    rmodel = build_model(cfg, Runtime(attn_impl="pallas", remat="none"))
    rparams = jax.tree_util.tree_map(jnp.asarray, ref["params"])
    want, _ = jax.jit(rmodel.loss)(rparams, {k: jnp.asarray(v.numpy())
                                              for k, v in batch.items()})
    with torch.inference_mode():
        got, metrics = model.loss(params, batch)
    _close(got, want)
    if model.cfg.uses_moe:
        _, rmetrics = jax.jit(rmodel.loss)(rparams, {k: jnp.asarray(v.numpy())
                                                     for k, v in batch.items()})
        _close(metrics["moe_aux"], rmetrics["moe_aux"])
        _close(metrics["ce"], rmetrics["ce"])
        assert float(metrics["moe_aux"]) > 0
    else:
        assert float(metrics["ce"]) == float(got)


@pytest.mark.parametrize("name", ["mamba2-2.7b", "hymba-1.5b"])
def test_ssd_forward_through_the_kernel_matches_reference(name):
    cfg = reduced(ARCHS[name]).replace(dtype="float32")
    pcfg = PC.reduced(PC.get_config(name)).replace(dtype="float32")
    p = RS.ssd_init(jax.random.key(2), cfg, jnp.float32)
    x = np.random.default_rng(5).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    want = RS.ssd_forward(p, jnp.asarray(x), cfg, use_pallas=True)
    with torch.inference_mode():
        got = PS.ssd_forward(params_from_numpy(_np(p), device="cpu"),
                             torch.from_numpy(x), pcfg, use_pallas=True)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("length", [5, 37])
@pytest.mark.parametrize("name", ["mamba2-2.7b", "hymba-1.5b"])
def test_ssd_forward_through_the_kernel_pads_the_tail(name, length):
    """At a length that is no multiple of the reduced chunk of 16 (37),
    or under it (5), the kernel route (``ssd_scan_plain`` on the CPU)
    gives the chunked form's output, final state and conv tail."""
    cfg = PC.reduced(PC.get_config(name)).replace(dtype="float32")
    gen = torch.Generator().manual_seed(3)
    p = PS.ssd_init(gen, cfg, torch.float32)
    x = torch.randn((2, length, cfg.d_model), generator=gen)
    with torch.inference_mode():
        got = PS.ssd_forward(p, x, cfg, use_pallas=True)
        want = PS.ssd_forward(p, x, cfg, use_pallas=False)
    assert length % cfg.ssm_chunk
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b.numpy())


def test_bfloat16_hymba_matches_reference():
    """bfloat16 parameters carried exactly; prefill logits, every cache
    leaf and three decode steps within 2e-2 of the reference, relative to
    each tensor's largest magnitude (the two frameworks round bfloat16 at
    other places, so single elements may differ by a few units in the
    last place)."""
    ref, model, params, batch, toks = _port("hymba-1.5b", "pallas", "bfloat16")
    assert params["embed"].dtype == torch.bfloat16
    assert np.array_equal(params["embed"].float().numpy(),
                          ref["params"]["embed"].astype(np.float32))
    with torch.inference_mode():
        logits, cache = model.prefill(params, batch)
        _rel_close(logits, ref["prefill"][0], 2e-2)
        for k, v in cache.items():
            _rel_close(v, ref["prefill"][1][k], 2e-2)
        cache = _pad_kv(cache, STEPS, _tpad)
        for i in range(STEPS):
            logits, cache = model.decode_step(
                params, cache, torch.from_numpy(toks[:, S + i:S + i + 1]), S + i)
            _rel_close(logits, ref["steps"][i], 2e-2)


@pytest.mark.parametrize("name", MOE)
def test_moe_impl_without_a_mesh(name):
    """Without an active ``mesh_context``: ``moe_impl="auto"`` takes the
    dense dispatch (the same logits as ``"dense"``) and ``"ep"`` raises,
    as the reference does without an active mesh."""
    ref, _, params, batch, _ = _port(name, "pallas")
    cfg = PC.reduced(PC.get_config(name)).replace(dtype="float32")
    with torch.inference_mode():
        auto = p_build_model(cfg, PRuntime(attn_impl="pallas", remat="none",
                                           moe_impl="auto"))
        _close(auto.prefill(params, batch)[0], ref["prefill"][0])
        ep = p_build_model(cfg, PRuntime(attn_impl="pallas", remat="none",
                                         moe_impl="ep"))
        with pytest.raises(RuntimeError, match="mesh"):
            ep.prefill(params, batch)


def test_entry_points_default_to_the_card():
    """Without a CUDA device, the card-by-default entry points raise unless
    the caller asks for the CPU."""
    model = p_build_model(PC.reduced(PC.get_config("granite-8b")))
    tree = {"a": np.zeros(2, np.float32)}
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(tree)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(1, 8)
    params = model.init(0, device="cpu")
    assert params["blocks"]["attn"]["wq"].shape[0] == model.cfg.num_layers
    assert params_from_numpy(tree, device="cpu")["a"].device.type == "cpu"


def test_init_follows_its_generator():
    """A generator decides where every leaf goes; a ``device`` that names
    another place raises instead of splitting the tree."""
    model = p_build_model(PC.reduced(PC.get_config("whisper-base")))
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = model.init(gen)
    leaves = []
    stack = [params]
    while stack:
        d = stack.pop()
        for v in d.values():
            (stack.append(v) if isinstance(v, dict) else leaves.append(v))
    assert "enc_norm" in params and {t.device.type for t in leaves} == {"cpu"}
    with pytest.raises(ValueError, match="generator"):
        model.init(torch.Generator(device="cpu"), device="meta")

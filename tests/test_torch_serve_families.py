"""The dense, vision and encoder-decoder families' serving path against the
reference, on the CPU, at shapes that ``reduced()`` hides.

``reduced()`` gives gemma3 exactly one 6-layer local:global period and a
window as long as the prompt, and whisper fewer cross-cache slots than
source frames.  Here each family keeps its published head dim at a few
layers and narrow widths:

* gemma3-4b at 10 layers (one period plus a 4-layer remainder of local
  layers), hd 256, 2 query heads over 1 KV head, qk-norm, a window of 16
  under a 40-token prompt, decoding past the window;
* phi-3-vision-4.2b, hd 96, 2 over 2 heads, 8 patch embeddings spliced
  over the first positions of a 24-token prompt;
* whisper-base, hd 64, 48 source frames, ``max_source_positions`` 48 and a
  12-token prompt, so the encoder's and the decoder's lengths differ.

In float32 with the reference's parameters carried over by
``carry.params_from_numpy``: ``prefill`` logits and every cache leaf, then
6 ``decode_step``s and the last cache, match the reference's ``Model`` at
atol/rtol 1e-4 under ``attn_impl`` "pallas" (the reference's kernel route
as its tests run it on the CPU, the port's plain kernel versions) and
"auto".  Each family's planted fault (gemma3: the window ignored; phi-3-
vision: ``causal`` ignored; whisper: the encoder's attention made causal)
must miss the reference's logits by more than that tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import Runtime, build_model  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.core.carry import params_from_numpy  # noqa: E402
from repro_torch.models import Runtime as PRuntime  # noqa: E402
from repro_torch.models.attention import attention  # noqa: E402
from repro_torch.models.model import Model as PModel  # noqa: E402
from repro_torch.train import make_decode_step, make_prefill  # noqa: E402

B, STEPS, TOL = 2, 6, 1e-4
NARROW = dict(d_model=64, d_ff=128, vocab_size=256, attn_q_chunk=16, attn_kv_chunk=16)
# name -> (config overrides, prompt length, source frames)
FAMILIES = {
    "gemma3-4b": (dict(NARROW, d_model=128, num_layers=10, num_heads=2, num_kv_heads=1,
                       sliding_window=16), 40, 0),
    "phi-3-vision-4.2b": (dict(NARROW, num_layers=2, num_heads=2, num_kv_heads=2,
                               num_frontend_tokens=8), 24, 0),
    "whisper-base": (dict(NARROW, num_layers=2, num_encoder_layers=2, num_heads=2,
                          num_kv_heads=2, max_source_positions=48), 12, 48),
}
NAMES = sorted(FAMILIES)


def _cfg(get, name):
    kw = FAMILIES[name][0]
    return get(name).replace(name=name + "-narrow", dtype="float32", **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, name, seed=11):
    """Prompt batch and the STEPS tokens decoded after it, as numpy."""
    _, S, frames = FAMILIES[name]
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    batch = {"tokens": toks[:, :S]}
    if cfg.frontend == "patch_stub":
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = rng.normal(size=(B, frames, cfg.d_model)).astype(np.float32)
    return batch, toks


def _pad_kv(cache, pad):
    return {k: (pad(v) if k in ("k", "v") else v) for k, v in cache.items()}


@functools.lru_cache(maxsize=None)
def reference(name, impl):
    """The reference's parameters and serving outputs, as numpy: prefill
    logits and cache, each decode step's logits and the last cache."""
    cfg = _cfg(get_config, name)
    model = build_model(cfg, Runtime(attn_impl=impl, remat="none"))
    params = model.init(jax.random.key(3))
    batch, toks = _batch(cfg, name)
    S = batch["tokens"].shape[1]
    logits, cache = jax.jit(model.prefill)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    out = {"params": _np(params), "prefill": (_np(logits), _np(cache)), "steps": []}
    cache = _pad_kv(cache, lambda v: jnp.pad(v, [(0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)]))
    decode = jax.jit(model.decode_step)
    for i in range(STEPS):
        logits, cache = decode(params, cache, jnp.asarray(toks[:, S + i:S + i + 1]),
                               jnp.int32(S + i))
        out["steps"].append(_np(logits))
    out["cache"] = _np(cache)
    return out


def _port(name, impl, model_cls=PModel):
    ref = reference(name, impl)
    cfg = _cfg(PC.get_config, name)
    model = model_cls(cfg, PRuntime(attn_impl=impl, remat="none"))
    params = params_from_numpy(ref["params"], device="cpu")
    batch, toks = _batch(cfg, name)
    return ref, model, params, {k: torch.from_numpy(v) for k, v in batch.items()}, toks


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


def test_shapes_are_the_ones_reduced_hides():
    """gemma3's depth leaves a remainder after its periods and its prompt
    outruns the window; whisper's encoder and decoder lengths differ and
    its cross cache holds every source frame; each family keeps its head
    dim."""
    g = _cfg(PC.get_config, "gemma3-4b")
    period = g.local_global_ratio + 1
    assert g.num_layers % period == 4 and FAMILIES["gemma3-4b"][1] > g.sliding_window
    assert [g.layer_is_global(li % period) for li in range(g.num_layers)].count(True) == 1
    w = _cfg(PC.get_config, "whisper-base")
    _, S, frames = FAMILIES["whisper-base"]
    assert frames == w.max_source_positions != S
    for name in NAMES:
        assert (_cfg(PC.get_config, name).resolved_head_dim
                == PC.get_config(name).resolved_head_dim)


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
    if model.cfg.is_encoder_decoder:  # the cross cache spans every source frame
        assert cache["cross_k"].shape[2] == model.cfg.max_source_positions


@pytest.mark.parametrize("impl", ["pallas", "auto"])
@pytest.mark.parametrize("name", NAMES)
def test_decode_steps_match_reference(name, impl):
    ref, model, params, batch, toks = _port(name, impl)
    S = batch["tokens"].shape[1]
    step = make_decode_step(model)
    with torch.inference_mode():
        _, cache = model.prefill(params, batch)
        cache = _pad_kv(cache, lambda v: F.pad(v, (0, 0, 0, 0, 0, STEPS)))
        for i in range(STEPS):
            logits, cache = step(params, cache,
                                 torch.from_numpy(toks[:, S + i:S + i + 1]), S + i)
            _close(logits, ref["steps"][i])
    for k, v in cache.items():
        _close(v, ref["cache"][k])


class _WindowIgnored(PModel):
    def __init__(self, cfg, rt):
        super().__init__(cfg.replace(sliding_window=0), rt)


class _CausalIgnored(PModel):
    def _self_attention(self, q, k, v, *, is_global):
        return attention(q, k, v, causal=False, impl=self.rt.attn_impl,
                         q_chunk=self.cfg.attn_q_chunk, kv_chunk=self.cfg.attn_kv_chunk)


class _CausalEncoder(PModel):
    def _enc_attention(self, q, k, v):
        return attention(q, k, v, causal=True, impl=self.rt.attn_impl,
                         q_chunk=self.cfg.attn_q_chunk, kv_chunk=self.cfg.attn_kv_chunk)


FAULTS = {"gemma3-4b": _WindowIgnored, "phi-3-vision-4.2b": _CausalIgnored,
          "whisper-base": _CausalEncoder}


@pytest.mark.parametrize("impl", ["pallas", "auto"])
@pytest.mark.parametrize("name", NAMES)
def test_planted_fault_is_caught(name, impl):
    """The parity check is not blind to what the card check plants: each
    family's fault moves the prefill logits by more than the tolerance."""
    ref, model, params, batch, _ = _port(name, impl, FAULTS[name])
    with torch.inference_mode():
        logits, _ = model.prefill(params, batch)
    want = np.asarray(ref["prefill"][0], np.float32)
    rel = np.abs(logits.float().numpy() - want).max() / np.abs(want).max()
    assert rel > TOL, (name, rel)
    with pytest.raises(AssertionError):
        _close(logits, want)

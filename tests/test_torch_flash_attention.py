"""The port's flash attention against the reference's oracles, on the CPU.

On a CPU tensor ``repro_torch.kernels.ops.flash_attention`` runs the
kernel's plain version (materialised scores); it is held against the
reference's ``ref.flash_attention_ref`` on every case of
``tests/test_kernels_flash.py``, and against the reference's Pallas
kernel in interpret mode on two of them.  Tolerances are the reference
tests': 2e-5 in float32, 2e-2 in bfloat16.  The float32 CUDA kernel's
arithmetic, a three-pass TF32 split, is emulated here and held to 2e-5
of float64 attention; the bfloat16 kernel's (128-row query tiles, key
tiles of 128 or 64, online softmax in the log2 domain, P rounded to bf16
per tile) is emulated and held to 2e-2 of float64 attention and of the
reference's oracle.  The CUDA kernels themselves are held against the
plain version in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as R  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as PR  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402

CASES = [  # tests/test_kernels_flash.py: (B, S, H, KVH, hd, window, softcap, bq, bk)
    (2, 128, 4, 2, 64, 0, 0.0, 64, 64),
    (1, 256, 8, 2, 32, 0, 0.0, 128, 64),
    (1, 256, 8, 2, 32, 64, 0.0, 64, 64),
    (2, 128, 2, 2, 64, 0, 30.0, 64, 32),
    (1, 128, 4, 1, 128, 32, 0.0, 32, 64),
    (1, 64, 4, 4, 16, 0, 0.0, 64, 64),
    (2, 192, 6, 2, 64, 96, 20.0, 64, 64),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B, Sq, Skv, H, KVH, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, KVH, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, KVH, hd)).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_reference_oracle(case, dtype):
    B, S, H, KVH, hd, win, cap, _, _ = case
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, S, S, H, KVH, hd, seed=S + hd), dtype)
    want = R.flash_attention_ref(jq, jk, jv, causal=True, window=win, softcap=cap)
    before = FA.STATS["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=True, window=win, softcap=cap)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert FA.STATS["flash_attention"] == before  # the CPU launches nothing
    _close(got, want, DTYPES[dtype][2])
    _close(PR.flash_attention_ref(q, k, v, causal=True, window=win, softcap=cap),
           want, DTYPES[dtype][2])


def test_noncausal_and_ragged_lengths_match_reference_oracle():
    for causal, (B, S, H, KVH, hd, win) in ((False, (1, 128, 4, 4, 32, 0)),
                                            (True, (2, 100, 6, 3, 16, 30)),
                                            (False, (1, 77, 4, 2, 32, 20))):
        (jq, jk, jv), (q, k, v) = _both(_inputs(B, S, S, H, KVH, hd, seed=3), "float32")
        want = R.flash_attention_ref(jq, jk, jv, causal=causal, window=win)
        _close(ops.flash_attention(q, k, v, causal=causal, window=win), want, 2e-5)


def test_explicit_scale_and_cross_lengths():
    (jq, jk, jv), (q, k, v) = _both(_inputs(2, 48, 80, 4, 2, 32, seed=9), "float32")
    for kw in (dict(causal=False, scale=0.3), dict(causal=True, window=16, scale=0.1)):
        want = R.flash_attention_ref(jq, jk, jv, **kw)
        _close(ops.flash_attention(q, k, v, **kw), want, 2e-5)


@pytest.mark.parametrize("case", [CASES[0], CASES[6]], ids=str)
def test_plain_matches_pallas_interpret(case):
    B, S, H, KVH, hd, win, cap, bq, bk = case
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, S, S, H, KVH, hd, seed=11), "float32")
    want = pallas_flash(jq, jk, jv, causal=True, window=win, softcap=cap,
                        block_q=bq, block_k=bk, interpret=True)
    _close(ops.flash_attention(q, k, v, causal=True, window=win, softcap=cap),
           want, 2e-5)


def test_attention_dispatch_matches_reference():
    """``impl="pallas"`` takes the kernel for Sq == Skv and no
    kv_valid_len, and the reference's auto route otherwise; ``dense`` and
    ``blocked`` match the reference's."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(2, 64, 64, 4, 2, 16, seed=5), "float32")
    for impl in ("pallas", "dense", "blocked", "auto"):
        kw = dict(causal=True, window=24, softcap=10.0, impl=impl,
                  q_chunk=16, kv_chunk=32)
        _close(PA.attention(q, k, v, **kw), RA.attention(jq, jk, jv, **kw), 2e-5)
    # decode-shaped: one query against a longer cache goes the auto route
    kw = dict(causal=False, window=24, q_offset=40, kv_valid_len=41, impl="pallas")
    _close(PA.attention(q[:, 40:41], k, v, **kw),
           RA.attention(jq[:, 40:41], jk, jv, **kw), 2e-5)


def test_wrapper_refuses_bad_arguments():
    q = torch.zeros(1, 8, 3, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k)  # 3 heads over 2 kv heads
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[..., :8], k[..., :8])
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError):
        ops.flash_attention(q, q.to(torch.bfloat16), q)


# ---------------------------------------------------------------------------
# The float32 kernel's arithmetic (three-pass TF32 split), emulated on the CPU
# ---------------------------------------------------------------------------

SPLIT_CASES = [  # (B, S, H, KVH, hd, window, softcap, causal, amplitude of q and k)
    (1, 300, 4, 2, 16, 0, 25.0, False, 1.0),
    (2, 192, 6, 2, 64, 96, 20.0, True, 1.0),
    (1, 256, 8, 2, 32, 64, 0.0, True, 1.0),
    (1, 333, 6, 2, 96, 100, 0.0, True, 1.0),
    (1, 300, 4, 2, 256, 0, 0.0, False, 1.0),
    # steep scores (std about 9), the size trained weights give
    (1, 256, 4, 2, 64, 0, 0.0, True, 3.0),
    (1, 300, 4, 2, 128, 0, 0.0, False, 3.0),
    (1, 200, 2, 1, 256, 0, 0.0, True, 3.0),
]


def _tf32(x):
    """``cvt.rna.tf32.f32``: to nearest (ties away from zero), low 13 bits 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a, b, passes):
    """a @ b as the kernel's wgmma chains compute it: operands split into
    hi = tf32(x) and lo = tf32(x - hi); lo.hi, hi.lo, then hi.hi (or
    hi.hi alone for ``passes=1``), 8 columns a step, each step's products
    summed exactly and added to one float32 accumulator."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    chains = [(al, bh), (ah, bl), (ah, bh)] if passes == 3 else [(ah, bh)]
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for x, y in chains:
        for k0 in range(0, a.shape[-1], 8):
            step = x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
            acc = (acc.double() + step).float()
    return acc


def _attention(q, k, v, *, causal, window, softcap, passes=None):
    """Materialised attention: in float64 (``passes=None``), or with both
    products emulated as the float32 kernel issues them."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    dt = torch.float64 if passes is None else torch.float32
    qg = (q.to(dt) * (1.0 / math.sqrt(hd))).reshape(B, S, KVH, G, hd).permute(0, 2, 3, 1, 4)
    kt = k.to(dt).permute(0, 2, 3, 1)[:, :, None].expand(B, KVH, G, hd, S)
    vg = v.to(dt).permute(0, 2, 1, 3)[:, :, None].expand(B, KVH, G, S, hd)
    s = qg @ kt if passes is None else _tf32_product(qg, kt, passes)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    i = torch.arange(S)
    mask = torch.ones((S, S), dtype=torch.bool)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window > 0:
        mask &= i[None, :] > i[:, None] - window
    s = s.masked_fill(~mask, -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))  # masked p are exactly 0
    pv = p @ vg if passes is None else _tf32_product(p, vg, passes)
    o = pv / p.sum(-1, keepdim=True)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_tf32_split_holds_float32_tolerance(case):
    """Three TF32 passes stay within the reference's 2e-5 of float64
    attention, steep scores included; one pass misses it on steep scores,
    which is why the float32 kernel issues three."""
    B, S, H, KVH, hd, window, softcap, causal, amp = case
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, S, S, H, KVH, hd, seed=S + hd))
    q, k = q * amp, k * amp
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = _attention(q, k, v, **kw).numpy()
    got = _attention(q, k, v, passes=3, **kw).double().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    # the plain version on float64 tensors is the same exact answer
    np.testing.assert_allclose(
        FA.flash_attention_plain(q.double(), k.double(), v.double(), **kw).numpy(),
        want, atol=1e-12, rtol=1e-12)
    if amp > 1:
        one = _attention(q, k, v, passes=1, **kw).double().numpy()
        assert not np.allclose(one, want, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# The bfloat16 kernel's arithmetic (flash_kernel_ws), emulated on the CPU
# ---------------------------------------------------------------------------

WS_CASES = [  # (B, S, H, KVH, hd, window, softcap, causal)
    (1, 300, 4, 4, 16, 0, 0.0, True),
    (1, 1000, 8, 2, 32, 0, 25.0, False),
    (2, 300, 10, 2, 64, 150, 0.0, True),  # window 150: edges inside key tiles
    (1, 1000, 5, 1, 64, 0, 0.0, False),
    (1, 100, 5, 1, 96, 0, 0.0, True),  # S below one query tile
    (1, 1000, 4, 1, 128, 200, 0.0, True),
    (1, 300, 4, 4, 128, 0, 30.0, False),
    (1, 64, 8, 2, 128, 0, 0.0, True),
    (1, 1000, 16, 4, 128, 0, 0.0, True),
    (1, 300, 4, 4, 256, 0, 0.0, True),
    (2, 300, 8, 2, 256, 100, 20.0, True),
    (1, 300, 4, 4, 96, 0, 0.0, True),  # hd 96, G 1 (phi-3-vision's prefill)
    (2, 300, 8, 8, 64, 0, 0.0, False),  # hd 64 non-causal, S no multiple of 128 (whisper)
]
WS_BQ = 128  # query rows of a block: two consumers of 64


def _ws_key_tile(hd):
    return 64 if hd == 256 else 128


def _ws_attention(q, k, v, *, causal, window, softcap, rescale=True):
    """Attention as flash_kernel_ws computes it, from bf16 inputs: per
    query tile of 128 rows, the key tiles of should_run in order; scores
    x in float32 (the raw product, or softcap*tanh(product*scale/softcap)),
    masked to -inf; the running max from -1e30; p = 2^(x*sl2 - m*sl2) with
    sl2 = log2(e)*scale (log2(e) under softcap); l = l*alpha + sum of the
    float32 p; O = O*alpha + bf16(p).V; o = O / max(l, 1e-30) in bf16.
    ``rescale=False`` leaves out O's rescale (a planted fault)."""
    B, S, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    BK = _ws_key_tile(hd)
    scale = 1.0 / math.sqrt(hd)
    sl2 = (1.0 if softcap > 0 else scale) * math.log2(math.e)
    qh = q.float().permute(0, 2, 1, 3)  # (B, H, S, hd)
    kh = k.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vh = v.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    out = torch.empty(B, H, S, hd, dtype=torch.bfloat16)
    for q0 in range(0, S, WS_BQ):
        rows = torch.arange(q0, q0 + WS_BQ)
        q_last = min(q0 + WS_BQ, S) - 1
        kt_end = -(-Skv // BK)
        if causal:
            kt_end = min(kt_end, q_last // BK + 1)
        kt_begin = (q0 - window + 1) // BK if window > 0 and q0 - window + 1 > 0 else 0
        qt = torch.zeros(B, H, WS_BQ, hd)
        qt[:, :, :min(WS_BQ, S - q0)] = qh[:, :, q0:q0 + WS_BQ]
        m = torch.full((B, H, WS_BQ, 1), -1e30)
        l = torch.zeros(B, H, WS_BQ, 1)
        o = torch.zeros(B, H, WS_BQ, hd)
        for kt in range(kt_begin, kt_end):
            cols = torch.arange(kt * BK, kt * BK + BK)
            kk = torch.zeros(B, H, BK, hd)
            vv = torch.zeros(B, H, BK, hd)
            n = min(BK, Skv - kt * BK)
            kk[:, :, :n] = kh[:, :, kt * BK:kt * BK + n]
            vv[:, :, :n] = vh[:, :, kt * BK:kt * BK + n]
            x = qt @ kk.transpose(-1, -2)
            if softcap > 0:
                x = softcap * torch.tanh(x * (scale / softcap))
            keep = cols[None, :] < Skv
            if causal:
                keep = keep & (cols[None, :] <= rows[:, None])
            if window > 0:
                keep = keep & (cols[None, :] > rows[:, None] - window)
            x = x.masked_fill(~keep, -math.inf)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2((m - m_new) * sl2)
            p = torch.exp2(x * sl2 - m_new * sl2)  # exactly 0 where masked
            l = l * alpha + p.sum(-1, keepdim=True)
            o = (o * alpha if rescale else o) + p.to(torch.bfloat16).float() @ vv
            m = m_new
        out[:, :, q0:q0 + WS_BQ] = (o / l.clamp_min(1e-30))[:, :, :min(WS_BQ, S - q0)].to(
            torch.bfloat16)
    return out.permute(0, 2, 1, 3)


@pytest.mark.parametrize("case", WS_CASES, ids=str)
def test_bf16_kernel_arithmetic_holds_its_tolerance(case):
    """The bf16 kernel's tiles and rescale order, emulated, stay within
    the reference's 2e-2 of float64 attention and of its own oracle."""
    B, S, H, KVH, hd, window, softcap, causal = case
    arrays = [a.astype(np.float32) for a in _inputs(B, S, S, H, KVH, hd, seed=S + hd + H)]
    (jq, jk, jv), (q, k, v) = _both(arrays, "bfloat16")
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _ws_attention(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    exact = FA.flash_attention_plain(q.double(), k.double(), v.double(), **kw)
    np.testing.assert_allclose(got.double().numpy(), exact.numpy(), atol=2e-2, rtol=2e-2)
    _close(got, R.flash_attention_ref(jq, jk, jv, **kw), 2e-2)


def test_bf16_emulation_without_rescale_fails():
    """The comparison sees the rescale: O not rescaled when a later key
    tile raises a row's max misses 2e-2 on a long causal case."""
    B, S, H, KVH, hd, window, softcap, causal = WS_CASES[8]
    (_, _, _), (q, k, v) = _both(_inputs(B, S, S, H, KVH, hd, seed=5), "bfloat16")
    q = (q.float() * 3).to(torch.bfloat16)  # steep scores: the max moves
    kw = dict(causal=causal, window=window, softcap=softcap)
    exact = FA.flash_attention_plain(q.double(), k.double(), v.double(), **kw).numpy()
    bad = _ws_attention(q, k, v, rescale=False, **kw).double().numpy()
    assert not np.allclose(bad, exact, atol=2e-2, rtol=2e-2)


def test_public_wrapper_refuses_float64_the_plain_version_takes():
    q = torch.zeros(1, 8, 2, 16, dtype=torch.float64)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q, q)
    assert FA.flash_attention_plain(q, q, q).dtype == torch.float64


def test_variant_builds_are_keyed_apart():
    """A planted fault's build (a ``-D`` flag, one source) never shares a
    library path with the real build: its hash is its own."""
    from repro_torch.kernels import _build

    real = _build.library_path()
    fault = _build.library_path(["-DREPRO_FLASH_F32_ONE_PASS"], ["flash_attention"])
    assert fault != real and fault.parent == real.parent == _build.BUILD_DIR
    assert [p.name for p in _build.sources(["flash_attention"])] == ["flash_attention.cu"]
    assert _build.library_path([], ["flash_attention"]) != real
    assert _build.library_path(["-DX"]) != real


def test_neg_inf_matches_reference():
    """``kernels.ref`` exports the masks' fill value, the reference's
    ``NEG_INF`` (-1e30), which the plain version and the model's masks use."""
    assert PR.NEG_INF == R.NEG_INF == FA.NEG_INF == PA.NEG_INF == -1e30
    assert "NEG_INF" in PR.__all__

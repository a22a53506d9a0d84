"""The port's flash attention against the reference's oracles, on the CPU.

On a CPU tensor ``repro_torch.kernels.ops.flash_attention`` runs the
kernel's plain version (materialised scores); it is held against the
reference's ``ref.flash_attention_ref`` on every case of
``tests/test_kernels_flash.py``, and against the reference's Pallas
kernel in interpret mode on two of them.  Tolerances are the reference
tests': 2e-5 in float32, 2e-2 in bfloat16.  The CUDA kernel itself is
held against the plain version in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""
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

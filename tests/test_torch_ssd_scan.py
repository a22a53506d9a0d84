"""The port's SSD scan and chunked SSD against the reference, on the CPU.

On a CPU tensor ``repro_torch.kernels.ops.ssd_scan`` runs the kernels'
plain version, in their decomposition (C·Bᵀ once per chunk, chunk-local
states for all chunks, the serial state pass, the outputs); it is held
against the reference's definitional recurrence ``ref.ssd_ref`` on every
case of ``tests/test_kernels_ssd.py`` and the kernels' edge shapes, and
against the reference's Pallas kernel in interpret mode on every case, at
the reference tests' tolerance of 2e-4.  The CUDA kernel is held against the plain version in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduced  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd  # noqa: E402
from repro.models import ssd as RS  # noqa: E402
from repro_torch.configs import get_config as p_get_config  # noqa: E402
from repro_torch.configs import reduced as p_reduced  # noqa: E402
from repro_torch.core.carry import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as PR  # noqa: E402
from repro_torch.kernels import ssd_scan as SS  # noqa: E402
from repro_torch.models import ssd as PS  # noqa: E402

CASES = [  # tests/test_kernels_ssd.py: (B, S, nh, hp, N, chunk)
    (2, 128, 4, 32, 64, 32),
    (1, 256, 2, 64, 128, 64),
    (2, 64, 8, 16, 32, 16),
    (1, 128, 4, 32, 64, 128),
]
TOL = 2e-4


def make(B, S, nh, hp, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, nh, hp)).astype(np.float32),
            rng.uniform(0.001, 0.1, (B, S, nh)).astype(np.float32),
            -rng.uniform(0.5, 4, (nh,)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_plain_matches_reference_oracle(case):
    arrays = make(*case[:5])
    yr, hr = R.ssd_ref(*map(jnp.asarray, arrays))
    before = SS.STATS["ssd_scan"]
    y, h = ops.ssd_scan(*_t(arrays), chunk=case[-1])
    assert SS.STATS["ssd_scan"] == before  # the CPU launches nothing
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _close(y, yr)
    _close(h, hr)


@pytest.mark.parametrize("case", [CASES[0], CASES[2]], ids=str)
def test_plain_matches_pallas_interpret(case):
    arrays = make(*case[:5], seed=1)
    yp, hp = pallas_ssd(*map(jnp.asarray, arrays), chunk=case[-1], interpret=True)
    y, h = ops.ssd_scan(*_t(arrays), chunk=case[-1])
    _close(y, yp)
    _close(h, hp)


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_decomposition_matches_pallas_interpret_every_case(case):
    """The plain version's four steps (C·Bᵀ once per chunk, chunk-local
    states in parallel, the serial state pass, the outputs) against the
    reference's Pallas kernel in interpret mode, which walks the chunks
    in series."""
    arrays = make(*case[:5], seed=5)
    yp, hp = pallas_ssd(*map(jnp.asarray, arrays), chunk=case[-1], interpret=True)
    y, h = SS.ssd_scan_plain(*_t(arrays), chunk=case[-1])
    _close(y, yp)
    _close(h, hp)


EDGES = [  # one chunk; chunk 1024; hp 128 with N 128; N 16; Q and N off 16
    (1, 256, 2, 32, 64, 256), (1, 1024, 2, 16, 16, 1024),
    (1, 128, 2, 128, 128, 64), (2, 128, 3, 64, 16, 32), (1, 100, 2, 16, 20, 100),
]


@pytest.mark.parametrize("case", EDGES, ids=[str(c) for c in EDGES])
def test_decomposition_edge_shapes_match_reference_oracle(case):
    arrays = make(*case[:5], seed=6)
    yr, hr = R.ssd_ref(*map(jnp.asarray, arrays))
    y, h = ops.ssd_scan(*_t(arrays), chunk=case[-1])
    _close(y, yr)
    _close(h, hr)


def test_decomposition_steep_decay_matches_reference_oracle():
    """Decays as steep as a trained mamba2's (A down to -16, dt up to
    0.5), where a chunk spans exp(-100) and more."""
    x, dt, A, Bm, Cm = make(2, 128, 3, 16, 32, seed=8)
    dt, A = dt * 5.0, A * 4.0
    yr, hr = R.ssd_ref(*map(jnp.asarray, (x, dt, A, Bm, Cm)))
    y, h = ops.ssd_scan(*_t((x, dt, A, Bm, Cm)), chunk=64)
    assert bool(torch.isfinite(y).all())
    _close(y, yr)
    _close(h, hr)


def test_dropped_state_hand_off_fails_the_tolerance():
    """The planted fault of chip_smoke.py: every chunk scanned from a zero
    state (the hand-off dropped) must fail the 2e-4 check."""
    B, S, nh, hp, N, Q = CASES[0]
    arrays = _t(make(B, S, nh, hp, N, seed=7))
    y, _ = SS.ssd_scan_plain(*arrays, chunk=Q)
    x, dt, A, Bm, Cm = arrays
    bad = torch.cat([SS.ssd_scan_plain(x[:, c:c + Q], dt[:, c:c + Q], A, Bm[:, c:c + Q],
                                       Cm[:, c:c + Q], chunk=Q)[0]
                     for c in range(0, S, Q)], dim=1)
    assert torch.equal(bad[:, :Q], y[:, :Q])  # the first chunk starts from zero anyway
    assert not torch.allclose(bad, y, atol=TOL, rtol=TOL)


def test_bfloat16_inputs_match_reference_oracle():
    x, dt, A, Bm, Cm = make(2, 64, 4, 16, 32, seed=4)
    yr, hr = R.ssd_ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(A),
                       jnp.asarray(Bm, jnp.bfloat16), jnp.asarray(Cm, jnp.bfloat16))
    bf = torch.bfloat16
    y, h = ops.ssd_scan(torch.from_numpy(x).to(bf), torch.from_numpy(dt),
                        torch.from_numpy(A), torch.from_numpy(Bm).to(bf),
                        torch.from_numpy(Cm).to(bf), chunk=16)
    _close(y, yr)
    _close(h, hr)


def test_oracle_with_initial_state_and_chunked_form():
    """The port's ``ssd_ref`` (with h0) and ``ssd_chunked`` (ragged tail,
    h0) against the reference's oracle."""
    x, dt, A, Bm, Cm = make(2, 100, 2, 16, 32, seed=2)
    h0 = np.random.default_rng(3).normal(size=(2, 2, 16, 32)).astype(np.float32)
    jx = list(map(jnp.asarray, (x, dt, A, Bm, Cm)))
    yr, hr = R.ssd_ref(*jx, h0=jnp.asarray(h0))
    y, h = PR.ssd_ref(*_t((x, dt, A, Bm, Cm)), h0=torch.from_numpy(h0))
    _close(y, yr)
    _close(h, hr)
    y, h = PS.ssd_chunked(*_t((x, dt, A, Bm, Cm)), chunk=32, h0=torch.from_numpy(h0))
    _close(y, yr)
    _close(h, hr)
    yr0, hr0 = R.ssd_ref(*jx)
    y, h = PS.ssd_chunked(*_t((x, dt, A, Bm, Cm)), chunk=32)
    _close(y, yr0)
    _close(h, hr0)


def _mamba_layer(seed=0):
    cfg = reduced(get_config("mamba2-2.7b")).replace(dtype="float32")
    pcfg = p_reduced(p_get_config("mamba2-2.7b")).replace(dtype="float32")
    p = RS.ssd_init(jax.random.key(seed), cfg, jnp.float32)
    pp = params_from_numpy(jax.tree_util.tree_map(np.asarray, p), device="cpu")
    return cfg, pcfg, p, pp


def test_forward_with_h0_through_the_kernel_raises():
    _, pcfg, _, pp = _mamba_layer()
    x = torch.zeros(1, 16, pcfg.d_model)
    h0 = torch.zeros(1, pcfg.ssm_heads, pcfg.ssm_head_dim, pcfg.ssm_state)
    with pytest.raises(ValueError):
        PS.ssd_forward(pp, x, pcfg, h0=h0, use_pallas=True)
    PS.ssd_forward(pp, x, pcfg, h0=h0)  # the chunked form takes it


def test_forward_h0_and_decode_step_match_reference():
    cfg, pcfg, p, pp = _mamba_layer(seed=1)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 17, cfg.d_model)).astype(np.float32)
    h0 = rng.normal(size=(2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)).astype(np.float32)
    ro = RS.ssd_forward(p, jnp.asarray(x), cfg, h0=jnp.asarray(h0))
    po = PS.ssd_forward(pp, torch.from_numpy(x), pcfg, h0=torch.from_numpy(h0))
    for a, b in zip(po, ro):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)
    _, state, tail = RS.ssd_forward(p, jnp.asarray(x[:, :16]), cfg)
    rd, rs = RS.ssd_decode_step(p, {"conv": tail, "h": state}, jnp.asarray(x[:, 16:]), cfg)
    _, pstate, ptail = PS.ssd_forward(pp, torch.from_numpy(x[:, :16]), pcfg)
    pd, ps = PS.ssd_decode_step(pp, {"conv": ptail, "h": pstate},
                                torch.from_numpy(x[:, 16:]), pcfg)
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), atol=1e-4, rtol=1e-4)
    for k in ("conv", "h"):
        np.testing.assert_allclose(ps[k].numpy(), np.asarray(rs[k]), atol=1e-4, rtol=1e-4)

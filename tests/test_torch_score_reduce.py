"""Port parity of the score-reduce kernels (repro_torch.kernels.score_reduce).

The port's plain PyTorch versions (what its wrappers run on CPU tensors)
against the reference ``repro.kernels.score_reduce`` in ``mode="ref"``
(pure jnp) and ``mode="interpret"`` (the Pallas body on the CPU), on the
same seeded windows carried across.  Tolerance: scores within 1e-6 (both
are float32 in the same order of operations, so they are expected equal)
and the identical winning row.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import carry_specs, carry_view, tensors  # noqa: E402
from test_score_reduce import rand_window  # noqa: E402

from repro.core.engine import enumerate_scored as ref_enumerate  # noqa: E402
from repro.kernels import score_reduce as R  # noqa: E402
from repro_torch.core.engine import enumerate_scored as port_enumerate  # noqa: E402
from repro_torch.core.perfmodel import _mk_spec  # noqa: E402
from repro_torch.core.types import NodeView  # noqa: E402
from repro_torch.kernels import score_reduce as P  # noqa: E402

LAM = 0.35
TOL = 1e-6


def window_pair(seed, lam=LAM, lam_f=0.0):
    """The reference and port batches of one seeded window."""
    specs, view = rand_window(seed)
    ref = ref_enumerate(specs, view, list(view.free_map), lam=lam, lam_f=lam_f)
    pview = carry_view(view)
    port = port_enumerate(carry_specs(specs), pview, list(pview.free_map),
                          lam=lam, lam_f=lam_f)
    return ref, port, view


def both(ref_batch, port_batch, view, mode="ref", **kw):
    """Run the reference kernel and the port's CPU wrapper on one window;
    ``kw`` holds numpy bias/mask/f and scalar overrides."""
    dev, g, n = ref_batch.padded_cols()
    pdev, pg, pn = port_batch.padded_cols()
    assert np.array_equal(dev, pdev) and np.array_equal(g, pg)
    assert np.array_equal(n, pn)
    args = dict(lam=LAM, g_free=view.free_units, M=view.total_units)
    args.update({k: v for k, v in kw.items() if k in ("lam", "g_free", "M", "lam_f")})
    f, bias, mask = kw.get("f"), kw.get("bias"), kw.get("mask")
    s_ref, b_ref = R.score_reduce(dev, g, n, f=f, bias=bias, mask=mask,
                                  mode=mode, **args)
    tdev, tg, tn, tf, tbias, tmask = tensors(pdev, pg, pn, f, bias, mask)
    s_port, b_port = P.score_reduce(tdev, tg, tn, f=tf, bias=tbias,
                                    mask=tmask, **args)
    return (np.asarray(s_ref), b_ref), (s_port.numpy(), b_port)


def assert_same(ref, port, tag):
    (s_ref, b_ref), (s_port, b_port) = ref, port
    assert s_ref.shape == s_port.shape, tag
    fin = np.isfinite(s_ref)
    assert np.array_equal(fin, np.isfinite(s_port)), tag
    if fin.any():
        assert np.max(np.abs(s_ref[fin] - s_port[fin])) <= TOL, tag
    assert b_ref == b_port, tag


@pytest.mark.parametrize("chunk", range(6))
def test_plain_matches_reference_ref_mode(chunk):
    """60 seeded windows, 10 per case: scores within 1e-6, same winner."""
    for seed in range(10 * chunk, 10 * chunk + 10):
        ref, port, view = window_pair(seed)
        r, p = both(ref, port, view)
        assert_same(r, p, seed)
        # and the winner agrees with the float64 engine's tie-break
        assert port.total_g[p[1]] == port.total_g[port.best_index()], seed


@pytest.mark.parametrize("seed", range(5))
def test_plain_matches_reference_interpret_mode(seed):
    ref, port, view = window_pair(seed)
    assert_same(*both(ref, port, view, mode="interpret"), seed)


def test_empty_window():
    view = NodeView(t=0.0, total_units=8, domains=2, free_units=8,
                    running=[], free_map=[True] * 8, domain_jobs=[0, 0])
    batch = port_enumerate([], view, list(view.free_map), lam=LAM)
    dev, g, n = tensors(*batch.padded_cols())
    scores, best = P.score_reduce(dev, g, n, lam=LAM, g_free=8, M=8)
    assert best == 0  # only the empty action exists
    assert abs(float(scores[0]) - batch.scores[0]) <= TOL
    # and a block with no rows at all
    z = torch.zeros((0, 1))
    s0, b0 = P.score_reduce(z, z, torch.zeros(0), lam=LAM, g_free=8, M=8)
    assert b0 == -1 and s0.numel() == 0


def test_all_infeasible_returns_sentinel():
    ref, port, view = window_pair(3)
    mask = np.zeros(len(port), dtype=np.float32)
    r, p = both(ref, port, view, mask=mask)
    assert_same(r, p, "all-infeasible")
    assert p[1] == -1 and np.all(np.isinf(p[0]))


def test_mask_restricts_argmin():
    ref, port, view = window_pair(5)
    _, (_, best) = both(ref, port, view)
    mask = np.ones(len(port), dtype=np.float32)
    mask[best] = 0.0
    r, p = both(ref, port, view, mask=mask)
    assert_same(r, p, "mask")
    assert p[1] != best and np.isinf(p[0][best])


def test_bias_and_frequency_plane():
    """bias column + an f plane weighted by λ_f ≠ 0, against the
    reference on the same inputs."""
    for seed in (7, 8, 9):
        ref, port, view = window_pair(seed, lam_f=0.25)
        rng = np.random.default_rng(seed)
        bias = rng.uniform(0.0, 0.5, len(port)).astype(np.float32)
        f = rng.integers(0, 3, port.padded_cols()[0].shape).astype(np.float32)
        assert_same(*both(ref, port, view, bias=bias, f=f, lam_f=0.25), seed)


def test_frequency_plane_from_dvfs_specs():
    """The engine's own f plane on a joint (count, frequency) window."""
    rng = np.random.default_rng(3)
    specs = []
    for i in range(4):
        t_hat, p_hat = {}, {}
        for g in (1, 2, 4):
            for f in range(3):
                t_hat[(g, f)] = 100.0 / g ** rng.uniform(0.4, 0.9) * (1 + 0.2 * f)
                p_hat[(g, f)] = 300.0 * g ** rng.uniform(0.6, 0.9) * (1 - 0.2 * f)
        specs.append(_mk_spec(f"j{i}", t_hat, p_hat))
    view = NodeView(t=0.0, total_units=4, domains=2, free_units=4,
                    running=[], free_map=[True] * 4, domain_jobs=[0, 0])
    batch = port_enumerate(specs, view, list(view.free_map), lam=LAM, lam_f=0.1)
    dev, g, n = batch.padded_cols()
    fcol = batch.padded_f()
    assert fcol.max() > 0
    s_ref, b_ref = R.score_reduce(dev, g, n, f=fcol, lam=LAM, g_free=4, M=4,
                                  lam_f=0.1, mode="ref")
    s_port, b_port = P.score_reduce(*tensors(dev, g, n), f=tensors(fcol)[0],
                                    lam=LAM, g_free=4, M=4, lam_f=0.1)
    assert np.max(np.abs(np.asarray(s_ref) - s_port.numpy())) <= TOL
    assert b_ref == b_port
    assert b_port == batch.best_index()


def test_large_synthetic_block():
    """A ≥5,000-row block, as the pod-scale exact path sends."""
    rng = np.random.default_rng(11)
    B, S = 6181, 4
    n = rng.integers(0, S + 1, B).astype(np.float32)
    n[0] = 0
    slot = np.arange(S)[None, :] < n[:, None]
    dev = np.where(slot, rng.uniform(0, 2, (B, S)), 0).astype(np.float32)
    g = np.where(slot, rng.integers(1, 5, (B, S)), 0).astype(np.float32)
    mask = (rng.uniform(size=B) > 0.1).astype(np.float32)
    s_ref, b_ref = R.score_reduce(dev, g, n, lam=LAM, g_free=16, M=16,
                                  mask=mask, mode="ref")
    s_port, b_port = P.score_reduce(*tensors(dev, g, n), mask=tensors(mask)[0],
                                    lam=LAM, g_free=16, M=16)
    fin = np.isfinite(np.asarray(s_ref))
    assert np.array_equal(fin, np.isfinite(s_port.numpy()))
    assert np.max(np.abs(np.asarray(s_ref)[fin] - s_port.numpy()[fin])) <= TOL
    assert b_ref == b_port


def multi_reqs(seeds):
    """Per-window request dicts (numpy, the reference's shape) with
    heterogeneous λ, f planes, biases and λ_f."""
    rng = np.random.default_rng(0)
    reqs = []
    for k, seed in enumerate(seeds):
        _, port, view = window_pair(seed)
        dev, g, n = port.padded_cols()
        r = dict(dev=dev, g=g, n=n, lam=float(0.1 + 0.1 * k),
                 g_free=view.free_units, M=view.total_units)
        if k % 2 == 0:
            r["f"] = np.ones_like(dev)
            r["lam_f"] = 0.25
        if k % 3 == 0:
            r["bias"] = rng.uniform(0.0, 0.5, len(dev)).astype(np.float32)
        reqs.append(r)
    return reqs


def solo(r):
    dev, g, n, f, bias, mask = tensors(r["dev"], r["g"], r["n"], r.get("f"),
                                       r.get("bias"), r.get("mask"))
    return P.score_reduce(dev, g, n, f=f, bias=bias, mask=mask, lam=r["lam"],
                          g_free=r["g_free"], M=r["M"],
                          lam_f=r.get("lam_f", 0.0))


def run_multi(reqs):
    packed = P.pack_windows(reqs, "cpu")
    scores, bests = P.score_reduce_multi(**packed)
    off = packed["offsets"].tolist()
    return [(scores[a:b], best) for a, b, best in zip(off, off[1:], bests)]


def test_multi_matches_reference_and_solo():
    reqs = multi_reqs(range(9))
    ref_out = R.score_reduce_multi(reqs, mode="ref")
    out = run_multi(reqs)
    assert len(out) == len(reqs) == len(ref_out)
    for k, ((s, b), (s_ref, b_ref), r) in enumerate(zip(out, ref_out, reqs)):
        assert b == b_ref, k
        fin = np.isfinite(s_ref)
        assert np.max(np.abs(s.numpy()[fin] - s_ref[fin])) <= TOL, k
        s_solo, b_solo = solo(r)
        assert b == b_solo, k
        assert torch.equal(s, s_solo), k  # bitwise, per window


def test_multi_mixed_edges():
    """Zero-row, all-masked and healthy windows in one call."""
    reqs = multi_reqs(range(3))
    reqs.insert(1, dict(reqs[1], mask=np.zeros(len(reqs[1]["dev"]), bool)))
    s = reqs[0]["dev"].shape[1]
    reqs.append(dict(dev=np.zeros((0, s), np.float32),
                     g=np.zeros((0, s), np.float32),
                     n=np.zeros((0,), np.float32), lam=LAM, g_free=8, M=8))
    ref_out = R.score_reduce_multi(reqs, mode="ref")
    out = run_multi(reqs)
    assert out[1][1] == -1 and bool(torch.isinf(out[1][0]).all())
    assert out[-1][1] == -1 and out[-1][0].numel() == 0
    for k, ((sc, b), (_, b_ref), r) in enumerate(zip(out, ref_out, reqs)):
        assert b == b_ref, k
        s_solo, b_solo = solo(r)
        assert b == b_solo and torch.equal(sc, s_solo), k


def test_multi_no_windows():
    packed = P.pack_windows([], "cpu")
    scores, bests = P.score_reduce_multi(**packed)
    assert bests == [] and scores.numel() == 0


def test_wrapper_rejects_bad_inputs():
    dev = torch.zeros((4, 2))
    with pytest.raises(TypeError):
        P.score_reduce(dev.double(), dev, torch.zeros(4), lam=LAM, g_free=4, M=4)
    with pytest.raises(ValueError):
        P.score_reduce(dev, dev, torch.zeros(3), lam=LAM, g_free=4, M=4)
    with pytest.raises(ValueError):
        P.score_reduce(dev.t().contiguous().t(), dev, torch.zeros(4),
                       lam=LAM, g_free=4, M=4)
    with pytest.raises(TypeError):
        P.score_reduce(np.zeros((4, 2), np.float32), dev, torch.zeros(4),
                       lam=LAM, g_free=4, M=4)


def test_cpu_path_counts_no_launch():
    P.reset_stats()
    ref, port, view = window_pair(1)
    both(ref, port, view)
    run_multi(multi_reqs(range(2)))
    assert all(s.launches == 0 for s in P.STATS.values())


def test_build_is_keyed_on_sources_and_needs_nvcc(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    real = _build.library_path()
    assert real.parent == _build.BUILD_DIR and real.suffix == ".so"
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// v1\n")
    v1 = _build.library_path()
    (tmp_path / "k.cu").write_text("// v2\n")
    assert _build.library_path() != v1 != real
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


# ---------------------------------------------------------------------------
# The guarded form: both argmins of the idle-node guard from one call
# ---------------------------------------------------------------------------


def guarded_block(seed, B, S=4, ties=False):
    """A seeded (B, S) block with bias, f plane, mask and guard columns;
    ``ties`` draws from so few values that many rows tie exactly."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, S + 1, B).astype(np.float32)
    slot = np.arange(S)[None, :] < n[:, None]
    if ties:
        dev = np.where(slot, rng.integers(0, 2, (B, S)) * 0.5, 0)
    else:
        dev = np.where(slot, rng.uniform(0, 2, (B, S)), 0)
    g = np.where(slot, rng.integers(1, 3 if ties else 5, (B, S)), 0)
    f = np.where(slot, rng.integers(0, 3, (B, S)), 0)
    return dict(dev=dev.astype(np.float32), g=g.astype(np.float32), n=n,
                f=f.astype(np.float32),
                bias=rng.uniform(0, 0.3, B).astype(np.float32),
                mask=(rng.uniform(size=B) > 0.2).astype(np.float32),
                guard=(n > 0).astype(np.float32))


def port_call(blk, *, guard=True, **opts):
    keys = ("f", "bias", "mask")
    dev, g, n, gd = tensors(blk["dev"], blk["g"], blk["n"], blk["guard"])
    kw = {k: tensors(blk[k])[0] for k in keys if opts.get(k, True)}
    args = dict(lam=LAM, g_free=6, M=8, lam_f=0.25 if "f" in kw else 0.0)
    return P.score_reduce(dev, g, n, guard=gd if guard else None, **kw, **args), kw, args


@pytest.mark.parametrize("case", ["plain", "f+bias", "mask", "ties", "dead_guard",
                                  "dead_mask", "one_row", "large"])
def test_guarded_plain_equals_two_plain_calls(case):
    """Scores and both winners of one guarded call are bitwise what two
    plain calls return: one with ``mask``, one with ``mask & guard``."""
    B = {"one_row": 1, "large": 9000}.get(case, 300)
    blk = guarded_block(len(case), B, ties=case == "ties")
    opts = dict(f=case in ("f+bias", "large"),
                bias=case in ("f+bias", "large"),
                mask=case not in ("plain", "f+bias", "ties"))
    if case == "dead_guard":
        blk["guard"][:] = 0.0
    if case == "dead_mask":
        blk["mask"][:] = 0.0
    (scores, best, best_g), kw, args = port_call(blk, **opts)
    dev, g, n, gd = tensors(blk["dev"], blk["g"], blk["n"], blk["guard"])
    s1, b1 = P.score_reduce_plain(dev, g, n, **kw, **args)
    mask = kw.get("mask")
    both_mask = gd if mask is None else gd * mask
    s2, b2 = P.score_reduce_plain(dev, g, n, **dict(kw, mask=both_mask), **args)
    assert torch.equal(scores, s1)
    assert (best, best_g) == (b1, b2)
    assert torch.equal(torch.where(gd > 0, scores, torch.full_like(scores, float("inf"))), s2)
    if case == "dead_guard" or case == "dead_mask":
        assert best_g == -1
    if case == "dead_mask":
        assert best == -1
    if case == "ties":
        fin = scores[torch.isfinite(scores)]
        assert int((fin == fin.min()).sum()) > 1  # the tie-break decided


def test_guarded_empty_block():
    z = torch.zeros((0, 3))
    out = P.score_reduce(z, z, torch.zeros(0), lam=LAM, g_free=4, M=4,
                         guard=torch.zeros(0))
    assert out[0].numel() == 0 and out[1:] == (-1, -1)
    assert P.score_reduce_plain(z, z, torch.zeros(0), lam=LAM, g_free=4, M=4,
                                guard=torch.zeros(0))[1:] == (-1, -1)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("seed", [2, 6])
def test_guarded_matches_reference_two_calls(mode, seed):
    """One guarded port call against the reference's idle-guard sequence:
    a call, then a second with the non-empty mask, on the same window."""
    ref, port, view = window_pair(seed, lam_f=0.25)
    dev, g, n = port.padded_cols()
    rng = np.random.default_rng(seed)
    bias = rng.uniform(0.0, 0.5, len(port)).astype(np.float32)
    f = rng.integers(0, 3, dev.shape).astype(np.float32)
    nonempty = (n > 0).astype(np.float32)
    args = dict(lam=LAM, g_free=view.free_units, M=view.total_units, lam_f=0.25)
    s_ref, b_ref = R.score_reduce(dev, g, n, f=f, bias=bias, mode=mode, **args)
    _, j_ref = R.score_reduce(dev, g, n, f=f, bias=bias, mask=nonempty,
                              mode=mode, **args)
    tdev, tg, tn, tf, tbias, tguard = tensors(dev, g, n, f, bias, nonempty)
    s, b, j = P.score_reduce(tdev, tg, tn, f=tf, bias=tbias, guard=tguard, **args)
    assert np.max(np.abs(np.asarray(s_ref) - s.numpy())) <= TOL
    assert (b, j) == (b_ref, j_ref)


def test_idle_node_guard_is_one_call(monkeypatch):
    """An idle node whose best row is the empty action: the torch engine
    makes one score_reduce call, with the guard, and launches the best
    non-empty action, as ``engine="vector"`` does."""
    import repro_torch.core.ecosched as E
    from repro_torch.core import EcoSched, ProfiledPerfModel
    from repro_torch.core.types import JobProfile

    # the min-energy mode (4 units) does not fit the 2 live units, and the
    # 1-unit mode's energy deviation (0.3) outweighs λ·G_free/M: empty wins
    truth = {"a": JobProfile(name="a", runtime={1: 130.0, 4: 100.0},
                             busy_power={1: 600.0, 4: 600.0})}
    view = NodeView(t=0.0, total_units=4, domains=2, free_units=2, running=[],
                    free_map=[True, True, False, False], domain_jobs=[0, 0],
                    dead_units=2)
    calls = []
    real = E.score_reduce

    def counting(*a, **kw):
        calls.append(kw.get("guard") is not None)
        return real(*a, **kw)

    monkeypatch.setattr(E, "score_reduce", counting)
    out = {}
    for engine in ("torch", "vector"):
        extra = {"device": "cpu"} if engine == "torch" else {}
        pol = EcoSched(ProfiledPerfModel(truth, noise=0.0, seed=0), lam=LAM,
                       tau=0.45, engine=engine, cache=False, **extra)
        out[engine] = pol.on_event(view, ["a"])
        assert pol._last_decision[1]  # the guard chose the row
        assert pol._last_decision[0].n_jobs[pol._last_decision[2]] > 0
    assert calls == [True]
    assert out["torch"] == out["vector"] and out["torch"]

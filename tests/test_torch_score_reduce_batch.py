"""Port parity of the cross-node batch reduction (``score_reduce_batch``).

The port's plain version (what its wrapper runs on CPU tensors) against
the reference ``repro.kernels.score_reduce.score_reduce_batch`` in
``mode="ref"`` (pure jnp) and ``mode="interpret"`` (the Pallas body on the
CPU), and against per-node solo calls of the port, on seeded ragged
requests built with numpy.  Tolerance: scores within 1e-6 of the
reference (both float32 in the same order of operations, so expected
equal), bitwise equal to the port's own solo path, and identical winning
rows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import tensors  # noqa: E402

from repro.kernels import score_reduce as R  # noqa: E402
from repro_torch.kernels import score_reduce as P  # noqa: E402

TOL = 1e-6


def ragged_reqs(seed, sizes, S=4, *, f=False, bias=False, mask=False):
    """One request per entry of ``sizes`` (rows B_k), the reference's numpy
    request shape: slot planes zero past each row's size ``n``, per-node
    λ / G_free / M, optional f plane, bias and feasibility mask."""
    rng = np.random.default_rng(seed)
    reqs = []
    for k, B in enumerate(sizes):
        s = S if isinstance(S, int) else S[k]
        n = rng.integers(0, s + 1, B).astype(np.float32)
        slot = np.arange(s)[None, :] < n[:, None]
        r = dict(
            dev=np.where(slot, rng.uniform(0, 2, (B, s)), 0).astype(np.float32),
            g=np.where(slot, rng.integers(1, 5, (B, s)), 0).astype(np.float32),
            n=n, lam=float(0.2 + 0.05 * k), g_free=int(rng.integers(1, 17)),
            M=16,
        )
        if f:
            r["f"] = np.where(slot, rng.integers(0, 4, (B, s)), 0).astype(np.float32)
            r["lam_f"] = 0.1
        if bias:
            r["bias"] = rng.uniform(0.0, 0.3, B)  # float64, as EcoSched stages it
        if mask:
            r["mask"] = rng.uniform(size=B) > 0.3
        reqs.append(r)
    return reqs


def run_batch(reqs):
    packed = P.pack_windows(reqs, "cpu")
    scores, bests = P.score_reduce_batch(**packed)
    off = packed["offsets"].tolist()
    return [(scores[a:b], best) for a, b, best in zip(off, off[1:], bests)]


def solo(r):
    dev, g, n, f, bias, mask = tensors(r["dev"], r["g"], r["n"], r.get("f"),
                                       r.get("bias"), r.get("mask"))
    return P.score_reduce(dev, g, n, f=f, bias=bias, mask=mask, lam=r["lam"],
                          g_free=r["g_free"], M=r["M"],
                          lam_f=r.get("lam_f", 0.0))


def assert_matches(reqs, ref_out, out):
    assert len(out) == len(ref_out) == len(reqs)
    for k, ((s, b), (s_ref, b_ref), r) in enumerate(zip(out, ref_out, reqs)):
        assert b == b_ref, k
        s_ref = np.asarray(s_ref)
        assert s.shape[0] == s_ref.shape[0], k
        fin = np.isfinite(s_ref)
        assert np.array_equal(fin, np.isfinite(s.numpy())), k
        if fin.any():
            assert np.max(np.abs(s.numpy()[fin] - s_ref[fin])) <= TOL, k
        s_solo, b_solo = solo(r)
        assert b == b_solo, k
        assert torch.equal(s, s_solo), k  # bitwise, per node


@pytest.mark.parametrize("f,bias,mask", [
    (False, False, False), (True, False, False), (False, True, False),
    (False, False, True), (True, True, True),
])
def test_plain_matches_reference_ref_mode(f, bias, mask):
    reqs = ragged_reqs(1, [7, 0, 300, 1, 257, 40], f=f, bias=bias, mask=mask)
    assert_matches(reqs, R.score_reduce_batch(reqs, mode="ref"), run_batch(reqs))


@pytest.mark.parametrize("seed", range(3))
def test_plain_matches_reference_interpret_mode(seed):
    reqs = ragged_reqs(seed, [5, 33, 0, 12], S=2, f=seed == 1,
                       bias=seed == 2, mask=seed > 0)
    assert_matches(reqs, R.score_reduce_batch(reqs, mode="interpret"),
                   run_batch(reqs))


def test_mixed_slot_widths():
    """Nodes with S from 1 to 8 share one call: narrower nodes are
    zero-padded, which adds exactly +0.0 to every slot sum."""
    reqs = ragged_reqs(4, [9, 20, 3, 64], S=[1, 3, 8, 2], f=True, mask=True)
    assert_matches(reqs, R.score_reduce_batch(reqs, mode="ref"), run_batch(reqs))


def test_edges_empty_and_all_masked():
    """B_k = 0 and all-masked nodes give -1 without disturbing their
    neighbours; a single node (D = 1) is a solo call."""
    reqs = ragged_reqs(5, [0, 30, 0, 12])
    reqs.insert(2, dict(reqs[1], mask=np.zeros(30, bool)))
    out = run_batch(reqs)
    assert [b for _, b in out][0] == -1 and out[3][1] == -1
    assert out[2][1] == -1 and bool(torch.isinf(out[2][0]).all())
    assert out[0][0].numel() == 0
    assert_matches(reqs, R.score_reduce_batch(reqs, mode="ref"), out)
    one = ragged_reqs(6, [77], bias=True)
    assert_matches(one, R.score_reduce_batch(one, mode="ref"), run_batch(one))


def test_no_nodes():
    packed = P.pack_windows([], "cpu")
    scores, bests = P.score_reduce_batch(**packed)
    assert bests == [] and scores.numel() == 0


def test_equals_multi_and_counts_no_cpu_launch():
    """The batch and multi forms compute the same function; on CPU tensors
    neither counts a launch (only a kernel launch counts)."""
    P.reset_stats()
    reqs = ragged_reqs(7, [4, 0, 90, 13], f=True, bias=True, mask=True)
    packed = P.pack_windows(reqs, "cpu")
    s_b, b_b = P.score_reduce_batch(**packed)
    s_m, b_m = P.score_reduce_multi(**packed)
    assert b_b == b_m and torch.equal(s_b, s_m)
    assert P.STATS["score_reduce_batch"].launches == 0


def test_wrapper_rejects_bad_inputs():
    packed = P.pack_windows(ragged_reqs(8, [3, 4]), "cpu")
    with pytest.raises(TypeError):
        P.score_reduce_batch(**dict(packed, offsets=packed["offsets"].long()))
    with pytest.raises(ValueError):
        P.score_reduce_batch(**dict(packed, params=packed["params"][:1]))


# ---------------------------------------------------------------------------
# The guarded packed form: each segment's idle-node guard in the same call
# ---------------------------------------------------------------------------


def guarded_reqs(case):
    """Ragged nodes, every other one carrying a guard (its non-empty rows),
    with the edge segments ``case`` names."""
    sizes = {"single_row": [1, 30, 1, 12], "empty": [0, 30, 0, 12]}.get(case, [7, 30, 90, 12])
    reqs = ragged_reqs(11, sizes, f=True, bias=True, mask=case != "no_mask")
    if case == "ties":  # few distinct values: many rows tie exactly
        rng = np.random.default_rng(12)
        for r in reqs:
            slot = np.arange(r["dev"].shape[1])[None, :] < r["n"][:, None]
            r["dev"] = np.where(slot, rng.integers(0, 2, r["dev"].shape) * 0.5, 0).astype(np.float32)
            r["g"] = np.where(slot, rng.integers(1, 3, r["g"].shape), 0).astype(np.float32)
            r.pop("bias")
            r.pop("f")
            r.update(lam=0.35, g_free=4, M=8)
    for k, r in enumerate(reqs):
        if k % 2 == 0:
            r["guard"] = r["n"] > 0
    if case == "all_masked":
        reqs[2]["mask"] = np.zeros(len(reqs[2]["n"]), bool)
    if case == "all_guard_masked":
        reqs[0]["guard"] = np.zeros(len(reqs[0]["n"]), bool)
    return reqs


def two_calls(reqs, fn):
    """The two calls the guard replaces: one as asked, one whose mask is
    ``mask & guard`` (-1 for a segment without a guard)."""
    plain = [{k: v for k, v in r.items() if k != "guard"} for r in reqs]
    s1, b1 = fn(**P.pack_windows(plain, "cpu"))
    masked = []
    for r, p in zip(reqs, plain):
        both = np.asarray(r.get("guard", np.zeros(len(r["n"]), bool)), bool)
        if r.get("mask") is not None:
            both = both & np.asarray(r["mask"], bool)
        masked.append(dict(p, mask=both))
    _, b2 = fn(**P.pack_windows(masked, "cpu"))
    return s1, b1, b2


@pytest.mark.parametrize("form", ["batch", "multi"])
@pytest.mark.parametrize("case", ["plain", "empty", "single_row", "all_masked",
                                  "all_guard_masked", "ties", "no_mask"])
def test_guarded_packed_plain_equals_two_plain_calls(form, case):
    """Scores and both winners of every segment from one guarded packed
    call are bitwise what two packed calls return: one with ``mask``, one
    with ``mask & guard``; segments without a guard give -1."""
    fn = getattr(P, f"score_reduce_{form}")
    reqs = guarded_reqs(case)
    packed = P.pack_windows(reqs, "cpu")
    assert packed["guarded"] == sum("guard" in r for r in reqs)
    scores, bests, bests_g = fn(**packed)
    s1, b1, b2 = two_calls(reqs, fn)
    assert torch.equal(scores, s1)
    assert bests == b1 and bests_g == b2
    assert all(b == -1 for r, b in zip(reqs, bests_g) if "guard" not in r)
    if case == "all_guard_masked":
        assert bests_g[0] == -1
    if case == "all_masked":
        assert bests[2] == bests_g[2] == -1
    if case == "empty":
        assert bests[0] == bests_g[0] == -1
    if case == "ties":  # some segment's winner was decided by the tie-break
        off = packed["offsets"].tolist()
        seg = [scores[a:b][torch.isfinite(scores[a:b])] for a, b in zip(off, off[1:])]
        assert any(int((x == x.min()).sum()) > 1 for x in seg if x.numel())


@pytest.mark.parametrize("form", ["batch", "multi"])
@pytest.mark.parametrize("mode", ["ref", "interpret"])
def test_guarded_packed_matches_reference_two_calls(form, mode):
    """One guarded packed call against the reference's idle-guard
    sequence: a packed call, then a second one whose guarded nodes are
    masked to their non-empty rows."""
    reqs = guarded_reqs("plain")
    ref_fn = getattr(R, f"score_reduce_{form}")
    plain = [{k: v for k, v in r.items() if k != "guard"} for r in reqs]
    ref1 = ref_fn(plain, mode=mode)
    ref2 = ref_fn([dict(p, mask=np.asarray(r["guard"]) & np.asarray(r["mask"]))
                   for r, p in zip(reqs, plain) if "guard" in r], mode=mode)
    scores, bests, bests_g = getattr(P, f"score_reduce_{form}")(**P.pack_windows(reqs, "cpu"))
    assert bests == [b for _, b in ref1]
    assert [b for r, b in zip(reqs, bests_g) if "guard" in r] == [b for _, b in ref2]
    want = np.concatenate([np.asarray(s) for s, _ in ref1])
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(scores.numpy()))
    assert np.max(np.abs(scores.numpy()[fin] - want[fin])) <= TOL


def test_packed_offsets_share_the_upload():
    """The int32 offsets are a view of the one uploaded buffer."""
    packed = P.pack_windows(guarded_reqs("plain"), "cpu")
    assert packed["offsets"].dtype == torch.int32
    assert packed["offsets"].untyped_storage().data_ptr() == packed["dev"].untyped_storage().data_ptr()
    assert packed["offsets"].tolist() == [0, 7, 37, 127, 139]

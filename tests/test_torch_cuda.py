"""The CUDA kernels on the card: each against its plain PyTorch version
on the same device tensors, and the torch engine's schedule against the
numpy engine's.  Needs an NVIDIA GPU and nvcc; skips elsewhere.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def _block(rng, B, S, device):
    n = rng.integers(0, S + 1, B).astype(np.float32)
    slot = np.arange(S)[None, :] < n[:, None]
    dev = np.where(slot, rng.uniform(0, 2, (B, S)), 0).astype(np.float32)
    g = np.where(slot, rng.integers(1, 5, (B, S)), 0).astype(np.float32)
    mask = (rng.uniform(size=B) > 0.2).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (dev, g, n, mask)]


@pytest.mark.parametrize("B", [1, 255, 256, 257, 6181])
def test_score_reduce_kernel_matches_plain(device, B):
    from repro_torch.kernels import score_reduce as K

    rng = np.random.default_rng(B)
    dev, g, n, mask = _block(rng, B, 4, device)
    kw = dict(lam=0.35, g_free=16, M=16, mask=mask)
    before = K.STATS["score_reduce"].launches
    s_k, b_k = K.score_reduce(dev, g, n, **kw)
    s_p, b_p = K.score_reduce_plain(dev, g, n, **kw)
    assert K.STATS["score_reduce"].launches == before + 1
    assert b_k == b_p
    assert torch.equal(s_k, s_p)


@pytest.mark.parametrize("B", [1, 255, 1321, 8192, 8193, 70000])
def test_score_reduce_guard_kernel_matches_plain(device, B):
    """One launch gives both winners, bitwise the plain version's, on
    both sides of the one-block threshold (8192 rows), and the
    multi-block combine leaves its ticket at 0 for the next call."""
    from repro_torch.kernels import score_reduce as K

    rng = np.random.default_rng(B + 1)
    dev, g, n, mask = _block(rng, B, 4, device)
    guard = (n > 0).float()
    kw = dict(lam=0.35, g_free=16, M=16, mask=mask, guard=guard)
    before = (K.STATS["score_reduce"].launches, K.STATS["score_reduce"].guarded)
    for _ in range(2):  # the second call finds the ticket reset
        s_k, b_k, j_k = K.score_reduce(dev, g, n, **kw)
        s_p, b_p, j_p = K.score_reduce_plain(dev, g, n, **kw)
        assert (b_k, j_k) == (b_p, j_p)
        assert torch.equal(s_k, s_p)
    after = (K.STATS["score_reduce"].launches, K.STATS["score_reduce"].guarded)
    assert after == (before[0] + 2, before[1] + 2)
    _, _, j_dead = K.score_reduce(dev, g, n, **dict(kw, guard=torch.zeros_like(guard)))
    assert j_dead == -1


def test_score_reduce_multi_kernel_matches_solo(device):
    from repro_torch.kernels import score_reduce as K

    rng = np.random.default_rng(3)
    reqs = []
    for k, B in enumerate((5, 0, 300, 17)):
        dev, g, n, _ = (t.cpu().numpy() for t in _block(rng, B, 2, "cpu"))
        reqs.append(dict(dev=dev, g=g, n=n, lam=0.1 * (k + 1), g_free=8, M=8))
    packed = K.pack_windows(reqs, device)
    scores, bests = K.score_reduce_multi(**packed)
    assert bests == K.score_reduce_multi_plain(**packed)[1]
    off = packed["offsets"].tolist()
    for w, (lo, hi) in enumerate(zip(off, off[1:])):
        s_w, b_w = K.score_reduce(packed["dev"][lo:hi], packed["g"][lo:hi],
                                  packed["n"][lo:hi], lam=reqs[w]["lam"],
                                  g_free=8, M=8)
        assert b_w == bests[w]
        assert torch.equal(s_w, scores[lo:hi])
    assert bests[1] == -1


def test_torch_engine_schedule_on_the_card(device):
    from repro_torch.core import EcoSched, Node, ProfiledPerfModel, simulate
    from repro_torch.core import calibration as C
    from repro_torch.kernels import score_reduce as K

    truth = C.build_system("h100", freq_levels=4)
    out = {}
    for engine in ("torch", "vector"):
        K.reset_stats()
        pol = EcoSched(ProfiledPerfModel(truth, noise=0.02, seed=1), lam=0.35,
                       tau=0.45, lam_f=0.1, engine=engine)
        r = simulate(pol, Node(4, 2, C.idle_power("h100")), truth,
                     queue=list(C.APP_ORDER))
        out[engine] = ([(x.job, x.g, x.f, x.start, x.end) for x in r.records],
                       r.makespan, r.total_energy, K.STATS["score_reduce"].launches)
    assert out["torch"][:3] == out["vector"][:3]
    assert out["torch"][3] > 0 and out["vector"][3] == 0


@pytest.mark.parametrize("sizes", [(5, 0, 300, 17), (1,), (6181, 0, 257, 256, 1)])
def test_score_reduce_batch_kernel_matches_plain_and_solo(device, sizes):
    from repro_torch.kernels import score_reduce as K

    rng = np.random.default_rng(len(sizes))
    reqs = []
    for k, B in enumerate(sizes):
        dev, g, n, mask = (t.cpu().numpy() for t in _block(rng, B, 3, "cpu"))
        reqs.append(dict(dev=dev, g=g, n=n, lam=0.1 * (k + 1), g_free=8, M=8,
                         mask=mask, bias=rng.uniform(0, 0.2, B)))
    packed = K.pack_windows(reqs, device)
    before = K.STATS["score_reduce_batch"].launches
    scores, bests = K.score_reduce_batch(**packed)
    assert K.STATS["score_reduce_batch"].launches == before + 1
    s_p, b_p = K.score_reduce_batch_plain(**packed)
    assert bests == b_p and torch.equal(scores, s_p)
    off = packed["offsets"].tolist()
    for d, (lo, hi) in enumerate(zip(off, off[1:])):
        sl = slice(lo, hi)
        s_d, b_d = K.score_reduce(packed["dev"][sl], packed["g"][sl],
                                  packed["n"][sl], lam=reqs[d]["lam"], g_free=8,
                                  M=8, bias=packed["bias"][sl],
                                  mask=packed["mask"][sl])
        assert b_d == bests[d]
        assert torch.equal(s_d, scores[sl])


@pytest.mark.parametrize("name", ["score_reduce_batch", "score_reduce_multi"])
@pytest.mark.parametrize("sizes", [(5, 0, 300, 17), (1,), (6181, 0, 257, 256, 1)])
def test_guarded_packed_kernel_matches_plain_and_two_calls(device, name, sizes):
    """The packed kernel with the idle-node guard on every other segment:
    one launch gives scores and both winners bitwise its plain version's
    and the two calls the guard replaces."""
    from repro_torch.kernels import score_reduce as K

    rng = np.random.default_rng(len(sizes) + 7)
    reqs = []
    for k, B in enumerate(sizes):
        dev, g, n, mask = (t.cpu().numpy() for t in _block(rng, B, 3, "cpu"))
        r = dict(dev=dev, g=g, n=n, lam=0.1 * (k + 1), g_free=8, M=8, mask=mask,
                 bias=rng.uniform(0, 0.2, B))
        if k % 2 == 0:
            r["guard"] = n > 0
        reqs.append(r)
    fn = getattr(K, name)
    packed = K.pack_windows(reqs, device)
    before = (K.STATS[name].launches, K.STATS[name].guarded)
    scores, bests, bests_g = fn(**packed)
    assert (K.STATS[name].launches, K.STATS[name].guarded) == (
        before[0] + 1, before[1] + sum("guard" in r for r in reqs))
    s_p, b_p, j_p = getattr(K, name + "_plain")(**packed)
    assert (bests, bests_g) == (b_p, j_p) and torch.equal(scores, s_p)
    plain = [{k: v for k, v in r.items() if k != "guard"} for r in reqs]
    s_1, b_1 = fn(**K.pack_windows(plain, device))
    masked = [dict(q, mask=np.asarray(r.get("guard", np.zeros(len(r["n"]), bool)), bool)
                   & (q["mask"] > 0)) for r, q in zip(reqs, plain)]
    _, j_2 = fn(**K.pack_windows(masked, device))
    assert torch.equal(scores, s_1) and bests == b_1 and bests_g == j_2
    assert all(j == -1 for r, j in zip(reqs, bests_g) if "guard" not in r)


def test_fleet_stages_through_the_batch_kernel(device):
    from repro_torch.core import (Cluster, EcoSched, NodeSpec, ProfiledPerfModel,
                                  RoundRobinDispatcher, bursty_stream)
    from repro_torch.core import calibration as C
    from repro_torch.kernels import score_reduce as K
    from repro_torch.roofline.hw import H100

    apps = C.build_system("h100")
    out = {}
    for engine in ("torch", "vector"):
        pols = []

        def policy_for(spec, truth, engine=engine):
            pols.append(EcoSched(ProfiledPerfModel(truth, noise=0.0, seed=1),
                                 lam=0.35, tau=0.45, engine=engine))
            return pols[-1]

        cl = Cluster([NodeSpec(f"n{i:03d}", H100, units=8, domains=2) for i in range(4)],
                     truth_for=lambda s: apps, policy_for=policy_for,
                     dispatcher=RoundRobinDispatcher())
        K.reset_stats()
        r = cl.simulate(bursty_stream(list(C.APP_ORDER), rate=0.25, n=48, seed=21, burst=6))
        out[engine] = ([(x.job, x.node, x.g, x.start, x.end) for x in r.records],
                       r.makespan, r.total_energy)
        if engine == "torch":
            assert K.STATS["score_reduce_batch"].launches > 0
            assert sum(p.stage_served for p in pols) > 0
    assert out["torch"] == out["vector"]


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", [(2, 192, 6, 2, 64, 96, 20.0, True),
                                   (1, 300, 8, 4, 128, 0, 0.0, False),
                                   # the other head dims: non-causal, ragged
                                   # S, softcap (bf16 takes the wgmma kernel)
                                   (1, 300, 4, 2, 16, 0, 25.0, False),
                                   (1, 300, 4, 2, 32, 0, 25.0, False),
                                   (1, 300, 4, 2, 96, 0, 25.0, False),
                                   (1, 300, 4, 2, 256, 0, 25.0, False),
                                   # hd 128 (bf16: flash_kernel_ws): G 1 and G 4 at
                                   # a ragged S, a window with softcap, and S 4096
                                   # (the K/V ring wraps 16 times)
                                   (1, 2113, 8, 8, 128, 0, 0.0, True),
                                   (1, 2113, 16, 4, 128, 0, 0.0, True),
                                   (1, 1000, 8, 2, 128, 300, 30.0, True),
                                   (1, 4096, 8, 2, 128, 0, 0.0, True),
                                   # the served families' prefills: gemma3-4b's
                                   # local and global layers, phi-3-vision's,
                                   # whisper-base's encoder (non-causal, ragged)
                                   (4, 2048, 8, 4, 256, 1024, 0.0, True),
                                   (4, 2048, 8, 4, 256, 0, 0.0, True),
                                   (4, 2048, 32, 32, 96, 0, 0.0, True),
                                   (8, 1500, 8, 8, 64, 0, 0.0, False),
                                   # their shapes small: hd 96 at G 1, causal; hd 64
                                   # non-causal, S no multiple of 128
                                   (1, 300, 4, 4, 96, 0, 0.0, True),
                                   (2, 300, 8, 8, 64, 0, 0.0, False),
                                   # causal with enough tile pairs to fill the card
                                   # and an odd tile count: the middle tile alone
                                   (4, 1408, 32, 8, 128, 0, 0.0, True),
                                   # steep scores: q and k x 3 (score std about 9)
                                   (1, 256, 4, 2, 64, 0, 0.0, True, 3.0),
                                   (1, 300, 4, 2, 128, 0, 0.0, False, 3.0),
                                   (1, 200, 2, 1, 256, 0, 0.0, True, 3.0),
                                   (1, 1500, 8, 8, 64, 0, 0.0, False, 3.0)])
def test_flash_attention_kernel_matches_plain(device, shape, dtype, tol):
    """The kernel against its plain version on the same card tensors; the
    plain float32 version runs without TF32.  On steep scores float32
    arithmetic's own error nears 2e-5 (the plain float32 version is 0.4-1.0
    of it from the exact answer there), so those cases hold the kernel to
    the plain version run in float64 on the same inputs."""
    from repro_torch.kernels import flash_attention as FA

    B, S, H, KVH, hd, window, softcap, causal, *amp = shape
    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, n, hd)).astype(np.float32))
               for n in (H, KVH, KVH))
    if amp:
        q, k = q * amp[0], k * amp[0]
    q, k, v = (t.to(device, getattr(torch, dtype)) for t in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = FA.STATS["flash_attention"]
    got = FA.flash_attention(q, k, v, **kw)
    assert FA.STATS["flash_attention"] == before + 1
    assert not torch.backends.cuda.matmul.allow_tf32
    want = FA.flash_attention_plain(*((t.double() for t in (q, k, v)) if amp else (q, k, v)),
                                    **kw)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.double(), want.double(), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(4, 2048, 16, 16, 128, 0, True),
                                   (1, 2113, 16, 4, 128, 300, True),
                                   (1, 300, 4, 2, 64, 0, False),
                                   (4, 2048, 32, 32, 96, 0, True),
                                   (8, 1500, 8, 8, 64, 0, False),
                                   (4, 1408, 32, 8, 128, 0, True)])
def test_flash_attention_bf16_launches_are_bitwise_equal(device, shape):
    """No atomics: two launches of the bf16 kernel on the same inputs give
    the same bits, whichever block a tile lands in (four of these shapes
    walk tiles persistently, the windowed one and the small one take a
    block a tile)."""
    from repro_torch.kernels import flash_attention as FA

    B, S, H, KVH, hd, window, causal = shape
    rng = np.random.default_rng(S + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, n, hd)).astype(np.float32))
               .to(device, torch.bfloat16) for n in (H, KVH, KVH))
    kw = dict(causal=causal, window=window)
    a = FA.flash_attention(q, k, v, **kw)
    b = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 128, 4, 32, 64, 32), (2, 512, 6, 64, 128, 256),
                                   # the kernels' edges: one chunk (S = Q), chunk
                                   # 1024, hp 128 with N 128, N 16, and a chunk
                                   # and state size off the 16-row tiles
                                   (1, 256, 4, 32, 64, 256), (1, 2048, 2, 64, 64, 1024),
                                   (1, 512, 4, 128, 128, 256), (2, 256, 4, 16, 16, 64),
                                   (1, 200, 3, 64, 40, 100),
                                   # hymba-1.5b's heads, as its prefill takes them,
                                   # and prompts under the chunk (Q = S, odd)
                                   (2, 2048, 50, 64, 16, 256), (2, 1, 50, 64, 16, 1),
                                   (2, 37, 50, 64, 16, 37), (2, 200, 50, 64, 16, 200)])
def test_ssd_scan_kernel_matches_plain(device, shape, dtype):
    from repro_torch.kernels import ssd_scan as SS

    B, S, nh, hp, N, Q = shape
    rng = np.random.default_rng(S)
    f32 = [rng.normal(size=(B, S, nh, hp)), rng.uniform(0.001, 0.1, (B, S, nh)),
           -rng.uniform(0.5, 4, (nh,)), rng.normal(size=(B, S, N)),
           rng.normal(size=(B, S, N))]
    args = [torch.from_numpy(a.astype(np.float32)).to(device) for a in f32]
    if dtype == "bfloat16":  # x, B and C in bf16; dt and A stay float32
        for k in (0, 3, 4):
            args[k] = args[k].to(torch.bfloat16)
    before = SS.STATS["ssd_scan"]
    y, h = SS.ssd_scan(*args, chunk=Q)
    assert SS.STATS["ssd_scan"] == before + 1
    yp, hp_ = SS.ssd_scan_plain(*args, chunk=Q)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yp, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(h, hp_, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_steep_decay_matches_plain(device, dtype):
    """Decays as steep as a trained mamba2's (A down to -16, dt up to 0.5):
    one 64-row tile spans exp(-100) and more, and no score overflows."""
    from repro_torch.kernels import ssd_scan as SS

    B, S, nh, hp, N, Q = 2, 512, 8, 64, 128, 256
    rng = np.random.default_rng(5)
    f32 = [rng.normal(size=(B, S, nh, hp)), rng.uniform(0.005, 0.5, (B, S, nh)),
           -rng.uniform(2, 16, (nh,)), rng.normal(size=(B, S, N)),
           rng.normal(size=(B, S, N))]
    args = [torch.from_numpy(a.astype(np.float32)).to(device) for a in f32]
    if dtype == "bfloat16":
        for k in (0, 3, 4):
            args[k] = args[k].to(torch.bfloat16)
    y, h = SS.ssd_scan(*args, chunk=Q)
    yp, hp_ = SS.ssd_scan_plain(*args, chunk=Q)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(y, yp, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(h, hp_, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("name,width,S,dtype,tol", [
    ("hymba-1.5b", "reduced", 45, "float32", 1e-4), ("hymba-1.5b", "reduced", 45, "bfloat16", 2e-2),
    ("mamba2-2.7b", "reduced", 45, "float32", 1e-4), ("mamba2-2.7b", "reduced", 45, "bfloat16", 2e-2),
    # full width at 2 layers, a prompt under the chunk of 256: Q = S = 37
    ("hymba-1.5b", "full", 37, "float32", 1e-4)])
def test_prefill_mixer_takes_ssd_scan_on_the_card(device, name, width, S, dtype, tol):
    """An SSM and hybrid prefill on the card under inference_mode, at a
    length that is no multiple of the chunk (reduced: 45 over 16) or
    under it (full width: 37 over 256): every layer's mixer launches
    ``ssd_scan`` once, and its ``model.ssd`` span notes the route and the
    launch; logits and every cache leaf within ``tol`` of each tensor's
    largest magnitude of the same prefill on the CPU (the chunked
    form)."""
    from repro_torch import trace
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models import Runtime, build_model
    from repro_torch.train import make_prefill
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(name).replace(dtype=dtype)
    cfg = reduced(cfg) if width == "reduced" else cfg.replace(num_layers=2)
    prefill = make_prefill(build_model(cfg, Runtime(remat="none")))
    params = build_model(cfg).init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32))
    assert S % cfg.ssm_chunk
    with torch.inference_mode():
        want = prefill(params, {"tokens": toks})
        before = SS.STATS["ssd_scan"]
        trace.take()
        with trace.recording():
            got = prefill(tree_map(lambda t: t.to(device), params), {"tokens": toks.to(device)})
        recs = [r for r in trace.take() if r.name == "model.ssd"]
    assert SS.STATS["ssd_scan"] - before == cfg.num_layers == len(recs)
    assert all(r.counters["route"] == "ssd_scan" and r.launches["ssd_scan"] == 1
               for r in recs)
    (gl, gc), (wl, wc) = got, want
    assert sorted(gc) == sorted(wc)
    for k, a, b in [("logits", gl, wl)] + [(k, gc[k], wc[k]) for k in wc]:
        b = b.float()
        rel = float((a.cpu().float() - b).abs().max()) / float(b.abs().max())
        assert rel < tol, (k, rel)


def test_prefill_under_grad_keeps_the_chunked_mixer_on_the_card(device):
    """A prefill on the card with grad on and a mixer parameter that
    requires grad builds a graph, which the kernel cannot join: every
    ``model.ssd`` span notes the chunked route, none launches
    ``ssd_scan``, nothing raises, and the logits carry the graph."""
    from repro_torch import trace
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models import Runtime, build_model

    cfg = reduced(get_config("hymba-1.5b"))
    model = build_model(cfg, Runtime(remat="none"))
    params = model.init(0, device=device)
    params["blocks"]["ssm"]["A_log"].requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 48)).astype(np.int32)).to(device)
    before = SS.STATS["ssd_scan"]
    trace.take()
    with torch.enable_grad(), trace.recording():
        logits, _ = model.prefill(params, {"tokens": toks})
    recs = [r for r in trace.take() if r.name == "model.ssd"]
    assert SS.STATS["ssd_scan"] == before
    assert len(recs) == cfg.num_layers and logits.requires_grad
    assert all(r.counters["route"] == "chunked" and r.launches["ssd_scan"] == 0
               for r in recs)


def test_hymba_shaped_prefill_launches_flash_attention(device):
    """Two hymba-1.5b layers at full width: prefill through the kernel
    route launches flash_attention once per layer and agrees with the
    plain blocked route on the same card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import Runtime, build_model

    cfg = get_config("hymba-1.5b").replace(num_layers=2, dtype="float32")
    params = build_model(cfg).init(0, device=device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 512)).astype(np.int32)).to(device)
    out = {}
    with torch.inference_mode():
        for impl in ("pallas", "blocked"):
            FA.reset_stats()
            out[impl] = build_model(cfg, Runtime(attn_impl=impl, remat="none")).prefill(
                params, {"tokens": toks})
            out[impl + "_launches"] = FA.STATS["flash_attention"]
    assert out["pallas_launches"] == 2 and out["blocked_launches"] == 0
    a, b = out["pallas"][0], out["blocked"][0]
    assert float((a - b).abs().max()) / float(b.abs().max()) < 1e-4


def test_daemon_on_the_card_matches_vector(device, tmp_path):
    """The control plane on the card: ``SchedulerService`` over the
    ``hetero`` preset with EcoSched(engine="torch") policies writes the
    same journal, byte for byte, as with ``engine="vector"``, ends on the
    same schedule, and its decisions launch ``score_reduce``."""
    from repro_torch.cli import make_backend_factory
    from repro_torch.core import SchedulerService
    from repro_torch.kernels import score_reduce as K

    ops = [("submit", "j0", "bert", 10.0), ("submit", "j1", "lbm", 10.0),
           ("submit", "j2", "resnet50", 40.0), ("advance", 60.0),
           ("submit", "j3", "gpt2", 90.0), ("advance", None)]
    got = {}
    for engine in ("torch", "vector"):
        path = tmp_path / f"{engine}.jnl"
        svc = SchedulerService(make_backend_factory(
            "hetero", elastic=True, freq_levels=3, engine=engine, device=device),
            journal_path=str(path))
        before = K.STATS["score_reduce"].launches
        for op in ops:
            if op[0] == "submit":
                svc.submit(*op[1:])
            else:
                svc.advance(op[1])
        got[engine] = (svc.result(), path.read_bytes(),
                       K.STATS["score_reduce"].launches - before)
        svc.close()
    assert got["torch"][0] == got["vector"][0] and got["torch"][0]["ok"]
    assert got["torch"][1] == got["vector"][1]
    assert got["torch"][2] > 0 and got["vector"][2] == 0


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "arctic-480b"])
def test_moe_layer_on_the_card_matches_cpu(device, name):
    """One reduced MoE layer, float32, on the card and on the CPU from the
    same weights: the same experts and drops, outputs within 1e-5."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import moe as PM

    cfg = reduced(get_config(name)).replace(dtype="float32")
    gen = torch.Generator(device="cpu").manual_seed(0)
    p = PM.moe_init(gen, cfg, torch.float32)
    x = torch.randn((2, 64, cfg.d_model), generator=gen)
    pd = {k: ({kk: vv.to(device) for kk, vv in v.items()} if isinstance(v, dict)
              else v.to(device)) for k, v in p.items()}
    r_cpu, r_dev = PM.route(p, x, cfg), PM.route(pd, x.to(device), cfg)
    assert torch.equal(r_cpu[0], r_dev[0].cpu()) and torch.equal(r_cpu[2], r_dev[2].cpu())
    torch.testing.assert_close(PM.moe_apply(pd, x.to(device), cfg).cpu(),
                               PM.moe_apply(p, x, cfg), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("which", ["flash_attention", "ssd_scan"])
def test_kernel_routes_raise_under_grad(device, which):
    """The kernels have no backward: on the card, with grad enabled and an
    input that requires grad, the wrapper raises instead of returning an
    output cut off from the graph; under no_grad it still serves."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cpu").manual_seed(0)
    if which == "flash_attention":
        args = [torch.randn((1, 64, 4, 64), generator=gen).to(device) for _ in range(3)]
        call = lambda *a: ops.flash_attention(*a, causal=True)  # noqa: E731
    else:
        args = [torch.randn((1, 64, 2, 64), generator=gen).to(device),
                torch.rand((1, 64, 2), generator=gen).to(device) * 0.1,
                -torch.rand((2,), generator=gen).to(device),
                torch.randn((1, 64, 16), generator=gen).to(device),
                torch.randn((1, 64, 16), generator=gen).to(device)]
        call = lambda *a: ops.ssd_scan(*a, chunk=32)  # noqa: E731
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        call(*args)
    with torch.no_grad():
        out = call(*args)
    assert out is not None


def test_train_step_on_the_card_matches_cpu(device):
    """One train step of reduced hymba-1.5b (float32, TF32 off) on the card
    and on the CPU from one state: loss rel. 1e-5, parameters within 1e-4
    of each leaf's largest magnitude; a step with attn_impl="pallas" on
    the card raises."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Runtime, build_model
    from repro_torch.optim import AdamW, WarmupCosine
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.tree import leaves_with_paths, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("hymba-1.5b")).replace(dtype="float32")
    opt, sched = AdamW(), WarmupCosine(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
    state = init_state(build_model(cfg), opt, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(cfg, 2, 64).global_batch(0).items()}
    step = make_train_step(build_model(cfg, Runtime(remat="full")), opt, sched)
    want, wm = step(state, batch)
    got, gm = step(tree_map(lambda t: t.to(device), state),
                   {k: v.to(device) for k, v in batch.items()})
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= 1e-5 * abs(float(wm["loss"]))
    gp = dict(leaves_with_paths(got["params"]))
    for k, w in leaves_with_paths(want["params"]):
        err = float((gp[k].cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        assert err < 1e-4, (k, err)
    pallas = make_train_step(build_model(cfg, Runtime(attn_impl="pallas")), opt, sched)
    with pytest.raises(RuntimeError, match="no backward"):
        pallas(tree_map(lambda t: t.to(device), state), {k: v.to(device) for k, v in batch.items()})


def test_dryrun_on_the_card_allocates_nothing(device):
    """A dry-run of full-width hymba-1.5b's prefill on fake tensors of the
    card counts its program and leaves the card's memory as it was."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed.meshes import AbstractMesh
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline import analysis as RA

    with RA.fake_mode():  # PyTorch's one 4-byte CUDA context probe for fake tensors
        torch.empty(0, device=device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rec = D.dryrun_cell("hymba-1.5b", ShapeCell("p2048", "prefill", 2048, 4),
                        mesh=AbstractMesh((1, 1), ("data", "model")), skip_variants=True,
                        device=device)
    assert torch.cuda.memory_allocated() == before
    assert torch.cuda.max_memory_allocated() == before
    assert 0.95 <= rec["cost_totals"]["flops"] / rec["model_flops_total"] <= 1.10


def tp_prefill_on_the_card(arch, device, tmp_path):
    """Reduced ``arch``'s prefill over 2 gloo ranks of the card, the model
    axis across them, on the kernel route, against the one-process kernel
    route on the same weights: each rank launches ``flash_attention`` once
    a layer, and the logits agree within 1e-4."""
    import torch_tp_ranks as TP
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import procs
    from repro_torch.distributed.meshes import LogicalDevice
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import Runtime, build_model
    from repro_torch.train import make_prefill

    cfg = reduced(get_config(arch)).replace(dtype="float32")
    model = build_model(cfg, Runtime(attn_impl="pallas", remat="none"))
    params = model.init(torch.Generator(device=device).manual_seed(0))
    before = FA.STATS["flash_attention"]
    with torch.inference_mode():
        want, _ = make_prefill(model)(params, {k: v.to(device)
                                               for k, v in TP.serve_batch(cfg).items()})
    assert FA.STATS["flash_attention"] == before + cfg.num_layers
    got = procs.spawn(TP.card_prefill, (arch,),
                      units=[LogicalDevice(i, device) for i in range(2)],
                      jobdir=str(tmp_path), backend="gloo", timeout=300)
    for logits, launches in got:
        assert launches == cfg.num_layers
        err = float((logits - want.cpu()).abs().max() / want.abs().max())
        assert err < 1e-4, err


def test_tensor_parallel_prefill_on_the_card_matches_one_process(device, tmp_path):
    """Reduced granite-8b: each rank on its own 2 heads."""
    tp_prefill_on_the_card("granite-8b", device, tmp_path)


def test_tensor_parallel_moe_prefill_on_the_card_matches_one_process(device, tmp_path):
    """Reduced qwen2-moe-a2.7b: each rank on its own 2 heads, 2 of the 4
    experts and half the shared expert's columns, one all-reduce a MoE
    layer."""
    tp_prefill_on_the_card("qwen2-moe-a2.7b", device, tmp_path)


def test_rank_trace_on_the_card_allocates_nothing(device):
    """The dry-run of reduced granite-8b (padded to model 4) on a (2, 4)
    mesh counts rank 0's step over a fake process group on fake tensors
    of the card: its collectives equal the same count on the CPU's fake
    tensors, kind by kind, and the card's memory is left as it was."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.meshes import AbstractMesh
    from repro_torch.launch import dryrun as D
    from repro_torch.models import Runtime
    from repro_torch.roofline import analysis as RA

    cfg, _ = shd.shardable(reduced(get_config("granite-8b")), 4)
    mesh, rt = AbstractMesh((2, 4), ("data", "model")), Runtime(remat="full")
    with RA.fake_mode():
        torch.empty(0, device=device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for kind, B in (("prefill", 4), ("train", 8), ("decode", 8)):
        cell = ShapeCell("t", kind, 64, B)
        got = D.trace_cell(cfg, cell, mesh, rt, grad_accum=1, device=device).rank_costs
        want = D.trace_cell(cfg, cell, mesh, rt, grad_accum=1, device="cpu").rank_costs
        assert got["_counts"] == want["_counts"] and got["coll_bytes"] == want["coll_bytes"]
        assert got["coll_bytes"] > 0, kind
    assert torch.cuda.memory_allocated() == before
    assert torch.cuda.max_memory_allocated() == before
    assert not torch.distributed.is_initialized()


def test_int8_moments_and_compression_over_ranks_of_the_card(device, tmp_path):
    """Reduced granite-8b at model_par 2 over 2 gloo ranks of the card,
    int8 moments and compression, one step from the one-process warm
    state on the card: loss and grad norm within rel. 1e-5 of one process
    on the card, every code at most one off."""
    import torch_tp_optim_ranks as OR
    from repro_torch.distributed import procs
    from repro_torch.distributed.meshes import LogicalDevice

    start = OR.warm_start("granite-8b", tmp_path, device)
    one = OR.one_process("granite-8b", "both", start, tmp_path, device)
    got = procs.spawn(OR.ranks, ({("granite-8b", "both"): (start, one["state"])}, tmp_path),
                      units=[LogicalDevice(i, device) for i in range(2)],
                      jobdir=str(tmp_path / "j"), backend="gloo", timeout=300)
    for r in got:
        res = r[("granite-8b", "both")]
        for k in ("loss", "grad_norm"):
            assert abs(res[k] - one[k]) <= 1e-5 * abs(one[k]), (k, res[k], one[k])
        for k, w in one["state"].items():
            if k.endswith("/q"):
                d = np.abs(res["state"][k].astype(np.int32) - w.astype(np.int32))
                assert d.max() <= 1, k


def test_donated_train_step_holds_one_state_on_the_card(device):
    """Reduced mamba2-2.7b at d_model 512 and a 1,024-entry vocabulary (2
    layers, float32, float32 moments, B 1 x S 16): its leaves are of like
    size, so the step's peak is at the update and one leaf's temporaries
    are a small part of the state.  From one state on the card, the
    donated step against the pure one: every leaf and metric bitwise
    equal, every leaf in the storage it was given, and the peak above the
    memory already held lower by at least 0.8 x the state's bytes."""
    import copy

    import torch_tp_optim_ranks as OR
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Runtime, build_model
    from repro_torch.optim import AdamW, WarmupCosine
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.tree import leaves, leaves_with_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("mamba2-2.7b")).replace(d_model=512, vocab_size=1024,
                                                     num_layers=2, dtype="float32")
    model, opt = build_model(cfg, Runtime(remat="full")), AdamW()
    sched = WarmupCosine(peak_lr=1e-3, warmup_steps=1, decay_steps=10)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in SyntheticLM(cfg, 1, 16).global_batch(0).items()}
    state = init_state(model, opt, 0, device=device)
    state_bytes = sum(t.numel() * t.element_size() for t in leaves(state))
    pure = make_train_step(model, opt, sched)
    donated = make_train_step(model, opt, sched, donate=True)
    pure(copy.deepcopy(state), batch)  # the libraries' workspaces, before the windows
    twin, given = copy.deepcopy(state), OR.storages(state)
    peaks, outs = {}, {}
    for name, step, st in (("pure", pure, twin), ("donated", donated, state)):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs[name] = step(st, batch)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - held
    (want, wm), (got, gm) = outs["pure"], outs["donated"]
    gl = dict(leaves_with_paths(got))
    assert not [k for k, t in leaves_with_paths(want) if not OR.same_bits(t, gl[k])]
    assert all(OR.same_bits(wm[k], gm[k]) for k in wm)
    assert OR.storages(got) == given
    print(f"donated step: peaks above the held memory {peaks}, state {state_bytes} B")
    assert peaks["pure"] - peaks["donated"] >= 0.8 * state_bytes, (peaks, state_bytes)

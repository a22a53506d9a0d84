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
                                   # steep scores: q and k x 3 (score std about 9)
                                   (1, 256, 4, 2, 64, 0, 0.0, True, 3.0),
                                   (1, 300, 4, 2, 128, 0, 0.0, False, 3.0),
                                   (1, 200, 2, 1, 256, 0, 0.0, True, 3.0)])
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 128, 4, 32, 64, 32), (2, 512, 6, 64, 128, 256),
                                   # the kernels' edges: one chunk (S = Q), chunk
                                   # 1024, hp 128 with N 128, N 16, and a chunk
                                   # and state size off the 16-row tiles
                                   (1, 256, 4, 32, 64, 256), (1, 2048, 2, 64, 64, 1024),
                                   (1, 512, 4, 128, 128, 256), (2, 256, 4, 16, 16, 64),
                                   (1, 200, 3, 64, 40, 100)])
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

#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py          # from the root of a checkout, one card

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's main path -- ``simulate()`` with ``EcoSched(engine="torch",
device="cuda")`` -- on the paper's calibrated node (h100/a100/v100, and
h100 with a 4-level DVFS ladder), on the elastic resize path, and on a
pod-scale node (M=16, K=4) with an online backlog of synthetic jobs.
Every schedule must equal the numpy engine's (``engine="vector"``) bit
for bit, and every kernel of the path must have been launched.

Phases: 1 device and build, 2 kernels vs plain versions, 3 paper node,
4 elastic, 5 pod scale, 6 kernel timings.  The last two lines are the
kernels' JSON record and ``{"ok": true, "device": {...}}``.  Any failed
check raises and the exit code is non-zero; without a CUDA device, or
without the repository around it, the script exits 2 and prints no
result.  It imports nothing of JAX and nothing of the reference package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

LAM, TAU, NOISE, SEED = 0.35, 0.45, 0.02, 1
TOL = 1e-6  # kernel vs plain version; same float32 ops, so expected 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
H100_RATIOS, H100_FLOOR = (1.0, 0.86, 0.72, 0.58), 0.32
POD_JOBS = 240


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Seeded inputs (this script's own copies; nothing is read from disk)
# ---------------------------------------------------------------------------


def synth_specs(W, M, seed, levels=1):
    """Seeded window like ``benchmarks/bench_decision_overhead.synth_window``
    (sublinear speedups, power-law busy power), optionally over a DVFS
    ladder of ``levels`` frequency levels."""
    import numpy as np
    from repro_torch.core.perfmodel import _mk_spec

    rng = np.random.default_rng(seed)
    counts = [g for g in (1, 2, 3, 4, 6, 8, 12, 16) if g <= M]
    specs = []
    for i in range(W):
        a, b = float(rng.uniform(0.35, 0.95)), float(rng.uniform(0.6, 0.9))
        mu = float(rng.uniform(0.1, 0.75))
        t_hat, p_hat = {}, {}
        for g in counts:
            for f in range(levels):
                r = H100_RATIOS[f]
                key = g if levels == 1 else (g, f)
                t_hat[key] = 100.0 / g ** a * (mu + (1.0 - mu) / r)
                p_hat[key] = 300.0 * g ** b * (H100_FLOOR + (1 - H100_FLOOR) * r ** 3)
        specs.append(_mk_spec(f"job{i}", t_hat, p_hat))
    return specs


def node_view(M, K, busy=()):
    from repro_torch.core import NodeView, PlacementState

    st = PlacementState(M, K)
    for g in busy:
        st.allocate(g)
    return NodeView(t=0.0, total_units=M, domains=K, free_units=st.free_count(),
                    running=[object()] * len(busy), free_map=list(st.free),
                    domain_jobs=list(st.domain_jobs))


def pod_truth(n_jobs, M=16, levels=4, seed=7):
    """Seeded pod-scale ground truth and its online arrival stream."""
    import numpy as np
    from repro_torch.core import JobProfile

    rng = np.random.default_rng(seed)
    counts = [g for g in (1, 2, 3, 4, 6, 8, 12, 16) if g <= M]
    ratios = H100_RATIOS[:levels]
    truth, stream, t = {}, [], 0.0
    for i in range(n_jobs):
        name = f"job{i}"
        t1, a = float(rng.uniform(600.0, 6000.0)), float(rng.uniform(0.35, 0.95))
        p0, b = float(rng.uniform(250.0, 500.0)), float(rng.uniform(0.6, 0.9))
        mu = float(rng.uniform(0.1, 0.75))
        runtime = {g: t1 / g ** a for g in counts}
        truth[name] = JobProfile(
            name=name, runtime=runtime,
            busy_power={g: p0 * g ** b for g in counts},
            dram_util={g: 1.0 / (runtime[g] * g) for g in counts},
            freq_time={f: mu + (1.0 - mu) / r for f, r in enumerate(ratios)},
            freq_power={f: H100_FLOOR + (1.0 - H100_FLOOR) * r ** 3
                        for f, r in enumerate(ratios)},
        )
        stream.append((t, name))
        t += float(rng.exponential(120.0))
    return truth, stream


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version on the card
# ---------------------------------------------------------------------------


class Diff:
    def __init__(self):
        self.max_abs = {"score_reduce": 0.0, "score_reduce_multi": 0.0}
        self.cases = {"score_reduce": 0, "score_reduce_multi": 0}

    def scores(self, name, a, b, tag):
        import torch

        fa, fb = torch.isfinite(a), torch.isfinite(b)
        check(torch.equal(fa, fb), f"{name} {tag}: +inf pattern differs")
        if bool(fa.any()):
            d = float((a[fa] - b[fb]).abs().max())
            check(d <= TOL, f"{name} {tag}: max |diff| {d} > {TOL}")
            self.max_abs[name] = max(self.max_abs[name], d)
        self.cases[name] += 1


def solo_vs_plain(diff, cols, kw, tag):
    from repro_torch.kernels import score_reduce as K

    args = (cols["dev"], cols["g"], cols["n"])
    s_k, b_k = K.score_reduce(*args, **kw)
    s_p, b_p = K.score_reduce_plain(*args, **kw)
    check(b_k == b_p, f"score_reduce {tag}: winner {b_k} != plain {b_p}")
    diff.scores("score_reduce", s_k, s_p, tag)
    return s_k, b_k


def multi_vs_plain(diff, reqs, device, tag):
    import torch
    from repro_torch.kernels import score_reduce as K

    packed = K.pack_windows(reqs, device)
    s_k, b_k = K.score_reduce_multi(**packed)
    s_p, b_p = K.score_reduce_multi_plain(**packed)
    check(b_k == b_p, f"score_reduce_multi {tag}: winners {b_k} != {b_p}")
    diff.scores("score_reduce_multi", s_k, s_p, tag)
    off = packed["offsets"].tolist()
    for w, (lo, hi) in enumerate(zip(off, off[1:])):  # bitwise = solo
        sl = slice(lo, hi)
        kw = dict(lam=reqs[w]["lam"], g_free=reqs[w]["g_free"], M=reqs[w]["M"],
                  lam_f=reqs[w].get("lam_f", 0.0),
                  f=None if packed["f"] is None else packed["f"][sl],
                  bias=None if packed["bias"] is None else packed["bias"][sl],
                  mask=None if packed["mask"] is None else packed["mask"][sl])
        s_w, b_w = K.score_reduce(packed["dev"][sl], packed["g"][sl],
                                  packed["n"][sl], **kw)
        check(b_w == b_k[w], f"multi {tag} window {w}: {b_k[w]} != solo {b_w}")
        check(torch.equal(s_w, s_k[sl]), f"multi {tag} window {w}: not bitwise")


def phase_kernels(device) -> Diff:
    import numpy as np
    import torch
    from repro_torch.core import enumerate_scored

    diff = Diff()
    rng = np.random.default_rng(0)
    reqs, n_windows = [], 0
    for M, K in ((4, 2), (8, 2), (8, 4), (16, 4)):
        for W in (4, 5, 8, 17):
            for levels in (1, 4):
                for busy in ((), (M // 4,)):
                    view = node_view(M, K, busy)
                    specs = synth_specs(W, M, seed=M * 100 + W, levels=levels)
                    lam_f = 0.1 if levels > 1 else 0.0
                    batch = enumerate_scored(specs, view, list(view.free_map),
                                             lam=LAM, lam_f=lam_f)
                    cols = batch.device_cols(device, with_f=levels > 1)
                    B = len(batch)
                    bias = torch.from_numpy(
                        rng.uniform(0, 0.3, B).astype(np.float32)).to(device)
                    mask = torch.from_numpy(
                        (rng.uniform(size=B) > 0.3).astype(np.float32)).to(device)
                    kw = dict(lam=LAM, g_free=view.free_units, M=M, f=cols["f"],
                              lam_f=lam_f)
                    tag = f"M{M}K{K}W{W}L{levels}b{len(busy)}"
                    _, best = solo_vs_plain(diff, cols, kw, tag)
                    if levels == 1:  # the float32 winner is the engine's
                        check(batch.total_g[best] == batch.total_g[batch.best_index()],
                              f"{tag}: kernel winner off the engine's frontier")
                    solo_vs_plain(diff, cols, dict(kw, bias=bias, mask=mask), tag + "+bm")
                    solo_vs_plain(diff, cols, dict(kw, mask=cols["nonempty"]), tag + "+ne")
                    dead = torch.zeros_like(cols["n"])
                    _, b_dead = solo_vs_plain(diff, cols, dict(kw, mask=dead), tag + "+dead")
                    check(b_dead == -1, f"{tag}: all-infeasible gave {b_dead}")
                    dev, g, n = batch.padded_cols()
                    reqs.append(dict(dev=dev, g=g, n=n, lam=LAM + 0.01 * n_windows,
                                     g_free=view.free_units, M=M,
                                     f=batch.padded_f() if levels > 1 else None,
                                     lam_f=lam_f, mask=(n > 0)))
                    n_windows += 1
    S_max = max(r["dev"].shape[1] for r in reqs)
    empty = dict(dev=np.zeros((0, S_max), np.float32), g=np.zeros((0, S_max), np.float32),
                 n=np.zeros(0, np.float32), lam=LAM, g_free=4, M=4)
    dead = dict(reqs[3], mask=np.zeros(len(reqs[3]["n"]), bool))
    multi = [empty] + reqs[:40] + [dead, empty] + reqs[40:]
    multi_vs_plain(diff, multi, device, "engine windows")
    # synthetic blocks around the 256-row block edge and far beyond it
    for B in (1, 255, 256, 257, 6181, 50000):
        for S in (1, 2, 4, 8):
            n = rng.integers(0, S + 1, B).astype(np.float32)
            slot = np.arange(S)[None, :] < n[:, None]
            planes = [np.where(slot, x, 0).astype(np.float32) for x in (
                rng.uniform(0, 2, (B, S)), rng.integers(1, 5, (B, S)),
                rng.integers(0, 4, (B, S)))]
            dev, g, f = (torch.from_numpy(p).to(device) for p in planes)
            cols = dict(dev=dev, g=g, n=torch.from_numpy(n).to(device))
            mask = torch.from_numpy((rng.uniform(size=B) > 0.2).astype(np.float32)).to(device)
            bias = torch.from_numpy(rng.uniform(0, 0.1, B).astype(np.float32)).to(device)
            tag = f"B{B}S{S}"
            kw = dict(lam=LAM, g_free=16, M=16)
            solo_vs_plain(diff, cols, kw, tag)
            solo_vs_plain(diff, cols, dict(kw, f=f, lam_f=0.1, bias=bias, mask=mask), tag + "+fbm")
            if B == 257:
                _, b_dead = solo_vs_plain(diff, cols, dict(kw, mask=torch.zeros_like(mask)),
                                          tag + "+dead")
                check(b_dead == -1, f"{tag}: all-infeasible gave {b_dead}")
        if B in (257, 6181):
            parts = np.split(np.arange(B), [B // 3, B // 3, 2 * B // 3])  # one empty
            wreqs = [dict(dev=planes[0][p], g=planes[1][p], n=n[p], f=planes[2][p],
                          lam=LAM, g_free=16, M=16, lam_f=0.1) for p in parts]
            multi_vs_plain(diff, wreqs, device, f"B{B} split")
    z = torch.zeros((0, 4), device=device)
    s0, b0 = solo_vs_plain(diff, dict(dev=z, g=z, n=torch.zeros(0, device=device)),
                           dict(lam=LAM, g_free=4, M=4), "B0")
    check(b0 == -1 and s0.numel() == 0, "B=0 must give (empty, -1)")
    if device.type == "cuda":  # a fault during the runs surfaces here
        torch.cuda.synchronize()
    return diff


# ---------------------------------------------------------------------------
# Phases 3-5: the main path
# ---------------------------------------------------------------------------


def timed_policy_class():
    from repro_torch.core import EcoSched

    class TimedEcoSched(EcoSched):
        """EcoSched that records each decision's host time and keeps the
        largest kernel inputs the run produced (for phase 6)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.times = []
            self.largest = None  # (rows, batch, g_free, M, lam_f)
            self.largest_multi = None  # (rows, reqs)

        def on_event(self, view, waiting):
            t0 = time.perf_counter()
            out = super().on_event(view, waiting)
            self.times.append(time.perf_counter() - t0)
            dec = self._last_decision
            if dec is not None and (self.largest is None or len(dec[0]) > self.largest[0]):
                self.largest = (len(dec[0]), dec[0], view.free_units,
                                view.alive_units, self.lam_f)
            return out

        def _resize_requests(self, cands, switch_cost):
            reqs = super()._resize_requests(cands, switch_cost)
            rows = sum(len(r["n"]) for r in reqs)
            if self.largest_multi is None or rows > self.largest_multi[0]:
                self.largest_multi = (rows, reqs)
            return reqs

    return TimedEcoSched


class MainPath:
    """What the main-path phases launched (summed over their torch runs)
    and the largest kernel inputs they produced."""

    def __init__(self):
        self.launches = {k: {"launches": 0, "rows": 0, "max_rows": 0}
                         for k in ("score_reduce", "score_reduce_multi")}
        self.solo = None  # (rows, batch, g_free, M, lam_f)
        self.multi = None  # (rows, reqs)
        self.pod = None  # the pod run's largest solo inputs

    def add(self, stats, pol):
        for name, st in stats.items():
            tot = self.launches[name]
            tot["launches"] += st["launches"]
            tot["rows"] += st["rows"]
            tot["max_rows"] = max(tot["max_rows"], st["max_rows"])
        if pol.largest and (self.solo is None or pol.largest[0] > self.solo[0]):
            self.solo = pol.largest
        if pol.largest_multi and (self.multi is None
                                  or pol.largest_multi[0] > self.multi[0]):
            self.multi = pol.largest_multi


def fp(res):
    import hashlib

    s = ";".join(f"{r.job}|{r.g}|{r.f}|{r.start!r}|{r.end!r}|{r.domain}|{r.kind}"
                 for r in res.records)
    return hashlib.md5(s.encode()).hexdigest(), res.makespan, res.total_energy


def run_pair(truth, node, *, sim_kw, pol_kw, device, label, path,
             noise=NOISE, seed=SEED):
    """One workload through the torch engine (on ``device``) and the numpy
    engine; checks the schedules are identical and the result sane.  The
    launch counts are set to 0 just before the torch run and read just
    after it."""
    import math
    from repro_torch.core import ProfiledPerfModel, simulate
    from repro_torch.kernels import score_reduce as K

    Timed = timed_policy_class()
    out = {}
    for engine in ("torch", "vector"):
        extra = {"device": device} if engine == "torch" else {}
        pol = Timed(ProfiledPerfModel(truth, noise=noise, seed=seed), lam=LAM, tau=TAU,
                    engine=engine, **extra, **pol_kw)
        if engine == "torch":
            K.reset_stats()
        res = simulate(pol, node, truth, **sim_kw)
        if engine == "torch":
            kstats = {k: dict(launches=v.launches, rows=v.rows, max_rows=v.max_rows)
                      for k, v in K.STATS.items()}
            path.add(kstats, pol)
        out[engine] = (res, pol)
    (rt, pt), (rv, pv) = out["torch"], out["vector"]
    check(fp(rt) == fp(rv), f"{label}: torch schedule differs from vector {fp(rt)} {fp(rv)}")
    check(math.isfinite(rt.total_energy) and rt.total_energy > 0 and rt.makespan > 0,
          f"{label}: energy/makespan not finite and positive")
    jobs = {a for _, a in sim_kw["arrivals"]} if "arrivals" in sim_kw else set(sim_kw["queue"])
    check({r.job for r in rt.records if r.kind == "run"} == jobs, f"{label}: not all jobs ran")
    print(f"  {label}: fp={fp(rt)[0]} makespan={rt.makespan!r} energy={rt.total_energy!r} "
          f"decisions={len(pt.times)} "
          f"launches={ {k: v['launches'] for k, v in kstats.items()} }")
    return rt, pt, pv, kstats


def phase_paper(device, path):
    from repro_torch.core import Node, SequentialOptimal, simulate, summarize
    from repro_torch.core import calibration as C

    for system, levels, lam_f in (("h100", 1, 0.0), ("a100", 1, 0.0),
                                  ("v100", 1, 0.0), ("h100", 4, 0.1)):
        truth = C.build_system(system, freq_levels=levels)
        node = Node(4, 2, C.idle_power(system))
        base = simulate(SequentialOptimal(truth), node, truth, queue=list(C.APP_ORDER))
        label = f"{system} freq_levels={levels} lam_f={lam_f}"
        rt, _, _, st = run_pair(
            truth, node, device=device, label=label, path=path,
            pol_kw=dict(lam_f=lam_f),
            sim_kw=dict(queue=list(C.APP_ORDER), charge_profiling=True,
                        slowdown_model=C.cross_numa_slowdown),
        )
        check(st["score_reduce"]["launches"] > 0, f"{label}: no score_reduce launch")
        s = summarize(base, rt)
        print(f"  {label} vs sequential_optimal_gpu: energy_saving={s['energy_saving']!r} "
              f"makespan_improvement={s['makespan_improvement']!r} "
              f"edp_saving={s['edp_saving']!r}")
        if levels > 1:
            check(any(r.f > 0 for r in rt.records), "DVFS run chose no lower level")


def phase_elastic(device, path):
    from repro_torch.core import ElasticConfig, JobProfile, Node
    from repro_torch.core import calibration as C

    truth = C.build_system("h100", freq_levels=3)
    stream = [(120.0 * i, a) for i, a in enumerate(C.APP_ORDER)]
    for batched in (True, False):
        _, _, _, st = run_pair(
            truth, Node(4, 2, C.idle_power("h100")), device=device, path=path,
            label=f"h100 DVFS elastic resize_batch={batched}",
            pol_kw=dict(resize_batch=batched),
            sim_kw=dict(arrivals=stream, slowdown_model=C.cross_numa_slowdown,
                        elastic=ElasticConfig(resize=True)),
        )
        if batched:
            check(st["score_reduce_multi"]["launches"] > 0,
                  "batched elastic run launched no score_reduce_multi")
    # a pair where a completion makes the co-runner's upsize worth it
    pair = {
        "A": ({1: 3500.0, 2: 2000.0, 3: 1600.0, 4: 1450.0},
              {1: 140.0, 2: 250.0, 3: 330.0, 4: 380.0}),
        "B": ({1: 1050.0, 2: 600.0, 4: 435.0}, {1: 140.0, 2: 250.0, 4: 380.0}),
    }
    truth = {k: JobProfile(name=k, runtime=t, busy_power=p,
                           dram_util={g: 1.0 / (t[g] * g) for g in t})
             for k, (t, p) in pair.items()}
    cfg = ElasticConfig(resize=True, ckpt_time=30.0, restart_time=15.0, min_gain_s=60.0)
    for batched in (True, False):
        rt, _, _, _ = run_pair(
            truth, Node(4, 2, 10.0), device=device, path=path,
            label=f"resize pair resize_batch={batched}", noise=0.0, seed=0,
            pol_kw=dict(resize_batch=batched), sim_kw=dict(queue=["A", "B"], elastic=cfg),
        )
        check(rt.resizes > 0, "resize pair did not resize")


def phase_pod(device, path):
    from repro_torch.core import Node

    truth, stream = pod_truth(POD_JOBS)
    _, pt, pv, kstats = run_pair(
        truth, Node(16, 4, 70.0), device=device, path=path,
        label=f"pod M=16 K=4 jobs={POD_JOBS} levels=4 window=17",
        pol_kw=dict(window=17), sim_kw=dict(arrivals=stream),
    )
    st = kstats["score_reduce"]
    n_launch = st["launches"]
    check(n_launch > 0, "pod run launched no score_reduce")
    med_t = statistics.median(pt.times) * 1e6
    med_v = statistics.median(pv.times) * 1e6
    print(f"  pod: decisions={len(pt.times)} kernel_launches={n_launch} "
          f"rows_per_launch max={st['max_rows']} "
          f"mean={st['rows'] / n_launch!r} median_us_per_decision torch={med_t!r} "
          f"vector={med_v!r} launch_hits={pt.launch_hits} frontier_hits={pt.frontier_hits}")
    path.pod = pt.largest


# ---------------------------------------------------------------------------
# Phase 6: times at the main path's largest shapes
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps):
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def host_us(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e6


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_solo(device, B, batch, g_free, M, lam_f):
    """Times of ``score_reduce`` on one main-path batch: back-to-back raw
    launches between CUDA events (``ms``, device time per launch pair),
    the plain version (``plain_ms``), and the wrapper's host-clock call
    time including its one D2H read (``call_us``)."""
    import ctypes

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import score_reduce as K

    lib = _build.library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    cols = batch.device_cols(device, with_f=bool(lam_f))
    S = cols["dev"].shape[1]
    f = cols["f"]
    kw = dict(lam=LAM, g_free=g_free, M=M, f=f, lam_f=lam_f)
    nb = -(-B // 256)
    scores = torch.empty(B, device=device)
    scratch = [torch.empty(nb, device=device), torch.empty(nb, device=device),
               torch.empty(nb, dtype=torch.int32, device=device),
               torch.empty(1, dtype=torch.int32, device=device)]

    def raw():
        err = lib.score_reduce_launch(
            cols["dev"].data_ptr(), cols["g"].data_ptr(),
            None if f is None else f.data_ptr(), cols["n"].data_ptr(), None, None,
            B, S, LAM, float(g_free), float(M), float(lam_f),
            scores.data_ptr(), *[t.data_ptr() for t in scratch], stream)
        check(err == 0, f"raw score_reduce launch error {err}")

    args = (cols["dev"], cols["g"], cols["n"])
    planes = 2 + (f is not None)
    n_bytes = 4 * (planes * B * S + B) + 4 * B + 4  # planes, n in; scores, best out
    bms, bby = bound_ms(n_bytes, B * (3 * S + 9))
    return dict(
        B=B, S=S, ms=cuda_ms(raw, 2000),
        plain_ms=cuda_ms(lambda: K.score_reduce_plain(*args, **kw), 200),
        call_us=host_us(lambda: K.score_reduce(*args, **kw), 2000),
        bound_ms=bms, bound_by=bby,
    )


def time_multi(device, rows, reqs):
    """The same three times for ``score_reduce_multi`` on one main-path
    request list (packing and upload stay outside the timed launches)."""
    import ctypes

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import score_reduce as K

    lib = _build.library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = K.pack_windows(reqs, device)
    W, S = p["params"].shape[0], p["dev"].shape[1]
    out_s = torch.empty(rows, device=device)
    out_b = torch.empty(W, dtype=torch.int32, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def raw():
        err = lib.score_reduce_multi_launch(
            ptr(p["dev"]), ptr(p["g"]), ptr(p["f"]), ptr(p["n"]), ptr(p["bias"]),
            ptr(p["mask"]), ptr(p["offsets"]), ptr(p["params"]), W, S,
            out_s.data_ptr(), out_b.data_ptr(), stream)
        check(err == 0, f"raw score_reduce_multi launch error {err}")

    planes = 2 + (p["f"] is not None)
    cols_in = 1 + (p["bias"] is not None) + (p["mask"] is not None)
    n_bytes = 4 * (planes * rows * S + cols_in * rows + 4 * W + W + 1) + 4 * (rows + W)
    bms, bby = bound_ms(n_bytes, rows * (3 * S + 9))
    return dict(
        B=rows, S=S, W=W, ms=cuda_ms(raw, 2000),
        plain_ms=cuda_ms(lambda: K.score_reduce_multi_plain(**p), 100),
        call_us=host_us(lambda: K.score_reduce_multi(**p), 2000),
        bound_ms=bms, bound_by=bby,
    )


def profiled(fn):
    """Run ``fn`` under ``torch.profiler`` (CPU + CUDA); returns the host
    wall seconds and the key averages of everything that ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, prof.key_averages()


def device_kernels(avgs):
    """{name: (count, device µs in total)} of the device-side entries."""
    return {e.key: (e.count, e.self_device_time_total) for e in avgs
            if e.self_device_time_total > 0}


def profile_lines(device, path):
    """Device time of each kernel per launch, the wrapper's host time by
    operation, and the pod run's device busy share, all from the profiler
    (printed; "not measured" when it saw no device activity)."""
    from repro_torch.core import Node, ProfiledPerfModel, simulate
    from repro_torch.kernels import score_reduce as K

    B, batch, g_free, M, lam_f = path.solo
    cols = batch.device_cols(device, with_f=bool(lam_f))
    kw = dict(lam=LAM, g_free=g_free, M=M, f=cols["f"], lam_f=lam_f)
    args = (cols["dev"], cols["g"], cols["n"])
    reps = 200
    packed = K.pack_windows(path.multi[1], device)

    def calls():
        for _ in range(reps):
            K.score_reduce(*args, **kw)
            K.score_reduce_multi(**packed)

    _, avgs = profiled(calls)
    dev = device_kernels(avgs)
    if not dev:
        print("  profiler: no device time seen; kernel device us not measured")
    for name, (count, us) in sorted(dev.items()):
        print(f"  profiler device: {name[:60]} count={count} us_per_launch={us / count!r}")
    top = sorted(avgs, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    print("  profiler host, per wrapper pair: " + ", ".join(
        f"{e.key}={e.self_cpu_time_total / reps!r}us" for e in top))

    truth, stream = pod_truth(POD_JOBS)
    pol = timed_policy_class()(ProfiledPerfModel(truth, noise=NOISE, seed=SEED),
                               lam=LAM, tau=TAU, engine="torch", device=device,
                               window=17)
    wall, avgs = profiled(lambda: simulate(pol, Node(16, 4, 70.0), truth, arrivals=stream))
    busy = sum(us for _, us in device_kernels(avgs).values()) * 1e-6
    if busy > 0:
        print(f"  pod run under the profiler: wall_s={wall!r} device_busy_s={busy!r} "
              f"idle_share={1.0 - busy / wall!r}")
    else:
        print("  pod run under the profiler: device busy share not measured")


def phase_timings(device, path, diff):
    import torch

    t = time_solo(device, *path.pod)
    print(f"  pod run's largest score_reduce: B={t['B']} S={t['S']} "
          f"kernel_ms={t['ms']!r} wrapper_call_us={t['call_us']!r}")
    rows = {"score_reduce": time_solo(device, *path.solo),
            "score_reduce_multi": time_multi(device, *path.multi)}
    replaces = {"score_reduce": "src/repro/kernels/score_reduce.py:138",
                "score_reduce_multi": "src/repro/kernels/score_reduce.py:374"}
    kernels = []
    for name, t in rows.items():
        print(f"  {name} at B={t['B']} S={t['S']}{' W=%d' % t['W'] if 'W' in t else ''}: "
              f"kernel_ms={t['ms']!r} plain_ms={t['plain_ms']!r} "
              f"wrapper_call_us={t['call_us']!r} (with its D2H read) "
              f"bound_ms={t['bound_ms']!r} ({t['bound_by']})")
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/score_reduce.cu",
            replaces=replaces[name], launches=path.launches[name]["launches"],
            max_abs_err=diff.max_abs[name], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None))

    # the launch-latency floor: two tiny launches and one int read back
    x = torch.zeros(1, dtype=torch.int32, device=device)

    def floor():
        x.add_(1)
        x.add_(1)
        return x.item()

    print(f"  floor (two 1-element launches + one D2H int read): "
          f"call_us={host_us(floor, 2000)!r}")
    profile_lines(device, path)
    return kernels


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch package under {SRC}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = smi()
    print("== phase 1: device and build")
    print(f"  nvidia-smi: {card}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"  kernels built in {build_s:.3f} s ({'cached' if cached else 'fresh'}) "
          f"-> {_build.library_path().relative_to(ROOT)}")
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("build_s"):
            print(f"  ptxas: {line.strip()}")

    print("== phase 2: kernels vs plain versions on the card")
    diff = phase_kernels(device)
    print(f"  cases={diff.cases} max_abs_err={diff.max_abs}")

    path = MainPath()
    print("== phase 3: main path, paper node")
    phase_paper(device, path)
    print("== phase 4: main path, elastic")
    phase_elastic(device, path)
    print("== phase 5: main path, pod scale")
    phase_pod(device, path)
    for name, st in path.launches.items():
        check(st["launches"] > 0, f"{name} was never launched on the main path")
    print(f"  main-path launches: {path.launches}")

    print("== phase 6: kernel times at the main path's largest shapes")
    kernels = phase_timings(device, path, diff)
    print(f"  total_s={time.perf_counter() - t_start:.1f}")
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Port parity of the fleet path: ``Cluster`` / ``ClusterRun`` over many
nodes, each running ``EcoSched``.

The port's policies run ``engine="torch", device="cpu"`` (the kernels'
plain versions, with the cross-node staging of ``score_reduce_batch`` and
``score_reduce_multi``); the reference runs ``engine="jax"`` (its jnp
``ref`` path) and ``engine="vector"`` on the same inputs carried across as
plain data.  Pass condition: identical schedules (job, node, count,
frequency level, start, end, kind, segment), makespan and total energy,
bit for bit.  Mirrors the staged-versus-solo locks of tests/test_fleet.py
and tests/test_resize_batch.py.
"""
import pytest

torch = pytest.importorskip("torch")

from test_resize_batch import synth as resize_synth  # noqa: E402
from torch_parity import carry_profiles  # noqa: E402

from repro import core as RCORE  # noqa: E402
from repro.core import calibration as RC  # noqa: E402
from repro.core.events import EVT_ARRIVAL as R_EVT_ARRIVAL  # noqa: E402
from repro.roofline import hw as RHW  # noqa: E402
from repro_torch import core as PCORE  # noqa: E402
from repro_torch.core import calibration as PC  # noqa: E402
from repro_torch.core import carry  # noqa: E402
from repro_torch.core.events import EVT_ARRIVAL as P_EVT_ARRIVAL  # noqa: E402
from repro_torch.kernels import score_reduce as PK  # noqa: E402
from repro_torch.roofline import hw as PHW  # noqa: E402

LAM, TAU = 0.35, 0.45
PKG = {"port": (PCORE, PC, PHW, P_EVT_ARRIVAL), "ref": (RCORE, RC, RHW, R_EVT_ARRIVAL)}


@pytest.fixture(autouse=True)
def _reference_ref_path(monkeypatch):
    # the reference's engine="jax" off-TPU: its pure-jnp path
    monkeypatch.setenv("REPRO_KERNELS", "ref")


def schedule_of(res):
    recs = sorted(
        (r.job, r.node, r.g, r.f, r.start, r.end, r.kind, r.segment)
        for r in res.records
    )
    return recs, res.makespan, res.total_energy


def engine_kw(side, engine):
    if side == "port":
        assert engine in ("torch", "vector")
        return dict(engine=engine, device="cpu") if engine == "torch" else dict(engine=engine)
    return dict(engine=engine)


def make_cluster(side, engine, dispatcher, *, truth_for, chips, n, units=4,
                 policies=None, slowdown=False, noise=0.02, **pol_kw):
    """A fleet of ``n`` nodes named in index order, chip ``chips(i)``."""
    pkg, C, hw, _ = PKG[side]

    def policy_for(spec, truth):
        pol = pkg.EcoSched(
            pkg.ProfiledPerfModel(truth, noise=noise, seed=1),
            lam=LAM, tau=TAU, **engine_kw(side, engine), **pol_kw,
        )
        if policies is not None:
            policies.append(pol)
        return pol

    return pkg.Cluster(
        [pkg.NodeSpec(f"n{i:03d}", getattr(hw, chips(i)), units=units, domains=2)
         for i in range(n)],
        truth_for=truth_for,
        policy_for=policy_for,
        dispatcher=dispatcher,
        slowdown_for=(lambda s: C.cross_numa_slowdown) if slowdown else None,
    )


def paper_truth(side):
    """The paper's calibrated app tables per chip, built by the reference
    and carried across for the port."""
    ref = {c: RC.build_system(c) for c in ("h100", "a100", "v100")}
    tables = ref if side == "ref" else {c: carry_profiles(t) for c, t in ref.items()}
    return lambda spec: tables[spec.chip.name]


def streams(apps, *, rate, n, seed, burst):
    """The reference's bursty stream and its port twin (plain rows)."""
    ref = RCORE.bursty_stream(list(apps), rate=rate, n=n, seed=seed, burst=burst)
    port = carry.arrivals_from_tuples([(a.name, a.app, a.t) for a in ref])
    return {"ref": ref, "port": port}


def dispatcher(side, name, hier):
    pkg = PKG[side][0]
    inner = {
        "rr": pkg.RoundRobinDispatcher,
        "ll": pkg.LeastLoadedDispatcher,
        "eco": pkg.EnergyAwareDispatcher,
        "predictive": pkg.PredictiveDispatcher,
    }[name]()
    if hier:
        return pkg.HierarchicalDispatcher(inner, pod_size=4, pods_per_region=2)
    return inner


def run_solo(cl, stream, side, **kw):
    """``Cluster.simulate`` with both fleet staging hooks detached: every
    node decision launches its own reduction."""
    evt = PKG[side][3]
    stream = sorted(stream, key=lambda a: a.t)
    run = cl.open_run(apps=sorted({a.app for a in stream}),
                      jobs=[(a.name, a.app) for a in stream], **kw)
    run.loop.prepare_batch = None
    run.loop.prepare_complete = None
    for a in stream:
        if a.t <= 0.0:
            run.route(a, 0.0)
        else:
            run.loop.queue.push(a.t, evt, a)
    run.loop.run()
    return run.finalize()


# ---------------------------------------------------------------------------
# Dispatch: every dispatcher, flat and hierarchical, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hier", [False, True], ids=["flat", "hier"])
@pytest.mark.parametrize("disp", ["rr", "ll", "eco", "predictive"])
def test_dispatch_matches_reference(disp, hier):
    """12 heterogeneous nodes, 48 bursty jobs: the port's torch fleet, the
    reference's vector fleet and the port's flat dispatch give one
    schedule."""
    st = streams(RC.APP_ORDER, rate=0.25, n=48, seed=13, burst=6)
    out = {}
    for side, engine in (("port", "torch"), ("ref", "vector")):
        cl = make_cluster(side, engine, dispatcher(side, disp, hier),
                          truth_for=paper_truth(side),
                          chips=lambda i: ("H100", "A100", "V100")[i % 3],
                          n=12, slowdown=True)
        out[side] = schedule_of(cl.simulate(st[side]))
    flat = make_cluster("port", "torch", dispatcher("port", disp, False),
                        truth_for=paper_truth("port"),
                        chips=lambda i: ("H100", "A100", "V100")[i % 3],
                        n=12, slowdown=True)
    out["port-flat"] = schedule_of(flat.simulate(st["port"]))
    assert out["port"] == out["ref"] == out["port-flat"]


def test_ragged_pods_match_reference_at_forty_nodes():
    """40 nodes in pods of 16 (the last one short), 160 jobs: the fleet
    cell's geometry at the smallest size the reference's bench runs."""
    apps = [f"app{i}" for i in range(8)]
    from benchmarks.bench_fleet import synth_apps

    ref_t = {c.name: synth_apps(c) for c in (RHW.H100, RHW.A100, RHW.V100)}
    tables = {"ref": ref_t, "port": {k: carry_profiles(v) for k, v in ref_t.items()}}
    st = streams(apps, rate=1.2, n=160, seed=7, burst=16)
    out, served = {}, 0
    for side, engine in (("port", "torch"), ("ref", "jax"), ("ref", "vector")):
        pkg = PKG[side][0]
        pols = []
        cl = make_cluster(
            side, engine,
            pkg.HierarchicalDispatcher(pkg.EnergyAwareDispatcher(), pod_size=16,
                                       pods_per_region=8),
            truth_for=lambda s, t=tables[side]: t[s.chip.name],
            chips=lambda i: ("H100", "A100", "V100")[(i // 16) % 3],
            n=40, units=8, noise=0.0, policies=pols, window=8,
        )
        out[(side, engine)] = schedule_of(cl.simulate(st[side]))
        if side == "port":
            served = sum(p.stage_served for p in pols)
    assert len(set(map(str, out.values()))) == 1
    assert served > 0  # decisions were served from cross-node batches


# ---------------------------------------------------------------------------
# Cross-node batched decisions: staging is pure
# ---------------------------------------------------------------------------


def h100_fleet(side, engine, policies=None, dispatcher_name="rr"):
    return make_cluster(side, engine, dispatcher(side, dispatcher_name, False),
                        truth_for=paper_truth(side), chips=lambda i: "H100",
                        n=4, units=8, noise=0.0, policies=policies)


@pytest.mark.parametrize("faulty", [False, True], ids=["no-faults", "faults"])
def test_batched_matches_solo_and_reference(faulty):
    """Same-instant multi-node bursts go through one ``score_reduce_batch``
    call; the schedule equals per-node solo reductions and the
    reference's jax fleet, with and without capacity events between
    staging and consumption."""
    n, seed = (40, 23) if faulty else (48, 21)
    st = streams(RC.APP_ORDER, rate=0.25, n=n, seed=seed, burst=6)
    kw = {}
    if faulty:
        fc = dict(seed=4, node_mtbf_s=4000.0, node_mttr_s=600.0,
                  degrade_frac=0.5, degrade_units=4, job_mtbf_s=9000.0)
        kw = {side: dict(faults=PKG[side][0].FaultConfig(**fc)) for side in PKG}
    pols = []
    batched = h100_fleet("port", "torch", pols).simulate(st["port"], **kw.get("port", {}))
    assert sum(p.stage_served for p in pols) > 0  # the batch path ran
    solo = run_solo(h100_fleet("port", "torch"), st["port"], "port", **kw.get("port", {}))
    ref = h100_fleet("ref", "jax").simulate(st["ref"], **kw.get("ref", {}))
    assert schedule_of(batched) == schedule_of(solo) == schedule_of(ref)
    if faulty:
        assert batched.node_failures > 0


def _stage_round_trip(pol, view, jobs):
    """The coordinator's protocol for one node, through the port's batch
    wrapper (a one-node call; an idle node's guard rides in it)."""
    req = pol.stage_score(view, jobs)
    assert req is not None
    out = PK.score_reduce_batch(**PK.pack_windows([req], pol.device))
    pol.stage_round1(out[1][0], out[2][0] if len(out) > 2 else -1)


def test_stale_staging_refits_on_capacity_change():
    """A staged result whose node degraded between staging and
    consumption is discarded and the decision recomputes against the
    degraded view; an unchanged view consumes it."""
    truth = PC.build_system("h100")
    jobs = list(PC.APP_ORDER)[:4]

    def fresh():
        return PCORE.EcoSched(PCORE.ProfiledPerfModel(truth, noise=0.0, seed=1),
                              lam=LAM, tau=TAU, device="cpu")

    view = PCORE.NodeView(t=0.0, total_units=8, domains=2, free_units=8,
                          running=[], free_map=[True] * 8, domain_jobs=[0, 0])
    degraded = PCORE.NodeView(
        t=0.0, total_units=8, domains=2, free_units=4, running=[],
        free_map=[True] * 4 + [False] * 4, domain_jobs=[0, 0], dead_units=4,
    )
    pol = fresh()
    _stage_round_trip(pol, view, jobs)
    out = pol.on_event(degraded, jobs)
    assert pol.stage_served == 0  # stale staging was not consumed
    assert out == fresh().on_event(degraded, jobs)
    assert all(ln.g <= 4 for ln in out)

    pol2 = fresh()
    _stage_round_trip(pol2, view, jobs)
    assert pol2.on_event(view, jobs) == fresh().on_event(view, jobs)
    assert pol2.stage_served == 1


def test_stage_score_declines_when_no_kernel_would_run():
    truth = PC.build_system("h100")
    view = PCORE.NodeView(t=0.0, total_units=8, domains=2, free_units=8,
                          running=[], free_map=[True] * 8, domain_jobs=[0, 0])
    pm = PCORE.ProfiledPerfModel(truth, noise=0.0, seed=1)
    assert PCORE.EcoSched(pm, engine="vector").stage_score(
        view, list(PC.APP_ORDER)[:2]) is None
    pol = PCORE.EcoSched(pm, device="cpu")
    assert pol.stage_score(view, []) is None  # empty window
    jobs = list(PC.APP_ORDER)[:2]
    pol.on_event(view, jobs)  # primes the launch memo
    assert pol.stage_score(view, jobs) is None
    assert pol.stage_resize(view, frac_of=lambda r: 0.0,
                            cfg=PCORE.ElasticConfig(resize=True)) is None


# ---------------------------------------------------------------------------
# COMPLETE bursts: batched resize tables and staged completions
# ---------------------------------------------------------------------------


def resize_fleet(side, engine, resize_batch, staged, *, faults=None,
                 dvfs=False, lam_f=0.0, policies=None):
    """tests/test_resize_batch.py's anchor+grow fleet (12 nodes, 80 jobs,
    submitted through ``ClusterRun.submit``)."""
    pkg, _, hw, _ = PKG[side]
    ref_t = {c.name: resize_synth(c, dvfs=dvfs) for c in (RHW.H100, RHW.A100)}
    truth = ref_t if side == "ref" else {k: carry_profiles(v) for k, v in ref_t.items()}
    apps = [f"app{i}" for i in range(6)]
    cl = make_cluster(
        side, engine,
        pkg.HierarchicalDispatcher(pkg.EnergyAwareDispatcher(), pod_size=4,
                                   pods_per_region=2),
        truth_for=lambda s: truth[s.chip.name],
        chips=lambda i: ("H100", "A100")[(i // 4) % 2], n=12, units=8,
        noise=0.0, policies=policies, lam_f=lam_f, window=8,
        resize_batch=resize_batch,
    )
    run = cl.open_run(apps=apps, faults=faults,
                      elastic=pkg.ElasticConfig(resize=True,
                                                resize_before_backfill=True))
    if not staged:
        run.loop.prepare_batch = None
        run.loop.prepare_complete = None
    for k, a in enumerate(RCORE.bursty_stream(apps, rate=0.6, n=80, seed=7, burst=12)):
        run.submit(f"j{k}", a.app, a.t)
    run.run_to_completion()
    return run.finalize()


def test_complete_bursts_match_reference_and_solo():
    """Batched resize tables and staged COMPLETE bursts reproduce the
    reference's per-job loop record for record, and the staged path
    actually serves resize decisions."""
    ref = schedule_of(resize_fleet("ref", "vector", False, False))
    pols = []
    res = resize_fleet("port", "torch", True, True, policies=pols)
    assert schedule_of(res) == ref
    assert res.resizes > 0
    assert sum(p.resize_stage_served for p in pols) > 0
    for rb, st in ((True, False), (False, False)):
        assert schedule_of(resize_fleet("port", "torch", rb, st)) == ref, (rb, st)
    assert schedule_of(resize_fleet("ref", "jax", True, True)) == ref


def test_complete_bursts_under_faults_match_reference():
    fc = dict(seed=11, node_mtbf_s=40_000.0, node_mttr_s=8_000.0, degrade_frac=0.5)
    solo = resize_fleet("ref", "vector", False, False, faults=RCORE.FaultConfig(**fc))
    batched = resize_fleet("port", "torch", True, True, faults=PCORE.FaultConfig(**fc))
    assert solo.node_failures > 0
    assert schedule_of(batched) == schedule_of(solo)


def test_complete_bursts_with_dvfs_retunes_match_reference_jax():
    """(count, frequency) retunes: the port's float32 kernels break exact
    DVFS score ties as the reference's float32 jax path does."""
    kw = dict(dvfs=True, lam_f=0.25)
    ref = resize_fleet("ref", "jax", True, True, **kw)
    port = resize_fleet("port", "torch", True, True, **kw)
    solo = resize_fleet("port", "torch", False, False, **kw)
    assert schedule_of(port) == schedule_of(ref) == schedule_of(solo)
    assert any(r.f != 0 for r in port.records)


def test_idle_guard_rides_in_one_packed_call_per_burst(monkeypatch):
    """Arrival and completion bursts that reach idle nodes make one packed
    call each, the idle nodes' guards inside it (counted by stand-ins for
    the launches), and the schedule is the reference's record for
    record."""
    import repro_torch.core.cluster as CL

    bursts = []  # (kind, [guarded segments of each packed call])
    for name in ("score_reduce_batch", "score_reduce_multi"):
        def counting(*a, _real=getattr(CL, name), **kw):
            bursts[-1][1].append(kw.get("guarded", 0) if kw.get("guard") is not None else 0)
            return _real(*a, **kw)

        monkeypatch.setattr(CL, name, counting)
    for meth, kind in (("_stage_arrival_batch", "arrival"),
                       ("_stage_complete_batch", "complete")):
        def staging(self, *a, _real=getattr(CL.ClusterRun, meth), _kind=kind, **kw):
            bursts.append((_kind, []))
            return _real(self, *a, **kw)

        monkeypatch.setattr(CL.ClusterRun, meth, staging)
    pols = []
    ref = schedule_of(resize_fleet("ref", "vector", False, False))
    assert schedule_of(resize_fleet("port", "torch", True, True, policies=pols)) == ref
    # the 256-node cell's geometry at 40 nodes (test above)
    from benchmarks.bench_fleet import synth_apps

    ref_t = {c.name: synth_apps(c) for c in (RHW.H100, RHW.A100, RHW.V100)}
    tables = {"ref": ref_t, "port": {k: carry_profiles(v) for k, v in ref_t.items()}}
    st = streams([f"app{i}" for i in range(8)], rate=1.2, n=160, seed=7, burst=16)
    out = {}
    for side, engine in (("port", "torch"), ("ref", "vector")):
        pkg = PKG[side][0]
        cl = make_cluster(
            side, engine,
            pkg.HierarchicalDispatcher(pkg.EnergyAwareDispatcher(), pod_size=16,
                                       pods_per_region=8),
            truth_for=lambda s, t=tables[side]: t[s.chip.name],
            chips=lambda i: ("H100", "A100", "V100")[(i // 16) % 3],
            n=40, units=8, noise=0.0, policies=pols if side == "port" else None, window=8,
        )
        out[side] = schedule_of(cl.simulate(st[side]))
    assert out["port"] == out["ref"]
    launched = [(kind, calls) for kind, calls in bursts if calls]
    assert launched and all(len(calls) == 1 for _, calls in launched)
    for kind in ("arrival", "complete"):
        assert any(calls[0] > 0 for k, calls in launched if k == kind), kind
    assert sum(p.stage_served for p in pols) > 0


# ---------------------------------------------------------------------------
# The forecast plane on the fleet
# ---------------------------------------------------------------------------


def test_predictive_dispatch_with_forecast_matches_reference():
    """``PredictiveDispatcher`` routing on the plane's forecasted waits,
    posterior-refined perf models and burst-gated migration, all on."""
    st = streams(RC.APP_ORDER, rate=0.25, n=48, seed=17, burst=6)
    out = {}
    for side, engine in (("port", "torch"), ("ref", "jax"), ("ref", "vector")):
        pkg = PKG[side][0]
        cl = make_cluster(side, engine, pkg.PredictiveDispatcher(),
                          truth_for=paper_truth(side),
                          chips=lambda i: ("H100", "A100", "V100")[i % 3], n=6)
        res = cl.simulate(st[side], forecast=pkg.ForecastConfig(),
                          elastic=pkg.ElasticConfig(migrate=True))
        out[(side, engine)] = (schedule_of(res), sorted(res.forecast.items()))
    assert len(set(map(str, out.values()))) == 1
    assert out[("port", "torch")][1]  # the plane reported its state


def test_cluster_result_rollups_match_reference():
    st = streams(RC.APP_ORDER, rate=0.25, n=30, seed=3, burst=6)
    res = {}
    for side, engine in (("port", "torch"), ("ref", "vector")):
        cl = make_cluster(side, engine, dispatcher(side, "eco", True),
                          truth_for=paper_truth(side),
                          chips=lambda i: ("H100", "A100", "V100")[i % 3], n=8)
        res[side] = cl.simulate(st[side], charge_profiling=True)
    p, r = res["port"], res["ref"]
    for attr in ("busy_energy", "idle_energy", "profiling_energy", "edp",
                 "tail_idle_energy", "mean_wait", "decision_events"):
        assert getattr(p, attr) == getattr(r, attr), attr
    assert p.fragmentation == r.fragmentation
    assert set(p.decision_phases) == set(r.decision_phases)

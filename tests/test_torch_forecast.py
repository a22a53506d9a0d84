"""Port parity of the fleet's host modules: arrival streams and trace
replay (``repro_torch.core.arrivals``), the forecast plane
(``repro_torch.core.forecast``) through ``simulate(forecast=...)``, and
the offline bounds (``repro_torch.core.oracle``).

Each is held against its reference twin on the same seeds and inputs:
streams, rate estimates, schedules, forecast summaries and bounds must be
identical (exact float equality; these are host computations in float64
on both sides).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch_parity import carry_profiles, schedule_key  # noqa: E402

from repro import core as RCORE  # noqa: E402
from repro.core import arrivals as RA  # noqa: E402
from repro.core import calibration as RC  # noqa: E402
from repro.roofline import hw as RHW  # noqa: E402
from repro_torch import core as PCORE  # noqa: E402
from repro_torch.core import arrivals as PA  # noqa: E402
from repro_torch.core import calibration as PC  # noqa: E402
from repro_torch.core import carry  # noqa: E402
from repro_torch.roofline import hw as PHW  # noqa: E402

SAMPLE_TRACE = __file__.rsplit("/", 2)[0] + "/benchmarks/data/datacenter_sample.csv"
LAM, TAU, NOISE = 0.35, 0.45, 0.02


def rows(stream):
    return [(a.t, a.name, a.app) for a in stream]


@pytest.fixture(autouse=True)
def _reference_ref_path(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")


# ---------------------------------------------------------------------------
# Arrival streams and traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_generated_streams_match_reference(seed):
    apps = list(RC.APP_ORDER)
    assert rows(PA.poisson_stream(apps, rate=0.01, n=40, seed=seed)) == rows(
        RA.poisson_stream(apps, rate=0.01, n=40, seed=seed))
    assert rows(PA.bursty_stream(apps, rate=0.25, n=60, seed=seed, burst=6)) == rows(
        RA.bursty_stream(apps, rate=0.25, n=60, seed=seed, burst=6))


def test_trace_text_and_files_match_reference(tmp_path):
    ref = RA.bursty_stream(list(RC.APP_ORDER), rate=0.1, n=30, seed=5, burst=4)
    port = carry.arrivals_from_tuples([(a.name, a.app, a.t) for a in ref])
    text = PA.dumps_trace(port)
    assert text == RA.dumps_trace(ref)  # byte-stable across packages
    assert PA.loads_trace(text) == port
    PA.save_trace(str(tmp_path / "t.csv"), port)
    assert rows(RA.load_trace(str(tmp_path / "t.csv"))) == rows(ref)
    assert PA.load_trace(str(tmp_path / "t.csv")) == port


def test_datacenter_sample_matches_reference():
    """The committed Philly-style sample: ISO timestamps, duplicate ids and
    unmodelled jobs, mapped onto the calibrated apps."""
    for kw in (dict(), dict(time_scale=0.5), dict(rebase=False)):
        amap = lambda a: a if a in RC.APP_ORDER else None  # noqa: E731
        port = PA.from_datacenter_csv(SAMPLE_TRACE, app_map=amap, **kw)
        assert rows(port) == rows(RA.from_datacenter_csv(SAMPLE_TRACE, app_map=amap, **kw))
        assert len(port) == 22


def test_datacenter_options_and_errors_match_reference():
    text = ("job_id,submit_time,app,dur\n"
            "j1,100.0,alpha,5\nj2,40.0,beta,6\nj1,160.0,alpha,7\n"
            "j3,70.0,dropme,8\nj1#1,220.0,alpha,9\n")
    amap = {"alpha": "gpt2", "beta": "bert"}
    assert rows(PA.from_datacenter_csv(text, app_map=amap, duration_col="dur")) == rows(
        RA.from_datacenter_csv(text, app_map=amap, duration_col="dur"))
    for bad, kw in (
        ("job_id,when,app\nj1,1.0,x\n", {}),
        ("job_id,submit_time,app\nj1,not-a-time,x\n", {}),
        (text, dict(app_map=amap, strict=True)),
        (text.replace(",5\n", ",-5\n"), dict(app_map=amap, duration_col="dur")),
    ):
        with pytest.raises(ValueError) as ref_err:
            RA.from_datacenter_csv(bad, **kw)
        with pytest.raises(ValueError) as port_err:
            PA.from_datacenter_csv(bad, **kw)
        assert str(port_err.value) == str(ref_err.value)


def test_arrival_rate_ewma_matches_reference():
    times = [100.0 * i for i in range(12)] + [1100.0] * 5 + [1500.0, 4000.0]
    r, p = RA.ArrivalRateEWMA(horizon=4, baseline_horizon=64), PA.ArrivalRateEWMA(
        horizon=4, baseline_horizon=64)
    for t in times:
        r.observe(t)
        p.observe(t)
        for now in (None, t, t + 50.0, t + 3000.0):
            assert p.rate(now) == r.rate(now)
            assert p.burst_factor(now) == r.burst_factor(now)
        assert p.baseline_rate() == r.baseline_rate()


# ---------------------------------------------------------------------------
# simulate(forecast=...) on one node
# ---------------------------------------------------------------------------


def eco(pkg, truth, engine, **kw):
    extra = {"device": "cpu"} if pkg is PCORE else {}
    return pkg.EcoSched(pkg.ProfiledPerfModel(truth, noise=NOISE, seed=1),
                        lam=LAM, tau=TAU, engine=engine, **extra, **kw)


@pytest.mark.parametrize("resize", [False, True], ids=["static", "elastic"])
def test_simulate_with_forecast_matches_reference(resize):
    """Online posterior refinement and the burst-conditioned resize switch
    cost: the port's torch engine against the reference's jax and vector
    engines, schedules and forecast summaries identical."""
    ref_truth = RC.build_system("h100", freq_levels=3)
    port_truth = carry_profiles(ref_truth)
    stream = [(90.0 * i, a) for i, a in enumerate(RC.APP_ORDER)]
    out = {}
    for tag, pkg, truth, engine in (("torch", PCORE, port_truth, "torch"),
                                    ("jax", RCORE, ref_truth, "jax"),
                                    ("vector", RCORE, ref_truth, "vector")):
        res = pkg.simulate(
            eco(pkg, truth, engine), pkg.Node(4, 2, RC.idle_power("h100")), truth,
            arrivals=stream, forecast=pkg.ForecastConfig(),
            elastic=pkg.ElasticConfig(resize=True) if resize else None,
        )
        out[tag] = (schedule_key(res), sorted(res.forecast.items()))
    assert out["torch"] == out["jax"] == out["vector"]
    assert dict(out["torch"][1])["refinements"] > 0


def test_all_off_forecast_is_the_plane_free_loop():
    truth = PC.build_system("h100")
    node = PCORE.Node(4, 2, PC.idle_power("h100"))
    a = PCORE.simulate(eco(PCORE, truth, "torch"), node, truth, queue=list(PC.APP_ORDER))
    b = PCORE.simulate(
        eco(PCORE, truth, "torch"), node, truth, queue=list(PC.APP_ORDER),
        forecast=PCORE.ForecastConfig(refine=False, queueing=False, burst_gate=False),
    )
    assert schedule_key(a) == schedule_key(b) and b.forecast == {}


def test_refined_perf_model_matches_reference():
    """The posterior the plane wraps a node's perf model in: identical
    refined specs after the same observations."""
    ref_truth = RC.build_system("a100")
    port_truth = carry_profiles(ref_truth)
    plans = {}
    for side, pkg, truth in (("ref", RCORE, ref_truth), ("port", PCORE, port_truth)):
        plane = pkg.ForecastPlane(pkg.ForecastConfig(), {"n": 4})
        pm = plane.refined_model("n", pkg.ProfiledPerfModel(truth, noise=NOISE, seed=3))
        for k, app in enumerate(list(RC.APP_ORDER)[:6]):
            pm.observe(app, 2, truth[app].runtime[2] * (1.1 + 0.05 * k),
                       p_obs=300.0 + 10.0 * k)
        plans[side] = [dataclasses.astuple(m) for app in RC.APP_ORDER
                       for m in pm.spec(app).modes] + [pm.version]
    assert plans["port"] == plans["ref"]
    assert plans["port"][-1] == 6  # every observation was taken


# ---------------------------------------------------------------------------
# Oracle bounds
# ---------------------------------------------------------------------------


def test_cluster_oracle_bound_matches_reference():
    stream = RA.bursty_stream(list(RC.APP_ORDER), rate=1 / 600, n=20, burst=4, seed=9)
    pstream = carry.arrivals_from_tuples([(a.name, a.app, a.t) for a in stream])
    names = ("H100", "A100", "V100")
    ref = RCORE.cluster_oracle_bound(
        [RCORE.NodeSpec(f"{c.lower()}-0", getattr(RHW, c)) for c in names],
        lambda s: RC.build_system(s.chip.name), stream)
    tables = {c.lower(): carry_profiles(RC.build_system(c.lower())) for c in names}
    port = PCORE.cluster_oracle_bound(
        [PCORE.NodeSpec(f"{c.lower()}-0", getattr(PHW, c)) for c in names],
        lambda s: tables[s.chip.name], pstream)
    assert port == ref


def _solve_both(**seed_kw):
    ref_truth = {a: p for a, p in RC.build_system("h100").items()
                 if a in list(RC.APP_ORDER)[:4]}
    port_truth = carry_profiles(ref_truth)
    node = (4, 2, RC.idle_power("h100"))
    ref = RCORE.OracleSolver(RCORE.Node(*node), ref_truth,
                             time_budget_s=30).solve(list(ref_truth))
    port = PCORE.OracleSolver(PCORE.Node(*node), port_truth, time_budget_s=30,
                              **seed_kw).solve(list(port_truth))
    return (schedule_key(port[0]), port[1]), (schedule_key(ref[0]), ref[1])


def test_oracle_solver_matches_reference():
    port, ref = _solve_both(engine="vector")
    assert port == ref and port[1]


def test_oracle_solver_seeds_on_the_torch_engine():
    """The seed schedules run on the engine the caller picks (here the
    torch engine's plain kernels); the solve is the reference's."""
    port, ref = _solve_both(engine="torch", device="cpu")
    assert port == ref and port[1]


def test_oracle_solver_defaults_to_the_card():
    """Like ``EcoSched``, the solver's seed policies default to the card:
    without CUDA the default refuses rather than running on the host."""
    truth = carry_profiles({a: p for a, p in RC.build_system("h100").items()
                            if a in list(RC.APP_ORDER)[:2]})
    solver = PCORE.OracleSolver(PCORE.Node(4, 2, RC.idle_power("h100")), truth)
    assert (solver.engine, solver.device) == ("torch", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            solver.solve(list(truth))

"""Port parity of the whole single-node ``simulate()`` path.

The port's ``EcoSched(engine="torch", device="cpu")`` (the kernels' plain
versions) against the reference's ``engine="jax"`` (its jnp ``ref`` path)
and ``engine="vector"``, on identical inputs carried across: identical
fingerprints (job, count, frequency level, start, end, node, domain),
makespan and total energy, bit for bit.  The reference's single-node
goldens are imported from tests/test_events.py, not copied.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_events import AB_TRUTH, GOLDEN  # noqa: E402
from test_events import fp_records as golden_fp  # noqa: E402
from torch_parity import carry_profiles, pod_table, schedule_key  # noqa: E402

from repro import core as RCORE  # noqa: E402
from repro.core import calibration as RC  # noqa: E402
from repro_torch import core as PCORE  # noqa: E402
from repro_torch.core import calibration as PC  # noqa: E402
from repro_torch.core import carry  # noqa: E402

LAM, TAU, NOISE, SEED = 0.35, 0.45, 0.02, 1


@pytest.fixture(autouse=True)
def _reference_ref_path(monkeypatch):
    # the reference's engine="jax" off-TPU: its pure-jnp path, whatever
    # another test file left in the environment
    monkeypatch.setenv("REPRO_KERNELS", "ref")


def eco(pkg, truth, engine, noise=NOISE, seed=SEED, **kw):
    extra = {"device": "cpu"} if engine == "torch" else {}
    return pkg.EcoSched(
        pkg.ProfiledPerfModel(truth, noise=noise, seed=seed),
        lam=LAM, tau=TAU, engine=engine, **extra, **kw,
    )


def run_both(ref_truth, node_args, stream, *, engines=("jax", "vector"),
             policy_kw=None, sim=None):
    """The port's torch engine and each reference engine on one workload;
    ``sim(pkg, C)`` returns the ``simulate`` keywords built from the
    package's own core and calibration modules."""
    policy_kw = policy_kw or {}
    out = {}
    port_truth = carry_profiles(ref_truth)
    for tag, pkg, C, truth, engine in (
        [("torch", PCORE, PC, port_truth, "torch")]
        + [(e, RCORE, RC, ref_truth, e) for e in engines]
    ):
        kw = sim(pkg, C) if sim is not None else {}
        res = pkg.simulate(
            eco(pkg, truth, engine, **policy_kw), pkg.Node(*node_args),
            truth, arrivals=stream, **kw,
        )
        out[tag] = res
    return out


def assert_same_schedules(out):
    keys = {tag: schedule_key(res) for tag, res in out.items()}
    assert len(set(keys.values())) == 1, keys
    return out["torch"]


def paper_stream():
    return [(120.0 * i, a) for i, a in enumerate(RC.APP_ORDER)]


def test_single_node_golden_replays_in_port():
    truth = PC.build_system("h100")
    node = PCORE.Node(4, 2, PC.idle_power("h100"))
    r = PCORE.simulate(
        eco(PCORE, truth, "torch"), node, truth, arrivals=paper_stream(),
        slowdown_model=PC.cross_numa_slowdown,
    )
    fp, makespan, energy = GOLDEN["single_eco"]
    assert golden_fp(r.records) == fp
    assert r.makespan == makespan and r.total_energy == energy
    r2 = PCORE.simulate(PCORE.Marble(truth), node, truth,
                        queue=list(PC.APP_ORDER))
    fp, makespan, energy = GOLDEN["single_marble"]
    assert golden_fp(r2.records) == fp
    assert r2.makespan == makespan and r2.total_energy == energy


def _fig6(pkg, C, truth, system, engine):
    """``benchmarks/common.run_system``'s four policies on one package."""
    node = pkg.Node(units=4, domains=2, idle_power_per_unit=C.idle_power(system))
    out = {}
    for pol in (pkg.SequentialMax(truth), pkg.SequentialOptimal(truth),
                pkg.Marble(truth), eco(pkg, truth, engine)):
        r = pkg.simulate(
            pol, node, truth, queue=list(C.APP_ORDER),
            charge_profiling=pol.name().startswith("ecosched"),
            slowdown_model=(C.cross_numa_slowdown
                            if pol.name().startswith(("ecosched", "marble"))
                            else None),
        )
        out[r.policy] = r
    return out


@pytest.mark.parametrize("system", ["h100", "a100", "v100"])
def test_fig6_policies_match(system):
    ref_truth = RC.build_system(system)
    ref = _fig6(RCORE, RC, ref_truth, system, "vector")
    port = _fig6(PCORE, PC, carry_profiles(ref_truth), system, "torch")
    assert list(port) == list(ref)
    for name in ref:
        assert schedule_key(port[name]) == schedule_key(ref[name]), name
    base_r, base_p = ref["sequential_optimal_gpu"], port["sequential_optimal_gpu"]
    for name in ("ecosched", "marble", "sequential_max_gpu"):
        assert PCORE.summarize(base_p, port[name]) == RCORE.summarize(
            base_r, ref[name]
        ), name


def test_dvfs_lam_f_matches():
    """4-level DVFS ladder with λ_f ≠ 0: the f plane reaches the kernel."""
    truth = RC.build_system("h100", freq_levels=4)
    out = run_both(truth, (4, 2, RC.idle_power("h100")), paper_stream(),
                   policy_kw=dict(lam_f=0.1),
                   sim=lambda pkg, C: dict(slowdown_model=C.cross_numa_slowdown))
    res = assert_same_schedules(out)
    assert any(r.f > 0 for r in res.records)


def _elastic(pkg, C, *, ckpt=None):
    kw = dict(ckpt_time=30.0, restart_time=15.0, min_gain_s=60.0) if ckpt else {}
    return dict(slowdown_model=C.cross_numa_slowdown,
                elastic=pkg.ElasticConfig(resize=True, **kw))


@pytest.mark.parametrize("batched", [True, False])
def test_elastic_resizes_match(batched):
    """The pair of tests/test_events.py that resizes A from 2 to 4 units
    when B completes: the decision goes through the resize scoring."""
    out = run_both(AB_TRUTH, (4, 2, 10.0), [(0.0, "A"), (0.0, "B")],
                   policy_kw=dict(resize_batch=batched, noise=0.0, seed=0),
                   sim=lambda pkg, C: _elastic(pkg, C, ckpt=True))
    res = assert_same_schedules(out)
    assert res.resizes > 0
    assert res.resize_history == out["vector"].resize_history


@pytest.mark.parametrize("batched", [True, False])
def test_elastic_dvfs_paper_stream_matches(batched):
    truth = RC.build_system("h100", freq_levels=3)
    out = run_both(truth, (4, 2, RC.idle_power("h100")), paper_stream(),
                   policy_kw=dict(resize_batch=batched), sim=_elastic)
    res = assert_same_schedules(out)
    assert res.freq_history == out["vector"].freq_history


def test_seeded_faults_match():
    truth = RC.build_system("h100")
    out = run_both(
        truth, (4, 2, RC.idle_power("h100")), paper_stream(),
        sim=lambda pkg, C: dict(
            slowdown_model=C.cross_numa_slowdown,
            faults=pkg.FaultConfig(
                seed=5, job_mtbf_s=6000.0, node_mtbf_s=20000.0,
                node_mttr_s=300.0, degrade_frac=0.5, retry_base_s=30.0,
            ),
        ),
    )
    res = assert_same_schedules(out)
    assert res.job_crashes + res.node_failures > 0
    for tag in ("jax", "vector"):
        assert (res.job_crashes, res.node_failures, res.fault_retries,
                res.lost_jobs) == (out[tag].job_crashes,
                                   out[tag].node_failures,
                                   out[tag].fault_retries, out[tag].lost_jobs)


def test_pod_node_matches():
    """A short M=16 / K=4 run with a 4-level DVFS ladder."""
    table, stream = pod_table(24, M=16, levels=4, seed=7)
    ref_truth = {a: RCORE.JobProfile(name=a, **d) for a, d in table.items()}
    assert carry.profiles_from_arrays(table) == carry_profiles(ref_truth)
    out = run_both(ref_truth, (16, 4, 70.0), stream,
                   policy_kw=dict(window=8))
    res = assert_same_schedules(out)
    assert len({r.job for r in res.records}) == 24


def test_enabled_forecast_matches_reference():
    """An enabled ``ForecastConfig`` is no longer refused: it builds the
    forecast plane, whose summary and schedule are the reference's."""
    ref_truth = RC.build_system("h100")
    out = {}
    for tag, pkg, truth, engine in (
        ("torch", PCORE, carry_profiles(ref_truth), "torch"),
        ("vector", RCORE, ref_truth, "vector"),
    ):
        res = pkg.simulate(eco(pkg, truth, engine), pkg.Node(4, 2, 70.0), truth,
                           queue=list(RC.APP_ORDER), forecast=pkg.ForecastConfig())
        out[tag] = (schedule_key(res), sorted(res.forecast.items()))
    assert out["torch"] == out["vector"]
    assert out["torch"][1]  # the plane ran and reported its state


def test_score_ties_carry_over_under_cpu_plain_kernels():
    """Engines agree on a window with exact cross-job score ties (two
    identical applications), where the tie-break decides the schedule."""
    rng = np.random.default_rng(5)
    base = dict(runtime={1: 900.0, 2: 500.0, 4: 300.0},
                busy_power={1: 200.0, 2: 380.0, 4: 700.0})
    table = {}
    for i in range(6):
        d = dict(base) if i < 2 else dict(
            runtime={g: float(t * rng.uniform(0.8, 1.2))
                     for g, t in base["runtime"].items()},
            busy_power=base["busy_power"],
        )
        d["dram_util"] = {g: 1.0 / (d["runtime"][g] * g) for g in d["runtime"]}
        table[f"app{i}"] = d
    ref_truth = {a: RCORE.JobProfile(name=a, **d) for a, d in table.items()}
    out = run_both(ref_truth, (4, 2, 50.0), [(0.0, a) for a in table])
    assert_same_schedules(out)

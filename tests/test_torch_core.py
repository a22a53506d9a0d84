"""Port parity of the host-side core (repro_torch.core) against the
reference package: hardware table, calibrated profiles, Phase-I specs,
the reference and vectorized enumerations, the carry constructors, the
device-plane memo, and the torch engine's device rule.  Every input is
made from a seed with numpy and carried across with ``carry``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (  # noqa: E402
    carry_profiles,
    carry_specs,
    carry_view,
    export_specs,
)
from test_score_reduce import rand_window  # noqa: E402

from repro.core import ProfiledPerfModel as RefPM  # noqa: E402
from repro.core import calibration as RC  # noqa: E402
from repro.core.actions import enumerate_actions as ref_actions  # noqa: E402
from repro.core.engine import DecisionCache as RefCache  # noqa: E402
from repro.core.engine import enumerate_scored as ref_scored  # noqa: E402
from repro.core.score import tau_filter as ref_tau  # noqa: E402
from repro.roofline import hw as RHW  # noqa: E402
from repro_torch.core import EcoSched, ProfiledPerfModel  # noqa: E402
from repro_torch.core import calibration as PC  # noqa: E402
from repro_torch.core import carry  # noqa: E402
from repro_torch.core.actions import enumerate_actions  # noqa: E402
from repro_torch.core.engine import DecisionCache, enumerate_scored  # noqa: E402
from repro_torch.core.score import tau_filter  # noqa: E402
from repro_torch.roofline import hw as PHW  # noqa: E402

SYSTEMS = ("h100", "a100", "v100")
LAM = 0.35


@pytest.mark.parametrize("system", SYSTEMS)
def test_chip_table_matches(system):
    assert dataclasses.asdict(PHW.CHIPS[system]) == dataclasses.asdict(
        RHW.CHIPS[system]
    )
    assert set(PHW.CHIPS) == {"h100", "a100", "v100"}


@pytest.mark.parametrize("levels", ["one", "full"])
@pytest.mark.parametrize("system", SYSTEMS)
def test_build_system_matches(system, levels):
    k = 1 if levels == "one" else len(RHW.CHIPS[system].freq_ratios)
    ref = RC.build_system(system, freq_levels=k)
    port = PC.build_system(system, freq_levels=k)
    assert list(port) == list(ref) == list(PC.APP_ORDER)
    assert port == carry_profiles(ref)  # dataclass equality, value for value
    assert PC.idle_power(system) == RC.idle_power(system)
    if k > 1:
        assert all(len(p.freq_levels) == k for p in port.values())


@pytest.mark.parametrize("system", SYSTEMS)
def test_profiled_specs_match(system):
    """Phase-I estimates drawn from the same seeded numpy streams."""
    truth = RC.build_system(system, freq_levels=3)
    ref = RefPM(truth, noise=0.02, seed=1)
    port = ProfiledPerfModel(carry_profiles(truth), noise=0.02, seed=1)
    for app in RC.APP_ORDER:
        r, p = export_specs([ref.spec(app)])[0], export_specs([port.spec(app)])[0]
        for col in ("g", "f", "t_norm", "p_bar", "e_norm"):
            assert np.array_equal(r[col], p[col]), (app, col)
        assert port.profiling_energy(app) == ref.profiling_energy(app)
        kept = export_specs([tau_filter(port.spec(app), 0.45)])[0]
        assert kept["g"].tolist() == export_specs(
            [ref_tau(ref.spec(app), 0.45)])[0]["g"].tolist()


def _names(action):
    return [(sp.name, m.g, m.f) for sp, m in action]


@pytest.mark.parametrize("chunk", range(3))
def test_enumerations_match(chunk):
    """The python reference enumeration and the vectorized engine give the
    reference's rows, in order, with float64 scores exactly equal."""
    for seed in range(10 * chunk, 10 * chunk + 10):
        specs, view = rand_window(seed)
        pspecs, pview = carry_specs(specs), carry_view(view)
        ra = ref_actions(specs, view, list(view.free_map), lam=LAM)
        pa = enumerate_actions(pspecs, pview, list(pview.free_map), lam=LAM)
        assert [s for s, _ in pa] == [s for s, _ in ra], seed
        assert [_names(a) for _, a in pa] == [_names(a) for _, a in ra], seed
        rb = ref_scored(specs, view, list(view.free_map), lam=LAM)
        pb = enumerate_scored(pspecs, pview, list(pview.free_map), lam=LAM)
        assert np.array_equal(pb.scores, rb.scores), seed
        assert np.array_equal(pb.total_g, rb.total_g), seed
        assert pb.best_index() == rb.best_index(), seed
        assert [_names(pb.action(i)) for i in range(len(pb))] == [
            _names(rb.action(i)) for i in range(len(rb))
        ], seed


def test_cached_enumeration_matches_reference_cache():
    """Repeated and permuted windows through both packages' DecisionCache."""
    rc, pc = RefCache(), DecisionCache()
    for seed in list(range(8)) + list(range(8)):
        specs, view = rand_window(seed)
        specs = specs[::-1] if seed % 2 else specs
        pspecs, pview = carry_specs(specs), carry_view(view)
        rb = ref_scored(specs, view, list(view.free_map), lam=LAM, cache=rc)
        pb = enumerate_scored(pspecs, pview, list(pview.free_map), lam=LAM,
                              cache=pc)
        assert np.array_equal(pb.scores, rb.scores), seed
        assert np.array_equal(pb.padded_cols()[0], rb.padded_cols()[0]), seed
    assert pc.stats() == rc.stats()


def test_device_cols_memo_is_shared_through_rebind():
    specs, view = rand_window(4)
    pview = carry_view(view)
    cache = DecisionCache()
    b1 = enumerate_scored(carry_specs(specs), pview, list(pview.free_map),
                          lam=LAM, lam_f=0.1, cache=cache)
    cols = b1.device_cols("cpu", with_f=True)
    dev, g, n = b1.padded_cols()
    assert np.array_equal(cols["dev"].numpy(), dev)
    assert np.array_equal(cols["g"].numpy(), g)
    assert np.array_equal(cols["n"].numpy(), n)
    assert np.array_equal(cols["f"].numpy(), b1.padded_f())
    assert np.array_equal(cols["nonempty"].numpy(), (n > 0).astype(np.float32))
    assert all(t.is_contiguous() for t in cols.values())
    # a cache hit rebinds the batch and reuses the same device tensors
    b2 = enumerate_scored(carry_specs(specs), pview, list(pview.free_map),
                          lam=LAM, lam_f=0.1, cache=cache)
    assert b2 is not b1
    assert b2.device_cols("cpu", with_f=True)["dev"] is cols["dev"]
    assert b1.device_cols("cpu")["f"] is None


def test_carry_round_trip_and_validation():
    rng = np.random.default_rng(2)
    table = {
        f"app{i}": dict(
            runtime={g: float(rng.uniform(100, 900)) for g in (1, 2, 4)},
            busy_power={g: float(rng.uniform(100, 400)) for g in (1, 2, 4)},
            profiling_energy=1.5,
        )
        for i in range(3)
    }
    prof = carry.profiles_from_arrays(table)
    assert list(prof) == list(table)
    assert prof["app1"].runtime == table["app1"]["runtime"]
    assert prof["app2"].freq_levels == (0,)
    with pytest.raises(ValueError):
        carry.specs_from_arrays([dict(name="x", g=[1, 2], t_norm=[1.0],
                                      p_bar=[1.0, 2.0], e_norm=[1.0, 1.0])])


def test_torch_engine_needs_a_device(monkeypatch):
    truth = PC.build_system("h100")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EcoSched(ProfiledPerfModel(truth), engine="torch")
    # the CPU is taken only when asked for
    pol = EcoSched(ProfiledPerfModel(truth), engine="torch", device="cpu")
    assert pol.device.type == "cpu"
    with pytest.raises(ValueError):
        EcoSched(ProfiledPerfModel(truth), engine="jax")


def test_default_policy_runs_on_the_card_or_raises(monkeypatch):
    """``EcoSched(pm)`` with no engine is the torch engine on ``cuda``:
    without a CUDA device it raises; ``device="cpu"`` runs the kernels'
    plain versions and gives the numpy engine's schedule."""
    from repro_torch.core import Node, simulate

    truth = PC.build_system("h100")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EcoSched(ProfiledPerfModel(truth))
    pol = EcoSched(ProfiledPerfModel(truth, noise=0.02, seed=1), device="cpu")
    assert pol.engine == "torch" and pol.device.type == "cpu"
    out = []
    for p in (pol, EcoSched(ProfiledPerfModel(truth, noise=0.02, seed=1),
                            engine="vector")):
        r = simulate(p, Node(4, 2, PC.idle_power("h100")), truth,
                     queue=list(PC.APP_ORDER))
        out.append(([(x.job, x.g, x.start, x.end) for x in r.records],
                    r.total_energy))
    assert out[0] == out[1]

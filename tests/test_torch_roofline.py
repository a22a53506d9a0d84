"""The roofline path of the port against the reference: the pure
functions of ``roofline/analysis.py`` bitwise, ``RooflinePerfModel``'s
specs bitwise and its schedules exact, the fake-tensor counter on
functions of known cost, the extrapolation identity (every layer is
counted), the dry-run's per-device argument and alias bytes against XLA's
``memory_analysis`` of the reference's ``lower_cell``, and one CLI run.
Inputs are seeded with numpy."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import carry_profiles, schedule_key  # noqa: E402

from repro import core as RCORE  # noqa: E402
from repro.configs import SHAPES as R_SHAPES  # noqa: E402
from repro.configs import get_config as r_get_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.distributed import sharding as RS  # noqa: E402
from repro.roofline import analysis as RA  # noqa: E402
from repro.roofline.hw import H100 as R_H100  # noqa: E402
from repro_torch import core as PCORE  # noqa: E402
from repro_torch.configs import SHAPES as P_SHAPES  # noqa: E402
from repro_torch.configs import get_config as p_get_config  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.distributed import sharding as PS  # noqa: E402
from repro_torch.distributed.meshes import AbstractMesh  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.roofline import analysis as PA  # noqa: E402
from repro_torch.roofline.hw import H100 as P_H100  # noqa: E402
from repro_torch.tree import eval_shape, leaves_with_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list_archs()
ONE_CARD = AbstractMesh((1, 1), ("data", "model"))


# ---------------------------------------------------------------------------
# Pure functions, bitwise
# ---------------------------------------------------------------------------


def _cost_dicts(rng):
    keys = ["flops", "bytes", "coll_bytes", "coll_all-reduce"]
    c0 = {k: float(rng.uniform(0, 1e9)) for k in keys}
    c1 = {k: c0[k] + float(rng.uniform(-1e8, 1e10)) for k in keys}
    cf = {k: float(rng.uniform(0, 1e11)) for k in keys[:3]}  # a key missing
    return c0, c1, cf


@pytest.mark.parametrize("seed", range(6))
def test_extrapolate_matches_reference(seed):
    rng = np.random.default_rng(seed)
    c0, c1, cf = _cost_dicts(rng)
    for periods in (0, 1, 5, 34 / 6, 64):
        assert PA.extrapolate(c0, c1, cf, periods_total=periods) == \
            RA.extrapolate(c0, c1, cf, periods_total=periods)


@pytest.mark.parametrize("per_device", [True, False])
def test_roofline_terms_match_reference(per_device):
    rng = np.random.default_rng(1)
    for _ in range(50):
        f, b, c = (float(x) for x in rng.uniform(0, 1e14, 3) * rng.integers(0, 2, 3))
        chips = int(rng.integers(1, 513))
        assert PA.roofline_terms(f, b, c, chips=chips, chip=P_H100, per_device=per_device) == \
            RA.roofline_terms(f, b, c, chips=chips, chip=R_H100, per_device=per_device)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_matches_reference_on_every_cell(arch):
    for shape in R_SHAPES:
        for mp in (1, 16):
            rcfg, _ = RS.shardable(r_get_config(arch), mp)
            pcfg, _ = PS.shardable(p_get_config(arch), mp)
            assert PA.model_flops(pcfg, P_SHAPES[shape], original_cfg=p_get_config(arch)) == \
                RA.model_flops(rcfg, R_SHAPES[shape], original_cfg=r_get_config(arch))
            assert PA.model_flops(pcfg, P_SHAPES[shape]) == RA.model_flops(rcfg, R_SHAPES[shape])


def _record(rng, shape, mesh, **opts):
    chips = int(np.prod([int(x) for x in mesh.split("x")]))
    return {
        "mesh": mesh,
        "chips": chips,
        "memory": {"argument_bytes": int(rng.integers(1e6, 1e11))},
        "opts": opts,
        "cost_totals": {"flops": float(rng.uniform(0, 1e15)) * int(rng.integers(0, 4) > 0),
                        "bytes": float(rng.uniform(0, 1e13)),
                        "coll_bytes": float(rng.uniform(0, 1e11))},
        "model_flops_total": float(rng.uniform(1e12, 1e17)),
        "shape": shape,
    }


_OPTS = {
    "decode": [{}, {"window_slice": True}, {"window_slice": False, "grad_accum": 2}],
    "prefill": [{}, {"remat": "none"}],
    "train": [{"remat": r, "grad_accum": a} for r in ("none", "dots", "full", "other")
              for a in (1, 4)] + [{}],
}


@pytest.mark.parametrize("arch", ARCHS)
def test_hbm_floor_and_derive_terms_match_reference(arch):
    """Seeded records of every shape (decode with and without
    ``window_slice``, prefill, train at each remat) on the 1-pod, 2-pod
    and one-card meshes: the same floor and terms, bitwise."""
    rng = np.random.default_rng(ARCHS.index(arch))
    for shape, cell in R_SHAPES.items():
        for mesh in ("16x16", "2x16x16", "1x1", "4x8"):
            mp = int(mesh.split("x")[-1])
            rcfg, _ = RS.shardable(r_get_config(arch), mp)
            pcfg, _ = PS.shardable(p_get_config(arch), mp)
            dp = int(np.prod([int(x) for x in mesh.split("x")[:-1]]))
            for opts in _OPTS[cell.kind]:
                rec = _record(rng, shape, mesh, **opts)
                assert PA.hbm_floor_bytes(rec, pcfg, P_SHAPES[shape], dp=dp, mp=mp) == \
                    RA.hbm_floor_bytes(rec, rcfg, cell, dp=dp, mp=mp)
                assert PA.derive_terms(rec, pcfg, P_SHAPES[shape], P_H100) == \
                    RA.derive_terms(rec, rcfg, cell, R_H100)


# ---------------------------------------------------------------------------
# RooflinePerfModel
# ---------------------------------------------------------------------------


def _cells(seed, n=8):
    rng = np.random.default_rng(seed)
    cells = {}
    for i in range(n):
        cell = {
            "chips_ref": int(rng.choice([1, 4, 64, 256])),
            "t_compute": float(rng.uniform(1e-4, 2.0)),
            "t_memory": float(rng.uniform(1e-4, 2.0)),
            "t_collective": float(rng.uniform(0, 0.5)) * int(rng.integers(0, 2)),
            "steps": int(rng.integers(100, 5000)),
        }
        if i % 3:
            cell["alpha_coll"] = float(rng.uniform(0.1, 0.6))
        cells[f"job{i}"] = cell
    return cells


def _spec_tuple(spec):
    return spec.name, [(m.g, m.f, m.t_norm, m.p_bar, m.e_norm) for m in spec.modes]


@pytest.mark.parametrize("units_to_chips", [1, 16, 64])
def test_roofline_perf_model_specs_match_reference(units_to_chips):
    cells = _cells(units_to_chips)
    kw = dict(counts=(1, 2, 3, 4), units_to_chips=units_to_chips)
    ref = RCORE.RooflinePerfModel(cells, chip=R_H100, **kw)
    port = PCORE.RooflinePerfModel(cells, chip=P_H100, **kw)
    for pm in (ref, port):
        pm.counts_for = {"job1": (1, 2), "job4": (2, 4)}
    for job in cells:
        assert _spec_tuple(port.spec(job)) == _spec_tuple(ref.spec(job))
        assert port._terms_at(cells[job], 8) == ref._terms_at(cells[job], 8)
        assert port.profiling_energy(job) == ref.profiling_energy(job) == 0.0


def _truth(core, chip, cells, counts, units_to_chips):
    """``benchmarks/bench_tpu_pod.py``'s ground truth: the model's curves
    with a per-job collective exponent the scheduler does not see."""
    truth = {}
    for i, (name, cell) in enumerate(sorted(cells.items())):
        real = dict(cell, alpha_coll=0.2 + 0.05 * (i % 5))
        runtime, power = {}, {}
        for g in counts:
            chips = g * units_to_chips
            tc, tm, tl = core.RooflinePerfModel(
                {name: real}, counts=counts, chip=chip,
                units_to_chips=units_to_chips)._terms_at(real, chips)
            step_t = max(tc, tm, tl)
            runtime[g] = step_t * cell["steps"]
            util = tc / step_t
            power[g] = (chip.power_idle + (chip.power_peak - chip.power_idle)
                        * (0.3 + 0.7 * util)) * chips
        truth[name] = core.JobProfile(name=name, runtime=runtime, busy_power=power)
    return truth


@pytest.mark.parametrize("units_to_chips", [1, 16])
def test_roofline_schedule_matches_reference(units_to_chips):
    """``simulate`` with ``EcoSched(RooflinePerfModel, engine="torch",
    device="cpu")`` gives the reference's ``engine="vector"`` schedule:
    fingerprint, makespan and energy, exactly."""
    cells = _cells(10 + units_to_chips, n=10)
    counts = (1, 2, 3, 4)
    truth = _truth(RCORE, R_H100, cells, counts, units_to_chips)
    out = {}
    for tag, core, chip, tr, extra in (
            ("vector", RCORE, R_H100, truth, {"engine": "vector"}),
            ("torch", PCORE, P_H100, carry_profiles(truth), {"engine": "torch", "device": "cpu"})):
        pm = core.RooflinePerfModel(cells, counts=counts, chip=chip,
                                    units_to_chips=units_to_chips)
        pm.counts_for = {"job2": (1, 2)}
        pol = core.EcoSched(pm, lam=0.35, tau=0.45, **extra)
        node = core.Node(4, 2, chip.power_idle * units_to_chips)
        out[tag] = core.simulate(pol, node, tr, queue=sorted(tr))
    assert schedule_key(out["torch"]) == schedule_key(out["vector"])
    assert len(out["torch"].records) >= len(cells)


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------


def test_counter_counts_a_known_function_exactly():
    """(64x32 @ 32x16) -> exp -> a view -> (.sum): flops 2·64·32·16;
    bytes of each non-view op's operands and results; the exp's
    elements; peak = a + b + the product + its exp (the product dies
    before the sum's 4-byte result is made)."""
    with PA.fake_mode():
        a, b = torch.empty(64, 32), torch.empty(32, 16)

    def f(a, b):
        e = torch.exp(a @ b).view(-1)
        return e.sum()

    cs, out = PA.count_costs(f, a, b)
    mm = (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert cs["flops"] == 2 * 64 * 32 * 16
    assert cs["bytes"] == mm + 2 * 64 * 16 * 4 + (64 * 16 * 4 + 4)
    assert cs["transcendentals"] == 64 * 16
    assert cs["peak_bytes"] == (64 * 32 + 32 * 16 + 2 * 64 * 16) * 4
    assert cs["coll_bytes"] == 0 and set(cs["_counts"].values()) == {0}
    assert tuple(out.shape) == ()


def test_counter_tracks_storages_not_views():
    """In-place updates and views of one storage count it once; a
    storage leaves the live sum with its last view."""
    with PA.fake_mode():
        x = torch.empty(1000)

    def f(x):
        y = x.clone()  # 4000 bytes
        y.mul_(2)
        v = y[:10].view(2, 5)  # a view: no new storage
        del y
        z = torch.empty(500)  # 2000 bytes while v keeps y's storage alive
        return v, z

    cs, _ = PA.count_costs(f, x)
    assert cs["peak_bytes"] == 4000 + 4000 + 2000
    assert cs["bytes"] == (4000 + 4000) + (4000 + 4000)  # clone, mul_


def test_counter_counts_dispatched_collectives():
    import torch.distributed  # noqa: F401  registers the functional collectives

    with PA.fake_mode():
        a = torch.empty(64, 32)

    def f(a):
        r = torch.ops._c10d_functional.all_reduce(a, "sum", "g")
        g = torch.ops._c10d_functional.all_gather_into_tensor(a, 4, "g")
        return torch.ops._c10d_functional.wait_tensor(r), g

    cs, _ = PA.count_costs(f, a)
    assert cs["coll_all-reduce"] == 64 * 32 * 4
    assert cs["coll_all-gather"] == 4 * 64 * 32 * 4
    assert cs["coll_bytes"] == 5 * 64 * 32 * 4
    assert cs["_counts"] == {"all-gather": 1, "all-reduce": 1, "reduce-scatter": 0,
                             "all-to-all": 0, "collective-permute": 0}


_KINDS = {"prefill": ShapeCell("t", "prefill", 64, 2), "decode": ShapeCell("t", "decode", 64, 2),
          "train": ShapeCell("t", "train", 64, 2)}


@pytest.mark.parametrize("kind", sorted(_KINDS))
@pytest.mark.parametrize("arch", ["granite-8b", "hymba-1.5b", "gemma3-4b", "qwen2-moe-a2.7b"])
def test_extrapolation_identity_counts_every_layer(arch, kind):
    """Counts at 0, 1, 2 and 3 periods of layers of a reduced config
    (gemma3: periods of 5 local + 1 global layers): every period adds the
    same, so the reference's ``C0 + (L / period)·(C1 − C0)`` gives the
    full count back.  The one exception is MoE training: the auxiliary
    loss runs on layer 0's router whenever there is a layer, so C0 lacks
    it and the first period's step is larger by exactly its count."""
    cell, rt = _KINDS[kind], Runtime(remat="full")
    base = reduced(p_get_config(arch))
    model = build_model(base, rt)
    cfg = base.replace(num_layers=3 * model.period)
    c = []
    for n in range(4):
        cs = D._costs_of(D.trace_cell(D._variant_cfg(cfg, model, n), cell, ONE_CARD, rt,
                                      device="cpu"), 1)
        cs.pop("_counts")
        c.append(cs)
    keys = ("flops", "bytes", "transcendentals", "coll_bytes")
    step = [{k: c[n + 1][k] - c[n][k] for k in keys} for n in range(3)]
    assert step[1] == step[2] and step[1]["flops"] > 0
    if kind == "train" and base.uses_moe:
        assert all(step[0][k] >= step[1][k] for k in keys) and step[0] != step[1]
    else:
        assert step[0] == step[1]
        assert PA.extrapolate(c[0], c[1], c[3], periods_total=3) == c[3]


def test_full_width_hymba_prefill_count_near_model_flops():
    """hymba-1.5b at full width, B 4 x S 2,048, on fake tensors (nothing
    allocated): the counted FLOPs within [0.95, 1.10] of the analytic
    ``model_flops``; on one card the argument bytes are all the
    parameters' and tokens' bytes (3.28 GB)."""
    rec = D.dryrun_cell("hymba-1.5b", ShapeCell("p2048", "prefill", 2048, 4), mesh=ONE_CARD,
                        skip_variants=True, device="cpu")
    ratio = rec["cost_totals"]["flops"] / rec["model_flops_total"]
    assert 0.95 <= ratio <= 1.10, ratio
    params = eval_shape(lambda: build_model(p_get_config("hymba-1.5b")).init(0, device="cpu"))
    n_bytes = sum(t.numel() * t.element_size() for _, t in leaves_with_paths(params))
    assert rec["memory"]["argument_bytes"] == n_bytes + 4 * 4 * 2048  # one card: all of it
    assert rec["chip"] == "h100" and rec["split"] == "even" and rec["coll_counted"]


def test_dryrun_leaves_later_real_steps_real():
    """A dry-run on the CPU's fake tensors leaves nothing fake behind: a
    real prefill afterwards (rope tables, which are cached per device,
    included) computes real, finite logits."""
    from torch._subclasses.fake_tensor import is_fake

    cfg = reduced(p_get_config("granite-8b"))
    D.trace_cell(cfg, _KINDS["prefill"], ONE_CARD, Runtime(), device="cpu")
    model = build_model(cfg, Runtime())
    params = model.init(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 64)))
    logits, _ = model.prefill(params, {"tokens": tokens})
    assert not is_fake(logits) and bool(torch.isfinite(logits.float()).all())


def test_pallas_runtime_is_refused():
    cfg = reduced(p_get_config("granite-8b"))
    with pytest.raises(ValueError, match="plain routes"):
        D.trace_cell(cfg, _KINDS["prefill"], ONE_CARD, Runtime(attn_impl="pallas"),
                     device="cpu")


# ---------------------------------------------------------------------------
# Argument and alias bytes against XLA
# ---------------------------------------------------------------------------

XLA_SCRIPT = r"""
import json, os, sys
sys.path.insert(0, "src")
import jax
assert len(jax.devices()) == 8
from repro import compat
from repro.configs import get_config, reduced
from repro.configs.base import ShapeCell
from repro.distributed import sharding as shd
from repro.launch import dryrun as D
from repro.models import Runtime
from repro.roofline import analysis as RA
mesh = jax.make_mesh((2, 4), ("data", "model"), **compat.auto_axis_types(2))
cfg, _ = shd.shardable(reduced(get_config("granite-8b")), 4)
rt = Runtime(remat="full", attn_impl="auto")
out, coll = {}, {}
for kind, B in (("prefill", 4), ("train", 8), ("decode", 8)):
    comp, _ = D.lower_cell(cfg, ShapeCell("t", kind, 64, B), mesh, rt, grad_accum=1)
    ma = comp.memory_analysis()
    out[kind] = [int(ma.argument_size_in_bytes), int(ma.alias_size_in_bytes)]
    coll[kind] = RA.collective_bytes(comp.as_text())
    # float32 (XLA-CPU reduces bf16 in float32) at 0 and 1 layers, each
    # collective's kind, result bytes and op name: the layers are a scan,
    # whose body the HLO holds once
    for L in (0, 1):
        comp, _ = D.lower_cell(cfg.replace(dtype="float32", num_layers=L),
                               ShapeCell("t", kind, 64, B), mesh, rt, grad_accum=1)
        ops = []
        for line in comp.as_text().splitlines():
            m = RA._OP_RE.match(line)
            if m:
                name = line.split('op_name="')[1].split('"')[0] if "op_name" in line else ""
                ops.append([m.group("op").replace("-start", ""),
                            RA._shape_bytes(m.group("result")), name])
        coll[f"{kind}/f32/L{L}"] = ops
out["coll"] = coll
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def xla_cells():
    """The reference's ``lower_cell`` of reduced granite-8b (``shardable``
    to model 4) on a (2, 4) mesh of 8 host devices, in a subprocess."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", XLA_SCRIPT], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_argument_and_alias_bytes_equal_xla(xla_cells):
    """Reduced granite-8b (``shardable`` to model 4) on a (2, 4) mesh at
    S 64: the port's argument bytes summed over leaf shards of its specs
    equal XLA's ``memory_analysis`` of the reference's ``lower_cell``
    (8 host devices, in a subprocess), and so do the donated bytes."""
    xla = {k: v for k, v in xla_cells.items() if k != "coll"}
    assert xla == {"prefill": [58496, 0], "train": [232968, 231944], "decode": [66196, 8192]}
    mesh = AbstractMesh((2, 4), ("data", "model"))
    cfg, _ = PS.shardable(reduced(p_get_config("granite-8b")), 4)
    rt = Runtime(remat="full", attn_impl="auto")
    for kind, B in (("prefill", 4), ("train", 8), ("decode", 8)):
        mem = D.trace_cell(cfg, ShapeCell("t", kind, 64, B), mesh, rt, grad_accum=1,
                           device="cpu").memory
        assert [mem["argument_bytes"], mem["alias_bytes"]] == xla[kind], kind


# the reference's decode attention over a sequence-sharded cache reduces
# its softmax's max and sum and its P.V partials over the model axis; the
# port's cache holds the rank's KV heads, whose attention needs none
SEQ_PARALLEL_ATTENTION = ("reduce_max", "reduce_sum", "bhgqk,bkhd->bqhgd")


def xla_extrapolated(ops0, ops1, periods, keep=lambda op: True):
    """{kind: bytes} of XLA's collectives as the reference's dry-run
    extrapolates them, C0 + periods · (C1 - C0), over the ops ``keep``
    passes."""
    def by_kind(ops):
        out = dict.fromkeys(PA.COLLECTIVE_KINDS, 0)
        for kind, n, name in ops:
            if keep(name):
                out[kind] += n
        return out
    c0, c1 = by_kind(ops0), by_kind(ops1)
    return {k: c0[k] + periods * (c1[k] - c0[k]) for k in c0}


def test_rank_trace_collectives_against_xla(xla_cells):
    """Rank 0's count of the same cells in float32 (``trace_cell``'s rank
    trace over a fake process group of 8) against XLA's collectives of the
    reference's, extrapolated over its layer scan as its dry-run does, by
    the bounds ``PERF.md`` wrote before the comparison: prefill all-reduce
    0.9-1.1x; decode all-reduce 0.9-1.1x once the reference's
    sequence-parallel attention's reductions, which the port's head-split
    cache does not make, are named and left out (with them, 0.69x); the
    train step's total 0.75-1.33x.  The kinds one side alone counts:
    the port's logits all-gather (whole logits on every rank) in prefill
    and decode, the reference's query all-gather in decode; in training,
    the port's ZeRO reduce-scatters against XLA's all-to-all and
    collective-permutes."""
    mesh = AbstractMesh((2, 4), ("data", "model"))
    cfg, _ = PS.shardable(reduced(p_get_config("granite-8b")), 4)
    cfg = cfg.replace(dtype="float32")
    rt = Runtime(remat="full", attn_impl="auto")
    got, want, flops = {}, {}, {}
    for kind, B in (("prefill", 4), ("train", 8), ("decode", 8)):
        tr = D.trace_cell(cfg, ShapeCell("t", kind, 64, B), mesh, rt, grad_accum=1,
                          device="cpu")
        got[kind] = {k: tr.rank_costs[f"coll_{k}"] for k in PA.COLLECTIVE_KINDS}
        flops[kind] = (tr.rank_costs["flops"], tr.costs["flops"] / 8)
        ops = [xla_cells["coll"][f"{kind}/f32/L{L}"] for L in (0, 1)]
        want[kind] = xla_extrapolated(*ops, cfg.num_layers)
        if kind == "decode":
            want["decode/residual"] = xla_extrapolated(
                *ops, cfg.num_layers,
                keep=lambda name: not any(t in name for t in SEQ_PARALLEL_ATTENTION))
    print("rank trace / XLA:", {
        "prefill all-reduce": got["prefill"]["all-reduce"] / want["prefill"]["all-reduce"],
        "decode all-reduce": got["decode"]["all-reduce"] / want["decode"]["all-reduce"],
        "decode all-reduce, residual stream":
            got["decode"]["all-reduce"] / want["decode/residual"]["all-reduce"],
        "train total": sum(got["train"].values()) / sum(want["train"].values())},
        {k: (got[k], want[k]) for k in ("prefill", "decode", "train")},
        "FLOPs, rank 0 and the even split:", flops)
    assert 0.9 <= got["prefill"]["all-reduce"] / want["prefill"]["all-reduce"] <= 1.1
    assert got["prefill"]["all-gather"] > 0 == want["prefill"]["all-gather"]
    assert 0.9 <= got["decode"]["all-reduce"] / want["decode/residual"]["all-reduce"] <= 1.1
    assert got["decode"]["all-reduce"] < 0.9 * want["decode"]["all-reduce"]
    total = sum(got["train"].values()) / sum(want["train"].values())
    assert 0.75 <= total <= 1.33, total
    assert got["train"]["reduce-scatter"] > 0 == want["train"]["reduce-scatter"]
    assert want["train"]["all-to-all"] > 0 == got["train"]["all-to-all"]


def test_counter_counts_in_place_collectives_on_a_fake_group():
    """Under a fake process group of 4 ranks, the in-place
    ``torch.distributed`` calls of known shapes: ``all_reduce`` at its
    tensor's bytes (in place: its result is its input, counted once),
    ``all_gather_into_tensor`` at 4 shares, ``reduce_scatter_tensor`` at
    a quarter, one call each."""
    import torch.distributed as dist
    from repro_torch.distributed.meshes import AbstractMesh as AM
    from repro_torch.distributed.meshes import rank_view

    with rank_view(AM((1, 4), ("data", "model")), "cpu") as rm:
        with PA.fake_mode() as mode:
            a = torch.empty(64, 32)

        def f(a):
            y = a.clone()
            dist.all_reduce(y, group=rm.model_group)
            g = a.new_empty(4 * 64, 32)
            dist.all_gather_into_tensor(g, a, group=rm.model_group)
            r = a.new_empty(16, 32)
            dist.reduce_scatter_tensor(r, a, group=rm.model_group)
            return y, g, r

        cs, _ = PA.count_costs(f, a, mode=mode)
    assert not torch.distributed.is_initialized()
    n = 64 * 32 * 4
    assert cs["coll_all-reduce"] == n and cs["coll_all-gather"] == 4 * n
    assert cs["coll_reduce-scatter"] == n // 4 and cs["coll_bytes"] == n + 4 * n + n // 4
    assert cs["_counts"] == {"all-gather": 1, "all-reduce": 1, "reduce-scatter": 1,
                             "all-to-all": 0, "collective-permute": 0}


def test_rank_view_refuses_an_initialised_group(tmp_path):
    """The fake group never replaces a process group in use."""
    import torch.distributed as dist
    from repro_torch.distributed.meshes import rank_view

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialised"):
            with rank_view(AbstractMesh((1, 2), ("data", "model")), "cpu"):
                pass
        assert dist.is_initialized() and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_record_derives_the_reference_terms(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "whisper-base",
         "--shape", "decode_32k", "--skip-variants", "--device", "cpu", "--out",
         str(tmp_path)], cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "dry-run complete" in proc.stdout
    rec = json.loads((tmp_path / "whisper-base__decode_32k__16x16.json").read_text())
    # rank 0 of the 16 x 16 mesh traced over a fake group: its collectives
    assert rec["mesh"] == "16x16" and rec["chips"] == 256 and rec["coll_counted"] is True
    assert rec["cost_totals"]["coll_bytes"] > 0
    assert rec["memory"]["argument_bytes"] > 0 and rec["cost_totals"]["flops"] > 0
    port = PA.derive_terms(rec, p_get_config("whisper-base"), P_SHAPES["decode_32k"], P_H100)
    ref = RA.derive_terms(rec, r_get_config("whisper-base"), R_SHAPES["decode_32k"], R_H100)
    assert port == ref
    assert rec["model_flops_total"] == RA.model_flops(
        RS.shardable(r_get_config("whisper-base"), 16)[0], R_SHAPES["decode_32k"],
        original_cfg=r_get_config("whisper-base"))


def test_cli_without_a_card_exits_2(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        D.main(["--arch", "whisper-base", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b", "qwen2-moe-a2.7b", "gemma3-4b",
                                  "whisper-base"])
def test_rank_trace_serves_every_family(arch, kind):
    """Rank 0's serving step of each family at model_par 2 on a (1, 2)
    mesh (padded as the dry-run pads it): it runs over the fake group --
    the decode cache that ``init_cache`` allocates under the rank's mesh
    included, an attention-free model's too -- and dispatches the model
    group's all-reduces.  An attention-free config keeps the published
    head counts of 0."""
    full = p_get_config(arch)
    cfg = reduced(full)
    if not full.num_heads:
        cfg = cfg.replace(num_heads=0, num_kv_heads=0)
    cfg, _ = PS.shardable(cfg, 2)
    tr = D.trace_cell(cfg, _KINDS[kind], AbstractMesh((1, 2), ("data", "model")),
                      Runtime(remat="full"), device="cpu")
    assert tr.rank_costs["_counts"]["all-reduce"] > 0
    assert tr.rank_costs["coll_bytes"] > 0

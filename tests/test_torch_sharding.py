"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's, for every arch on the reference tests' 1-pod (16, 16) and
2-pod (2, 16, 16) meshes (``tests/test_sharding.py``): ``shardable``'s
changes, and ``param_specs``, ``opt_state_specs`` (ZeRO on and off;
float32 and int8 moments), ``batch_specs``, ``cache_specs`` and
``activation_rules`` spec for spec, leaf for leaf.  The specs are pure
functions of the config, the mesh's shape and the leaves' shapes; the
port reads its leaves' shapes from its own ``eval_shape`` of
``Model.init``, so the leaf paths are held too.  Plus the port's mirrors
of the reference's ``zero_extend``, batch/cache and mesh-helper cases,
and its meshes of logical units."""
import jax
import pytest

torch = pytest.importorskip("torch")

from repro.compat import abstract_mesh  # noqa: E402
from repro.configs import ARCHS, get_config  # noqa: E402
from repro.distributed import ctx as RC  # noqa: E402
from repro.distributed import sharding as RS  # noqa: E402
from repro.models import Runtime, build_model  # noqa: E402
from repro.optim import AdamW, AdamWConfig  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch import models as PMod  # noqa: E402
from repro_torch import optim as PO  # noqa: E402
from repro_torch.distributed import ctx as PCtx  # noqa: E402
from repro_torch.distributed import meshes as PMe  # noqa: E402
from repro_torch.distributed import sharding as PS  # noqa: E402
from repro_torch.distributed.meshes import P  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.tree import eval_shape, leaves_with_paths  # noqa: E402

R_MESH = {"1pod": abstract_mesh((16, 16), ("data", "model")),
          "2pod": abstract_mesh((2, 16, 16), ("pod", "data", "model"))}
P_MESH = {"1pod": make_production_mesh(), "2pod": make_production_mesh(multi_pod=True)}


def _ref_specs(tree):
    """{path: tuple(spec)} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s) for path, s in flat}


def _port_specs(tree):
    return {k: tuple(s) for k, s in leaves_with_paths(tree)}


_SHAPES = {}


def _shapes(name, model_par):
    """Reference and port parameter shapes of ``shardable(cfg, mp)``."""
    key = (name, model_par)
    if key not in _SHAPES:
        rcfg, _ = RS.shardable(get_config(name), model_par)
        pcfg, _ = PS.shardable(PC.get_config(name), model_par)
        rshape = jax.eval_shape(lambda: build_model(rcfg, Runtime()).init(jax.random.key(0)))
        pshape = eval_shape(lambda: PMod.build_model(pcfg).init(0, device="cpu"))
        _SHAPES[key] = (rcfg, pcfg, rshape, pshape)
    return _SHAPES[key]


@pytest.mark.parametrize("name", sorted(ARCHS))
@pytest.mark.parametrize("mp", [2, 16])
def test_shardable_matches(name, mp):
    rcfg, rch = RS.shardable(get_config(name), mp)
    pcfg, pch = PS.shardable(PC.get_config(name), mp)
    assert pch == rch
    for f in ("num_heads", "num_kv_heads", "num_experts", "vocab_size", "d_inner"):
        assert getattr(pcfg, f) == getattr(rcfg, f), f


@pytest.mark.parametrize("name", sorted(ARCHS))
@pytest.mark.parametrize("mesh", ["1pod", "2pod"])
def test_param_and_opt_specs_match(name, mesh):
    rmesh, pmesh = R_MESH[mesh], P_MESH[mesh]
    rcfg, pcfg, rshape, pshape = _shapes(name, rmesh.shape["model"])
    rp = _ref_specs(RS.param_specs(rcfg, rmesh, rshape))
    pp = _port_specs(PS.param_specs(pcfg, pmesh, pshape))
    assert pp == rp
    for sd in ("float32", "int8"):
        ropt = jax.eval_shape(lambda: AdamW(AdamWConfig(state_dtype=sd)).init(rshape))
        popt = PO.AdamW(PO.AdamWConfig(state_dtype=sd)).init(pshape)  # meta tensors
        for zero in (True, False):
            want = _ref_specs(RS.opt_state_specs(rcfg, rmesh, ropt, zero=zero))
            got = _port_specs(PS.opt_state_specs(pcfg, pmesh, popt, zero=zero))
            assert got == want, (sd, zero)


@pytest.mark.parametrize("name", sorted(ARCHS))
@pytest.mark.parametrize("mesh", ["1pod", "2pod"])
def test_batch_cache_activation_specs_match(name, mesh):
    rmesh, pmesh = R_MESH[mesh], P_MESH[mesh]
    rcfg, _ = RS.shardable(get_config(name), 16)
    pcfg, _ = PS.shardable(PC.get_config(name), 16)
    for B in (1, 32, 64, 256):
        shapes = {"tokens": (B, 4096), "patch_embeds": (B, 16, rcfg.d_model)}
        assert {k: tuple(v) for k, v in PS.batch_specs(pcfg, pmesh, shapes).items()} == \
            {k: tuple(v) for k, v in RS.batch_specs(rcfg, rmesh, shapes).items()}
        rm = build_model(rcfg, Runtime(decode_window_slice=True))
        for cap in (4096, 32768):
            cache = {k: tuple(v.shape) for k, v in
                     jax.eval_shape(lambda: rm.init_cache(B, cap)).items()}
            assert {k: tuple(v) for k, v in PS.cache_specs(pcfg, pmesh, cache).items()} == \
                {k: tuple(v) for k, v in RS.cache_specs(rcfg, rmesh, cache).items()}
        want = RS.activation_rules(rcfg, rmesh, B)
        got = PS.activation_rules(pcfg, pmesh, B)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].spec) == tuple(want[k].spec)


def test_zero_extend():
    mesh = P_MESH["1pod"]
    assert PS.zero_extend(P(None, "model"), (4096, 1024), mesh) == P("data", "model")
    assert PS.zero_extend(P(None, None), (7, 64), mesh) == P(None, "data")
    assert PS.zero_extend(P(None,), (7,), mesh) == P(None)
    assert PS.zero_extend(P(None, None), (64, 64), P_MESH["2pod"]) == P(("pod", "data"), None)
    for spec, shape in (((None, "model"), (4096, 1024)), ((None, None), (7, 64)),
                        ((None,), (7,)), ((None, None, None), (32, 3, 48))):
        for m in ("1pod", "2pod"):
            want = RS.zero_extend(jax.sharding.PartitionSpec(*spec), shape, R_MESH[m])
            assert tuple(PS.zero_extend(P(*spec), shape, P_MESH[m])) == tuple(want)


def test_batch_and_cache_specs():
    mesh = P_MESH["1pod"]
    cfg, _ = PS.shardable(PC.get_config("qwen3-32b"), 16)
    assert PS.batch_specs(cfg, mesh, {"tokens": (256, 4096)})["tokens"] == P("data", None)
    assert PS.batch_specs(cfg, mesh, {"tokens": (1, 4096)})["tokens"] == P(None, None)
    cs = PS.cache_specs(cfg, mesh, {"k": (64, 128, 32768, 8, 128), "v": (64, 128, 32768, 8, 128)})
    assert cs["k"] == P(None, "data", "model", None, None)


def test_mesh_helpers():
    assert PS.mesh_dp_size(P_MESH["2pod"]) == 32
    assert PS.mesh_dp_axes(P_MESH["2pod"]) == ("pod", "data")
    assert PS.mesh_model_size(P_MESH["1pod"]) == 16
    assert P_MESH["2pod"].shape == dict(R_MESH["2pod"].shape)
    assert P_MESH["2pod"].axis_names == tuple(R_MESH["2pod"].axis_names)


def test_logical_units_and_carving(monkeypatch):
    """``REPRO_HOST_DEVICES`` presents logical units of one device, meshes
    carve contiguous blocks of them, and every unit of a mesh names the
    same device."""
    monkeypatch.setenv("REPRO_HOST_DEVICES", "8")
    units = PMe.units("cpu")
    assert [u.id for u in units] == list(range(8))
    assert {u.device for u in units} == {torch.device("cpu")}
    m1 = PMe.carve_submesh(units, 0, 4, model_axis=2)
    m2 = PMe.carve_submesh(units, 4, 4, model_axis=2)
    assert m1.shape == {"data": 2, "model": 2} and m1.axis_names == ("data", "model")
    assert set(m1.devices.flat).isdisjoint(set(m2.devices.flat))
    assert m1.device == torch.device("cpu")
    x = torch.ones((8, 16))
    assert PMe.NamedSharding(m1, P("data", "model")).place(x).device == m1.device
    with pytest.raises(ValueError):
        PMe.carve_submesh(units, 6, 4)
    monkeypatch.delenv("REPRO_HOST_DEVICES")
    assert len(PMe.units("cpu")) == 1
    assert PMe.GPU_NODE_4X.unit_slice(1, 2) == (1, 2)
    assert PMe.V5E_POD_256.total_chips == 256


def test_mesh_over_two_cards_is_refused():
    """A (1, 2) mesh over two cards describes a tensor-parallel job of two
    ranks, a card each (its ``model`` axis across them).  Outside those
    ranks it holds no device and no group, and placing a leaf on it is
    refused."""
    units = [PMe.LogicalDevice(0, torch.device("cuda", 0)),
             PMe.LogicalDevice(1, torch.device("cuda", 1))]
    m = PMe.make_mesh((1, 2), ("data", "model"), devices=units)
    assert m.spans_cards and m.rows == [tuple(units)]
    assert m.device is None and m.group is None and m.model_group is None
    with pytest.raises(RuntimeError, match="holds no unit"):
        PMe.NamedSharding(m, P(None, "model")).place(torch.ones(2, 4))


def test_current_rules_matches_reference():
    """``current_rules()``: None outside ``sharding_rules``, the installed
    table inside it (the innermost one when nested, None under
    ``sharding_rules(None)``), restored on exit, in both packages."""
    outer, inner = {"embed": P("data", None)}, {"residual": P(None, "model")}
    for ctx in (RC, PCtx):
        assert ctx.current_rules() is None
        with ctx.sharding_rules(outer):
            assert ctx.current_rules() is outer
            with ctx.sharding_rules(inner):
                assert ctx.current_rules() is inner
            with ctx.sharding_rules(None):
                assert ctx.current_rules() is None
            assert ctx.current_rules() is outer
        assert ctx.current_rules() is None

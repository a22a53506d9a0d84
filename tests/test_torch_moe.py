"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``), on the CPU.

At ``reduced(qwen2-moe-a2.7b)`` (shared experts) and
``reduced(arctic-480b)`` (dense residual), with the reference's
``moe_init`` weights carried over by ``carry.params_from_numpy``:
``moe_apply`` and ``moe_aux_loss`` within atol/rtol 1e-4 in float32, and
within 2e-2 of the largest reference magnitude in bfloat16.  The
capacity drops must be the reference's, not only close outputs: one
flipped drop moves one position by a large amount, so a case that drops
many slots (capacity factor 1.0, S·k/E = 16) also holds the kept mask,
and tied router probabilities must go to the lower expert index, as
``jax.lax.top_k`` sends them.  The router (and the shared-expert gate)
stays float32 in a bfloat16 model in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.core.carry import params_from_numpy  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402

MOE = sorted(n for n, c in ARCHS.items() if c.uses_moe)
B = 2


def _cfgs(name, dtype="float32"):
    return (reduced(ARCHS[name]).replace(dtype=dtype),
            PC.reduced(PC.get_config(name)).replace(dtype=dtype))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_params(cfg, dtype, seed=3):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return RM.moe_init(jax.random.key(seed), cfg, jdt)


def _x(cfg, S, dtype, seed=11, scale=1.0):
    x = np.random.default_rng(seed).normal(size=(B, S, cfg.d_model)) * scale
    return x.astype(np.float32)


def _pair(name, dtype, S, *, router=None, seed=3):
    """(ref cfg, port cfg, ref params, port params, ref x, port x)."""
    rcfg, pcfg = _cfgs(name, dtype)
    rp = _ref_params(rcfg, dtype, seed)
    if router is not None:
        rp = dict(rp, router=jnp.asarray(router, jnp.float32))
    pp = params_from_numpy(_np(rp), device="cpu")
    x = _x(rcfg, S, dtype)
    rx = jnp.asarray(x).astype(rp["experts"]["gate"].dtype)
    px = torch.from_numpy(x).to(pp["experts"]["gate"].dtype)
    return rcfg, pcfg, rp, pp, rx, px


def _ref_keep(rp, rx, cfg, cf):
    """The reference's kept mask, by ``moe_apply``'s own steps
    (``src/repro/models/moe.py``): top-k, position-in-expert, capacity."""
    S = rx.shape[1]
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = max(1, int(np.ceil(cf * S * k / E)))
    probs = jax.nn.softmax(rx.astype(jnp.float32) @ rp["router"], axis=-1)
    top_e = jax.lax.top_k(probs, k)[1].reshape(rx.shape[0], S * k)
    pos = jnp.cumsum(jax.nn.one_hot(top_e, E, dtype=jnp.int32), axis=1) - 1
    pos_of = jnp.take_along_axis(pos, top_e[..., None], axis=2)[..., 0]
    return np.asarray(top_e), np.asarray(pos_of < C)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _rel_close(got, want, tol):
    want = np.asarray(want, np.float32)
    rel = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert rel < tol, rel


@pytest.mark.parametrize("S", [1, 8, 32])
@pytest.mark.parametrize("name", MOE)
def test_moe_apply_matches_reference_float32(name, S):
    rcfg, pcfg, rp, pp, rx, px = _pair(name, "float32", S)
    want = RM.moe_apply(rp, rx, rcfg)
    got = PM.moe_apply(pp, px, pcfg)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("name", MOE)
def test_moe_aux_loss_matches_reference(name):
    rcfg, pcfg, rp, pp, rx, px = _pair(name, "float32", 32)
    _close(PM.moe_aux_loss(pp, px, pcfg), RM.moe_aux_loss(rp, rx, rcfg))


@pytest.mark.parametrize("name", MOE)
def test_moe_apply_matches_reference_bfloat16(name):
    """bfloat16 weights carried exactly, the router kept float32: within
    2e-2 of the reference's largest magnitude."""
    rcfg, pcfg, rp, pp, rx, px = _pair(name, "bfloat16", 32)
    assert pp["router"].dtype == torch.float32
    assert pp["experts"]["gate"].dtype == torch.bfloat16
    want = RM.moe_apply(rp, rx, rcfg)
    got = PM.moe_apply(pp, px, pcfg)
    assert got.dtype == torch.bfloat16
    _rel_close(got, want, 2e-2)
    _close(PM.moe_aux_loss(pp, px, pcfg), RM.moe_aux_loss(rp, rx, rcfg))


@pytest.mark.parametrize("name", MOE)
def test_capacity_drops_are_the_references(name):
    """Capacity factor 1.0 at S 64: S·k/E = 32 slots an expert on
    average, against a capacity of 32, so skewed routing drops many.  The
    kept mask equals the reference's slot for slot, and so does the
    output."""
    rcfg, pcfg, rp, pp, rx, px = _pair(name, "float32", 64)
    # skew the router toward expert 0 so its buffer overflows
    router = np.asarray(rp["router"]).copy()
    router[:, 0] += 0.5 * np.abs(router).mean()
    rcfg, pcfg, rp, pp, rx, px = _pair(name, "float32", 64, router=router)
    want_e, want_keep = _ref_keep(rp, rx, rcfg, 1.0)
    flat_e, _, keep, _, C = PM.route(pp, px, pcfg, capacity_factor=1.0)
    assert C == 32
    assert np.array_equal(flat_e.numpy(), want_e)
    assert np.array_equal(keep.numpy(), want_keep)
    assert 0 < (~want_keep).sum() < want_keep.size // 2  # the case drops some
    _close(PM.moe_apply(pp, px, pcfg, capacity_factor=1.0),
           RM.moe_apply(rp, rx, rcfg, capacity_factor=1.0))


@pytest.mark.parametrize("tie", ["all", "pairs"])
@pytest.mark.parametrize("name", MOE)
def test_tied_router_goes_to_the_lower_expert(name, tie):
    """Tied router probabilities: every expert ("all": a zero router), or
    experts 0/1 and 2/3 ("pairs": duplicated router columns).  The port
    picks the lower index of a tie, as ``jax.lax.top_k`` does, so the
    experts, the drops and the output are the reference's."""
    rcfg, _, rp, _, _, _ = _pair(name, "float32", 16)
    d, E = rcfg.d_model, rcfg.num_experts
    if tie == "all":
        router = np.zeros((d, E), np.float32)
    else:
        base = np.asarray(rp["router"])
        router = np.repeat(base[:, ::2], 2, axis=1)[:, :E].copy()
    rcfg, pcfg, rp, pp, rx, px = _pair(name, "float32", 16, router=router)
    want_e, want_keep = _ref_keep(rp, rx, rcfg, 1.25)
    flat_e, _, keep, _, _ = PM.route(pp, px, pcfg)
    assert np.array_equal(flat_e.numpy(), want_e)
    assert np.array_equal(keep.numpy(), want_keep)
    if tie == "all":  # top-2 of equal probabilities: experts 0 and 1
        assert set(np.unique(want_e)) == {0, 1}
    else:  # each pair's lower member wins: an odd expert is never first
        assert (want_e.reshape(B, 16, -1)[..., 0] % 2 == 0).all()
    _close(PM.moe_apply(pp, px, pcfg), RM.moe_apply(rp, rx, rcfg))
    _close(PM.moe_aux_loss(pp, px, pcfg), RM.moe_aux_loss(rp, rx, rcfg))


def test_top_k_ties_on_a_vector():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3]])
    vals, idx = PM.top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2]]
    assert vals.tolist() == np.asarray(jv).tolist()


@pytest.mark.parametrize("name", MOE)
def test_moe_init_matches_reference_tree(name):
    """The port's ``moe_init`` gives the reference's tree: the same keys,
    shapes and dtypes, the router and shared gate float32 in a bfloat16
    model, and the expert weights at the reference's scale."""
    rcfg, pcfg = _cfgs(name, "bfloat16")
    rtree = _np(_ref_params(rcfg, "bfloat16"))
    gen = torch.Generator(device="cpu").manual_seed(0)
    ptree = PM.moe_init(gen, pcfg, torch.bfloat16)

    def walk(r, p, path=""):
        assert set(r) == set(p), path
        for k in r:
            if isinstance(r[k], dict):
                walk(r[k], p[k], f"{path}/{k}")
            else:
                assert tuple(p[k].shape) == r[k].shape, f"{path}/{k}"
                assert str(p[k].dtype).split(".")[-1] == r[k].dtype.name, f"{path}/{k}"

    walk(rtree, ptree)
    assert ptree["router"].dtype == torch.float32
    for key in ("gate", "up", "down"):
        want = float(np.asarray(rtree["experts"][key], np.float32).std())
        got = float(ptree["experts"][key].float().std())
        assert abs(got - want) < 0.1 * want, key


def test_carrying_with_a_dtype_would_cast_the_router():
    """Why the MoE tree is carried without ``dtype``: a cast carries every
    floating leaf, the float32 router included, which the reference keeps
    float32 in a bfloat16 model."""
    rcfg, _ = _cfgs("qwen2-moe-a2.7b", "bfloat16")
    tree = _np(_ref_params(rcfg, "bfloat16"))
    assert params_from_numpy(tree, device="cpu")["router"].dtype == torch.float32
    assert params_from_numpy(tree, device="cpu")["shared_gate"].dtype == torch.float32
    cast = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert cast["router"].dtype == torch.bfloat16

"""The port's expert-parallel MoE (``repro_torch.models.moe.moe_apply_ep``)
against the reference's (``repro.models.moe.moe_apply_ep``), on the CPU.

On a (1, 1) mesh in process, at reduced qwen2-moe-a2.7b (shared experts)
and arctic-480b (dense residual), float32, capacity factor 1.0 so slots
are dropped: rel. 1e-5 and the kept (token, slot) pairs of the reference
(its ``_local_expert_compute`` routing replayed with jax ops).  The
model's ``moe_impl="ep"`` / ``"auto"`` under ``mesh_context`` takes the
path in both packages.  At mp 4 and on a (2, 2) mesh, against the
reference run on 4 emulated host devices in a subprocess (``slow``, as
``tests/test_multidevice.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import moe as RM  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.core.carry import params_from_numpy  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402

from test_torch_moe import B, MOE, _cfgs, _np, _pair, _rel_close  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401


# ---------------------------------------------------------------------------
# The expert-parallel path, moe_apply_ep
# ---------------------------------------------------------------------------


def _ref_ep_keep(rp, rx, cfg, cf, mp):
    """The reference's kept (token, slot) pairs of every model column at
    ``dp = 1``, by ``_local_expert_compute``'s own steps."""
    B, S, d = rx.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    E_loc, T = E // mp, B * S
    C = max(1, int(np.ceil(cf * T * k / E)))
    probs = jax.nn.softmax(rx.reshape(T, d).astype(jnp.float32) @ rp["router"], axis=-1)
    flat_e = jax.lax.top_k(probs, k)[1].reshape(-1)
    out = []
    for j in range(mp):
        local = (flat_e >= j * E_loc) & (flat_e < (j + 1) * E_loc)
        loc_e = jnp.where(local, flat_e - j * E_loc, E_loc)
        pos = jnp.cumsum(jax.nn.one_hot(loc_e, E_loc + 1, dtype=jnp.int32), axis=0) - 1
        pos_of = jnp.take_along_axis(pos, loc_e[:, None], axis=1)[:, 0]
        out.append(np.asarray(local & (pos_of < C)))
    return out, C


def _port_ep_keep(pp, px, cfg, cf, mp):
    B, S, d = px.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = max(1, int(np.ceil(cf * B * S * k / E)))
    logits = px.reshape(B * S, d).float() @ pp["router"]
    return [PM.local_route(logits, e_base=j * (E // mp), E_loc=E // mp, k=k, C=C)[2].numpy()
            for j in range(mp)]


@pytest.mark.parametrize("name", MOE)
def test_moe_apply_ep_matches_reference_mp1(name):
    """``moe_apply_ep`` on a (1, 1) mesh in both packages, float32, at
    capacity factor 1.0 (slots are dropped): rel. 1e-5, and the kept slots
    are the reference's."""
    cf = 1.0
    from repro.distributed.meshes import make_mesh as r_make_mesh
    from repro_torch.distributed.meshes import make_mesh, units

    rcfg, pcfg, rp, pp, rx, px = _pair(name, "float32", 32)
    want = RM.moe_apply_ep(rp, rx, rcfg, r_make_mesh((1, 1), ("data", "model")),
                           capacity_factor=cf)
    mesh = make_mesh((1, 1), ("data", "model"), devices=units("cpu", count=1))
    got = PM.moe_apply_ep(pp, px, pcfg, mesh, capacity_factor=cf)
    _rel_close(got, want, 1e-5)
    want_keep, _ = _ref_ep_keep(rp, rx, rcfg, cf, 1)
    got_keep = _port_ep_keep(pp, px, pcfg, cf, 1)
    assert np.array_equal(got_keep[0], want_keep[0])
    assert (~want_keep[0]).sum() > 0  # the case drops slots


def test_model_takes_the_ep_path_under_a_mesh():
    """``moe_impl="ep"`` and ``"auto"`` under ``mesh_context`` route the
    model's MoE layers through ``moe_apply_ep`` in both packages: the same
    loss, which differs from the dense dispatch's where the capacity
    (from the whole batch's tokens, not a row's) drops other slots."""
    from repro.distributed.ctx import mesh_context as r_mesh_context
    from repro.distributed.meshes import make_mesh as r_make_mesh
    from repro.models import Runtime as RRuntime, build_model as r_build
    from repro_torch.distributed.ctx import mesh_context
    from repro_torch.distributed.meshes import make_mesh, units
    from repro_torch.models import Runtime as PRuntime, build_model as p_build

    rcfg, pcfg = _cfgs("qwen2-moe-a2.7b")
    rmodel = r_build(rcfg, RRuntime(remat="none", moe_impl="ep"))
    params = rmodel.init(jax.random.key(0))
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (B, 24)).astype(np.int32)
    with r_mesh_context(r_make_mesh((1, 1), ("data", "model"))):
        want = float(jax.jit(rmodel.loss)(params, {"tokens": jnp.asarray(toks)})[0])
    pp = params_from_numpy(_np(params), device="cpu")
    batch = {"tokens": torch.from_numpy(toks)}
    for impl in ("ep", "auto"):
        pmodel = p_build(pcfg, PRuntime(remat="none", moe_impl=impl))
        with mesh_context(make_mesh((1, 1), ("data", "model"), devices=units("cpu", count=1))):
            got = float(pmodel.loss(pp, batch)[0])
        assert abs(got - want) <= 1e-5 * abs(want), impl


_EP_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ARCHS, reduced
from repro.distributed.meshes import make_mesh
from repro.models import moe as RM
assert len(jax.devices()) == 4
CASES = [("qwen2-moe-a2.7b", (1, 4), 1.0), ("qwen2-moe-a2.7b", (2, 2), 1.0),
         ("arctic-480b", (1, 4), 1.25)]
out = {}
for name, shape, cf in CASES:
    cfg = reduced(ARCHS[name]).replace(dtype="float32", num_experts=8)
    p = RM.moe_init(jax.random.key(3), cfg, jnp.float32)
    x = np.random.default_rng(11).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
        out[name + "|p|" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    out[name + "|x"] = x
    mesh = make_mesh(shape, ("data", "model"))
    y = RM.moe_apply_ep(p, jnp.asarray(x), cfg, mesh, capacity_factor=cf)
    out[f"{name}|y|{shape[0]}x{shape[1]}|{cf}"] = np.asarray(y)
np.savez(sys.argv[1], **out)
print("EP OK")
"""


@pytest.mark.slow
def test_moe_apply_ep_matches_reference_mp4(tmp_path):
    """At ``mp`` 4 (a (1, 4) mesh; qwen2-moe-a2.7b dropping slots at
    capacity factor 1.0, arctic-480b at 1.25) and at (2, 2) (batch
    shards, each with its own capacity), against the reference run on 4
    emulated host devices in a subprocess: rel. 1e-5, float32, reduced
    configs with 8 experts (2 a column at mp 4)."""
    import os
    import subprocess
    import sys

    from repro_torch.distributed.meshes import make_mesh, units
    from repro_torch.tree import set_by_path

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    out = tmp_path / "ep.npz"
    proc = subprocess.run([sys.executable, "-c", _EP_SCRIPT, str(out)],
                          cwd=os.path.join(os.path.dirname(__file__), ".."),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "EP OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(out) as z:
        arrays = {k: z[k] for k in z.files}
    for key in (k for k in arrays if "|y|" in k):
        name, _, shape, cf = key.split("|")
        cfg = PC.reduced(PC.get_config(name)).replace(dtype="float32", num_experts=8)
        p = {}
        for k, v in arrays.items():
            if k.startswith(name + "|p|"):
                set_by_path(p, k.split("|")[2], torch.from_numpy(v))
        x = torch.from_numpy(arrays[name + "|x"])
        dims = tuple(int(n) for n in shape.split("x"))
        mesh = make_mesh(dims, ("data", "model"), devices=units("cpu", count=4))
        _rel_close(PM.moe_apply_ep(p, x, cfg, mesh, capacity_factor=float(cf)),
                   arrays[key], 1e-5)

"""Training parity on the CPU, second part: one ``make_train_step`` step
of reduced mamba2-2.7b and qwen2-moe-a2.7b against the reference's (as
``tests/test_torch_train.py`` holds granite-8b and hymba-1.5b), ``remat``
none / full / dots bitwise equal in the port, and the chunked SSD's
gradient at a chunk whose decay overflows float32: the reference's is
NaN (``exp`` above the diagonal overflows and ``where`` sends 0·inf back),
the port's is finite and equals the reference's own gradient at a chunk
small enough for it to be finite, within float32 rounding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import check_train_step, flat_np, np_tree, port_train_step  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("name", ["mamba2-2.7b", "qwen2-moe-a2.7b"])
def test_train_step_from_init_matches_reference(name):
    out = check_train_step(name, 1, False, warm_steps=0)
    assert not out["flips"]


@pytest.mark.parametrize("name,grad_accum,compress", [
    ("mamba2-2.7b", 1, False), ("mamba2-2.7b", 2, True),
    ("qwen2-moe-a2.7b", 1, False), ("qwen2-moe-a2.7b", 2, True),
])
def test_train_step_mid_run_matches_reference(name, grad_accum, compress):
    out = check_train_step(name, grad_accum, compress, warm_steps=3)
    assert not out["ill"]
    if not compress:
        assert not out["flips"]


@pytest.mark.parametrize("name", ["hymba-1.5b", "whisper-base", "qwen2-moe-a2.7b",
                                  "gemma3-4b"])
def test_remat_modes_agree_bitwise(name):
    """Recomputing each period of layers (and each encoder layer) in the
    backward pass changes no bit of the step on the CPU: ``remat`` none,
    full and dots give the same loss, grads' norm and parameters."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.train.step import init_state

    cfg = reduced(get_config(name)).replace(dtype="float32")
    state = init_state(build_model(cfg), AdamW(), 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(cfg, 2, 32).global_batch(0).items()}
    out = {}
    for remat in ("none", "full", "dots"):
        new, met = port_train_step(name, 1, False, remat=remat)(state, batch)
        out[remat] = (flat_np(new["params"]), float(met["loss"]), float(met["grad_norm"]))
    for remat in ("full", "dots"):
        assert out[remat][1:] == out["none"][1:], remat
        for k, v in out["none"][0].items():
            assert np.array_equal(out[remat][0][k], v), (remat, k)


def test_ssd_gradient_finite_where_the_reference_is_nan():
    from repro.configs import get_config, reduced
    from repro.data import SyntheticLM
    from repro.models import Runtime, build_model
    from repro_torch.configs import get_config as pget, reduced as pred
    from repro_torch.core.carry import params_from_numpy
    from repro_torch.models import build_model as pbuild
    from repro_torch.train.step import value_and_grad
    from repro_torch.tree import leaves_with_paths

    name = "mamba2-2.7b"
    cfg = reduced(get_config(name)).replace(dtype="float32")
    model = build_model(cfg, Runtime(remat="none"))
    params = model.init(jax.random.key(0))
    batch = SyntheticLM(cfg, 1, 256).global_batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def ref_grads(chunk):
        m = build_model(cfg.replace(ssm_chunk=chunk), Runtime(remat="none"))
        (loss, _), g = jax.jit(jax.value_and_grad(lambda p: m.loss(p, jb), has_aux=True))(params)
        return float(loss), flat_np(np_tree(g))

    loss256, g256 = ref_grads(256)
    loss16, g16 = ref_grads(16)
    assert not all(np.isfinite(v).all() for v in g256.values())  # the reference's NaN
    assert all(np.isfinite(v).all() for v in g16.values())
    pm = pbuild(pred(pget(name)).replace(dtype="float32", ssm_chunk=256))
    pl, _, pg = value_and_grad(pm, params_from_numpy(np_tree(params), device="cpu"),
                               {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(pl) - loss256) <= 1e-5 * abs(loss256)
    assert abs(float(pl) - loss16) <= 1e-5 * abs(loss16)
    for k, g in leaves_with_paths(pg):
        g = g.numpy()
        assert np.isfinite(g).all(), k
        assert np.abs(g - g16[k]).max() <= 1e-4 * np.abs(g16[k]).max(), k

"""The checkpoint format is the contract between the packages: a state
with float32, bfloat16, int8 and int32 leaves written by either package's
``checkpoint.save`` restores bit-exact in the other, both ways, with the
same ``meta.json`` keys, leaf paths and ``dtype_map`` (bf16 as ``uint16``
bits; the port needs no ``ml_dtypes``).  A whole reference train state
(int8 moments, master weights, residuals) restores in the port under the
port's own state template, so the leaf paths agree.  Plus the port's
mirrors of ``tests/test_substrate.py``'s checkpoint cases: rotation,
``latest_step`` and the shape-mismatch error."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as RManager  # noqa: E402
from repro.checkpoint import restore as r_restore  # noqa: E402
from repro.checkpoint import save as r_save  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, load_arrays, restore, save  # noqa: E402
from repro_torch.core.carry import state_from_numpy  # noqa: E402
from repro_torch.tree import eval_shape, leaves_with_paths  # noqa: E402


def _ref_state(rng):
    def moment():
        return {"w": {"q": jnp.asarray(rng.integers(-127, 128, (4, 1, 256)), jnp.int8),
                      "scale": jnp.asarray(rng.random((4, 1, 1)), jnp.float32)},
                "b": jnp.asarray(rng.normal(size=(6,)), jnp.float32)}

    return {
        "params": {"w": jnp.asarray(rng.normal(size=(4, 6)), jnp.bfloat16),
                   "b": jnp.asarray(rng.normal(size=(6,)), jnp.float32)},
        "opt": {"m": moment(), "v": moment(), "count": jnp.asarray(7, jnp.int32)},
        "step": jnp.asarray(7, jnp.int32),
    }


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _port_bits(t):
    return (t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16
            else t.numpy())


def test_reference_checkpoint_restores_bit_exact_in_port(tmp_path):
    ref = _ref_state(np.random.default_rng(0))
    r_save(str(tmp_path / "r"), ref, step=7, metadata={"note": "x"})
    like = eval_shape(lambda: state_from_numpy(jax.tree_util.tree_map(np.asarray, ref),
                                               device="cpu"))
    got, meta = restore(str(tmp_path / "r"), like)
    assert meta["step"] == 7 and meta["metadata"] == {"note": "x"}
    want = dict(leaves_with_paths(jax.tree_util.tree_map(np.asarray, ref)))
    for k, t in leaves_with_paths(got):
        assert t.dtype == like_dtype(like, k)
        np.testing.assert_array_equal(_port_bits(t), _bits(want[k]), err_msg=k)
    assert got["params"]["w"].dtype == torch.bfloat16
    assert got["opt"]["m"]["w"]["q"].dtype == torch.int8
    assert got["step"].dtype == torch.int32


def like_dtype(like, key):
    return dict(leaves_with_paths(like))[key].dtype


def test_port_checkpoint_restores_bit_exact_in_reference(tmp_path):
    ref = _ref_state(np.random.default_rng(1))
    port = state_from_numpy(jax.tree_util.tree_map(np.asarray, ref), device="cpu")
    save(str(tmp_path / "p"), port, step=7, metadata={"note": "x"})
    r_save(str(tmp_path / "r"), ref, step=7, metadata={"note": "x"})
    with open(tmp_path / "p" / "meta.json") as f:
        pm = json.load(f)
    with open(tmp_path / "r" / "meta.json") as f:
        rm = json.load(f)
    assert pm == rm  # step, metadata, sorted keys, dtype_map
    assert rm["dtype_map"] == {"params/w": "bfloat16"}
    got, meta = r_restore(str(tmp_path / "p"), jax.eval_shape(lambda: ref))
    assert meta["step"] == 7
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                              jax.tree_util.tree_flatten_with_path(ref)[0]):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # the stored arrays themselves are the reference's, name for name
    pa, _ = load_arrays(str(tmp_path / "p"))
    with np.load(tmp_path / "r" / "arrays.npz") as z:
        ra = {k: z[k] for k in z.files}
    assert sorted(pa) == sorted(ra)
    for k in ra:
        assert pa[k].dtype == ra[k].dtype and np.array_equal(pa[k], ra[k]), k


def test_reference_train_state_restores_under_port_template(tmp_path):
    """A reduced model's whole reference train state -- int8 moments,
    master weights, compression residuals -- restores under the port's
    own ``init_state`` template: the same leaf paths, shapes and types."""
    from repro.configs import get_config, reduced
    from repro.models import Runtime, build_model
    from repro.optim import AdamW, AdamWConfig
    from repro.train.step import init_state
    from repro_torch import configs as PC
    from repro_torch import models as PMod
    from repro_torch import optim as PO
    from repro_torch.train.step import init_state as p_init_state

    cfg = reduced(get_config("qwen2-moe-a2.7b"))
    ocfg = dict(state_dtype="int8", master_weights=True)
    st = init_state(build_model(cfg, Runtime()), AdamW(AdamWConfig(**ocfg)),
                    jax.random.key(0), compress=True)
    r_save(str(tmp_path / "r"), st, step=0)
    pm = PMod.build_model(PC.reduced(PC.get_config("qwen2-moe-a2.7b")))
    like = eval_shape(lambda: p_init_state(pm, PO.AdamW(PO.AdamWConfig(**ocfg)), 0,
                                           compress=True, device="cpu"))
    got, _ = restore(str(tmp_path / "r"), like)
    want = dict(leaves_with_paths(jax.tree_util.tree_map(np.asarray, st)))
    have = dict(leaves_with_paths(got))
    assert sorted(have) == sorted(want)
    assert "opt/m/blocks/moe/experts/gate/q" in have and "opt/master/embed" in have
    for k, t in have.items():
        np.testing.assert_array_equal(_port_bits(t), _bits(want[k]), err_msg=k)


def test_state_from_numpy_round_trip():
    """Reference train state -> numpy -> port: every leaf keeps its type,
    shape and bits; a tree that is not a train state is refused."""
    ref = jax.tree_util.tree_map(np.asarray, _ref_state(np.random.default_rng(2)))
    port = state_from_numpy(ref, device="cpu")
    want = dict(leaves_with_paths(ref))
    for k, t in leaves_with_paths(port):
        assert t.shape == want[k].shape
        np.testing.assert_array_equal(_port_bits(t), _bits(want[k]), err_msg=k)
    assert port["opt"]["m"]["w"]["q"].dtype == torch.int8
    assert port["params"]["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        state_from_numpy({"params": ref["params"]}, device="cpu")


def test_ckpt_roundtrip_bf16(tmp_path):
    tree = {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4).to(torch.bfloat16),
        "nested": {"b": torch.ones((2,), dtype=torch.int32), "c": torch.zeros(())},
    }
    p = str(tmp_path / "ck")
    save(p, tree, step=7, metadata={"note": "x"})
    like = {"a": torch.empty((3, 4), dtype=torch.bfloat16, device="meta"),
            "nested": {"b": torch.empty((2,), dtype=torch.int32, device="meta"),
                       "c": torch.empty((), device="meta")}}
    out, meta = restore(p, like)
    assert meta["step"] == 7
    assert out["a"].dtype == torch.bfloat16
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["nested"]["b"], tree["nested"]["b"])


def test_ckpt_manager_rotation_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    tree = {"x": torch.arange(4)}
    for s in (10, 20, 30):
        mgr.save(s, tree)
    assert mgr.all_steps() == [20, 30] and mgr.latest_step() == 30
    out, meta = mgr.restore_latest({"x": torch.empty(4, dtype=torch.int64, device="meta")})
    assert meta["step"] == 30 and torch.equal(out["x"], tree["x"])
    # the reference's manager reads the port's directory the same way
    rmgr = RManager(str(tmp_path), keep=2, async_save=False)
    assert rmgr.all_steps() == [20, 30]


def test_ckpt_manager_async_save_and_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = {"x": torch.arange(1000, dtype=torch.float32)}
    mgr.save(5, tree)
    mgr.wait()
    assert mgr.latest_step() == 5 and mgr.last_save_s is not None
    assert os.path.exists(tmp_path / "step_0000000005" / "meta.json")


def test_ckpt_shape_mismatch_raises(tmp_path):
    p = str(tmp_path / "ck")
    save(p, {"x": torch.ones((4,))})
    with pytest.raises(ValueError):
        restore(p, {"x": torch.empty((5,), device="meta")})
    with pytest.raises(KeyError):
        restore(p, {"y": torch.empty((4,), device="meta")})


def test_ckpt_compressed_member_raises(tmp_path):
    """Both packages store the arrays uncompressed (``np.savez``); a
    compressed ``arrays.npz`` is rejected with the member it names."""
    p = tmp_path / "ck"
    save(str(p), {"x": torch.ones((4,)), "y": torch.zeros((3,))})
    np.savez_compressed(p / "arrays.npz", x=np.ones(4, np.float32), y=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="'x.npy' is compressed"):
        restore(str(p), {"x": torch.empty((4,), device="meta"),
                         "y": torch.empty((3,), device="meta")})

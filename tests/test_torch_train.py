"""One ``make_train_step`` step of the port against the reference's, on
the CPU, for reduced granite-8b (every combination of ``grad_accum`` 1 / 2
and gradient compression off / on) and reduced hymba-1.5b (1 / off and
2 / on), in float32 (``tests/test_torch_train_ssm_moe.py`` has
mamba2-2.7b and qwen2-moe-a2.7b).

Both packages start from one state, the reference's, carried with
``core/carry.state_from_numpy`` (its parameters through
``params_from_numpy``): its init, and its state after 3 of its own steps
(warm moments).  Loss and grad norm within rel. 1e-5, every updated
parameter within 1e-5 of its leaf's largest magnitude (the elements left
out and why: ``torch_parity.check_train_step``; they are counted)."""
import pytest

torch = pytest.importorskip("torch")

from torch_parity import check_train_step  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("name", ["granite-8b", "hymba-1.5b"])
def test_train_step_from_init_matches_reference(name):
    out = check_train_step(name, 1, False, warm_steps=0)
    assert not out["flips"]


@pytest.mark.parametrize("name,grad_accum,compress", [
    ("granite-8b", 1, False), ("granite-8b", 2, False),
    ("granite-8b", 1, True), ("granite-8b", 2, True),
    ("hymba-1.5b", 1, False), ("hymba-1.5b", 2, True),
])
def test_train_step_mid_run_matches_reference(name, grad_accum, compress):
    out = check_train_step(name, grad_accum, compress, warm_steps=3)
    assert not out["ill"]  # mid-run, no element is left out for conditioning
    if not compress:
        assert not out["flips"]

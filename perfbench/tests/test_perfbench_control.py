"""The comparison that decides ``correct`` fails what it must: the
lower-precision control (the reference with float8 weight products in
the program's place) fails one of each cell's limits, and a run whose
timed path is broken underneath comes out not correct, once for each
fault its cell can have.  Both at a size the CPU holds; the readings at
the cells' own sizes are ``control.py``'s on the card (PERF.md)."""
import pytest

torch = pytest.importorskip("torch")

from perfbench_tiny import PREFILLS, TRAIN, tiny_cell  # noqa: E402

import control  # noqa: E402
import harness  # noqa: E402
import program  # noqa: E402

CPU = torch.device("cpu")


def _run(cell):
    run = harness.run_cell(cell, seed=2**31 + 17, seconds=0.2, trace=False, device=CPU,
                           t_start=0.0)
    return harness.result(cell, run, False, {"platform": "cpu"})


@pytest.mark.parametrize("workload", [TRAIN] + PREFILLS)
def test_sound_run_is_correct(workload):
    out = _run(tiny_cell(workload))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("workload", [TRAIN] + PREFILLS)
def test_control_separates(workload):
    """At the small size the errors have less depth and width to grow
    through than at the cell's, so the limits (set at the cell's size)
    are not the yardstick here: the control reads more than three times
    what the program reads on one of the compared numbers."""
    cell = tiny_cell(workload)
    seed = 2**31 + 17
    program_numbers = harness.run_cell(cell, seed=seed, seconds=0.2, trace=False,
                                       device=CPU, t_start=0.0).numbers
    got = control.readings(cell, seed, CPU)["control_fp8"]
    assert any(got[k] > 3 * program_numbers[k] for k in cell.limits), (got, program_numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [TRAIN] + PREFILLS)
def test_control_fails_a_limit_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cell = harness.load_cell(workload)
    got = control.readings(cell, 2**31 + 5, torch.device("cuda", 0))["control_fp8"]
    assert any(got[k] > lim for k, lim in cell.limits.items()), (got, cell.limits)


def _state_unchanged(make):
    def broken(model, optimizer, schedule, **kw):
        pure = make(model, optimizer, schedule, **dict(kw, donate=False))

        def step(state, batch):
            return state, pure(state, batch)[1]
        return step
    return broken


def _train_half_batch(make):
    def broken(*a, **kw):
        real = make(*a, **kw)
        return lambda state, batch: real(state, {"tokens": batch["tokens"][: len(
            batch["tokens"]) // 2]})
    return broken


def _prefill_half_batch(make):
    def broken(*a, **kw):
        real = make(*a, **kw)

        def prefill(params, batch):
            t = batch["tokens"]
            logits, cache = real(params, {"tokens": t[: len(t) // 2]})
            return (torch.cat([logits, logits]),
                    {k: torch.cat([c, c], dim=1) for k, c in cache.items()})
        return prefill
    return broken


def _prefill_altered(make):
    def broken(*a, **kw):
        real = make(*a, **kw)

        def prefill(params, batch):
            logits, cache = real(params, batch)
            logits = logits.clone()
            logits[0] = -logits[0]
            return logits, cache
        return prefill
    return broken


@pytest.mark.parametrize("workload,entry,fault", [
    (TRAIN, "make_train_step", _state_unchanged),
    (TRAIN, "make_train_step", _train_half_batch),
    *[(w, "make_prefill", f) for w in PREFILLS for f in (_prefill_half_batch, _prefill_altered)],
])
def test_broken_timed_path_is_not_correct(monkeypatch, workload, entry, fault):
    monkeypatch.setattr(program, entry, fault(getattr(program, entry)))
    out = _run(tiny_cell(workload))
    assert not out["correct"], out["checks"]

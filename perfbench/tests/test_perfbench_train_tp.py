"""The training cell over ranks (``kinds/train_tp.py``) at a size the CPU
holds, its four ranks over gloo: a sound run is correct, the float8
control separates, a run whose timed path is broken underneath (the
state left unchanged, half the batch, the exchange between the ranks
left out) comes out not correct, and the second moment's int8 decode
broken underneath moves the change after two steps.  Its reference's
int8 round trips (``reference/train_int8.py``) are checked by hand and
against the program's own."""
import pytest

torch = pytest.importorskip("torch")

from perfbench_tiny import TRAIN_TP, tiny_tp_cell  # noqa: E402

import control  # noqa: E402
import harness  # noqa: E402
from kinds import train_tp  # noqa: E402
from reference import train_int8 as ri  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 29
STEP = 2.0 ** -7  # a block's scale where its largest magnitude is 127 * 2^-7


@pytest.fixture
def one_thread():
    """One thread a rank: four ranks share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell):
    run = harness.run_cell(cell, seed=SEED, seconds=0.2, trace=False, device=CPU,
                           t_start=0.0, devices=[CPU] * cell.chips)
    return run, harness.result(cell, run, False, {"platform": "cpu"})


def test_round_trip_by_hand():
    """Codes round half to even under the block's scale (its largest
    magnitude over 127); the residual is what the codes leave out, and it
    is carried into the next step's input; a last axis that is no whole
    number of blocks is padded, each block scaled by its own largest."""
    x = torch.zeros(300)
    x[:5] = torch.tensor([127.0, 2.5, 3.5, -1.5, 0.4]) * STEP
    x[256:258] = torch.tensor([-2.0, 0.75])
    q, scale = ri.codes(x)
    assert q.shape == (2, 256) and scale.shape == (2, 1)
    assert scale[:, 0].tolist() == [STEP, (torch.tensor(2.0) / 127.0).item()]
    assert q[0, :5].tolist() == [127.0, 2.0, 4.0, -2.0, 0.0]
    assert q[1, :2].tolist() == [-127.0, round(0.75 * 127.0 / 2.0)]
    sent = ri.round_trip(x)
    assert sent[:5].tolist() == [127 * STEP, 2 * STEP, 4 * STEP, -2 * STEP, 0.0]
    residual = x - sent
    assert residual[:5].tolist() == pytest.approx([0.0, 0.5 * STEP, -0.5 * STEP, 0.5 * STEP,
                                                   0.4 * STEP])
    g = torch.zeros(300)
    g[:2] = torch.tensor([127.0, 1.0]) * STEP
    assert ri.round_trip(g)[1] == STEP  # alone, a code of 1
    assert ri.round_trip(g + residual)[1] == 2 * STEP  # 1.5 with the residual carried: 2
    held = ri.Moment("int8").store(x)
    assert held[0].dtype == torch.int8 and held[1].dtype == torch.float32
    assert torch.equal(ri.Moment("int8").read(held, x), sent)


def test_round_trips_match_the_programs():
    from repro_torch.optim import adamw, compress

    g = torch.Generator().manual_seed(3)
    for shape in [(4, 300), (2, 3, 512), (700,)]:
        x = torch.randn(shape, generator=g) * torch.rand(shape, generator=g).pow(4)
        assert torch.equal(ri.round_trip(x), compress._quantize(x))
        held = ri.Moment("int8").store(x)
        theirs = adamw._q8(x)
        assert torch.equal(held[0], theirs["q"]) and torch.equal(held[1], theirs["scale"])
        assert torch.equal(ri.Moment("int8").read(held, x), adamw._dq8(theirs, x.shape))


def test_sound_run_is_correct(one_thread):
    run, out = _run(tiny_tp_cell())
    assert out["correct"], (out["checks"], run.numbers)
    assert run.steps >= 1 and out["attempted"] == run.steps
    assert set(out["metrics"]) == {"train_tp_tokens_per_s", "peak_mem_gib", "setup_s"}


def test_control_separates(one_thread):
    """At the small size the limits (set at the cell's size) are not the
    yardstick: the control reads more than three times what the program
    reads on one of the compared numbers."""
    cell = tiny_tp_cell()
    program = _run(cell)[0].numbers
    got = control.readings(cell, SEED, CPU, devices=[CPU] * cell.chips)["control_fp8"]
    assert any(got[k] > 3 * program[k] for k in cell.limits), (got, program)


@pytest.mark.cuda
def test_control_fails_a_limit_at_the_cells_size():
    cell = harness.load_cell(TRAIN_TP)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        pytest.skip(f"fewer than {cell.chips} CUDA devices")
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    harness.reference_precision()
    got = control.train_tp_readings(cell, 2**31 + 5, devices, sides=["control_fp8"])
    run = harness.Run(kind="train_tp", config=cell.config, traffic=cell.traffic,
                      numbers=got["control_fp8"])
    checks = harness.checks(run, cell.limits)
    assert not harness.correct(checks), checks


@pytest.mark.parametrize("fault", [f for f in control.FAULTS if f != "v_decode"])
def test_broken_timed_path_is_not_correct(monkeypatch, one_thread, fault):
    monkeypatch.setattr(train_tp, "PLANT", f"control:plant_{fault}")
    run, out = _run(tiny_tp_cell())
    assert not out["correct"], (out["checks"], run.numbers)


def test_second_moments_decode_moves_the_change_after_two_steps(monkeypatch, one_thread):
    """The int8 second moment read back without its scales changes only
    the second step's update: the first gradient and the first change
    stay, the change after two steps moves far past the sound run's (at
    this size in float32; at the cell's size ``control.py --fault
    v_decode`` reads it against the limit)."""
    cell = tiny_tp_cell()
    sound = _run(cell)[0].numbers
    monkeypatch.setattr(train_tp, "PLANT", "control:plant_v_decode")
    broken = _run(cell)[0].numbers
    assert broken["grad_gap"] == sound["grad_gap"]
    assert broken["change_first_gap"] == sound["change_first_gap"]
    assert broken["change_gap"] > max(100 * sound["change_gap"], 1e-4), (broken, sound)


def test_a_fault_is_read_at_the_cells_own_path(one_thread):
    cell = tiny_tp_cell()
    got = control.fault_readings(cell, SEED, [CPU] * cell.chips, "half_batch")
    assert got["fault_half_batch"]["grad_gap"] > cell.limits["grad_gap"]
    assert train_tp.PLANT is None


def test_the_cell_takes_four_chips():
    cell = harness.load_cell(TRAIN_TP)
    mesh = cell.traffic["mesh"]
    assert cell.chips == 4 == mesh["data"] * mesh["model"]


def fails_on_rank(bad):
    import program

    if program.procs.current().rank == bad:
        raise ValueError(f"planted on rank {bad}")
    return "done"


@pytest.mark.parametrize("bad", [None, 0, 1])
def test_over_ranks_returns_rank_0s_value_or_a_ranks_failure(bad):
    args, devices = (bad,), [CPU, CPU]
    if bad is None:
        assert harness.over_ranks(fails_on_rank, args, devices, timeout=60.0) == "done"
        return
    with pytest.raises(RuntimeError, match=f"planted on rank {bad}"):
        harness.over_ranks(fails_on_rank, args, devices, timeout=60.0)

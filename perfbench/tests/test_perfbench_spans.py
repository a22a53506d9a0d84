"""The readers of the program's spans (``spans.py``, ``metrics/*_ms.*``)
on hand-made records: nothing where the program has no trace module or
recorded no root (an older program), nothing in a run of another kind,
where the stretch has no such span or a span has no device time; else
the span's device ms a step, its phases summed, the lead-in's root and
what lies in it left out."""
import sys
import types
from types import SimpleNamespace as R

import pytest

torch = pytest.importorskip("torch")

import perfbench_tiny  # noqa: E402,F401  (puts the benchmark on sys.path)

import devtrace as tr  # noqa: E402
import harness  # noqa: E402

# metric -> (kind, span)
READERS = {"attn_ms.train": ("train", "model.attention"),
           "mixer_ms.train": ("train", "model.ssd"),
           "optimizer_ms.train": ("train", "optim.update"),
           "attn_ms.prefill": ("prefill", "model.attention"),
           "mixer_ms.prefill": ("prefill", "model.ssd")}
ROOT = {"train": "step.train", "prefill": "step.prefill"}


def run_of(kind, steps=2):
    return harness.Run(kind=kind, config={}, traffic={}, stretch=tr.Stretch(steps=steps))


def records(kind, span, steps=2, device_ms=1.0):
    """A lead-in root and ``steps`` roots, each holding the span in every
    phase (forward 1, recompute 2, backward 4 times ``device_ms``) and one
    other span; each root takes 100 ms."""
    out, next_id = [], iter(range(1, 1000))
    for _ in range(steps + 1):
        root = next(next_id)
        out.append(R(name=ROOT[kind], id=root, parent=None, step=root, phase="forward",
                     device_ms=100.0))
        for phase, scale in (("forward", 1), ("recompute", 2), ("backward", 4)):
            out.append(R(name=span, id=next(next_id), parent=root, step=root, phase=phase,
                         device_ms=None if device_ms is None else scale * device_ms))
        out.append(R(name="other", id=next(next_id), parent=root, step=root,
                     phase="forward", device_ms=50.0))
    return out


@pytest.fixture
def program(monkeypatch):
    """Puts a trace module holding the given records in the program's
    place; None for a program without one."""
    def put(recs):
        if recs is None:
            monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
        else:
            mod = types.ModuleType("repro_torch.trace")
            mod.records = lambda: list(recs)
            monkeypatch.setitem(sys.modules, "repro_torch.trace", mod)
    return put


@pytest.mark.parametrize("name", READERS)
def test_an_older_program_reads_nothing(name, program):
    kind, _ = READERS[name]
    program(None)
    assert harness.load_reader(name)(run_of(kind)) is None
    program([])  # the module, no root
    assert harness.load_reader(name)(run_of(kind)) is None


@pytest.mark.parametrize("name", READERS)
def test_ms_a_step_phases_summed_lead_in_left_out(name, program):
    kind, span = READERS[name]
    recs = records(kind, span)
    recs[1].device_ms = 1000.0  # the lead-in's span: left out
    program(recs)
    assert harness.load_reader(name)(run_of(kind)) == pytest.approx(7.0)
    recs[-2].device_ms = 8.0  # the last step's backward: 4 -> 8
    assert harness.load_reader(name)(run_of(kind)) == pytest.approx(9.0)


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_the_span_a_time_or_the_kind(name, program):
    kind, span = READERS[name]
    other = "prefill" if kind == "train" else "train"
    program(records(kind, "not." + span))  # a cell whose model has no such span
    assert harness.load_reader(name)(run_of(kind)) is None
    program(records(kind, span, device_ms=None))  # work on the CPU
    assert harness.load_reader(name)(run_of(kind)) is None
    program(records(kind, span))
    assert harness.load_reader(name)(run_of(other)) is None
    assert harness.load_reader(name)(harness.Run(kind=kind, config={}, traffic={})) is None
    assert harness.load_reader(name)(run_of(kind, steps=4)) is None  # fewer roots than steps

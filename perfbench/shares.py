"""The shares of a traced stretch that the ``mfu.*`` and ``idle_share.*``
readers report, one function each for every kind of run: a reader names
its kind and, for ``mfu``, the work of one of the stretch's steps."""
import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def mfu(run, kind: str, step_flops):
    """``step_flops(config, batch, seq_len)`` FLOPs a step over the
    stretch's steps, as a share (%) of the bf16 peak of the cell's chips
    (each card's times their count) over the stretch's host-clock
    seconds; None in another kind of run or where the trace saw no
    device operation."""
    st = run.stretch
    if run.kind != kind or st is None or not st.steps or st.busy_s <= 0:
        return None
    tf = run.traffic
    work = st.steps * step_flops(run.config, tf["batch"], tf["seq_len"])
    return 100.0 * work / (st.seconds * run.chips * PEAKS["bf16_flops_per_s"])


def idle_share(run, kind: str):
    """The share (%) of the stretch in which no operation ran on the
    device (1 - the union of the device operations' intervals over the
    stretch); None in another kind of run or where none ran."""
    st = run.stretch
    if run.kind != kind or st is None or st.window_s <= 0 or st.busy_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)

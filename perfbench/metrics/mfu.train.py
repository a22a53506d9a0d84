"""mfu.train: the training step's model FLOPs (``flops.train_step_flops``)
over the traced stretch's steps, as a share (%) of the card's bf16 peak
over the stretch's host-clock seconds (synchronised start and end);
nothing where the trace saw no device operation."""
import json
from pathlib import Path

import flops

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())


def read(run):
    st = run.stretch
    if run.kind != "train" or st is None or not st.steps or st.busy_s <= 0:
        return None
    tf = run.traffic
    work = st.steps * flops.train_step_flops(run.config, tf["batch"], tf["seq_len"])
    return 100.0 * work / (st.seconds * PEAKS["bf16_flops_per_s"])

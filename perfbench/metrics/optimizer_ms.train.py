"""optimizer_ms.train: device ms a training step in the optimizer's update
(the span ``optim.update``: ``AdamW.update``), over the traced stretch
(``spans.py``)."""
import spans


def read(run):
    return spans.device_ms_per_step(run, "train", "optim.update")

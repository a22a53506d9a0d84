"""mixer_ms.train: device ms a training step in the SSM mixers (the spans
``model.ssd``: ``ssd_apply``), forward, remat's recompute and backward
summed, over the traced stretch (``spans.py``)."""
import spans


def read(run):
    return spans.device_ms_per_step(run, "train", "model.ssd")

"""attn_ms.train_tp: ``attn_ms.train`` in the training over ranks (kind
``train_tp``): rank 0's device ms a step in its attention sublayers (the
spans ``model.attention``), forward, remat's recompute and backward
summed, over the traced stretch (``spans.py``)."""
import spans


def read(run):
    return spans.device_ms_per_step(run, "train_tp", "model.attention")

"""attn_ms.train: device ms a training step in the attention sublayers
(the spans ``model.attention``: q/k/v projections to the output
projection), forward, remat's recompute and backward summed, over the
traced stretch (``spans.py``)."""
import spans


def read(run):
    return spans.device_ms_per_step(run, "train", "model.attention")

"""attn_ms.prefill: device ms a prefill in the attention sublayers (the
spans ``model.attention``: q/k/v projections to the output projection),
over the traced stretch (``spans.py``)."""
import spans


def read(run):
    return spans.device_ms_per_step(run, "prefill", "model.attention")

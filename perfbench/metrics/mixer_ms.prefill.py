"""mixer_ms.prefill: device ms a prefill in the SSM mixers (the spans
``model.ssd``: ``Model._ssd_with_state``), over the traced stretch
(``spans.py``)."""
import spans


def read(run):
    return spans.device_ms_per_step(run, "prefill", "model.ssd")

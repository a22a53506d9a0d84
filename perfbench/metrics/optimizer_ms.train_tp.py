"""optimizer_ms.train_tp: ``optimizer_ms.train`` in the training over ranks
(kind ``train_tp``): rank 0's device ms a step in the optimizer's update
(the span ``optim.update``, the int8 codes' gathers inside it), over the
traced stretch (``spans.py``)."""
import spans


def read(run):
    return spans.device_ms_per_step(run, "train_tp", "optim.update")

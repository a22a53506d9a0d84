"""mfu.train_tp: ``mfu.train`` of the training over ranks (kind
``train_tp``): the whole model's FLOPs a step, not a rank's share, over
the peak of all the cell's chips (``shares.mfu``)."""
import flops
import shares


def read(run):
    return shares.mfu(run, "train_tp", flops.train_step_flops)

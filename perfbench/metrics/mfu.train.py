"""mfu.train: the training step's model FLOPs (``flops.train_step_flops``)
over the traced stretch's steps, as a share (%) of the bf16 peak of the
cell's chips over the stretch's host-clock seconds (``shares.mfu``)."""
import flops
import shares


def read(run):
    return shares.mfu(run, "train", flops.train_step_flops)

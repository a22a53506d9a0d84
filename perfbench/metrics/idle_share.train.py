"""idle_share.train: the share (%) of the traced stretch of training
in which no operation ran on the device (``shares.idle_share``)."""
import shares


def read(run):
    return shares.idle_share(run, "train")

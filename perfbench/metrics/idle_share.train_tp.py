"""idle_share.train_tp: the share (%) of the traced stretch of training
over ranks in which no operation ran on rank 0's card
(``shares.idle_share``)."""
import shares


def read(run):
    return shares.idle_share(run, "train_tp")

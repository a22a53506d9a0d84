"""mfu.prefill: the prefill's model FLOPs (``flops.prefill_flops``: the
head at the last position only) over the traced stretch's prefills, as a
share (%) of the bf16 peak of the cell's chips over the stretch's
host-clock seconds (``shares.mfu``)."""
import flops
import shares


def read(run):
    return shares.mfu(run, "prefill", flops.prefill_flops)

"""collective_ms.train_tp: device ms a step of the training over ranks
(kind ``train_tp``) in rank 0's NCCL kernels (the collectives of
``distributed/ctx.py``'s model-parallel regions, the gradients'
reductions and the optimizer's all-gathers), over the traced stretch: the
profiler's device time of the kernels NCCL launches (``ncclDevKernel_*``,
``ncclKernel_*``); nothing where the stretch ran none."""

KERNELS = ("ncclDevKernel", "ncclKernel")


def read(run):
    st = run.stretch
    if run.kind != "train_tp" or st is None or not st.steps:
        return None
    seconds = [s for name, (_, s) in st.device_ops.items() if name.startswith(KERNELS)]
    if not seconds:
        return None
    return 1e3 * sum(seconds) / st.steps

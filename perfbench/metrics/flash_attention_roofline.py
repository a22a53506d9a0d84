"""flash_attention_roofline: the share (%) of its roofline that the
``flash_attention`` kernel reaches in the traced stretch of prefills.

The bound of one call is the larger of its operations at the bf16 peak
and its bytes at the HBM bandwidth (``flops.flash_ops``,
``flops.flash_bytes``); every call of a prefill has the same shape.  The
kernel's device time is the profiler's time per listed launch times the
launches the wrapper counted (the profiler can drop a record, never add
one): a listing of more launches than were made, or of none, reads
nothing.
"""
import json
from pathlib import Path

import flops

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())
KERNELS = ("flash_kernel_ws", "flash_split_kv_kernel", "flash_kernel_tf32")
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def read(run):
    st = run.stretch
    if run.kind != "prefill" or st is None or not st.flash_launches:
        return None
    listed = [(c, s) for name, (c, s) in st.device_ops.items()
              if any(k in name for k in KERNELS)]
    count, seconds = sum(c for c, _ in listed), sum(s for _, s in listed)
    if count == 0 or count > st.flash_launches or seconds <= 0:
        return None
    cfg, tf = run.config, run.traffic
    B, S, hd = tf["batch"], tf["seq_len"], cfg["head_dim"]
    H, KVH = cfg["num_heads"], cfg["num_kv_heads"]
    ops = flops.flash_ops(B, S, H, hd, cfg.get("sliding_window", 0))
    moved = flops.flash_bytes(B, S, H, KVH, hd, ITEMSIZE[cfg["dtype"]])
    bound = max(ops / PEAKS["bf16_flops_per_s"], moved / PEAKS["hbm_bytes_per_s"])
    device_s = seconds / count * st.flash_launches
    return 100.0 * bound * st.flash_launches / device_s

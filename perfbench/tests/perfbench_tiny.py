"""Shared helpers of the benchmark's tests: a cell of ``BENCHMARK.json``
cut to a size the CPU runs in seconds (every kind of layer kept).  Not a
test module."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(HERE), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=97)
TINY_HYBRID = dict(sliding_window=24, ssm_chunk=16, ssm_head_dim=16)


def tiny_config(cfg: dict, **kw) -> dict:
    out = dict(cfg, **TINY)
    if cfg["family"] == "hybrid":
        out.update(TINY_HYBRID)
    out.update(kw)
    return out


def workload(config: str, kind: str) -> str:
    """The name of ``BENCHMARK.json``'s cell of configuration ``config``
    whose traffic is of ``kind`` (``train``, ``train_tp`` or ``prefill``)."""
    import json

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        if w["config"] == config and traffic["kind"] == kind:
            return w["name"]
    raise KeyError((config, kind))


TRAIN = workload("hymba-1.5b", "train")
PREFILLS = [workload("granite-8b", "prefill"), workload("hymba-1.5b", "prefill")]
TRAIN_TP = workload("granite-8b", "train_tp")
# the cell over ranks at a small size: KV heads and the FFN's width split
# over its four ranks, the FFN's columns a rank whole blocks of 256; in
# float32, where the ranks and the reference agree to rounding (in bf16 at
# this size the gaps are bf16's, above the limits set at the cell's size)
TINY_TP = dict(num_kv_heads=4, d_ff=1024, vocab_size=256, dtype="float32")


def tiny_cell(workload: str, **cfg_kw):
    import harness

    cell = harness.load_cell(workload)
    cell.config = tiny_config(cell.config, **cfg_kw)
    cell.traffic = dict(cell.traffic, batch=4, seq_len=40)
    return cell


def tiny_tp_cell(**cfg_kw):
    """``TRAIN_TP`` at the small size; its ranks run on the CPU over gloo."""
    return tiny_cell(TRAIN_TP, **dict(TINY_TP, **cfg_kw))

"""One run of one cell: the cell's files found by the names in
``BENCHMARK.json``, set-up, the measured window, the traced stretch, the
comparison with the plain reference, and the result line.

Everything that belongs to one cell is data: the configuration is
``BENCHMARK.json``'s file for it, the traffic is
``traffic/<traffic>.json`` (its ``kind`` names the loop in ``kinds/``
that drives it), the limits of the comparison are
``limits/<workload>.json``, each per-layer metric is read by
``metrics/<name>.py``, and a configuration's family (its mixer's weights,
work and reference) is ``families/<family>.py``.  A new cell adds files
and edits none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

import devtrace as tr

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(bench_path.read_text())
    root = bench_path.parent
    base = root / bench["paths"][0]
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path.name}; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    mine = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    return Cell(
        name=workload, chips=w["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((base / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((base / "limits" / f"{workload}.json").read_text()),
        end_to_end=mine, per_layer=layer)


@dataclass
class Run:
    """What a kind's loop hands back: the window's counts, the outputs'
    numbers compared with the reference, and the traced stretch."""
    kind: str
    config: dict
    traffic: dict
    setup_s: float = 0.0
    steps: int = 0
    window_s: float = 0.0
    tokens: int = 0
    memory_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    numbers: Dict[str, float] = field(default_factory=dict)
    stretch: Optional[tr.Stretch] = None
    reference_s: float = 0.0


def window(one_step: Callable[[int], None], seconds: float, trace_steps: int,
           sync: Callable[[], None], launches: Callable[[], int]):
    """Run ``one_step(i)`` (which returns once step i has finished on the
    device) until ``seconds`` have passed: whole steps only, the last one
    ending past the mark.  With ``trace_steps``, step 1 runs under the
    profiler as its lead-in and steps 2 .. trace_steps + 1 are the traced
    stretch (the window is held open until they have run).  Returns
    (steps, seconds to the end of the last, stretch)."""
    stretch = tr.Stretch() if trace_steps else None
    t0 = time.perf_counter()
    i = 0
    while True:
        if stretch is not None and i == 1:
            with tr.profiled(stretch, sync, lambda: one_step(1)):
                before = launches()
                for i in range(2, trace_steps + 2):
                    one_step(i)
                stretch.flash_launches = launches() - before
            stretch.steps = trace_steps
        else:
            one_step(i)
        i += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds and (stretch is None or stretch.steps):
            return i, elapsed, stretch


def load_reader(name: str):
    """The per-layer metric ``name``'s reader, ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def checks(run: Run, limits: dict) -> Dict[str, dict]:
    """Each compared number beside its limit (``limits``: name -> limit;
    a number at or under its limit passes).  A number that is not finite
    is written as text, so the line stays JSON, and fails."""
    return {k: {"value": v if math.isfinite(v) else str(v), "limit": lim}
            for k, lim in limits.items() for v in [run.numbers[k]]}


def correct(cmp: Dict[str, dict]) -> bool:
    return all(isinstance(c["value"], float) and c["value"] <= c["limit"]
               for c in cmp.values())


def result(cell: Cell, run: Run, trace: bool, device: dict) -> dict:
    cmp = checks(run, cell.limits)
    ok = correct(cmp) and run.failed == 0
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if run.stretch is not None and run.stretch.busy_s > 0:
            device = dict(device, busy_s=run.stretch.busy_s, window_s=run.stretch.window_s)
    else:
        values = {
            "setup_s": run.setup_s,
            "peak_mem_gib": run.memory_peak_bytes / 2**30,
            f"{run.kind}_tokens_per_s": run.tokens / run.window_s if run.window_s else None,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if values.get(m["name"]) is not None}
    out = {"correct": ok, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if trace and run.stretch is not None:
        out["breakdown"] = tr.breakdown(run.stretch)
    out["checks"] = cmp
    return out


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float) -> Run:
    kind = importlib.import_module(f"kinds.{cell.traffic['kind']}")
    return kind.run(cell, seed=seed, seconds=seconds, trace=trace, device=device,
                    t_start=t_start)


def forbidden_modules(modules) -> list:
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def syncer(device: torch.device) -> Callable[[], None]:
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated()) if device.type == "cuda" else 0


def free(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference_precision() -> None:
    """float32 products in float32: TF32 off, for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rel_gap(a: float, b: float, base: float) -> float:
    return abs(a - b) / base

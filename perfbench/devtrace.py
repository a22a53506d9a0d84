"""Spans of the benchmark's own loop, and the device trace of a steady
stretch of a traced window.

The spans are ``torch.profiler.record_function`` ranges around the calls
into the program (and around waiting for it), so in a traced stretch they
lie in the profiler's own clock beside the device's operations.  The
trace is read in memory from the profiler's events: every device
operation (kernels, copies, sets) with its start and end.  Busy time is
the union of their intervals, so operations that overlap on several
streams count once.  An idle gap is a stretch between two busy intervals;
it is named by the innermost span the host had open when it began.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

STRETCH = "bench.stretch"
SPANS = ("bench.inputs", "bench.prefill", "bench.train_step", "bench.synchronise")


def span(name: str):
    return torch.profiler.record_function(name)


@dataclass
class Stretch:
    """What one traced stretch measured."""
    steps: int = 0
    seconds: float = 0.0  # host clock, from a synchronised start to a synchronised end
    window_s: float = 0.0  # the stretch's length in the profiler's clock
    busy_s: float = 0.0
    device_ops: Dict[str, List[float]] = field(default_factory=dict)  # name -> [count, s]
    gaps: List[Tuple[str, float]] = field(default_factory=list)
    flash_launches: int = 0


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event the profiler kept."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        yield e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(), e.end_ns()


def union(intervals):
    """Sorted, merged (start, end) intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(prof, stretch: Stretch) -> Stretch:
    """Fill ``stretch`` from the stopped profiler ``prof``."""
    dev, host, window = [], [], None
    for name, is_dev, s, e in _events(prof):
        if name == STRETCH and not is_dev:
            window = (s, e)
        elif is_dev and not name.startswith("bench."):
            dev.append((name, s, e))
        elif not is_dev and name in SPANS:
            host.append((name, s, e))
    if window is None or not dev:
        return stretch
    lo, hi = window
    dev = [(name, s, e) for name, s, e in dev if lo <= s < hi]  # the lead-in's are before
    busy = union((s, min(e, hi)) for _, s, e in dev)
    stretch.window_s = (hi - lo) * 1e-9
    stretch.busy_s = sum(e - s for s, e in busy) * 1e-9
    for name, s, e in dev:
        c = stretch.device_ops.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += (e - s) * 1e-9
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if busy:
        gaps = [(lo, busy[0][0])] + gaps + [(busy[-1][1], hi)]
    named = []
    for s, e in gaps:
        if e <= s:
            continue
        open_spans = [(hs, n) for n, hs, he in host if hs <= s < he]
        named.append((max(open_spans)[1] if open_spans else "none", (e - s) * 1e-9))
    stretch.gaps = sorted(named, key=lambda g: -g[1])
    return stretch


@contextlib.contextmanager
def profiled(stretch: Stretch, sync, lead_in):
    """Profile the block (CPU and CUDA activity) as one stretch; its host
    seconds from a synchronised start to a synchronised end.  ``lead_in``
    runs under the profiler before the stretch starts: the first step the
    profiler sees pays its start-up on the host, which is not the
    program's."""
    import time

    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    lead_in()
    sync()
    t0 = time.perf_counter()
    with span(STRETCH):
        yield stretch
        sync()
    stretch.seconds = time.perf_counter() - t0
    prof.stop()
    read(prof, stretch)


def breakdown(stretch: Stretch, n: int = 10) -> dict:
    ops = sorted(stretch.device_ops.items(), key=lambda kv: -kv[1][1])[:n]
    return {"device_ops": [[name[:160], s] for name, (_, s) in ops],
            "idle_gaps": [[name, s] for name, s in stretch.gaps[:n]]}

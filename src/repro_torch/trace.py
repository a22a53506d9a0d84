"""Spans inside the port: named intervals at a few boundaries of the
training step and the prefill, on the profiler's clock and the device's.

The sites: the roots ``step.train`` (one per call of
``train.step.make_train_step``'s step) and ``step.prefill`` (one per call
of ``make_prefill``'s entry), each counting its tokens; ``optim.update``
(the optimizer's update inside the step: leaves updated, bytes of
optimizer state); ``model.attention`` (a layer's attention sublayer, from
the q/k/v projections to the output projection: the route ``attention``
took) and ``model.ssd`` (a layer's SSM mixer: the route ``ssd_forward``
took).

Spans are recorded only while ``torch.profiler`` is profiling, or inside
:func:`recording`.  Otherwise a span site costs one check: ``span``
returns a shared no-op context and ``call`` calls its function, with no
autograd node, no CUDA event and no allocation.

A record (:class:`Record`) holds the span's name, its id, its parent's id
and its step (the id of the root it belongs to); its phase: ``forward``,
``recompute`` (the forward run again inside the backward pass, under
remat) or ``backward``; its host start and end in Unix-epoch nanoseconds,
the clock ``torch.profiler`` gives its events; its device milliseconds,
between two timing CUDA events recorded on the current stream at its edges
(None for work on the CPU); the launches of the port's kernels inside it
(deltas of the ``STATS`` of ``kernels/flash_attention.py`` and
``kernels/ssd_scan.py``); and what its site counts.

A span over differentiable work (:func:`call`) covers its backward pass
too: where grad is on, its inputs and its outputs pass through identity
autograd functions, whose backward marks the edges of the span's backward
(the outputs' gradients arriving, the inputs' leaving) and gives a record
of phase ``backward``.  Gradients pass through untouched, so the numbers
are the same bit for bit.

Records go into a ring of fixed size that counts what it drops;
:func:`records` reads it and :func:`take` reads and clears it, each
waiting for the device to pass a record's end event before reading its
time.  The spans are not ``record_function`` ranges: the profiler would
list each one's device side as an operation spanning the kernels inside
it, and a reader of the trace would count it as busy time.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ssd_scan as _ssd

CAPACITY = 4096  # records; a traced training step of hymba-1.5b makes 194


@dataclass
class Record:
    name: str
    id: int
    parent: Optional[int]
    step: int
    phase: str  # forward | recompute | backward
    start_ns: int
    end_ns: int
    device_ms: Optional[float] = None
    launches: Dict[str, int] = field(default_factory=dict)
    counters: Dict[str, Any] = field(default_factory=dict)
    events: Optional[tuple] = field(default=None, repr=False)  # until resolved


def _launches() -> tuple:
    return _flash.STATS["flash_attention"], _ssd.STATS["ssd_scan"]


def _since(before: tuple) -> Dict[str, int]:
    now = _launches()
    return {"flash_attention": now[0] - before[0], "ssd_scan": now[1] - before[1]}


def _event(device):
    """A timing event recorded on ``device``'s current stream; None off CUDA."""
    if device is None or device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class _Edge(torch.autograd.Function):
    """The identity; its backward calls ``mark`` first."""

    @staticmethod
    def forward(ctx, mark, *ts):
        ctx.mark = mark
        ctx.set_materialize_grads(False)
        return ts

    @staticmethod
    def backward(ctx, *grads):
        ctx.mark()
        return (None, *grads)


def _through_edge(tree, mark):
    """``tree`` (nested dicts, lists and tuples) with its tensors that
    require grad passed through one ``_Edge``; as it is where none does."""
    flat, spec = tree_flatten(tree)
    live = [i for i, t in enumerate(flat) if isinstance(t, torch.Tensor) and t.requires_grad]
    if not live:
        return tree
    for i, t in zip(live, _Edge.apply(mark, *(flat[i] for i in live))):
        flat[i] = t
    return tree_unflatten(flat, spec)


class _Off:
    """The shared no-op span: what a site gets while nothing records."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False


_OFF = _Off()


class _Span:
    def __init__(self, rec: "Recorder", name: str, device, counters: dict):
        self.rec, self.name, self.device, self.counters = rec, name, device, counters

    def __enter__(self):
        rec = self.rec
        parent = rec._stack[-1] if rec._stack else None
        self.id = next(rec._ids)
        self.parent = None if parent is None else parent.id
        self.step = self.id if parent is None else parent.step
        # a span opened while autograd runs a backward pass is remat's
        # recomputation of the forward
        self.phase = "recompute" if torch._C._current_graph_task_id() != -1 else "forward"
        rec._stack.append(self)
        self.before = _launches()
        self.start_event = _event(self.device)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_event = _event(self.device)
        end_ns = time.time_ns()
        self.rec._stack.remove(self)
        self.rec._add(Record(
            self.name, self.id, self.parent, self.step, self.phase, self.start_ns, end_ns,
            launches=_since(self.before), counters=self.counters,
            events=None if end_event is None else (self.start_event, end_event)))
        return False

    def count(self, **counters):
        self.counters.update(counters)

    def backward_edges(self):
        """(begin, end): the marks of this span's backward pass, to be
        called by the outputs' edge and the inputs' edge."""
        rec, box = self.rec, {}

        def begin():
            box["before"] = _launches()
            box["event"] = _event(self.device)
            box["ns"] = time.time_ns()

        def end():
            end_event = _event(self.device)
            rec._add(Record(
                self.name, next(rec._ids), self.parent, self.step, "backward", box["ns"],
                time.time_ns(), launches=_since(box["before"]),
                events=None if end_event is None else (box["event"], end_event)))

        return begin, end


class Recorder:
    """Spans of one process: a ring of at most ``capacity`` records, the
    count of records it dropped, and the stack of open spans.  The stack
    is the process's, not a thread's: a backward pass runs in autograd's
    threads while the thread that started it waits, and its spans nest in
    the step that thread opened."""

    def __init__(self, capacity: int = CAPACITY):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._stack: List[_Span] = []
        self._forced = 0
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def on(self) -> bool:
        return bool(self._forced) or torch.autograd._profiler_enabled()

    @contextlib.contextmanager
    def recording(self):
        """Record inside the block, whether or not a profiler runs."""
        with self._lock:
            self._forced += 1
        try:
            yield self
        finally:
            with self._lock:
                self._forced -= 1

    def span(self, name: str, like: Optional[torch.Tensor] = None, **counters):
        """A span over the block; device times where ``like`` (a tensor of
        the block's work) is on a CUDA device.  While nothing records, the
        shared no-op context, which is false (a site counts only where the
        span is true)."""
        if not self.on():
            return _OFF
        return _Span(self, name, None if like is None else like.device, counters)

    def call(self, name: str, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` in a span, its device that of the first
        tensor among the arguments.  Where grad is on, the tensors of the
        arguments and of the result that require grad pass through
        identity functions whose backward records the span's backward."""
        if not self.on():
            return fn(*args, **kwargs)
        first = next((t for t in tree_flatten((args, kwargs))[0]
                      if isinstance(t, torch.Tensor)), None)
        sp = _Span(self, name, None if first is None else first.device, {})
        with sp:
            if not torch.is_grad_enabled():
                return fn(*args, **kwargs)
            begin, end = sp.backward_edges()
            args, kwargs = _through_edge((args, kwargs), end)
            return _through_edge(fn(*args, **kwargs), begin)

    def note(self, name: str, **counters):
        """Put ``counters`` into the innermost open span if it is named
        ``name`` (what a site's callee alone knows, such as its route)."""
        if self.on() and self._stack and self._stack[-1].name == name:
            self._stack[-1].counters.update(counters)

    def _add(self, record: Record) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(record)

    def _resolved(self) -> List[Record]:
        for r in self._ring:
            if r.events is not None:
                start, end = r.events
                end.synchronize()
                r.device_ms, r.events = start.elapsed_time(end), None
        return list(self._ring)

    def records(self) -> List[Record]:
        """The records held, oldest first, each with its device time."""
        with self._lock:
            return self._resolved()

    def take(self) -> List[Record]:
        """:meth:`records`, and the ring emptied."""
        with self._lock:
            out = self._resolved()
            self._ring.clear()
            return out


RECORDER = Recorder()
recording = RECORDER.recording
span = RECORDER.span
call = RECORDER.call
note = RECORDER.note
records = RECORDER.records
take = RECORDER.take


def dropped() -> int:
    return RECORDER.dropped

"""The program's own spans in a traced stretch (``repro_torch.trace``):
a root span a step (``step.train`` or ``step.prefill``) and the spans
inside it, each with its device time between two CUDA events.

The program records its spans while the profiler runs, which is over the
lead-in step and the stretch: the records hold one root more than the
stretch has steps, the lead-in's, which comes first and is left out.
Nothing is read where the program has no such module or recorded no root
(a program older than its spans)."""
import importlib

ROOTS = {"train": "step.train", "prefill": "step.prefill"}


def stretch_records(run):
    """The records of the stretch's steps (their roots and what lies in
    them), or None."""
    st = run.stretch
    if st is None or not st.steps or run.kind not in ROOTS:
        return None
    try:
        trace = importlib.import_module("repro_torch.trace")
    except ImportError:
        return None
    records = trace.records()
    roots = [r for r in records if r.name == ROOTS[run.kind] and r.parent is None]
    if len(roots) < st.steps:
        return None
    steps = {r.id for r in roots[-st.steps:]}
    return [r for r in records if r.step in steps]


def device_ms_per_step(run, kind: str, name: str):
    """The device ms a step of the spans named ``name`` in a stretch of
    ``kind``, summed over their phases (forward, recompute, backward);
    None in another kind of run, where the stretch has no such span, or
    where one has no device time."""
    if run.kind != kind:
        return None
    recs = stretch_records(run)
    times = [r.device_ms for r in recs or () if r.name == name]
    if not times or any(t is None for t in times):
        return None
    return sum(times) / run.stretch.steps

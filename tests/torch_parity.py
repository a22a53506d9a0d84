"""Shared helpers of the ``test_torch_*`` files: export the reference
package's inputs as plain data and carry them into the port, so both run
on identical inputs.  Not a test module (no ``test_`` prefix)."""
import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.core import carry
from repro_torch.core.types import NodeView as PortNodeView


def fp_records(records):
    """The reference tests' fingerprint (tests/test_events.py), plus the
    DVFS level, so frequency choices are compared too."""
    s = ";".join(
        f"{r.job}|{r.g}|{r.f}|{r.start!r}|{r.end!r}|{r.node}|{r.domain}"
        for r in records
    )
    return hashlib.md5(s.encode()).hexdigest()


def export_profiles(truth):
    """Reference ``{app: JobProfile}`` -> plain nested dicts."""
    return {app: dataclasses.asdict(p) for app, p in truth.items()}


def carry_profiles(truth):
    return carry.profiles_from_arrays(export_profiles(truth))


def export_specs(specs):
    """Reference ``[JobSpec]`` -> per-mode numpy columns."""
    return [
        {
            "name": s.name,
            "g": np.array([m.g for m in s.modes], dtype=np.int64),
            "f": np.array([m.f for m in s.modes], dtype=np.int64),
            "t_norm": np.array([m.t_norm for m in s.modes]),
            "p_bar": np.array([m.p_bar for m in s.modes]),
            "e_norm": np.array([m.e_norm for m in s.modes]),
        }
        for s in specs
    ]


def carry_specs(specs):
    return carry.specs_from_arrays(export_specs(specs))


def carry_view(view):
    """A reference ``NodeView`` of a synthetic window (no running-job
    objects the decision reads) as the port's."""
    return PortNodeView(
        t=view.t, total_units=view.total_units, domains=view.domains,
        free_units=view.free_units, running=list(view.running),
        free_map=list(view.free_map), domain_jobs=list(view.domain_jobs),
        dead_units=view.dead_units,
    )


def tensors(*arrays):
    """numpy -> CPU float32 tensors (None stays None)."""
    return tuple(
        None if a is None
        else torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        for a in arrays
    )


def schedule_key(res):
    return (fp_records(res.records), res.makespan, res.total_energy)


def pod_table(n_jobs, *, M=16, levels=4, seed=7):
    """Seeded synthetic pod-scale truth table as plain dicts: sublinear
    speedups and power-law busy power over the counts that fit ``M`` (the
    shape of ``benchmarks/bench_decision_overhead.synth_window``), with
    the H100 DVFS ladder's sweet-spot curves at a per-job memory-bound
    fraction.  Returns (table, arrival stream)."""
    ratios = (1.0, 0.86, 0.72, 0.58)[:levels]
    floor = 0.32
    rng = np.random.default_rng(seed)
    counts = [g for g in (1, 2, 3, 4, 6, 8, 12, 16) if g <= M]
    table, stream, t = {}, [], 0.0
    for i in range(n_jobs):
        name = f"job{i}"
        t1 = float(rng.uniform(600.0, 6000.0))
        a = float(rng.uniform(0.35, 0.95))
        p0 = float(rng.uniform(250.0, 500.0))
        b = float(rng.uniform(0.6, 0.9))
        mu = float(rng.uniform(0.1, 0.75))
        runtime = {g: t1 / g ** a for g in counts}
        table[name] = dict(
            runtime=runtime,
            busy_power={g: p0 * g ** b for g in counts},
            dram_util={g: 1.0 / (runtime[g] * g) for g in counts},
            freq_time={f: mu + (1.0 - mu) / r for f, r in enumerate(ratios)},
            freq_power={f: floor + (1.0 - floor) * r ** 3
                        for f, r in enumerate(ratios)},
        )
        stream.append((t, name))
        t += float(rng.exponential(120.0))
    return table, stream

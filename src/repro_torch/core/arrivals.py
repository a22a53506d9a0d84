"""Online arrival streams for the cluster simulator.

The paper evaluates a single static scheduling window; real GPU
datacenters see jobs *arrive over time* (the regime of arXiv:2412.17484 /
arXiv:2304.06381).  This module generates seeded, replayable arrival
streams over the calibrated application mix:

  * ``poisson_stream``  — exponential inter-arrival gaps (rate jobs/s),
  * ``bursty_stream``   — Poisson-spaced bursts of correlated submissions
    (one user submitting a sweep), the heavy-tail pattern trace studies
    report,
  * ``save_trace`` / ``load_trace`` — byte-stable CSV round-trip so a
    stream can be replayed across machines and compared across policies.

All randomness flows through ``np.random.default_rng(seed)``; a fixed
seed yields a byte-identical trace.  Twin of ``repro.core.arrivals``:
the same seed gives the same stream in both packages.

``ArrivalRateEWMA`` is the online inter-arrival-rate estimator feeding
the forecast-driven control plane (``repro_torch.core.forecast``): two
exponentially weighted means over recent inter-arrival gaps — a short
horizon that reacts to bursts and a long horizon that anchors the
baseline — whose ratio is the burst signal the plane's hysteresis gates
on.  The short estimate is *censored* at query time by the silence since
the last arrival, so a stale burst reading decays as soon as the stream
goes quiet.
"""
from __future__ import annotations

import csv
import datetime as _dt
import io
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np


@dataclass(frozen=True)
class Arrival:
    """One job submission: unique instance ``name`` of application ``app``."""

    t: float
    name: str
    app: str


def _instance(app: str, idx: int) -> str:
    return f"{app}#{idx}"


def poisson_stream(
    apps: Sequence[str],
    *,
    rate: float,
    n: int,
    seed: int = 0,
    start: float = 0.0,
) -> List[Arrival]:
    """``n`` arrivals, exponential gaps with mean ``1/rate`` seconds, app
    drawn uniformly from ``apps``."""
    assert rate > 0 and n >= 0
    rng = np.random.default_rng(seed)
    t = start
    out: List[Arrival] = []
    for i in range(n):
        t += float(rng.exponential(1.0 / rate))
        app = str(apps[int(rng.integers(len(apps)))])
        out.append(Arrival(t=round(t, 6), name=_instance(app, i), app=app))
    return out


def bursty_stream(
    apps: Sequence[str],
    *,
    rate: float,
    n: int,
    burst: int = 4,
    seed: int = 0,
    start: float = 0.0,
) -> List[Arrival]:
    """~``n`` arrivals in bursts of 1..``burst`` jobs submitted together.

    Burst *starts* are Poisson with the given overall job rate scaled by
    the mean burst size, so the long-run job rate still ≈ ``rate``.
    """
    assert rate > 0 and n >= 0 and burst >= 1
    rng = np.random.default_rng(seed)
    mean_burst = (1 + burst) / 2.0
    t = start
    out: List[Arrival] = []
    i = 0
    while i < n:
        t += float(rng.exponential(mean_burst / rate))
        size = min(int(rng.integers(1, burst + 1)), n - i)
        app = str(apps[int(rng.integers(len(apps)))])  # a burst repeats one app
        for _ in range(size):
            out.append(Arrival(t=round(t, 6), name=_instance(app, i), app=app))
            i += 1
    return out


# ---------------------------------------------------------------------------
# Online arrival-rate estimation (forecast plane input)
# ---------------------------------------------------------------------------


class ArrivalRateEWMA:
    """Two-horizon EWMA over inter-arrival gaps.

    ``observe(t)`` feeds each arrival instant (monotone non-decreasing;
    same-instant burst members contribute zero gaps, which is exactly the
    burst signature).  ``rate(now)`` inverts the short-horizon mean gap,
    censored by the silence since the last arrival — ``max(gap_ewma,
    now - last)`` — so the estimate cannot stay hot forever after the
    stream stops.  ``burst_factor(now)`` is short-rate / baseline-rate:
    ~1 in steady state, ≫1 while a burst lands, decaying back toward 1
    through the post-burst lull.

    ``horizon`` counts effective samples: the EWMA weight is
    ``2 / (horizon + 1)`` (the classic N-period convention), so
    ``horizon=8`` reacts within a burst or two while
    ``baseline_horizon=64`` smooths over the whole recent stream.  Below
    ``min_samples`` gaps the estimator reports no signal (rate 0, factor
    1) rather than extrapolating from nothing.
    """

    def __init__(
        self,
        horizon: int = 8,
        baseline_horizon: int = 64,
        *,
        min_samples: int = 3,
    ):
        if horizon < 1 or baseline_horizon < 1:
            raise ValueError("EWMA horizons must be >= 1")
        self.alpha_short = 2.0 / (horizon + 1)
        self.alpha_long = 2.0 / (baseline_horizon + 1)
        self.min_samples = min_samples
        self.gap_short: Optional[float] = None
        self.gap_long: Optional[float] = None
        self.last_t: Optional[float] = None
        self.n_gaps = 0

    def observe(self, t: float) -> None:
        if self.last_t is not None:
            gap = max(t - self.last_t, 0.0)
            if self.gap_short is None:
                self.gap_short = gap
                self.gap_long = gap
            else:
                self.gap_short += self.alpha_short * (gap - self.gap_short)
                self.gap_long += self.alpha_long * (gap - self.gap_long)
            self.n_gaps += 1
        self.last_t = max(t, self.last_t) if self.last_t is not None else t

    def _short_gap(self, now: Optional[float]) -> Optional[float]:
        if self.n_gaps < self.min_samples or self.gap_short is None:
            return None
        gap = self.gap_short
        if now is not None and self.last_t is not None:
            gap = max(gap, now - self.last_t)  # censor: silence decays the rate
        return gap

    def rate(self, now: Optional[float] = None) -> float:
        """Short-horizon arrival rate (jobs/s); 0 before warm-up."""
        gap = self._short_gap(now)
        return 0.0 if gap is None else 1.0 / max(gap, 1e-9)

    def baseline_rate(self) -> float:
        """Long-horizon anchor rate (jobs/s); 0 before warm-up."""
        if self.n_gaps < self.min_samples or not self.gap_long:
            return 0.0
        return 1.0 / max(self.gap_long, 1e-9)

    def burst_factor(self, now: Optional[float] = None) -> float:
        """short-rate / baseline-rate; 1.0 whenever either is unwarmed."""
        gap = self._short_gap(now)
        if gap is None or self.gap_long is None:
            return 1.0
        return max(self.gap_long, 1e-9) / max(gap, 1e-9)


# ---------------------------------------------------------------------------
# Replayable trace files
# ---------------------------------------------------------------------------


def dumps_trace(stream: Sequence[Arrival]) -> str:
    """Canonical CSV serialization (header + ``t,name,app`` rows).

    Times use ``repr`` (shortest exact float form) so the round-trip is
    lossless for *any* stream, not just the 6-decimal generator output.
    Names and apps go through ``csv`` quoting, so adversarial values
    (commas, quotes, even newlines) survive the round-trip instead of
    corrupting neighbouring fields; plain names serialize byte-identically
    to the unquoted legacy format.
    """
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\n")
    w.writerow(["t", "name", "app"])
    for a in stream:
        if not a.name or not a.app:
            raise ValueError(f"arrival at t={a.t} has an empty name/app")
        w.writerow([repr(a.t), a.name, a.app])
    return buf.getvalue()


def loads_trace(text: str) -> List[Arrival]:
    rows = csv.reader(io.StringIO(text))
    header = next(rows, None)
    if header is not None and header[:1] != ["t"]:
        raise ValueError(f"not a trace file (header {header!r})")
    out: List[Arrival] = []
    for row in rows:
        if not row:
            continue
        if len(row) != 3:
            raise ValueError(f"malformed trace row {row!r}")
        t, name, app = row
        out.append(Arrival(t=float(t), name=name, app=app))
    return out


def save_trace(path: str, stream: Sequence[Arrival]) -> None:
    with open(path, "w") as f:
        f.write(dumps_trace(stream))


def load_trace(path: str) -> List[Arrival]:
    with open(path) as f:
        return loads_trace(f.read())


# ---------------------------------------------------------------------------
# Datacenter log replay (Philly / Helios-style submission CSVs)
# ---------------------------------------------------------------------------


def _parse_submit(raw: str) -> float:
    """Submission time as seconds: plain float, or an ISO-8601 timestamp
    (``2017-10-03 09:14:07``, the Philly/Helios log format).  Naive
    timestamps are pinned to UTC so the parse is machine-independent and
    inter-arrival gaps never pick up DST discontinuities."""
    raw = raw.strip()
    try:
        return float(raw)
    except ValueError:
        pass
    try:
        dt = _dt.datetime.fromisoformat(raw)
    except ValueError as e:
        raise ValueError(f"unparseable submit time {raw!r}") from e
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return dt.timestamp()


def from_datacenter_csv(
    source: str,
    *,
    t_col: str = "submit_time",
    name_col: str = "job_id",
    app_col: str = "app",
    app_map: Optional[Union[Dict[str, str], Callable[[str], Optional[str]]]] = None,
    rebase: bool = True,
    time_scale: float = 1.0,
    duration_col: Optional[str] = None,
    strict: bool = False,
) -> List[Arrival]:
    """Philly/Helios-style submission log -> replayable ``Arrival`` stream.

    Public GPU-datacenter traces (arXiv:2412.17484 / arXiv:2304.06381 use
    the same shape) are CSVs with one row per submitted job carrying a job
    id, a submission timestamp and some application/model tag.  This loader
    maps them onto the cluster simulator so benches can replay *real*
    arrival shapes (diurnal bursts, heavy-tailed sweeps) against the
    calibrated app mix:

      * ``source``   — a path, or the CSV text itself (anything containing
        a newline is treated as text),
      * ``t_col``    — submission time: float seconds or ISO-8601
        timestamps; with ``rebase`` (default) the earliest submission
        becomes t=0, and ``time_scale`` then compresses/stretches the
        stream (0.5 = replay twice as fast),
      * ``app_col``/``app_map`` — the application tag, optionally mapped
        onto calibrated app names (a dict or callable; rows mapping to
        ``None``/missing are dropped — real logs carry job types the
        calibration does not model),
      * duplicate job ids are uniquified with ``#k`` so the stream
        satisfies the simulator's unique-name contract,
      * ``duration_col`` — optional logged-runtime column, validated only:
        a malformed (unparseable, negative or zero) duration raises
        ``ValueError`` naming the row — corrupt rows must never silently
        shape a replay,
      * ``strict`` — promote the two silent normalizations to explicit
        errors: an app with no ``app_map`` entry raises instead of being
        dropped, and out-of-order submit times raise instead of being
        sorted.  Use it when the log is supposed to be clean and a
        surprise would mean the wrong file was loaded.

    The result is sorted by time (stable, so same-instant rows keep log
    order) and round-trips byte-stably through ``save_trace``/``load_trace``
    like every generated stream.
    """
    if "\n" in source:
        text = source
    else:
        with open(source) as f:
            text = f.read()
    rows = list(csv.DictReader(io.StringIO(text)))
    if not rows:
        return []
    for col in (t_col, name_col, app_col) + (
        (duration_col,) if duration_col is not None else ()
    ):
        if col not in rows[0]:
            raise ValueError(
                f"column {col!r} not in trace header {sorted(rows[0])!r}"
            )
    parsed: List[Arrival] = []
    emitted: set = set()
    next_suffix: Dict[str, int] = {}
    prev_t: Optional[float] = None
    for row in rows:
        if duration_col is not None:
            raw_dur = (row[duration_col] or "").strip()
            try:
                dur = float(raw_dur)
            except ValueError as e:
                raise ValueError(
                    f"unparseable {duration_col!r} {raw_dur!r} in row {row!r}"
                ) from e
            if not dur > 0.0:
                raise ValueError(
                    f"non-positive {duration_col!r} {dur!r} in row {row!r}"
                )
        raw_app = (row[app_col] or "").strip()
        if app_map is None:
            app = raw_app
        elif callable(app_map):
            app = app_map(raw_app)
        else:
            app = app_map.get(raw_app)
        if not app:
            if strict:
                raise ValueError(
                    f"app {raw_app!r} has no app_map entry (row {row!r}); "
                    "pass strict=False to drop unmodeled job types"
                )
            continue  # unmodeled job type
        t = _parse_submit(row[t_col])
        if strict and prev_t is not None and t < prev_t:
            raise ValueError(
                f"out-of-order submit time {row[t_col]!r} in row {row!r} "
                "(strict=True; pass strict=False to sort)"
            )
        prev_t = t
        name = (row[name_col] or "").strip()
        if not name:
            raise ValueError(f"row with empty {name_col!r}: {row!r}")
        if name in emitted:
            # synthesized names can collide with ids literally in the log
            # (j1, j1, "j1#1"), so probe until genuinely fresh
            k = next_suffix.get(name, 1)
            while f"{name}#{k}" in emitted:
                k += 1
            next_suffix[name] = k + 1
            name = f"{name}#{k}"
        emitted.add(name)
        parsed.append(Arrival(t=t, name=name, app=app))
    if not parsed:
        return []
    parsed.sort(key=lambda a: a.t)  # stable: same-instant rows keep log order
    t0 = parsed[0].t if rebase else 0.0
    return [
        Arrival(t=round((a.t - t0) * time_scale, 6), name=a.name, app=a.app)
        for a in parsed
    ]

"""Command-line front end for the scheduler daemon.

``python -m repro_torch.cli daemon`` boots a ``SchedulerService`` over a
unix socket on a calibrated simulation backend whose node policies run
``EcoSched(engine="torch")``: every decision reduces on the hand-written
``score_reduce`` kernels on ``--device`` (default ``cuda``; without a card
the daemon exits non-zero unless ``--device cpu`` asks for the kernels'
plain versions).  Every other subcommand is a thin JSON-lines client
against a running daemon:

    python -m repro_torch.cli daemon --socket /tmp/eco.sock --journal /tmp/eco.jnl &
    python -m repro_torch.cli submit --socket /tmp/eco.sock --name j0 --app resnet50
    python -m repro_torch.cli advance --socket /tmp/eco.sock --until 3600
    python -m repro_torch.cli jobs --socket /tmp/eco.sock
    python -m repro_torch.cli drain --socket /tmp/eco.sock
    python -m repro_torch.cli result --socket /tmp/eco.sock
    python -m repro_torch.cli shutdown --socket /tmp/eco.sock

Kill the daemon (even with SIGKILL) and boot it again with the same
``--journal`` and preset: it replays the journal through a fresh backend
and resumes exactly where it was — the recovery contract documented in
docs/control_plane.md and property-tested in tests/test_torch_service.py.
The journal is the reference's format, byte for byte: a journal written
by ``python -m repro.cli`` recovers here with the same preset and flags,
and the other way round.

Presets build the same calibrated systems the benchmarks use (the
paper's H100/A100/V100 platforms, EcoSched per node):

  * ``single-h100`` — one 4-GPU H100 node,
  * ``hetero``      — one node each of H100/A100/V100 behind the
                      energy-aware dispatcher.

Twin of ``repro.cli``, plus ``--device``.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core import calibration as C
from repro_torch.core.cluster import (
    Cluster,
    EnergyAwareDispatcher,
    LeastLoadedDispatcher,
    NodeSpec,
    PredictiveDispatcher,
    RoundRobinDispatcher,
)
from repro_torch.core.ecosched import EcoSched
from repro_torch.core.events import ElasticConfig
from repro_torch.core.faults import FaultConfig
from repro_torch.core.forecast import ForecastConfig
from repro_torch.core.perfmodel import ProfiledPerfModel
from repro_torch.core.service import (
    AdmissionConfig,
    ClusterBackend,
    SchedulerService,
    request,
    request_retry,
    serve,
)
from repro_torch.device import resolve_device
from repro_torch.roofline.hw import CHIPS

# reproduction-locked policy hyperparameters (EXPERIMENTS.md)
LAM, TAU, NOISE, SEED = 0.35, 0.45, 0.02, 1

PRESETS = {
    "single-h100": ("h100",),
    "hetero": ("h100", "a100", "v100"),
}

DISPATCHERS = {
    "eco": EnergyAwareDispatcher,
    "predictive": PredictiveDispatcher,
    "rr": RoundRobinDispatcher,
    "least-loaded": LeastLoadedDispatcher,
}


def make_backend_factory(
    preset: str,
    *,
    dispatcher: str = "eco",
    elastic: bool = False,
    forecast: bool = False,
    freq_levels: int = 1,
    faults: "FaultConfig | None" = None,
    engine: str = "torch",
    device="cuda",
):
    """A fresh-backend factory for ``SchedulerService``: every call
    rebuilds the calibrated cluster from scratch (deterministically),
    which is exactly what journal replay needs.  ``freq_levels > 1``
    enables DVFS: each node's truth tables carry per-frequency
    runtime/power curves, the per-node policies pick joint (count,
    frequency) actions, and the chosen level is journaled per transition
    so crash recovery replays it bit-identically.  The node policies
    score on ``engine`` (``"torch"``: the CUDA kernels on ``device``, or
    their plain versions with ``device="cpu"``; ``"vector"``: the numpy
    engine); the schedule, and so the journal, is the same either way."""
    systems = PRESETS[preset]

    def make() -> ClusterBackend:
        seen = {}
        specs = []
        for s in systems:
            idx = seen.get(s, 0)
            seen[s] = idx + 1
            specs.append(NodeSpec(name=f"{s}-{idx}", chip=CHIPS[s]))
        cluster = Cluster(
            specs,
            truth_for=lambda spec: C.build_system(
                spec.chip.name, freq_levels=freq_levels
            ),
            policy_for=lambda spec, truth: EcoSched(
                ProfiledPerfModel(truth, noise=NOISE, seed=SEED),
                lam=LAM,
                tau=TAU,
                engine=engine,
                device=device,
            ),
            dispatcher=DISPATCHERS[dispatcher](),
            slowdown_for=lambda spec: C.cross_numa_slowdown,
            label=f"{preset}:{dispatcher}",
        )
        return ClusterBackend(
            cluster,
            elastic=(
                ElasticConfig(resize=True, migrate=len(systems) > 1)
                if elastic
                else None
            ),
            forecast=ForecastConfig() if forecast else None,
            faults=faults,
        )

    return make


def _client(args: argparse.Namespace, req: dict) -> int:
    # transient connect failures (daemon still booting / recovering) are
    # retried with exponential backoff unless --no-retry asks for the
    # old fail-fast behavior
    if getattr(args, "no_retry", False):
        resp = request(args.socket, req)
    else:
        resp = request_retry(args.socket, req)
    print(json.dumps(resp, sort_keys=True, indent=2))
    return 0 if resp.get("ok") else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="repro_torch.cli", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, **kw):
        sp = sub.add_parser(name, **kw)
        sp.add_argument("--socket", required=True, help="unix socket path")
        sp.add_argument(
            "--no-retry",
            action="store_true",
            help="fail fast instead of retrying transient connect errors",
        )
        return sp

    d = add("daemon", help="boot the scheduler daemon")
    d.add_argument("--journal", default=None, help="append-only journal path")
    d.add_argument("--preset", default="hetero", choices=sorted(PRESETS))
    d.add_argument(
        "--dispatcher", default="eco", choices=sorted(DISPATCHERS)
    )
    d.add_argument("--elastic", action="store_true")
    d.add_argument("--forecast", action="store_true")
    d.add_argument(
        "--freq-levels",
        type=int,
        default=1,
        help="DVFS levels per chip (1 = base clock only)",
    )
    d.add_argument("--fsync", action="store_true")
    d.add_argument("--max-pending", type=int, default=256)
    d.add_argument("--burst-limit", type=float, default=3.0)
    d.add_argument("--burst-pending", type=int, default=16)
    d.add_argument(
        "--fault-seed", type=int, default=0, help="fault-injection RNG seed"
    )
    d.add_argument(
        "--node-mtbf",
        type=float,
        default=0.0,
        help="mean seconds between node failures (0 = no node faults)",
    )
    d.add_argument(
        "--node-mttr", type=float, default=600.0, help="mean repair seconds"
    )
    d.add_argument(
        "--degrade-frac",
        type=float,
        default=0.0,
        help="probability a node failure is partial (loses --degrade-units)",
    )
    d.add_argument("--degrade-units", type=int, default=1)
    d.add_argument(
        "--job-mtbf",
        type=float,
        default=0.0,
        help="mean running seconds between job crashes (0 = no job faults)",
    )
    d.add_argument("--max-retries", type=int, default=3)
    d.add_argument(
        "--device",
        default="cuda",
        help="where the policies' kernels run (cpu = their plain versions)",
    )

    s = add("submit", help="submit one job")
    s.add_argument("--name", required=True)
    s.add_argument("--app", required=True)
    s.add_argument("--t", type=float, default=None)

    c = add("cancel", help="cancel a not-yet-running job")
    c.add_argument("--name", required=True)

    st = add("status", help="one job's lifecycle state")
    st.add_argument("--name", required=True)

    add("jobs", help="list all jobs")
    a = add("advance", help="advance simulated time")
    a.add_argument("--until", type=float, default=None)
    add("drain", help="run until every queued job has finished")
    add("stats", help="daemon statistics")
    add("compact", help="fold journaled transitions into a snapshot")
    add("result", help="final schedule fingerprint (after drain)")
    add("ping", help="liveness check")
    add("shutdown", help="stop the daemon cleanly")

    args = p.parse_args(argv)

    if args.cmd == "daemon":
        try:
            resolve_device(args.device)
        except RuntimeError as exc:
            print(f"daemon: {exc}", file=sys.stderr, flush=True)
            return 2
        faults = FaultConfig(
            seed=args.fault_seed,
            node_mtbf_s=args.node_mtbf,
            node_mttr_s=args.node_mttr,
            degrade_frac=args.degrade_frac,
            degrade_units=args.degrade_units,
            job_mtbf_s=args.job_mtbf,
            max_retries=args.max_retries,
        )
        service = SchedulerService(
            make_backend_factory(
                args.preset,
                dispatcher=args.dispatcher,
                elastic=args.elastic,
                forecast=args.forecast,
                freq_levels=args.freq_levels,
                faults=faults if faults.enabled else None,
                device=args.device,
            ),
            journal_path=args.journal,
            admission=AdmissionConfig(
                max_pending=args.max_pending,
                burst_limit=args.burst_limit,
                burst_pending=args.burst_pending,
            ),
            fsync=args.fsync,
        )
        print(f"daemon: {service.backend.describe()} on {args.socket}", flush=True)
        serve(service, args.socket)
        return 0
    if args.cmd == "submit":
        req = {"op": "submit", "name": args.name, "app": args.app}
        if args.t is not None:
            req["t"] = args.t
        return _client(args, req)
    if args.cmd == "cancel":
        return _client(args, {"op": "cancel", "name": args.name})
    if args.cmd == "status":
        return _client(args, {"op": "status", "name": args.name})
    if args.cmd == "advance":
        req = {"op": "advance"}
        if args.until is not None:
            req["until"] = args.until
        return _client(args, req)
    return _client(args, {"op": args.cmd})


if __name__ == "__main__":
    sys.exit(main())

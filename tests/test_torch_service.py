"""The port's scheduler control plane against the reference, on the CPU.

Mirrors tests/test_service.py case for case on ``repro_torch.core``
(``journal``, ``service``) and ``repro_torch.cli``: the job-lifecycle
state machine, journal round-trips, the admission gate, idempotent
resubmit and cancel, daemon-vs-batch schedule parity, and the crash
property -- truncate the journal at seeded byte offsets (a SIGKILL can
land anywhere), restart, replay, re-apply the workload, and the final
schedule is bit-identical to the uninterrupted run -- up to a live
``python -m repro_torch.cli daemon --device cpu`` killed with SIGKILL.
The port's node policies run ``EcoSched(engine="torch", device="cpu")``
(the kernels' plain versions).

Then the two packages against each other.  The journal file is the
contract: the same ops through the reference's ``SchedulerService`` and
the port's write byte-identical journals (the 2-node cluster, and the
``hetero`` preset with DVFS levels and with elastic resizing), and a
journal written by either package, truncated at seeded offsets, recovers
in the other with no replay divergence and the same fingerprint.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import cli as RCLI  # noqa: E402
from repro import core as RCORE  # noqa: E402
from repro.core import calibration as RC  # noqa: E402
from repro.roofline import hw as RHW  # noqa: E402
from repro_torch import cli as PCLI  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AdmissionConfig,
    Arrival,
    Cluster,
    ClusterBackend,
    EcoSched,
    EnergyAwareDispatcher,
    IllegalTransition,
    JobInfo,
    Journal,
    JournalError,
    NodeSpec,
    ProfiledPerfModel,
    RecoveryError,
    SchedulerService,
)
from repro_torch.core import calibration as C  # noqa: E402
from repro_torch.core.service import (  # noqa: E402
    ADMITTED,
    CANCELLED,
    DONE,
    FAILED,
    MIGRATING,
    PREEMPTED,
    QUEUED,
    RUNNING,
    SUBMITTED,
    TRANSITIONS,
)
from repro_torch.roofline.hw import A100, H100  # noqa: E402

LAM, TAU, NOISE, SEED = 0.35, 0.45, 0.02, 1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT_POLICY = dict(engine="torch", device="cpu")


def _cluster(dispatcher=None, *, freq_levels=1, label="svc-test"):
    return Cluster(
        [NodeSpec("h100-0", H100), NodeSpec("a100-0", A100)],
        truth_for=lambda s: C.build_system(s.chip.name, freq_levels=freq_levels),
        policy_for=lambda s, t: EcoSched(
            ProfiledPerfModel(t, noise=NOISE, seed=SEED), lam=LAM, tau=TAU,
            **PORT_POLICY,
        ),
        dispatcher=dispatcher or EnergyAwareDispatcher(),
        slowdown_for=lambda s: C.cross_numa_slowdown,
        label=label,
    )


def _ref_cluster(*, freq_levels=1, label="svc-test"):
    """The reference's twin of ``_cluster`` (tests/test_service.py)."""
    return RCORE.Cluster(
        [RCORE.NodeSpec("h100-0", RHW.H100), RCORE.NodeSpec("a100-0", RHW.A100)],
        truth_for=lambda s: RC.build_system(s.chip.name, freq_levels=freq_levels),
        policy_for=lambda s, t: RCORE.EcoSched(
            RCORE.ProfiledPerfModel(t, noise=NOISE, seed=SEED), lam=LAM, tau=TAU
        ),
        dispatcher=RCORE.EnergyAwareDispatcher(),
        slowdown_for=lambda s: RC.cross_numa_slowdown,
        label=label,
    )


def _factory(**kw):
    return lambda: ClusterBackend(_cluster(), **kw)


def _fingerprint(service):
    res = service.result()
    assert res["ok"], res
    return (
        tuple(tuple(r) for r in sorted(res["records"])),
        res["makespan"],
        res["total_energy"],
    )


# a workload exercising every journal record kind: staggered submits,
# a same-instant pair, a cancel, bounded advances, a late straggler, drain
# (the reference's OPS, tests/test_service.py)
OPS = [
    ("submit", "j0", "bert", 10.0),
    ("submit", "j1", "lbm", 10.0),
    ("submit", "j2", "resnet50", 40.0),
    ("advance", 60.0),
    ("submit", "j3", "gpt2", 90.0),
    ("submit", "j4", "MonteCarlo", 90.0),
    ("cancel", "j4"),
    ("advance", 800.0),
    ("submit", "j5", "vgg16", 1200.0),
    ("drain",),
]


def _apply(service, ops=OPS):
    for op in ops:
        if op[0] == "submit":
            service.submit(op[1], op[2], op[3])
        elif op[0] == "cancel":
            service.cancel(op[1])
        elif op[0] == "advance":
            service.advance(op[1])
        else:
            service.advance(None)


# --------------------------------------------------------------------------
# state machine
# --------------------------------------------------------------------------


def test_legal_lifecycle_paths():
    j = JobInfo(name="a", app="x")
    for s in (ADMITTED, QUEUED, RUNNING, PREEMPTED, QUEUED, MIGRATING,
              QUEUED, RUNNING, DONE):
        j.advance(s, 1.0)
    assert j.state == DONE
    assert [s for _, s in j.history] == [
        ADMITTED, QUEUED, RUNNING, PREEMPTED, QUEUED, MIGRATING,
        QUEUED, RUNNING, DONE,
    ]


@pytest.mark.parametrize(
    "path",
    [
        (RUNNING,),                      # SUBMITTED cannot launch directly
        (ADMITTED, RUNNING),             # must be QUEUED first
        (ADMITTED, QUEUED, RUNNING, DONE, QUEUED),   # DONE is terminal
        (ADMITTED, CANCELLED, QUEUED),   # CANCELLED is terminal
        (FAILED, ADMITTED),              # FAILED is terminal
        (ADMITTED, QUEUED, PREEMPTED),   # preempt only from RUNNING
    ],
)
def test_illegal_transitions_raise(path):
    j = JobInfo(name="a", app="x")
    with pytest.raises(IllegalTransition):
        for s in path:
            j.advance(s, 0.0)


def test_unknown_state_raises():
    j = JobInfo(name="a", app="x")
    with pytest.raises(IllegalTransition):
        j.advance("LIMBO", 0.0)


def test_every_state_is_reachable():
    reachable, frontier = {SUBMITTED}, [SUBMITTED]
    while frontier:
        for nxt in TRANSITIONS[frontier.pop()]:
            if nxt not in reachable:
                reachable.add(nxt)
                frontier.append(nxt)
    assert reachable == set(TRANSITIONS)


def test_state_machine_is_the_reference():
    from repro.core import service as RSVC

    assert TRANSITIONS == RSVC.TRANSITIONS
    assert AdmissionConfig().to_dict() == RCORE.AdmissionConfig().to_dict()


# --------------------------------------------------------------------------
# journal
# --------------------------------------------------------------------------


def test_journal_round_trip(tmp_path):
    path = str(tmp_path / "j.jnl")
    recs = [
        {"k": "hdr", "v": 1},
        {"k": "sub", "t": 1.5, "name": "a", "app": "x", "ok": True},
        {"k": "evt", "e": "queued", "t": 1.5, "job": "a"},
    ]
    with Journal(path) as j:
        for r in recs:
            j.append(r)
    assert Journal.read(path) == recs
    # the reference reads the same file the same way
    assert RCORE.Journal.read(path) == recs


def test_journal_torn_tail_dropped(tmp_path):
    path = str(tmp_path / "j.jnl")
    with Journal(path) as j:
        j.append({"k": "hdr", "v": 1})
        j.append({"k": "sub", "name": "a"})
    with open(path, "ab") as f:
        f.write(b'{"k":"sub","na')  # SIGKILL mid-append
    recs = Journal.read(path)
    assert [r["k"] for r in recs] == ["hdr", "sub"]


def test_journal_corrupt_middle_raises(tmp_path):
    path = str(tmp_path / "j.jnl")
    lines = ['{"k":"hdr","v":1}', "not json at all", '{"k":"sub","name":"a"}']
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.raises(JournalError):
        Journal.read(path)


def test_journal_complete_tail_without_newline_kept(tmp_path):
    path = str(tmp_path / "j.jnl")
    with open(path, "w") as f:
        f.write('{"k":"hdr","v":1}\n{"k":"sub","name":"a"}')  # newline lost
    assert [r["k"] for r in Journal.read(path)] == ["hdr", "sub"]


def test_chain_hash_is_the_reference():
    from repro.core import journal as RJ
    from repro_torch.core import journal as PJ

    recs = [{"k": "evt", "e": "launch", "t": 1.25, "job": f"j{i}", "g": i}
            for i in range(5)]
    assert PJ.JOURNAL_VERSION == RJ.JOURNAL_VERSION
    assert PJ.chain_hash(recs) == RJ.chain_hash(recs)
    assert PJ.chain_hash(recs[2:], PJ.chain_hash(recs[:2])) == RJ.chain_hash(recs)


# --------------------------------------------------------------------------
# admission control
# --------------------------------------------------------------------------


def test_queue_full_rejection():
    svc = SchedulerService(
        _factory(), admission=AdmissionConfig(max_pending=2, burst_limit=0)
    )
    assert svc.submit("a", "bert", 10.0)["ok"]
    assert svc.submit("b", "bert", 11.0)["ok"]
    resp = svc.submit("c", "bert", 12.0)
    assert not resp["ok"] and "queue full" in resp["reason"]
    assert svc.jobs["c"].state == FAILED
    assert svc.gate.rejected == 1
    # the backlog draining re-opens the gate
    svc.advance(None)
    assert svc.submit("d", "bert", 20000.0)["ok"]


def test_burst_shed_rejection():
    svc = SchedulerService(
        _factory(),
        admission=AdmissionConfig(
            max_pending=0, burst_limit=2.0, burst_pending=2,
            ewma_horizon=4, baseline_horizon=64,
        ),
    )
    # establish a slow baseline...
    t = 0.0
    for i in range(8):
        t += 500.0
        assert svc.submit(f"s{i}", "bert", t)["ok"]
    # ...then a tight burst on top of a deep backlog
    rejected = []
    for i in range(12):
        t += 1.0
        resp = svc.submit(f"b{i}", "bert", t)
        if not resp["ok"]:
            rejected.append(resp["reason"])
    assert rejected and all("burst shed" in r for r in rejected)
    assert svc.gate.rejected == len(rejected)


def test_unplaceable_app_fails_at_the_edge():
    svc = SchedulerService(_factory())
    resp = svc.submit("a", "no-such-app", 1.0)
    assert not resp["ok"] and "no node can run" in resp["reason"]
    assert svc.jobs["a"].state == FAILED


def test_idempotent_resubmit(tmp_path):
    path = str(tmp_path / "j.jnl")
    svc = SchedulerService(_factory(), journal_path=path)
    svc.submit("a", "bert", 10.0)
    resp = svc.submit("a", "bert", 10.0)  # client retry after a crash
    assert resp["ok"] and resp.get("dup")
    svc.close()
    subs = [r for r in Journal.read(path) if r["k"] == "sub"]
    assert len(subs) == 1  # the retry journaled nothing


# --------------------------------------------------------------------------
# cancel semantics
# --------------------------------------------------------------------------


def test_cancel_queued_job_and_refuse_running():
    svc = SchedulerService(_factory())
    svc.submit("a", "bert", 10.0)
    svc.submit("b", "lbm", 20.0)
    assert svc.cancel("a")["ok"]  # never launched: cancellable
    assert svc.jobs["a"].state == CANCELLED
    svc.advance(100.0)  # b launches
    assert svc.jobs["b"].state == RUNNING
    resp = svc.cancel("b")
    assert not resp["ok"] and "not cancellable" in resp["reason"]
    assert not svc.cancel("nope")["ok"]  # unknown job
    svc.advance(None)
    res = svc.result()
    assert [r[0] for r in res["records"]] == ["b"]  # a left no trace


# --------------------------------------------------------------------------
# daemon-vs-batch schedule parity
# --------------------------------------------------------------------------


def test_service_matches_batch_simulate():
    stream = [
        Arrival(t=10.0, name="j0", app="bert"),
        Arrival(t=10.0, name="j1", app="lbm"),
        Arrival(t=40.0, name="j2", app="resnet50"),
        Arrival(t=90.0, name="j3", app="gpt2"),
        Arrival(t=1200.0, name="j4", app="vgg16"),
    ]
    batch = _cluster().simulate(stream)
    svc = SchedulerService(
        lambda: ClusterBackend(
            _cluster(), apps=sorted({a.app for a in stream})
        )
    )
    for a in stream:
        assert svc.submit(a.name, a.app, a.t)["ok"]
    svc.advance(None)
    res = svc.result()
    assert res["ok"]
    batch_keyed = sorted(
        [r.job, r.node, r.g, r.f, r.start, r.end] for r in batch.records
    )
    assert sorted(res["records"]) == batch_keyed
    assert res["makespan"] == batch.makespan
    assert res["total_energy"] == batch.total_energy


# --------------------------------------------------------------------------
# recovery
# --------------------------------------------------------------------------


def test_clean_restart_recovers_identical_state(tmp_path):
    path = str(tmp_path / "j.jnl")
    svc = SchedulerService(_factory(), journal_path=path)
    _apply(svc)
    golden = _fingerprint(svc)
    golden_jobs = {n: j.to_dict() for n, j in svc.jobs.items()}
    svc.close()

    back = SchedulerService(_factory(), journal_path=path)
    assert back.replay_divergences == 0
    assert _fingerprint(back) == golden
    assert {n: j.to_dict() for n, j in back.jobs.items()} == golden_jobs
    back.close()


def test_crash_recovery_at_random_offsets(tmp_path):
    """Kill the daemon at ANY byte offset of the journal, restart,
    replay, re-drive the workload — the final schedule is bit-identical
    to the run that never crashed."""
    golden_path = str(tmp_path / "golden.jnl")
    svc = SchedulerService(_factory(), journal_path=golden_path)
    _apply(svc)
    golden = _fingerprint(svc)
    svc.close()
    blob = open(golden_path, "rb").read()
    header_end = blob.index(b"\n") + 1

    rng = np.random.default_rng(1234)
    offsets = sorted(
        {int(o) for o in rng.integers(1, len(blob), size=12)}
        | {header_end - 2, header_end, len(blob) - 1}
    )
    for off in offsets:
        path = str(tmp_path / f"crash{off}.jnl")
        with open(path, "wb") as f:
            f.write(blob[:off])
        back = SchedulerService(_factory(), journal_path=path)  # recovers
        _apply(back)  # the client re-drives; submits are idempotent
        assert _fingerprint(back) == golden, f"diverged at offset {off}"
        assert back.replay_divergences == 0
        back.close()
        # and the repaired journal recovers once more, untouched
        again = SchedulerService(_factory(), journal_path=path)
        assert _fingerprint(again) == golden
        again.close()


def test_crash_recovery_replays_dvfs_bit_identically(tmp_path):
    """With frequency ladders enabled, the journal carries each
    transition's chosen (g, f) and crash recovery replays the joint
    actions bit-identically at any truncation offset."""

    def factory():
        return ClusterBackend(_cluster(freq_levels=3, label="svc-dvfs"))

    golden_path = str(tmp_path / "golden.jnl")
    svc = SchedulerService(factory, journal_path=golden_path)
    _apply(svc)
    golden = _fingerprint(svc)
    svc.close()
    recs = Journal.read(golden_path)
    # the backend identity distinguishes DVFS systems, transitions carry f,
    # and the workload actually exercised a non-base frequency level
    assert "/f3" in recs[0]["backend"]
    evts = [r for r in recs if r["k"] == "evt"]
    assert all("f" in r for r in evts)
    assert any(r["f"] > 0 for r in evts if r["e"] == "launch")
    assert any(r[3] > 0 for r in golden[0])  # records journal f too

    blob = open(golden_path, "rb").read()
    rng = np.random.default_rng(99)
    for off in sorted({int(o) for o in rng.integers(1, len(blob), size=6)}):
        path = str(tmp_path / f"crash{off}.jnl")
        with open(path, "wb") as f:
            f.write(blob[:off])
        back = SchedulerService(factory, journal_path=path)  # recovers
        _apply(back)  # the client re-drives; submits are idempotent
        assert _fingerprint(back) == golden, f"diverged at offset {off}"
        assert back.replay_divergences == 0
        back.close()


def test_tampered_event_raises_recovery_error(tmp_path):
    path = str(tmp_path / "j.jnl")
    svc = SchedulerService(_factory(), journal_path=path)
    _apply(svc)
    svc.close()
    lines = open(path).read().splitlines()
    for i, line in enumerate(lines):
        rec = json.loads(line)
        if rec["k"] == "evt" and rec["e"] == "launch":
            rec["node"] = "h100-0" if rec["node"] != "h100-0" else "a100-0"
            lines[i] = json.dumps(rec, separators=(",", ":"), sort_keys=True)
            break
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.raises(RecoveryError):
        SchedulerService(_factory(), journal_path=path)


def test_lost_input_record_raises_recovery_error(tmp_path):
    # deleting an *input* (adv) leaves journaled transitions that replay
    # can no longer regenerate -> the prefix check must refuse
    path = str(tmp_path / "j.jnl")
    svc = SchedulerService(_factory(), journal_path=path)
    _apply(svc)
    svc.close()
    lines = [
        l for l in open(path).read().splitlines()
        if json.loads(l)["k"] != "adv"
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.raises(RecoveryError):
        SchedulerService(_factory(), journal_path=path)


def test_wrong_backend_raises_recovery_error(tmp_path):
    path = str(tmp_path / "j.jnl")
    svc = SchedulerService(_factory(), journal_path=path)
    svc.submit("a", "bert", 10.0)
    svc.close()

    def other():
        return ClusterBackend(
            Cluster(
                [NodeSpec("h100-0", H100)],
                truth_for=lambda s: C.build_system(s.chip.name),
                policy_for=lambda s, t: EcoSched(
                    ProfiledPerfModel(t, noise=NOISE, seed=SEED),
                    lam=LAM, tau=TAU, **PORT_POLICY,
                ),
                dispatcher=EnergyAwareDispatcher(),
            )
        )

    with pytest.raises(RecoveryError):
        SchedulerService(other, journal_path=path)


# --------------------------------------------------------------------------
# auto journal compaction
# --------------------------------------------------------------------------


def test_auto_compaction_by_size(tmp_path):
    """Once the journal outgrows ``compact_every_bytes``, the folded
    snapshot runs by itself — and the compacted journal still recovers
    the exact same schedule."""
    path = str(tmp_path / "j.jnl")
    svc = SchedulerService(
        _factory(), journal_path=path, compact_every_bytes=1500
    )
    _apply(svc)
    golden = _fingerprint(svc)
    assert svc.auto_compactions >= 1
    assert svc.stats()["auto_compactions"] == svc.auto_compactions
    svc.close()
    recs = Journal.read(path)
    assert recs[1]["k"] == "snap" and recs[1]["n"] > 0
    back = SchedulerService(_factory(), journal_path=path)
    assert _fingerprint(back) == golden
    assert back.replay_divergences == 0
    back.close()


def test_auto_compaction_by_age(tmp_path):
    """The age trigger fires once the oldest un-compacted transition is
    older than ``compact_max_age_s`` — a mostly-idle daemon compacts on
    its next operation instead of never."""
    path = str(tmp_path / "j.jnl")
    svc = SchedulerService(
        _factory(), journal_path=path, compact_max_age_s=1e-6
    )
    _apply(svc)
    golden = _fingerprint(svc)
    assert svc.auto_compactions >= 1
    svc.close()
    back = SchedulerService(_factory(), journal_path=path)
    assert _fingerprint(back) == golden
    back.close()


def test_auto_compaction_disabled_by_default(tmp_path):
    path = str(tmp_path / "j.jnl")
    svc = SchedulerService(_factory(), journal_path=path)
    _apply(svc)
    assert svc.auto_compactions == 0
    svc.close()
    assert all(r["k"] != "snap" for r in Journal.read(path))


def test_stale_compaction_tmp_ignored(tmp_path):
    """A crash during the snapshot's tmp write leaves ``<journal>.tmp``
    beside an untouched journal; recovery must ignore it and the next
    compaction must overwrite it."""
    path = str(tmp_path / "j.jnl")
    svc = SchedulerService(_factory(), journal_path=path)
    _apply(svc)
    golden = _fingerprint(svc)
    svc.close()
    with open(path + ".tmp", "w") as f:
        f.write('{"k":"hdr","v":3')  # torn mid-write
    back = SchedulerService(_factory(), journal_path=path)
    assert _fingerprint(back) == golden
    assert back.compact()["ok"]
    again = SchedulerService(_factory(), journal_path=path)
    assert _fingerprint(again) == golden
    again.close()
    back.close()


_COMPACT_KILL_CHILD = """\
import os
import signal
import sys

sys.path.insert(0, {src!r})
from repro_torch.core import (
    Cluster, ClusterBackend, EcoSched, EnergyAwareDispatcher, NodeSpec,
    ProfiledPerfModel, SchedulerService,
)
from repro_torch.core import calibration as C
from repro_torch.roofline.hw import A100, H100


def factory():
    return ClusterBackend(Cluster(
        [NodeSpec("h100-0", H100), NodeSpec("a100-0", A100)],
        truth_for=lambda s: C.build_system(s.chip.name),
        policy_for=lambda s, t: EcoSched(
            ProfiledPerfModel(t, noise=0.02, seed=1), lam=0.35, tau=0.45,
            engine="torch", device="cpu",
        ),
        dispatcher=EnergyAwareDispatcher(),
        slowdown_for=lambda s: C.cross_numa_slowdown,
        label="svc-test",
    ))


svc = SchedulerService(factory, journal_path=sys.argv[1])
svc.submit("j0", "bert", 10.0)
svc.submit("j1", "lbm", 10.0)
svc.submit("j2", "resnet50", 40.0)
svc.advance(60.0)
svc.advance(800.0)

stage = sys.argv[2]
real_replace = os.replace


def kill_replace(src_p, dst_p):
    if stage == "after_replace":
        real_replace(src_p, dst_p)
    os.kill(os.getpid(), signal.SIGKILL)


os.replace = kill_replace
svc.compact()  # never returns
"""


@pytest.mark.parametrize("stage", ["before_replace", "after_replace"])
def test_mid_compaction_sigkill_crash_safe(tmp_path, stage):
    """SIGKILL landing inside ``Journal.snapshot`` — right before or
    right after the atomic rename — leaves either the old journal (plus
    a stale tmp) or the compacted one, never a mix; restart recovers and
    the re-driven workload finishes bit-identical to an uninterrupted
    run."""
    ref = SchedulerService(_factory())
    _apply(ref)
    golden = _fingerprint(ref)

    path = str(tmp_path / "j.jnl")
    script = tmp_path / "child.py"
    script.write_text(_COMPACT_KILL_CHILD.format(src=SRC))
    proc = subprocess.run(
        [sys.executable, str(script), path, stage],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=120,
    )
    assert proc.returncode == -signal.SIGKILL, proc.stdout.decode()
    if stage == "before_replace":
        assert os.path.exists(path + ".tmp")  # the torn compaction
        assert all(r["k"] != "snap" for r in Journal.read(path))
    else:
        assert Journal.read(path)[1]["k"] == "snap"

    back = SchedulerService(_factory(), journal_path=path)
    assert back.replay_divergences == 0
    _apply(back)  # re-drive everything; submits are idempotent
    assert _fingerprint(back) == golden
    back.close()
    again = SchedulerService(_factory(), journal_path=path)
    assert _fingerprint(again) == golden
    again.close()


# --------------------------------------------------------------------------
# the real thing: SIGKILL a live daemon subprocess, restart, compare
# --------------------------------------------------------------------------


def _rpc(sock_path, req, *, timeout=10.0):
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
        c.settimeout(timeout)
        c.connect(sock_path)
        c.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = c.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())


def _boot_daemon(sock_path, jnl_path, *extra):
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "repro_torch.cli", "daemon",
            "--socket", sock_path, "--journal", jnl_path,
            "--preset", "hetero", "--device", "cpu", *extra,
        ],
        env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    # importing torch takes seconds on a loaded machine
    deadline = time.time() + 90.0
    while time.time() < deadline:
        if proc.poll() is not None:
            out = proc.stdout.read().decode()
            raise RuntimeError(f"daemon died on boot:\n{out}")
        try:
            if _rpc(sock_path, {"op": "ping"}).get("pong"):
                return proc
        except (OSError, ValueError):
            time.sleep(0.1)
    proc.kill()
    proc.wait(timeout=10)
    raise RuntimeError("daemon never answered ping")


DAEMON_OPS = [
    {"op": "submit", "name": "a", "app": "bert", "t": 10.0},
    {"op": "submit", "name": "b", "app": "lbm", "t": 25.0},
    {"op": "submit", "name": "c", "app": "resnet50", "t": 25.0},
    {"op": "advance", "until": 500.0},
    {"op": "submit", "name": "d", "app": "gpt2", "t": 900.0},
]


def test_sigkill_daemon_recovers_bit_identical(tmp_path):
    golden_svc = SchedulerService(PCLI.make_backend_factory("hetero", device="cpu"))
    for req in DAEMON_OPS:
        assert golden_svc.handle(req)["ok"]
    golden_svc.advance(None)
    golden = _fingerprint(golden_svc)

    sock = str(tmp_path / "d.sock")
    jnl = str(tmp_path / "d.jnl")
    proc = _boot_daemon(sock, jnl)
    try:
        for req in DAEMON_OPS:
            assert _rpc(sock, req)["ok"]
        os.kill(proc.pid, signal.SIGKILL)  # no warning, no flush window
        proc.wait(timeout=10)

        proc = _boot_daemon(sock, jnl)  # same journal -> replay
        assert _rpc(sock, {"op": "drain"})["ok"]
        res = _rpc(sock, {"op": "result"})
        assert res["ok"]
        assert (
            tuple(tuple(r) for r in sorted(res["records"])),
            res["makespan"],
            res["total_energy"],
        ) == golden
        stats = _rpc(sock, {"op": "stats"})
        assert stats["replay_divergences"] == 0
        assert _rpc(sock, {"op": "shutdown"})["ok"]
        proc.wait(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_daemon_without_a_card_exits(tmp_path):
    """Without ``--device cpu`` the daemon runs on the card; with no card
    it exits non-zero with ``resolve_device``'s message and never serves
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sock = str(tmp_path / "d.sock")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.cli", "daemon", "--socket", sock,
         "--journal", str(tmp_path / "d.jnl")],
        env=dict(os.environ, PYTHONPATH=SRC), cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not os.path.exists(sock) and not os.path.exists(tmp_path / "d.jnl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PCLI.make_backend_factory("hetero")()


# --------------------------------------------------------------------------
# the two packages against each other: the journal file is the contract
# --------------------------------------------------------------------------


# name -> (reference factory, port factory); the hetero ones are the
# daemon presets of both CLIs
SETUPS = {
    "two_node": (
        lambda: RCORE.ClusterBackend(_ref_cluster()),
        lambda: ClusterBackend(_cluster()),
    ),
    "two_node_f3": (
        lambda: RCORE.ClusterBackend(_ref_cluster(freq_levels=3, label="svc-dvfs")),
        lambda: ClusterBackend(_cluster(freq_levels=3, label="svc-dvfs")),
    ),
    "hetero": (
        RCLI.make_backend_factory("hetero"),
        PCLI.make_backend_factory("hetero", device="cpu"),
    ),
    "hetero_f3": (
        RCLI.make_backend_factory("hetero", freq_levels=3),
        PCLI.make_backend_factory("hetero", freq_levels=3, device="cpu"),
    ),
    "hetero_elastic": (
        RCLI.make_backend_factory("hetero", elastic=True),
        PCLI.make_backend_factory("hetero", elastic=True, device="cpu"),
    ),
    "hetero_elastic_f3": (
        RCLI.make_backend_factory("hetero", elastic=True, freq_levels=3),
        PCLI.make_backend_factory("hetero", elastic=True, freq_levels=3, device="cpu"),
    ),
}
PKGS = {"ref": RCORE.SchedulerService, "port": SchedulerService}


def _service(side, setup, **kw):
    ref_f, port_f = SETUPS[setup]
    return PKGS[side](ref_f if side == "ref" else port_f, **kw)


def _written(tmp_path, side, setup, ops=OPS):
    path = str(tmp_path / f"{side}-{setup}.jnl")
    svc = _service(side, setup, journal_path=path)
    _apply(svc, ops)
    fp = _fingerprint(svc)
    svc.close()
    return path, fp


def _stream_ops(n, apps, seed=5):
    """A seeded online workload: ``n`` submits over ``apps`` with
    same-instant groups, bounded advances every 8 submits, a cancel, and
    a drain."""
    rng = np.random.default_rng(seed)
    ops, t = [], 0.0
    for i in range(n):
        t += float(rng.choice([0.0, 0.0, 15.0, 60.0, 240.0]))
        ops.append(("submit", f"s{i}", str(rng.choice(apps)), t))
        if i % 8 == 7:
            ops.append(("advance", t + 30.0))
        if i == n // 2:
            ops.append(("cancel", f"s{i}"))
    ops.append(("drain",))
    return ops


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_journals_are_byte_identical(tmp_path, setup):
    """The same ops through the reference's service and the port's write
    the same bytes, header (backend identity) included, and give the
    same schedule."""
    rpath, rfp = _written(tmp_path, "ref", setup)
    ppath, pfp = _written(tmp_path, "port", setup)
    rblob, pblob = open(rpath, "rb").read(), open(ppath, "rb").read()
    assert pblob == rblob
    assert pfp == rfp
    recs = Journal.read(ppath)
    assert recs[0]["backend"] == _service("ref", setup).backend.describe()
    assert {r["k"] for r in recs} == {"hdr", "sub", "cxl", "adv", "evt"}
    if setup.endswith("f3"):
        assert "/f3" in recs[0]["backend"]
        assert any(r["f"] > 0 for r in recs if r["k"] == "evt")


@pytest.mark.parametrize("setup", ["hetero", "hetero_elastic_f3"])
def test_online_stream_journals_are_byte_identical(tmp_path, setup):
    """A longer seeded online stream (same-instant cross-node bursts,
    resizes under ``elastic``) writes the same journal in both packages,
    and the compacted journal recovers across them."""
    C_ = _service("ref", setup).backend.run.apps
    ops = _stream_ops(48, C_)
    rpath, rfp = _written(tmp_path, "ref", setup, ops)
    ppath, pfp = _written(tmp_path, "port", setup, ops)
    assert open(ppath, "rb").read() == open(rpath, "rb").read()
    assert pfp == rfp
    if setup.startswith("hetero_elastic"):
        evts = [r["e"] for r in Journal.read(ppath) if r["k"] == "evt"]
        assert "ckpt" in evts or "migrate" in evts  # elastic moves were journaled
    # fold the events in the reference, recover in the port (snap chain)
    svc = _service("ref", setup, journal_path=rpath)
    assert svc.compact()["ok"]
    svc.close()
    back = _service("port", setup, journal_path=rpath)
    assert back.replay_divergences == 0
    assert _fingerprint(back) == rfp
    back.close()


@pytest.mark.parametrize("setup", ["two_node", "hetero_f3", "hetero_elastic"])
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_journal_recovers_in_the_other_package(tmp_path, setup, writer, reader):
    """A journal written by one package, cut at seeded byte offsets (a
    SIGKILL mid-append), recovers in the other: replay agrees with every
    journaled transition, the re-driven workload ends on the writer's
    fingerprint, and the journal the reader completed recovers in the
    writer's package to that fingerprint once more."""
    golden_path, golden = _written(tmp_path, writer, setup)
    blob = open(golden_path, "rb").read()
    header_end = blob.index(b"\n") + 1
    rng = np.random.default_rng(4321)
    offsets = sorted({int(o) for o in rng.integers(header_end, len(blob), size=6)}
                     | {header_end, len(blob) - 1})
    for off in offsets:
        path = str(tmp_path / f"{writer}-{reader}-{off}.jnl")
        with open(path, "wb") as f:
            f.write(blob[:off])
        back = _service(reader, setup, journal_path=path)
        assert back.replay_divergences == 0
        _apply(back)  # the client re-drives; submits are idempotent
        assert _fingerprint(back) == golden, f"diverged at offset {off}"
        back.close()
        again = _service(writer, setup, journal_path=path)
        assert again.replay_divergences == 0
        assert _fingerprint(again) == golden, f"round trip diverged at offset {off}"
        again.close()


def test_port_refuses_a_journal_of_another_backend(tmp_path):
    """Cross-package recovery still checks the backend identity: a
    reference journal of the 2-node cluster does not replay through the
    port's hetero preset."""
    path, _ = _written(tmp_path, "ref", "two_node")
    with pytest.raises(RecoveryError, match="backend"):
        _service("port", "hetero", journal_path=path)


def test_wire_responses_match_the_reference():
    """``handle`` answers every op of the wire protocol with the
    reference's JSON, byte for byte (journal-free services)."""
    reqs = [
        {"op": "ping"},
        {"op": "submit", "name": "a", "app": "bert", "t": 10.0},
        {"op": "submit", "name": "a", "app": "bert", "t": 10.0},
        {"op": "submit", "name": "b", "app": "nope", "t": 11.0},
        {"op": "submit", "name": "", "app": "bert"},
        {"op": "submit", "name": "c", "app": "lbm", "t": 11.0},
        {"op": "cancel", "name": "c"},
        {"op": "cancel", "name": "zz"},
        {"op": "status", "name": "a"},
        {"op": "advance", "until": 400.0},
        {"op": "jobs"},
        {"op": "result"},
        {"op": "drain"},
        {"op": "result"},
        {"op": "compact"},
        {"op": "frobnicate"},
        ["not", "an", "object"],
    ]
    ref, port = _service("ref", "hetero"), _service("port", "hetero")
    for req in reqs:
        want, got = ref.handle(req), port.handle(req)
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True), req
    want, got = ref.stats(), port.stats()
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)

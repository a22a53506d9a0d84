"""The donated train step (``make_train_step(..., donate=True)``, the
reference's ``jax.jit(step, donate_argnums=(0,))``) against the pure one,
on the CPU: from one state and its deep copy, every leaf of the new states
and every metric bitwise equal, every leaf of the donated step's state in
the storage it was given.  In one process on reduced granite-8b (float32
moments; int8 moments with master weights and compression; ``grad_accum``
2; bf16 parameters with float32 masters), over gloo ranks through the
``Trainer``'s own step ((2, 1) with ZeRO, (1, 2) with int8 columns and
compression, (2, 2)), and in the dry-run's count of a reduced train cell,
whose peak falls by about one state.  Also the checkpoint's host snapshot,
which must not alias a state the next donated step overwrites."""
import copy
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_optim_ranks as OR  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, restore  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.distributed import procs  # noqa: E402
from repro_torch.distributed.meshes import AbstractMesh, units  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig, WarmupCosine  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import eval_shape, leaves_with_paths  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

SPAWN_S = 150
STEPS = 3
# one process: case -> (AdamW config, keywords of make_train_step, parameter type)
ONE = {
    "float32": (AdamWConfig(), {}, "float32"),
    "int8_master_compress": (AdamWConfig(state_dtype="int8", master_weights=True),
                             {"compress": True}, "float32"),
    "accum2": (AdamWConfig(master_weights=True), {"grad_accum": 2}, "float32"),
    "bf16_master": (AdamWConfig(master_weights=True), {}, "bfloat16"),
}
# over ranks: ranks -> {case: (harness, keywords of its make_trainer)}
RANKS = {
    2: {"zero_2x1": ("ranks", {}),
        "zero_int8_compress_2x1": ("ranks", {"opt": OR.TR.INT8, "compress": True}),
        "int8_columns_compress_1x2": ("tp_optim", {"mode": "both", "model_par": 2})},
    4: {"int8_compress_2x2": ("tp_optim", {"mode": "both", "model_par": 2}),
        "zero_accum2_4x1": ("ranks", {"grad_accum": 2})},
}
MESH = {"zero_2x1": (2, 1), "zero_int8_compress_2x1": (2, 1),
        "int8_columns_compress_1x2": (1, 2), "int8_compress_2x2": (2, 2),
        "zero_accum2_4x1": (4, 1)}


def granite(dtype="float32"):
    return reduced(get_config("granite-8b")).replace(vocab_size=512, dtype=dtype)


@pytest.mark.parametrize("case", list(ONE))
def test_donated_step_is_the_pure_step_in_place(case, one_torch_thread):
    """Three steps of each from one state: bitwise equal, the donated
    state in the given storage, and the pure step's input left as it was."""
    opt_cfg, kw, dtype = ONE[case]
    cfg = granite(dtype)
    model, opt = build_model(cfg, Runtime(remat="none")), AdamW(opt_cfg)
    sched = WarmupCosine(peak_lr=2e-3, warmup_steps=1, decay_steps=30)
    state = TS.init_state(model, opt, 0, compress=kw.get("compress", False), device="cpu")
    data = SyntheticLM(cfg, batch=8, seq_len=32)
    batches = [{k: torch.from_numpy(v) for k, v in data.global_batch(s).items()}
               for s in range(STEPS)]
    pure = TS.make_train_step(model, opt, sched, **kw)
    before = copy.deepcopy(state)
    pure(state, batches[0])
    assert not [k for k, t in leaves_with_paths(before)
                if not OR.same_bits(t, dict(leaves_with_paths(state))[k])]
    out = OR.donated_vs_pure(TS.make_train_step(model, opt, sched, donate=True, **kw), pure,
                             state, batches)
    assert all(not s["differ"] and not s["moved"] for s in out), out
    assert out[0]["leaves"] == len(list(leaves_with_paths(before)))


@pytest.fixture(scope="module")
def rank_jobs(tmp_path_factory):
    """The 2- and 4-rank jobs, side by side."""
    tmp = tmp_path_factory.mktemp("donate")
    with ThreadPoolExecutor(len(RANKS)) as pool:
        jobs = {n: pool.submit(procs.spawn, OR.donation, (cases, tmp, 2),
                               units=units("cpu", count=n), jobdir=str(tmp / f"j{n}"),
                               backend="gloo", timeout=2 * SPAWN_S)
                for n, cases in RANKS.items()}
        return {n: job.result() for n, job in jobs.items()}


@pytest.mark.parametrize("case", list(MESH))
def test_donated_trainer_step_over_ranks_is_the_pure_step(rank_jobs, case):
    """The Trainer's donated step against the same step built pure on each
    rank: bitwise equal shares, each in the storage the rank gave it."""
    n = next(n for n, cases in RANKS.items() if case in cases)
    res = rank_jobs[n]
    assert sorted(r["rank"] for r in res) == list(range(n))
    for r in res:
        got = r[case]
        assert got["mesh"] == MESH[case]
        assert all(not s["differ"] and not s["moved"] for s in got["steps"]), (r["rank"], got)


def state_bytes_by_leaf(state):
    """Each parameter leaf's bytes across the state (the parameter, its
    moments or codes, master copy and residual), by the parameter's path."""
    out = {}
    for k, t in leaves_with_paths(state):
        parts = k.split("/")
        if parts[0] == "opt" and parts[1] in ("m", "v", "master"):
            leaf = "/".join(p for p in parts[2:] if p not in ("q", "scale"))
        elif parts[0] in ("params", "residuals"):
            leaf = "/".join(parts[1:])
        else:
            continue
        out[leaf] = out.get(leaf, 0) + t.numel() * t.element_size()
    return out


@pytest.mark.parametrize("opt_dtype,compress", [("float32", False), ("int8", True)])
def test_dryrun_counts_one_state_less_when_donated(monkeypatch, opt_dtype, compress):
    """The dry-run's train cell of reduced granite-8b (8 layers, B 1 x S
    16: the update holds the peak), traced donated as the reference lowers
    it and pure: the counted peak falls by at least the state's bytes less
    twice its largest leaf's; FLOPs and alias bytes stay."""
    cfg = reduced(get_config("granite-8b")).replace(num_layers=8)
    cell = ShapeCell("t", "train", 16, 1)
    mesh = AbstractMesh((1, 1), ("data", "model"))
    kw = dict(opt_dtype=opt_dtype, compress=compress, grad_accum=1, device="cpu")
    donated = D.trace_cell(cfg, cell, mesh, Runtime(remat="full"), **kw)
    pure_step = TS.make_train_step
    monkeypatch.setattr(D, "make_train_step",
                        lambda *a, **k: pure_step(*a, **dict(k, donate=False)))
    pure = D.trace_cell(cfg, cell, mesh, Runtime(remat="full"), **kw)
    model = build_model(cfg, Runtime())
    opt = AdamW(AdamWConfig(state_dtype=opt_dtype, master_weights=True))
    by_leaf = state_bytes_by_leaf(eval_shape(
        lambda: TS.init_state(model, opt, 0, compress=compress, device="cpu")))
    state_bytes = sum(by_leaf.values())
    assert donated.memory["alias_bytes"] == pure.memory["alias_bytes"] > state_bytes
    assert donated.costs["flops"] == pure.costs["flops"]
    assert (donated.costs["peak_bytes"]
            <= pure.costs["peak_bytes"] - state_bytes + 2 * max(by_leaf.values()))


def test_checkpoint_snapshot_does_not_alias_the_state(tmp_path):
    """A save's host snapshot is a copy: a leaf updated in place after the
    save (as a donated step updates it) leaves the file with the value it
    had at the save."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    h = torch.ones(5, dtype=torch.bfloat16)
    state = {"params": {"w": w, "h": h}, "step": torch.tensor(3, dtype=torch.int32)}
    want = {k: t.clone() for k, t in leaves_with_paths(state)}
    host = mgr.save(3, state)
    w.add_(100.0)
    h.mul_(-2.0)
    state["step"].add_(1)
    mgr.wait()
    live = dict(leaves_with_paths(state))
    for k, (a, _) in host.items():
        t = live[k]
        assert not np.shares_memory(a, (t.view(torch.int16) if t.dtype == torch.bfloat16
                                        else t).numpy()), k
    got, meta = restore(str(tmp_path / "step_0000000003"), state)
    assert meta["step"] == 3
    for k, t in leaves_with_paths(got):
        assert OR.same_bits(t, want[k]), k

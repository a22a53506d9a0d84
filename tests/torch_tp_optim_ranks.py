"""What the int8-moment and gradient-compression tests over a ``model``
axis across ranks (``tests/test_torch_tp_optim.py``) run inside each rank,
and the one-process runs they are held to.  ``procs.spawn`` pickles these
by import path, so they live in a module that imports neither JAX nor the
reference package.  Not a test module."""
import copy

import torch

import torch_ranks as TR
from repro_torch.configs import get_config, reduced
from repro_torch.core.carry import state_from_numpy
from repro_torch.data import SyntheticLM
from repro_torch.distributed import procs
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.ctx import sharding_rules
from repro_torch.distributed.fault import FailureInjector
from repro_torch.distributed.meshes import gather_dim, units
from repro_torch.models import Runtime, build_model
from repro_torch.optim import AdamW, AdamWConfig, WarmupCosine
from repro_torch.optim import adamw as PADAM
from repro_torch.optim import compress as PCOMP
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.step import init_state, make_train_step
from repro_torch.tree import leaves_with_paths, tree_map
from torch_tp_ranks import whole_grads

B, S = 8, 32
WARM = 2  # one-process steps before the compared one (Adam's first step is ill-conditioned)
# reduced granite-8b (d_model 64: wq 32 columns a rank at model_par 2, the
# FFN's gate/up 64, the head's 512-entry vocabulary 256, whole blocks),
# reduced qwen2-moe-a2.7b (4 experts split over E, shared experts over
# their columns) and reduced mamba2-2.7b (SSD heads, wz/wx/wdt columns)
ARCHS = ("granite-8b", "qwen2-moe-a2.7b", "mamba2-2.7b")
# mode -> (int8 moments, compression)
MODES = {"int8": (True, False), "compress": (False, True), "both": (True, True)}


def train_cfg(arch):
    """Reduced ``arch``, vocab 512, float32."""
    return reduced(get_config(arch)).replace(vocab_size=512, dtype="float32")


def make_trainer(ckpt_dir, devices, *, arch="granite-8b", mode="both", model_par=1, steps=30,
                 ckpt_every=8, injector=None, backend=None, peak_lr=2e-3):
    """The multi-device scenario's Trainer (master weights, B 8 x S 32, a
    checkpoint every 8 steps) with ``mode``'s int8 moments and
    compression, on ``devices`` at ``model_par``, the learning rate
    warming up to ``peak_lr`` over 3 steps."""
    int8, compress = MODES[mode]
    cfg = train_cfg(arch)
    opt = AdamWConfig(state_dtype="int8" if int8 else "float32", master_weights=True)
    return Trainer(
        cfg, build_model(cfg, Runtime(remat="none")), AdamW(opt),
        WarmupCosine(peak_lr=peak_lr, warmup_steps=3, decay_steps=30),
        SyntheticLM(cfg, batch=B, seq_len=S),
        TrainerConfig(total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(ckpt_dir),
                      log_every=1000, timeout_s=120, compress=compress),
        devices=devices, model_par=model_par, failure_injector=injector, device="cpu",
        backend=backend)


def np_state(state):
    """The state's leaves as host copies (a later donated step updates
    the tensors in place)."""
    return {k: t.to("cpu", copy=True).numpy() for k, t in leaves_with_paths(state)}


class Moments:
    """Records the float moments ``adamw._q8`` quantizes while entered, in
    call order (each leaf's first and second moment in turn): the values
    before rounding, which tell a code on a rounding boundary."""

    def __enter__(self):
        self.seen, self._orig = [], PADAM._q8

        def rec(x, out=None):
            self.seen.append(x.detach().clone())
            return self._orig(x, out)

        PADAM._q8 = rec
        return self

    def __exit__(self, *exc):
        PADAM._q8 = self._orig


def warm_start(arch, tmp, device="cpu"):
    """The port's initial state of ``arch`` after WARM one-process steps
    on ``device`` with int8 moments and compression (numpy)."""
    tr = make_trainer(tmp / f"warm_{arch}", units(device, count=1), arch=arch, mode="both")
    state = init_state(tr.model, tr.optimizer, 0, compress=True, device=tr.mesh.device)
    for s in range(WARM):
        state, _ = tr._step(state, tr._place_batch(tr.dataset.global_batch(s)))
    return tree_map(lambda t: t.cpu().numpy(), state)


def mode_start(both, mode):
    """``mode``'s state carried from ``warm_start``'s: without compression
    no residuals, without int8 moments the codes decoded to float32."""
    int8, compress = MODES[mode]
    st = {k: v for k, v in both.items() if compress or k != "residuals"}
    if not int8:
        params = dict(leaves_with_paths(both["params"]))

        def decode(tree):
            flat = {}
            for k, p in params.items():
                qs = {n: torch.from_numpy(tree_at(tree, f"{k}/{n}")) for n in ("q", "scale")}
                flat[k] = PADAM._dq8(qs, p.shape).numpy()
            return unflatten(flat)

        st["opt"] = dict(both["opt"], m=decode(both["opt"]["m"]), v=decode(both["opt"]["v"]))
    return st


def in_call_order(tree, prefix=""):
    """The leaves' paths in the order ``tree_map`` visits them (the dicts'
    own order)."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from in_call_order(v, path)
        else:
            yield path


def tree_at(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def unflatten(flat):
    out = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        d = out
        for part in head:
            d = d.setdefault(part, {})
        d[last] = v
    return out


def batch_of(tr):
    return tr._place_batch(tr.dataset.global_batch(WARM))


def one_process(arch, mode, start, tmp, device="cpu"):
    """The one-process step from ``start`` on ``device``: loss, grad norm,
    lr, the new state, the mean gradient at ``start`` and, with int8
    moments, the float moments before quantization ({"m/<leaf>":,
    "v/<leaf>":})."""
    tr = make_trainer(tmp / f"one_{arch}_{mode}", units(device, count=1), arch=arch, mode=mode)
    state = state_from_numpy(start, device=tr.mesh.device)
    _, grads = whole_grads(tr, state, batch_of(tr))
    with Moments() as rec:
        new, met = tr._step(state, batch_of(tr))
    floats = {}
    if rec.seen:
        paths = list(in_call_order(state["params"]))
        assert len(rec.seen) == 2 * len(paths)
        for i, k in enumerate(paths):
            floats[f"m/{k}"] = rec.seen[2 * i].cpu().numpy()
            floats[f"v/{k}"] = rec.seen[2 * i + 1].cpu().numpy()
    return {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "lr": float(met["lr"]), "state": np_state(new), "floats": floats,
            "grads": np_state(grads)}


def ranked_step(tr, start, want):
    """One train step of ``tr`` over the ranks from the whole state
    ``start``: loss, grad norm, the new state and the mean gradient at
    ``start`` gathered whole, and per leaf of the moments' codes and
    scales and of the residuals, this rank's share and its spec's
    partition.  ``want``: the one-process new state, whose shares under
    the specs each rank also returns."""
    shard = tr.state_shardings
    state = tree_map(lambda s, t: s.place(t), shard, state_from_numpy(start, device="cpu"))
    _, grads = whole_grads(tr, state, batch_of(tr))
    new, met = tr._step(state, batch_of(tr))
    held = {}
    flat = dict(leaves_with_paths(shard))
    for k, t in leaves_with_paths(new):
        if k.startswith(("opt/m/", "opt/v/", "residuals/")):
            s = flat[k]
            held[k] = (t.cpu().numpy(), s.place(torch.from_numpy(want[k])).cpu().numpy(),
                       tuple(s.spec))
    whole = tree_map(lambda s, t: s.gather(t), shard, new)
    return {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "state": np_state(whole), "grads": np_state(grads), "held": held,
            "mesh": (tr.mesh.n_data, tr.mesh.n_model, tr.mesh.data_index, tr.mesh.model_index)}


def own_blocks_codes(x, mesh):
    """The planted fault of the moments' route: this rank quantizes its own
    columns in blocks of its own (their round trip) before the codes of
    the whole leaf are formed."""
    mine = PADAM._dq8(PADAM._q8(x), x.shape)
    return PADAM._q8(gather_dim(mine, mine.dim() - 1, mesh.model_group, mesh.n_model))


def own_blocks_round_trip(x, mesh):
    """The planted fault of the compression route: this rank quantizes its
    own columns in blocks of its own.  It still takes part in the group's
    gather where the others gather (its result dropped), so the ranks stay
    in step."""
    if x.shape[-1] % PCOMP.BLOCK:
        gather_dim(x, x.dim() - 1, mesh.model_group, mesh.n_model)
    return PCOMP._quantize(x)


def ranks(cases, tmp, fault_rank=None):
    """In each rank, a (data, model_par 2) mesh over the job's ranks: one
    step of every case ({(arch, mode): (start, want state)}); then, on a
    (1, 2) mesh, granite-8b's int8 and compression steps with rank
    ``fault_rank`` quantizing its own columns in blocks of its own."""
    world = procs.current()
    us = list(world.units)
    out = {"rank": world.rank}
    for (arch, mode), (start, want) in cases.items():
        tr = make_trainer(tmp / f"r{world.size}_{arch}_{mode}", us, arch=arch, mode=mode,
                          model_par=2)
        out[(arch, mode)] = ranked_step(tr, start, want)
    if fault_rank is not None:
        for mode, mod, name, plant in (("int8", PADAM, "_whole_codes", own_blocks_codes),
                                       ("compress", PCOMP, "_quantize_columns",
                                        own_blocks_round_trip)):
            start, want = cases[("granite-8b", mode)]
            tr = make_trainer(tmp / f"fault_{mode}", us, arch="granite-8b", mode=mode,
                              model_par=2)
            orig = getattr(mod, name)
            if world.rank == fault_rank:
                setattr(mod, name, plant)
            try:
                out[("fault", mode)] = ranked_step(tr, start, want)
            finally:
                setattr(mod, name, orig)
    return out


def elastic(ckpt_dir, peak_lr, fail_at):
    """In each rank: the multi-device scenario with int8 moments and
    compression at model_par 2 over the job's ranks, 2 units lost at step
    ``fail_at``, run by the rank's own ``Trainer`` (as
    ``Trainer._run_ranks`` runs it); beside the run's result (None on the
    ranks that do not lead or were lost) and the mesh it ended on, what
    the rank restored from a checkpoint after the recovery: (step, its
    shares as numpy, its mesh's (n_data, n_model, data index, model
    index))."""
    world = procs.current()
    tr = make_trainer(ckpt_dir, list(world.units), model_par=2,
                      injector=FailureInjector(schedule={fail_at: 2}), peak_lr=peak_lr)
    restored, restore = [], tr._init_or_restore

    def recording():
        state, step = restore()
        if step:
            m = tr.mesh
            restored.append((step, np_state(state),
                             (m.n_data, m.n_model, m.data_index, m.model_index)))
        return state, step

    tr._init_or_restore = recording
    out = tr.run()
    return out, dict(tr.mesh.shape), restored


def pure_step(tr):
    """``tr``'s train step as ``Trainer._build`` makes it, but pure: it
    leaves the state it is given as it was."""
    pspecs = tr.state_specs["params"]
    gspecs = pspecs
    if tr.tcfg.zero:
        like = tr._state_shape()["params"]
        gspecs = tree_map(lambda sp, leaf: shd.zero_extend(sp, tuple(leaf.shape), tr.mesh),
                          pspecs, like)
    return make_train_step(tr.model, tr.optimizer, tr.schedule, compress=tr.tcfg.compress,
                           grad_accum=tr.tcfg.grad_accum,
                           grad_shardings=shd.named(tr.mesh, gspecs),
                           opt_shardings=tr.state_shardings["opt"])


def same_bits(a, b):
    """Whether two tensors hold the same bytes (NaNs included)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def storages(state):
    return {k: t.untyped_storage().data_ptr() for k, t in leaves_with_paths(state)}


def donated_vs_pure(step, pure, state, batches):
    """``step`` (donated) on ``state`` and ``pure`` on its deep copy, one
    batch after another: per step, the paths of the new states' leaves
    and metrics that differ in a bit, and the paths of the donated step's
    leaves that are not in the storage ``state`` gave them."""
    twin = copy.deepcopy(state)
    given = storages(state)
    out = []
    for batch in batches:
        twin, pm = pure(twin, batch)
        state, dm = step(state, batch)
        got = dict(leaves_with_paths(state))
        differ = [k for k, t in leaves_with_paths(twin) if not same_bits(t, got[k])]
        differ += [f"metrics/{k}" for k in pm if not same_bits(pm[k], dm[k])]
        moved = [k for k, p in storages(state).items() if p != given[k]]
        out.append({"differ": differ, "moved": moved, "leaves": len(got)})
    return out


def donation(cases, tmp, steps=2):
    """In each rank: for each of ``cases`` ({name: (harness, keywords of
    its ``make_trainer``)}, harness ``"ranks"`` for ``torch_ranks``'s,
    ``"tp_optim"`` for this module's), the Trainer's train step (donated)
    against the same step built pure, ``steps`` steps from the Trainer's
    initial state (``donated_vs_pure``), with the mesh's shape."""
    world = procs.current()
    us = list(world.units)
    out = {"rank": world.rank}
    for name, (harness, kw) in cases.items():
        make = TR.make_trainer if harness == "ranks" else make_trainer
        tr = make(tmp / f"donate{world.size}_{name}", us, **kw)
        state, _ = tr._init_or_restore()
        batches = [tr._place_batch(tr.dataset.global_batch(s)) for s in range(steps)]
        with sharding_rules(tr._rules):
            steps_out = donated_vs_pure(tr._step, pure_step(tr), state, batches)
        out[name] = {"steps": steps_out, "mesh": (tr.mesh.n_data, tr.mesh.n_model)}
    return out

"""What the multi-rank tests (``tests/test_torch_multicard.py``) run inside
each rank.  ``repro_torch.distributed.procs.spawn`` pickles these by
import path, so they live in a module that imports neither JAX nor the
reference package: each rank imports only the port.  Not a test module."""
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.carry import state_from_numpy
from repro_torch.data import SyntheticLM
from repro_torch.distributed import procs
from repro_torch.distributed.meshes import NamedSharding, P, carve_submesh, units
from repro_torch.models import Runtime, build_model
from repro_torch.optim import AdamW, AdamWConfig, WarmupCosine
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.tree import leaves_with_paths, tree_map

B, S = 8, 32
INT8 = AdamWConfig(state_dtype="int8", master_weights=True)
# the cases one step is held to one process in, by their keywords of make_trainer
CASES = {"granite-8b": {}, "mamba2-2.7b": {"arch": "mamba2-2.7b"}, "accum2": {"grad_accum": 2},
         "compress": {"compress": True}, "int8": {"opt": INT8}}


def make_trainer(ckpt_dir, devices, *, steps=30, ckpt_every=8, injector=None, backend=None,
                 opt=None, arch="granite-8b", grad_accum=1, compress=False):
    """The elastic scenario's Trainer: reduced ``arch`` (vocab 512,
    float32), master weights, B 8 x S 32, a checkpoint every 8 steps; on
    ``devices``, or (None) on every unit of the card(s)."""
    cfg = reduced(get_config(arch)).replace(vocab_size=512, dtype="float32")
    return Trainer(
        cfg, build_model(cfg, Runtime(remat="none")),
        AdamW(opt or AdamWConfig(master_weights=True)),
        WarmupCosine(peak_lr=2e-3, warmup_steps=3, decay_steps=30),
        SyntheticLM(cfg, batch=B, seq_len=S),
        TrainerConfig(total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(ckpt_dir),
                      log_every=1000, timeout_s=120, grad_accum=grad_accum, compress=compress),
        devices=devices, failure_injector=injector,
        device="cpu" if devices is not None else "cuda", backend=backend)


def one_step(tr, state_np, step):
    """One train step of ``tr`` (a Trainer in this rank) from the whole
    state ``state_np``: the new parameters (whole), loss, grad norm and
    this rank's bytes of the first and second moments, with each moment
    leaf's whole bytes and whether its ZeRO spec left it whole."""
    state = tree_map(lambda s, t: s.place(t), tr.state_shardings,
                     state_from_numpy(state_np, device="cpu"))
    batch = tr._place_batch(tr.dataset.global_batch(step))
    new, met = tr._step(state, batch)
    moments = {}
    for tree in ("m", "v"):
        shard = dict(leaves_with_paths(tr.state_shardings["opt"][tree]))
        for k, t in leaves_with_paths(new["opt"][tree]):
            whole = shard[k].gather(t)
            moments[f"{tree}/{k}"] = (t.nbytes, whole.nbytes, shard[k].dim is None)
    return {"params": {k: t.numpy() for k, t in leaves_with_paths(new["params"])},
            "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "moments": moments}


def four_ranks(cases, step, cross_dir, cross_to):
    """Run in each of 4 ranks: the reference's sub-mesh check at model_par
    1 (two disjoint blocks of 2 ranks, 8 x 16 ones and twos, sum x 3
    over each block) and at model_par 2 over all 4 (a (2, 2) mesh, the
    ones split over both axes); one step of each of ``cases`` ({name: (keywords of
    ``make_trainer``, the whole state)}) on all 4 ranks, and of
    ``"granite-8b"`` on each 2-rank block too; then a Trainer over the 4
    ranks that resumes the one-process checkpoint in ``cross_dir`` and
    trains to step ``cross_to`` (its end checkpoint gathered whole)."""
    world = procs.current()
    us = units("cpu", count=4)
    out = {"rank": world.rank}
    blocks = [carve_submesh(us, 0, 2, model_axis=1), carve_submesh(us, 2, 2, model_axis=1)]
    for i, m in enumerate(blocks):
        if m.group is None:
            continue
        x = NamedSharding(m, P("data", None)).place(torch.ones((8, 16)) * (i + 1))
        out["submesh"] = (i, tuple(x.shape), float(m.sum((x * 3).sum())))
    m = carve_submesh(us, 0, 4, model_axis=2)  # the model axis across ranks
    x = NamedSharding(m, P("data", "model")).place(torch.ones((8, 16)))
    out["model_across_ranks"] = (tuple(x.shape), float(m.model_sum(m.sum((x * 3).sum()))))
    for name, (kw, state_np) in cases.items():
        out[f"{name}/4"] = one_step(make_trainer(cross_dir.parent / name, us, **kw), state_np, step)
    kw, state_np = cases["granite-8b"]
    mine = us[:2] if world.rank < 2 else us[2:]
    out["granite-8b/2"] = one_step(
        make_trainer(cross_dir.parent / f"step2_{world.rank // 2}", mine, **kw), state_np, step)
    res = make_trainer(cross_dir, us, steps=cross_to, ckpt_every=10**9).run()
    out["cross"] = None if res is None else [h["loss"] for h in res["history"]]
    return out


def skip_reduction_on(rank, state_np, step, ckpt_dir):
    """A planted fault: rank ``rank`` skips the gradient reduction (it
    keeps its own gradients' share), the others reduce as they should."""
    if procs.current().rank == rank:
        NamedSharding.reduce = lambda self, t: self.place(t)
    tr = make_trainer(ckpt_dir, units("cpu", count=procs.current().size))
    return one_step(tr, state_np, step)

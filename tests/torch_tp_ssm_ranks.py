"""What the SSM and hybrid tensor-parallel tests (``tests/test_torch_tp_ssm.py``)
run inside each rank.  ``repro_torch.distributed.procs.spawn`` pickles
these by import path, so they live in a module that imports neither JAX
nor the reference package.  Not a test module."""
import torch
import torch.nn.functional as F

import torch_tp_ranks as TP
from repro_torch.configs import get_config, reduced
from repro_torch.core.carry import params_from_numpy
from repro_torch.data import SyntheticLM
from repro_torch.distributed import procs
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.meshes import make_mesh, units
from repro_torch.models import Runtime, build_model
from repro_torch.models import ssd as SSD
from repro_torch.models.common import rms_norm, silu
from repro_torch.optim import AdamW, AdamWConfig, WarmupCosine
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.step import make_decode_step, make_prefill, placed_params
from repro_torch.tree import eval_shape, leaves_with_paths, tree_map

# case -> (arch, overrides of its reduced float32 config)
CASES = {
    # 8 SSD heads over d_inner 128, a tied head: every SSD leaf but B/C
    # split at 2 and 4, and the vocabulary
    "mamba2": ("mamba2-2.7b", {}),
    # 4 query heads over 1 KV head, 8 SSD heads, d_ff 128: attention, SSM,
    # FFN and vocabulary split at 2 (one all-reduce for the mixer)
    "hymba": ("hymba-1.5b", {}),
    # hymba-1.5b's layout at model_par 2: 5 heads and a vocabulary of 257
    # whole (as 25 and 32,001), the SSM and FFN split
    "hymba-m2": ("hymba-1.5b", {"num_heads": 5, "num_kv_heads": 1, "vocab_size": 257}),
    # its layout at 4: 6 SSD heads whole too (as 50), only the FFN split
    "hymba-m4": ("hymba-1.5b", {"num_heads": 5, "num_kv_heads": 1, "vocab_size": 257,
                                "d_model": 48}),
}
# the cases also trained at (1, 4) and served over 4 ranks
WIDE = ("mamba2", "hymba-m4")
# the cases also held against the reference on a (1, 2) mesh of host devices
REF_SERVE = ("mamba2", "hymba-m2")
# the planted faults, each on rank 1 serving mamba2
FAULTS = ("ssm_leave", "local_norm")
SERVE_P, SERVE_STEPS, SERVE_CAP = TP.SERVE_P, TP.SERVE_STEPS, TP.SERVE_CAP


def serve_cfg(case):
    """Case ``case``'s reduced config, in float32."""
    arch, kw = CASES[case]
    return reduced(get_config(arch)).replace(dtype="float32", **kw)


def train_cfg(case):
    """``serve_cfg`` at vocab 512 unless the case sets it (the multi-device
    scenario's, as ``torch_tp_ranks.train_cfg``)."""
    kw = {} if "vocab_size" in CASES[case][1] else {"vocab_size": 512}
    return serve_cfg(case).replace(**kw)


def make_trainer(case, ckpt_dir, devices, *, model_par=1, steps=30, injector=None,
                 backend=None):
    """``torch_tp_ranks.make_trainer``'s Trainer of ``case``."""
    cfg = train_cfg(case)
    return Trainer(
        cfg, build_model(cfg, Runtime(remat="none")), AdamW(AdamWConfig(master_weights=True)),
        WarmupCosine(peak_lr=2e-3, warmup_steps=3, decay_steps=30),
        SyntheticLM(cfg, batch=TP.B, seq_len=TP.S),
        TrainerConfig(total_steps=steps, ckpt_every=8, ckpt_dir=str(ckpt_dir),
                      log_every=1000, timeout_s=120),
        devices=devices, model_par=model_par, failure_injector=injector, device="cpu",
        backend=backend)


def serve(case, mesh, given=None):
    """Prefill plus SERVE_STEPS decode steps of ``case`` over ``mesh``
    (None: one process), as ``torch_tp_ranks.serve``: the logits of each,
    whole, and the shapes of the SSM state the prefill returns and
    ``init_cache`` allocates (heads of ``h``, channels of ``conv``)."""
    cfg = serve_cfg(case)
    model = build_model(cfg, Runtime(remat="none"))
    like = eval_shape(lambda: model.init(0, device="cpu"))
    specs = None if mesh is None else shd.named(mesh, shd.param_specs(cfg, mesh, like))
    if given is not None:
        params = params_from_numpy(given["params"], device="cpu")
        if specs is not None:
            params = tree_map(lambda s, t: s.place(t), specs, params)
        batch = {k: torch.from_numpy(v) for k, v in given["batch"].items()}
    else:
        params = (model.init(0, device="cpu") if specs is None
                  else placed_params(model, 0, specs, device="cpu"))
        batch = TP.serve_batch(cfg)
    prefill, step = make_prefill(model, mesh), make_decode_step(model, mesh)
    with torch.inference_mode():
        logits, cache = prefill(params, batch)
        state = {"h": tuple(cache["h"].shape), "conv": tuple(cache["conv"].shape)}
        cache = {k: (F.pad(v, (0, 0, 0, 0, 0, SERVE_CAP - v.shape[2])) if k in ("k", "v") else v)
                 for k, v in cache.items()}
        out = [logits.numpy()]
        for i in range(SERVE_STEPS):
            tok = (logits[:, -1].argmax(-1)[:, None] if given is None
                   else torch.from_numpy(given["tokens"][i]))
            logits, cache = step(params, cache, tok, SERVE_P + i)
            out.append(logits.numpy())
        state["decoded"] = {k: tuple(cache[k].shape) for k in ("h", "conv")}
        zeroed = model.init_cache(TP.SERVE_B, SERVE_CAP, device="cpu", mesh=mesh)
    state["init_cache"] = {k: tuple(zeroed[k].shape) for k in ("h", "conv")}
    return {"logits": out, "state": state}


def plant(fault, rank):
    """Planted fault ``fault`` on rank ``rank``; returns the undo.
    ``"ssm_leave"``: its SSM mixers keep their own partial sums (it takes
    part in the all-reduce, its result dropped).  ``"local_norm"``: its
    gated norms take the mean square over its own channels (the model
    group's sum still taken, and dropped).  Both keep the ranks in step."""
    name = {"ssm_leave": "leave_model", "local_norm": "_gated_norm"}[fault]
    orig = getattr(SSD, name)

    def kept(x):
        orig(x)
        return x

    def own_channels(y, z, scale, cfg, split):
        orig(y, z, scale, cfg, split)
        return rms_norm(y * silu(z), scale, cfg.norm_eps)

    if procs.current().rank == rank:
        setattr(SSD, name, kept if fault == "ssm_leave" else own_channels)
    return lambda: setattr(SSD, name, orig)


def one_step(tr, state_np, step):
    """``torch_tp_ranks.one_step``, with the mesh and the parameter leaves
    whose specs split them over ``model``."""
    split = [k for k, s in leaves_with_paths(tr.state_shardings["params"]) if s.mdim is not None]
    return dict(TP.one_step(tr, state_np, step), mesh=dict(tr.mesh.shape), model_split=split)


def two_ranks(cases, step, tmp, given):
    """In each of 2 ranks, a (1, 2) mesh: one train step of each of
    ``cases`` ({case: the whole state}); serving of every case (from the
    reference's weights and tokens where ``given`` has them); then mamba2
    again with each planted fault on rank 1."""
    world = procs.current()
    us = units("cpu", count=world.size)
    out = {"rank": world.rank}
    for case, state_np in cases.items():
        tr = make_trainer(case, tmp / f"two_{case}", us, model_par=2)
        out[f"train/{case}"] = one_step(tr, state_np, step)
    mesh = make_mesh((1, 2), ("data", "model"), devices=us)
    out["mesh"] = (mesh.n_data, mesh.n_model)
    for case in CASES:
        out[f"serve/{case}"] = serve(case, mesh, given.get(case))
    for fault in FAULTS:
        undo = plant(fault, 1)
        try:
            out[f"fault/{fault}"] = serve("mamba2", mesh)
        finally:
            undo()
    return out


def four_ranks(cases, step, tmp):
    """In each of 4 ranks: one train step of each of ``cases`` on a (2, 2)
    mesh, and of the WIDE ones on a (1, 4) mesh; serving of the WIDE cases
    on a (1, 4) mesh."""
    world = procs.current()
    us = units("cpu", count=world.size)
    out = {"rank": world.rank}
    for case, state_np in cases.items():
        for mp in (2, 4) if case in WIDE else (2,):
            tr = make_trainer(case, tmp / f"four_{case}_{mp}", us, model_par=mp)
            out[f"train/{case}/mp{mp}"] = one_step(tr, state_np, step)
    wide = make_mesh((1, 4), ("data", "model"), devices=us)
    for case in WIDE:
        out[f"serve4/{case}"] = serve(case, wide)
    return out

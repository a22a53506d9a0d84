"""What the tensor-parallel tests (``tests/test_torch_tensor_parallel.py``)
run inside each rank.  ``repro_torch.distributed.procs.spawn`` pickles
these by import path, so they live in a module that imports neither JAX
nor the reference package.  Not a test module."""
import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.core.carry import params_from_numpy, state_from_numpy
from repro_torch.data import SyntheticLM
from repro_torch.distributed import procs
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.ctx import mesh_context
from repro_torch.distributed.meshes import make_mesh, units
from repro_torch.models import Runtime, build_model
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, AdamWConfig, WarmupCosine
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.step import make_decode_step, make_prefill, placed_params, value_and_grad
from repro_torch.tree import eval_shape, leaves_with_paths, tree_map

B, S = 8, 32
TRAIN_ARCHS = ("qwen3-32b", "granite-8b")
# serving case -> (arch, overrides of its reduced float32 config)
SERVE_CASES = {
    "granite-8b": ("granite-8b", {}),
    "gemma3-4b": ("gemma3-4b", {}),
    "phi-3-vision-4.2b": ("phi-3-vision-4.2b", {}),
    "whisper-base": ("whisper-base", {}),
    # whisper's own vocabulary, which does not divide model_par 2: the
    # specs leave embed (its tied head) whole
    "whisper-base-v51865": ("whisper-base", {"vocab_size": 51865}),
}
SERVE_ARCHS = tuple(SERVE_CASES)
# the cases also held against the reference on a (1, 2) mesh of host
# devices, from its weights and decoding its greedy tokens
REF_SERVE = ("gemma3-4b", "whisper-base-v51865")
SERVE_B, SERVE_P, SERVE_STEPS, SERVE_CAP = 2, 16, 8, 32


def train_cfg(arch):
    """The multi-device scenario's config: reduced ``arch``, vocab 512, in
    float32 (bf16 rounding of partial sums would dwarf the tolerances)."""
    return reduced(get_config(arch)).replace(vocab_size=512, dtype="float32")


def make_trainer(ckpt_dir, devices, *, arch="qwen3-32b", model_par=1, steps=30, ckpt_every=8,
                 injector=None, backend=None):
    """``tests/test_multidevice.py``'s Trainer: master weights, B 8 x S 32,
    a checkpoint every 8 steps, on ``devices`` at ``model_par``."""
    cfg = train_cfg(arch)
    return Trainer(
        cfg, build_model(cfg, Runtime(remat="none")), AdamW(AdamWConfig(master_weights=True)),
        WarmupCosine(peak_lr=2e-3, warmup_steps=3, decay_steps=30),
        SyntheticLM(cfg, batch=B, seq_len=S),
        TrainerConfig(total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(ckpt_dir),
                      log_every=1000, timeout_s=120),
        devices=devices, model_par=model_par, failure_injector=injector, device="cpu",
        backend=backend)


def whole_grads(tr, state, batch):
    """The batch's mean gradient of ``tr``'s loss at ``state`` (placed),
    gathered whole: each rank's model-local gradient of its rows, reduced
    over the data group and gathered over both axes."""
    with mesh_context(tr.mesh if tr.mesh.model_group is not None else None):
        loss, _, grads = value_and_grad(tr.model, state["params"], batch)
    shard = tr.state_shardings["params"]
    return float(loss), tree_map(lambda s, g: s.gather(s.reduce(g)), shard, grads)


def one_step(tr, state_np, step):
    """One train step of ``tr`` from the whole state ``state_np``: the new
    parameters and the mean gradient (both whole), loss, grad norm, and
    per leaf this rank's bytes against the whole leaf's with the number of
    ranks its spec splits it over (parameters and moments)."""
    state = tree_map(lambda s, t: s.place(t), tr.state_shardings,
                     state_from_numpy(state_np, device="cpu"))
    batch = tr._place_batch(tr.dataset.global_batch(step))
    _, grads = whole_grads(tr, state, batch)
    new, met = tr._step(state, batch)
    held = {}
    trees = {"params": tr.state_shardings["params"], "m": tr.state_shardings["opt"]["m"],
             "v": tr.state_shardings["opt"]["v"]}
    for name, shard in trees.items():
        shard = dict(leaves_with_paths(shard))
        got = new["params"] if name == "params" else new["opt"][name]
        for k, t in leaves_with_paths(got):
            s = shard[k]
            ways = (tr.mesh.n_data if s.dim is not None else 1) * \
                (tr.mesh.n_model if s.mdim is not None else 1)
            held[f"{name}/{k}"] = (t.nbytes, s.gather(t).nbytes, ways)
    gathered = tree_map(lambda s, t: s.gather(t), tr.state_shardings["params"], new["params"])
    return {"params": {k: t.numpy() for k, t in leaves_with_paths(gathered)},
            "grads": {k: t.numpy() for k, t in leaves_with_paths(grads)},
            "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]), "held": held}


def serve_cfg(case):
    """Serving case ``case``'s reduced config, in float32."""
    arch, kw = SERVE_CASES[case]
    return reduced(get_config(arch)).replace(dtype="float32", **kw)


def serve_batch_np(cfg, seed=0):
    """A seeded serving batch of ``cfg``'s family, made with numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (SERVE_B, SERVE_P)).astype(np.int32)}
    if cfg.frontend == "patch_stub":
        batch["patch_embeds"] = 0.02 * rng.standard_normal(
            (SERVE_B, cfg.num_frontend_tokens, cfg.d_model), dtype=np.float32)
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = rng.standard_normal(
            (SERVE_B, cfg.max_source_positions, cfg.d_model), dtype=np.float32)
    return batch


def serve_batch(cfg, seed=0):
    """``serve_batch_np`` as tensors."""
    return {k: torch.from_numpy(v) for k, v in serve_batch_np(cfg, seed).items()}


def serve(case, mesh, given=None):
    """Prefill plus SERVE_STEPS decode steps of serving case ``case``
    over ``mesh`` (None: one process): the logits of each, whole, and the
    cache's KV heads.  Seeded port weights and the greedy tokens, or those
    of ``given`` (the reference's: ``params`` carried over by
    ``carry.params_from_numpy``, ``tokens`` fed in turn, ``batch``)."""
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
        batch = serve_batch(cfg)
    prefill, step = make_prefill(model, mesh), make_decode_step(model, mesh)
    with torch.inference_mode():
        logits, cache = prefill(params, batch)
        heads = cache["k"].shape[3]
        cache = {k: (F.pad(v, (0, 0, 0, 0, 0, SERVE_CAP - v.shape[2])) if k in ("k", "v") else v)
                 for k, v in cache.items()}
        out = [logits.numpy()]
        for i in range(SERVE_STEPS):
            tok = (logits[:, -1].argmax(-1)[:, None] if given is None
                   else torch.from_numpy(given["tokens"][i]))
            logits, cache = step(params, cache, tok, SERVE_P + i)
            out.append(logits.numpy())
        zeroed = model.init_cache(SERVE_B, SERVE_CAP, device="cpu", mesh=mesh)
    return {"logits": out, "kv_heads": heads, "init_cache_kv_heads": zeroed["k"].shape[3]}


def skip_attention_leave(rank):
    """A planted fault on rank ``rank``: its attention sublayers keep their
    own partial sums instead of the model group's.  It still takes part
    in each all-reduce (its result dropped), so the ranks stay in step."""
    from repro_torch.distributed.ctx import leave_model

    if procs.current().rank != rank:
        return

    def attn_proj(self, o, p):
        out = o.reshape(*o.shape[:2], -1) @ p["wo"]
        if self._attn_split(p):
            leave_model(out)
        return out

    Model._attn_proj = attn_proj


def two_ranks(cases, step, fault_rank, tmp, given):
    """In each of 2 ranks, a (1, 2) mesh: one train step of each of
    ``cases`` ({arch: the whole state}); serving of every SERVE_ARCHS
    case (from the reference's weights and tokens where ``given`` has
    them); then serving granite-8b again with the planted fault on rank
    ``fault_rank``.  ``tmp``: a directory for the Trainers' checkpoints
    (none is written)."""
    world = procs.current()
    us = units("cpu", count=world.size)
    out = {"rank": world.rank}
    for arch, state_np in cases.items():
        tr = make_trainer(tmp / f"two_{arch}", us, arch=arch, model_par=2)
        out[f"train/{arch}"] = one_step(tr, state_np, step)
    mesh = make_mesh((1, 2), ("data", "model"), devices=us)
    out["mesh"] = (mesh.n_data, mesh.n_model, mesh.data_index, mesh.model_index)
    for case in SERVE_ARCHS:
        out[f"serve/{case}"] = serve(case, mesh, given.get(case))
    skip_attention_leave(fault_rank)
    out["fault"] = serve("granite-8b", mesh)
    return out


def four_ranks(cases, step, ckpt_in, ckpt_out):
    """In each of 4 ranks, a (2, 2) mesh: one train step of each of
    ``cases``; the one-process checkpoint ``ckpt_in`` restored over the
    mesh and gathered whole; and the state of ``cases["qwen3-32b"]``
    placed over the mesh and checkpointed into ``ckpt_out``."""
    world = procs.current()
    us = units("cpu", count=world.size)
    out = {"rank": world.rank}
    for arch, state_np in cases.items():
        tr = make_trainer(ckpt_out.parent / f"four_{arch}", us, arch=arch, model_par=2)
        out[f"train/{arch}"] = one_step(tr, state_np, step)
    tr = make_trainer(ckpt_in, us, model_par=2)
    mesh = tr.mesh
    out["mesh"] = (mesh.n_data, mesh.n_model, mesh.data_index, mesh.model_index)
    restored, meta = tr.ckpt.restore_latest(tr._state_shape(), shardings=tr.state_shardings)
    whole = tree_map(lambda s, t: s.gather(t), tr.state_shardings, restored)
    out["restored"] = (int(meta["step"]), {k: t.clone() for k, t in leaves_with_paths(whole)})
    state = tree_map(lambda s, t: s.place(t), tr.state_shardings,
                     state_from_numpy(cases["qwen3-32b"], device="cpu"))
    ckpt = CheckpointManager(str(ckpt_out), async_save=False)
    ckpt.save(7, state, shardings=tr.state_shardings)
    return out


def card_prefill(arch):
    """The tensor-parallel prefill of reduced ``arch`` (float32, seeded
    weights drawn on the rank's card) over this job's ranks on the kernel
    route: the logits and this rank's ``flash_attention`` launches."""
    from repro_torch.kernels import flash_attention as FA

    world = procs.current()
    us = list(world.units)
    mesh = make_mesh((1, len(us)), ("data", "model"), devices=us)
    cfg = reduced(get_config(arch)).replace(dtype="float32")
    model = build_model(cfg, Runtime(attn_impl="pallas", remat="none"))
    like = eval_shape(lambda: model.init(0, device="cpu"))
    params = placed_params(model, torch.Generator(device=mesh.device).manual_seed(0),
                           shd.named(mesh, shd.param_specs(cfg, mesh, like)))
    FA.reset_stats()
    with torch.inference_mode():
        logits, _ = make_prefill(model, mesh)(params, {
            k: v.to(mesh.device) for k, v in serve_batch(cfg).items()})
    return logits.cpu(), FA.STATS["flash_attention"]

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
from repro_torch.distributed.ctx import data_context, gather_model, mesh_context
from repro_torch.distributed.meshes import NamedSharding, make_mesh, units
from repro_torch.models import Runtime, build_model
from repro_torch.models import moe as PM
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, AdamWConfig, WarmupCosine
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.step import make_decode_step, make_prefill, placed_params, value_and_grad
from repro_torch.tree import eval_shape, leaves_with_paths, set_by_path, tree_map

B, S = 8, 32
# the MoE family's cases, training and serving: qwen2-moe-a2.7b (4
# experts top-2 and a shared one), arctic-480b (a dense residual FFN), and
# 3 experts, which do not divide model_par 2 (the specs split every
# expert's hidden columns instead; ``shardable`` would pad them, so the
# config is taken as it is)
MOE_CASES = {
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}),
    "arctic-480b": ("arctic-480b", {}),
    "qwen2-moe-e3": ("qwen2-moe-a2.7b", {"num_experts": 3}),
}
MOE = tuple(MOE_CASES)
# training case -> (arch, overrides of its reduced float32 config)
TRAIN_CASES = {"qwen3-32b": ("qwen3-32b", {}), "granite-8b": ("granite-8b", {}), **MOE_CASES}
TRAIN_ARCHS = tuple(TRAIN_CASES)
# serving case -> (arch, overrides of its reduced float32 config)
SERVE_CASES = {
    "granite-8b": ("granite-8b", {}),
    "gemma3-4b": ("gemma3-4b", {}),
    "phi-3-vision-4.2b": ("phi-3-vision-4.2b", {}),
    "whisper-base": ("whisper-base", {}),
    # whisper's own vocabulary, which does not divide model_par 2: the
    # specs leave embed (its tied head) whole
    "whisper-base-v51865": ("whisper-base", {"vocab_size": 51865}),
    **MOE_CASES,
}
SERVE_ARCHS = tuple(SERVE_CASES)
# the cases also held against the reference on a (1, 2) mesh of host
# devices, from its weights and decoding its greedy tokens
REF_SERVE = ("gemma3-4b", "whisper-base-v51865", *MOE)
SERVE_B, SERVE_P, SERVE_STEPS, SERVE_CAP = 2, 16, 8, 32
# moe_apply_ep over ranks against the reference's on a (1, 2) mesh of
# host devices: arch -> capacity factor (8 experts, 4 a rank)
EP_CASES = {"qwen2-moe-a2.7b": 1.0, "arctic-480b": 1.25}


def train_cfg(case):
    """The multi-device scenario's config: reduced ``case``, vocab 512, in
    float32 (bf16 rounding of partial sums would dwarf the tolerances)."""
    arch, kw = TRAIN_CASES[case]
    return reduced(get_config(arch)).replace(vocab_size=512, dtype="float32", **kw)


def ep_cfg(arch):
    """``EP_CASES``' config: reduced ``arch`` with 8 experts, float32."""
    return reduced(get_config(arch)).replace(dtype="float32", num_experts=8)


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
    gathered whole: each rank's model-local gradient of its rows (MoE's
    balance loss over the whole batch, as the train step takes it),
    reduced over the data group and gathered over both axes."""
    ranked = tr.mesh.group is not None
    with mesh_context(tr.mesh if tr.mesh.model_group is not None else None), \
            data_context(tr.mesh if ranked else None):
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


class Routes:
    """Every routing's top-k experts while entered (``models/moe.py``'s
    ``top_k`` wrapped), as numpy arrays in call order: a check beside the
    main path, which does not read them."""

    def __enter__(self):
        self.calls, self._orig = [], PM.top_k

        def recorded(probs, k):
            vals, idx = self._orig(probs, k)
            self.calls.append(idx.numpy().copy())
            return vals, idx

        PM.top_k = recorded
        return self

    def __exit__(self, *exc):
        PM.top_k = self._orig


def serve(case, mesh, given=None):
    """Prefill plus SERVE_STEPS decode steps of serving case ``case``
    over ``mesh`` (None: one process): the logits of each, whole, the
    cache's KV heads and every MoE routing's top-k experts.  Seeded port
    weights and the greedy tokens, or those of ``given`` (the reference's:
    ``params`` carried over by ``carry.params_from_numpy``, ``tokens`` fed
    in turn, ``batch``)."""
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
    with torch.inference_mode(), Routes() as routes:
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
    return {"logits": out, "kv_heads": heads, "init_cache_kv_heads": zeroed["k"].shape[3],
            "routes": routes.calls}


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


def skip_moe_leave(rank):
    """A planted fault on rank ``rank``: its MoE layers keep their own
    partial sums instead of the model group's (it still takes part in the
    all-reduce, its result dropped).  Returns the undo."""
    orig = PM.leave_model

    def kept(x):
        orig(x)
        return x

    if procs.current().rank == rank:
        PM.leave_model = kept
    return lambda: setattr(PM, "leave_model", orig)


def every_expert(rank):
    """A planted fault on rank ``rank``: it computes the routed part over
    every expert rather than its own, so the sum over the model group
    counts that part again.  Every rank gathers the whole expert leaves
    (an all-gather, so the ranks stay in step).  Returns the undo."""
    orig = PM.routed_experts
    me = procs.current().rank == rank

    def routed(p, x, cfg, capacity_factor=1.25, e_base=0):
        whole = {k: gather_model(t, 0) for k, t in p["experts"].items()}
        if not me:
            return orig(p, x, cfg, capacity_factor, e_base)
        return orig({"router": p["router"], "experts": whole}, x, cfg, capacity_factor)

    PM.routed_experts = routed
    return lambda: setattr(PM, "routed_experts", orig)


def ep_over_ranks(mesh, given):
    """``moe_apply_ep`` over ``mesh``'s model group on the reference's
    ``EP_CASES`` ({arch: params, x, y, capacity factor}): each rank's share
    of the parameters placed by the specs; its output, the experts it
    holds and its routings."""
    out = {}
    for arch, case in given.items():
        cfg = ep_cfg(arch)
        p = {}
        for path, t in leaves_with_paths(params_from_numpy(case["params"], device="cpu")):
            spec = shd.param_spec_for(cfg, mesh, f"moe/{path}", tuple(t.shape))
            set_by_path(p, path, NamedSharding(mesh, spec).place(t))
        with torch.inference_mode(), mesh_context(mesh), Routes() as routes:
            y = PM.moe_apply_ep(p, torch.from_numpy(case["x"]), cfg, mesh,
                                capacity_factor=case["cf"])
        out[arch] = {"y": y.numpy(), "experts": p["experts"]["gate"].shape[0],
                     "routes": routes.calls}
    return out


def two_ranks(cases, step, fault_rank, tmp, given):
    """In each of 2 ranks, a (1, 2) mesh: one train step of each of
    ``cases`` ({arch: the whole state}); serving of every SERVE_ARCHS
    case (from the reference's weights and tokens where ``given`` has
    them) and ``moe_apply_ep`` on the reference's ``given["ep"]``; then
    serving granite-8b again with the planted fault on rank
    ``fault_rank``, and qwen2-moe-a2.7b with each MoE fault there.
    ``tmp``: a directory for the Trainers' checkpoints (none is
    written)."""
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
    out["ep"] = ep_over_ranks(mesh, given["ep"])
    for name, plant in (("moe_leave", skip_moe_leave), ("every_expert", every_expert)):
        undo = plant(fault_rank)
        try:
            out[f"fault/{name}"] = serve("qwen2-moe-a2.7b", mesh)
        finally:
            undo()
    skip_attention_leave(fault_rank)
    out["fault"] = serve("granite-8b", mesh)
    return out


def four_ranks(cases, step, ckpt_in, ckpt_out):
    """In each of 4 ranks, a (2, 2) mesh: one train step of each of
    ``cases``; serving of the MoE cases on a (1, 4) mesh; the one-process
    checkpoint ``ckpt_in`` restored over the
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
    wide = make_mesh((1, 4), ("data", "model"), devices=us)
    for case in MOE:
        out[f"serve4/{case}"] = serve(case, wide)
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

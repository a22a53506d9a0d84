"""Dry-run: plan a job before it runs (twin of
``repro.launch.dryrun``).

For every (architecture × input-shape × mesh) cell this:
  1. pads the config to TP divisibility (``sharding.shardable``),
  2. builds the real step (train / prefill / decode) through the calls the
     training and serving paths make and runs it once on fake tensors
     under ``roofline.analysis.count_costs`` -- nothing is computed and
     nothing is allocated -- counting the FLOPs, bytes, collectives and
     the peak of live bytes it dispatches,
  3. sizes every argument per device from the sharding specs
     (``param_specs`` / ``opt_state_specs`` / ``batch_specs`` /
     ``cache_specs``, shard extents ceil-divided as XLA pads): argument,
     alias (the donated state in train, the donated cache in decode) and
     output bytes,
  4. counts the 0-layer and 1-period variants as the reference compiles
     them; the layers are a Python loop, so their extrapolation gives the
     full count back,
  5. derives the three roofline terms against the H100 and writes one
     JSON per cell under ``--out`` (default ``build/dryrun``).

A step runs the global batch on one device (``distributed/meshes.py``),
so it cannot be partitioned as XLA partitions it: FLOPs, bytes and
transcendentals are the global counts split evenly over the mesh's chips
(``"split": "even"``), and temp bytes the counted peak less the
arguments, split the same way.  No collective is dispatched there, so a
record of more than one chip says ``"coll_counted": false``.

Runs on the card's program (fake ``cuda`` tensors; without a card it
exits 2) unless ``--device cpu`` is given.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs import SHAPES, cell_applicable, get_config, list_archs
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.ctx import mesh_context, sharding_rules
from repro_torch.distributed.meshes import P
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Runtime, build_model
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.optim.schedule import WarmupCosine
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.hw import H100
from repro_torch.train import init_state, make_decode_step, make_prefill, make_train_step
from repro_torch.tree import eval_shape, leaves_with_paths, tree_map

DEFAULT_OUT = os.path.join("build", "dryrun")


# ---------------------------------------------------------------------------
# Input stand-ins (meta tensors and their specs; no allocation)
# ---------------------------------------------------------------------------


def batch_shapes(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Model-input shapes for a cell: {name: (shape, dtype)}."""
    B, S = cell.global_batch, cell.seq_len
    if cell.kind in ("train", "prefill"):
        tgt = S // 8 if cfg.is_encoder_decoder else S
        out = {"tokens": ((B, tgt), torch.int32)}
        if cfg.frontend == "patch_stub":
            out["patch_embeds"] = ((B, cfg.num_frontend_tokens, cfg.d_model), torch.bfloat16)
        if cfg.is_encoder_decoder:
            out["src_embeds"] = ((B, S, cfg.d_model), torch.bfloat16)
        return out
    return {"token": ((B, 1), torch.int32)}


def input_specs(cfg: ModelConfig, cell: ShapeCell, mesh=None):
    """``(meta, specs)``: a meta tensor for every model input of this
    cell, and its spec on ``mesh`` (``specs`` is None without a mesh)."""
    shapes = batch_shapes(cfg, cell)
    meta = {k: torch.empty(s, dtype=d, device="meta") for k, (s, d) in shapes.items()}
    if mesh is None:
        return meta, None
    return meta, shd.batch_specs(cfg, mesh, {k: s for k, (s, _) in shapes.items()})


def shard_bytes(tree, specs, mesh) -> int:
    """Bytes of one device's shards of ``tree``'s leaves under ``specs``
    on ``mesh``: each sharded extent ceil-divided by its axes' sizes, as
    XLA pads."""
    spec_of = dict(leaves_with_paths(specs))
    total = 0
    for path, t in leaves_with_paths(tree):
        spec = tuple(spec_of[path])
        n = t.element_size()
        for i, dim in enumerate(t.shape):
            part = spec[i] if i < len(spec) else None
            k = 1
            for ax in ((part,) if isinstance(part, str) else (part or ())):
                k *= mesh.shape[ax]
            n *= -(-dim // k)
        total += n
    return total


# ---------------------------------------------------------------------------
# Per-cell trace
# ---------------------------------------------------------------------------


def _cache_specs(cfg: ModelConfig, mesh, cache) -> Dict[str, P]:
    return shd.cache_specs(cfg, mesh, {k: tuple(v.shape) for k, v in cache.items()})


def _variant_cfg(cfg: ModelConfig, model, n_periods: int) -> ModelConfig:
    L = n_periods * model.period
    kw = {"num_layers": L}
    if cfg.is_encoder_decoder:
        kw["num_encoder_layers"] = max(
            0, cfg.num_encoder_layers * L // max(cfg.num_layers, 1)
        ) if cfg.num_layers else 0
        if n_periods:
            kw["num_encoder_layers"] = max(1, kw["num_encoder_layers"])
    return cfg.replace(**kw)


@dataclass
class Trace:
    """One counted step: ``costs`` are ``count_costs``' global counts,
    ``memory`` the per-device argument / alias / output bytes from the
    specs, ``arg_bytes`` the global arguments' bytes (live from the start
    of the count)."""

    costs: Dict[str, Any]
    memory: Dict[str, int]
    arg_bytes: int
    seconds: float


def trace_cell(
    cfg: ModelConfig,
    cell: ShapeCell,
    mesh,
    rt: Runtime,
    *,
    opt_dtype: str = "float32",
    zero: bool = True,
    compress: bool = False,
    grad_accum: int = 1,
    lr_peak: float = 3e-4,
    device="cuda",
) -> Trace:
    """Run one (cfg × cell) step once on fake tensors of ``device`` under
    the counter; the reference's ``lower_cell``.  Parameters, state,
    batch and cache are fake: nothing is allocated on the device."""
    if rt.attn_impl == "pallas":
        raise ValueError(
            'the dry-run counts the plain routes; attn_impl="pallas" launches '
            "kernels that read data, which fake tensors do not hold "
            '(use "auto", "dense" or "blocked")')
    dev = resolve_device(device)
    model = build_model(cfg, rt)
    rules = shd.activation_rules(cfg, mesh, cell.global_batch)
    batch, batch_specs = input_specs(cfg, cell, mesh)
    donated = None  # the argument whose buffers the step's outputs reuse

    if cell.kind == "train":
        opt = AdamW(AdamWConfig(state_dtype=opt_dtype, master_weights=zero))
        step = make_train_step(model, opt, WarmupCosine(peak_lr=lr_peak), compress=compress,
                               grad_accum=grad_accum)
        state = eval_shape(lambda: init_state(model, opt, 0, compress=compress, device="cpu"))
        pspecs = shd.param_specs(cfg, mesh, state["params"])
        state_specs = {"params": pspecs, "step": P(),
                       "opt": shd.opt_state_specs(cfg, mesh, state["opt"], zero=zero)}
        if compress:
            state_specs["residuals"] = pspecs
        args = {"state": state, "batch": batch}
        specs = {"state": state_specs, "batch": batch_specs}
        donated = "state"

        def run(a):
            return step(a["state"], a["batch"])
    else:
        params = eval_shape(lambda: model.init(0, device="cpu"))
        args = {"params": params}
        specs = {"params": shd.param_specs(cfg, mesh, params)}
        if cell.kind == "prefill":
            prefill = make_prefill(model)
            args["batch"], specs["batch"] = batch, batch_specs

            def run(a):
                return prefill(a["params"], a["batch"])
        else:  # decode: one token written at the cache's last position
            decode = make_decode_step(model)
            cache = eval_shape(lambda: model.init_cache(cell.global_batch, cell.seq_len,
                                                        device="cpu"))
            args.update(cache=cache, token=batch["token"],
                        pos=torch.empty((), dtype=torch.int32, device="meta"))
            specs.update(cache=_cache_specs(cfg, mesh, cache), token=batch_specs["token"],
                         pos=P())
            donated = "cache"

            def run(a):
                return decode(a["params"], a["cache"], a["token"], cell.seq_len - 1)

    mode = RA.fake_mode()
    with mode:
        fake = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev), args)
    arg_bytes = sum(t.numel() * t.element_size() for _, t in leaves_with_paths(fake))
    t0 = time.perf_counter()
    with sharding_rules(rules), mesh_context(mesh):
        costs, out = RA.count_costs(run, fake, mode=mode)
    seconds = time.perf_counter() - t0
    if cell.kind == "train":
        new_state, metrics = out
        outs = {"state": new_state, "metrics": metrics}
        out_specs = {"state": specs["state"], "metrics": tree_map(lambda _: P(), metrics)}
    else:
        logits, cache = out
        outs = {"logits": logits, "cache": cache or {}}  # no cache without layers
        out_specs = {"logits": shd.batch_specs(cfg, mesh, {"l": tuple(logits.shape)})["l"],
                     "cache": _cache_specs(cfg, mesh, outs["cache"])}
    memory = {
        "argument_bytes": shard_bytes(args, specs, mesh),
        "output_bytes": shard_bytes(outs, out_specs, mesh),
        "alias_bytes": shard_bytes(args[donated], specs[donated], mesh) if donated else 0,
    }
    return Trace(costs=costs, memory=memory, arg_bytes=arg_bytes, seconds=seconds)


# ---------------------------------------------------------------------------
# Cost extraction (per device, split evenly)
# ---------------------------------------------------------------------------


def _costs_of(trace: Trace, chips: int) -> Dict[str, Any]:
    cs = {k: v for k, v in trace.costs.items() if k != "peak_bytes"}
    for k in ("flops", "bytes", "transcendentals"):
        cs[k] = cs[k] / chips
    return cs


def dryrun_cell(
    arch: str,
    shape: Union[str, ShapeCell],
    *,
    multi_pod: bool = False,
    rt: Optional[Runtime] = None,
    opt_dtype: Optional[str] = None,
    zero: bool = True,
    compress: bool = False,
    grad_accum: int = 0,
    skip_variants: bool = False,
    mesh=None,
    device="cuda",
) -> Dict[str, Any]:
    """One record.  ``shape`` names a cell of ``SHAPES`` or is a
    ``ShapeCell``; ``mesh`` defaults to the production mesh (an abstract
    mesh of any shape with ``data`` / ``model`` axes will do, e.g. (1, 1)
    for one card)."""
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    cfg0 = get_config(arch)
    ok, why = cell_applicable(cfg0, cell)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    model_par = mesh.shape["model"]
    chips = math.prod(mesh.shape.values())
    result: Dict[str, Any] = {
        "arch": arch,
        "shape": cell.name,
        "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        "chips": chips,
        "chip": H100.name,
        "applicable": ok,
        "skip_reason": why,
    }
    if not ok:
        return result

    cfg, changes = shd.shardable(cfg0, model_par)
    result["pad_changes"] = {k: list(v) for k, v in changes.items()}
    rt = rt or Runtime(remat="full", attn_impl="auto")
    if opt_dtype is None:
        # int8 moments for the MoE monsters, fp32 elsewhere (fits-HBM default)
        opt_dtype = "int8" if cfg.param_count() > 100e9 else "float32"
    if cell.kind == "train" and grad_accum == 0:
        # auto: keep the per-microbatch rows per chip small
        rows = cell.global_batch // shd.mesh_dp_size(mesh)
        grad_accum = max(1, min(8, rows // 2))
    elif grad_accum == 0:
        grad_accum = 1
    result["opts"] = {
        "remat": rt.remat, "attn_impl": rt.attn_impl, "opt_dtype": opt_dtype,
        "zero": zero, "compress": compress, "grad_accum": grad_accum,
        "window_slice": rt.decode_window_slice, "moe_impl": rt.moe_impl,
    }
    result["split"] = "even"
    result["coll_counted"] = chips == 1

    def trace(c):
        return trace_cell(c, cell, mesh, rt, opt_dtype=opt_dtype, zero=zero,
                          compress=compress, grad_accum=grad_accum, device=device)

    model = build_model(cfg, rt)
    full = trace(cfg)
    result["trace_s_full"] = round(full.seconds, 2)

    mem = dict(full.memory)
    mem["temp_bytes"] = int(max(full.costs["peak_bytes"] - full.arg_bytes, 0) / chips)
    result["memory"] = mem
    result["peak_bytes_counted"] = int(full.costs["peak_bytes"])
    result["hbm_per_device"] = int(
        mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"] - mem["alias_bytes"]
    )
    # The reference's first-principles HBM model (chip-independent):
    #   args (exact, from the specs -- params/opt/cache shards)
    # + remat carry stack  L x (microbatch tokens/chip) x d x 2B
    # + working activations ~6 live residual-sized tensors (fp32)
    # + logits microbatch buffer (fp32, vocab/model sharded)
    # all x1.3 headroom.
    args_b = float(mem["argument_bytes"])
    extra = 0.0
    mp = shd.mesh_model_size(mesh)
    dp = shd.mesh_dp_size(mesh)
    if cell.kind == "train":
        tokens_chip = cell.tokens_per_step / dp / max(grad_accum, 1)
        extra += cfg.num_layers * tokens_chip * cfg.d_model * 2.0  # bf16 carries
        extra += 6 * tokens_chip * cfg.d_model * 4.0
        extra += tokens_chip * (cfg.vocab_size / mp) * 4.0
    elif cell.kind == "prefill":
        tokens_chip = cell.tokens_per_step / dp
        kvh = max(cfg.num_kv_heads, 1)
        extra += (
            cfg.num_layers * tokens_chip * 2 * kvh * cfg.resolved_head_dim * 2.0 / mp
        )  # kv cache output (seq or head sharded over model)
        extra += 6 * tokens_chip * cfg.d_model * 2.0
    else:
        extra += 4 * (cell.global_batch / max(dp, 1)) * cfg.d_model * 4.0
    result["hbm_per_device_tpu_model"] = int((args_b + extra) * 1.3)
    result["fits_hbm_raw"] = bool(result["hbm_per_device"] <= H100.hbm_bytes)
    result["fits_hbm"] = bool(result["hbm_per_device_tpu_model"] <= H100.hbm_bytes)

    c_full = _costs_of(full, chips)
    result["counts_full"] = c_full.pop("_counts")

    if skip_variants:
        totals = c_full
    else:
        # reduced-layer variants, as the reference compiles them
        t0 = time.perf_counter()
        c1 = _costs_of(trace(_variant_cfg(cfg, model, 1)), chips)
        c0 = _costs_of(trace(_variant_cfg(cfg, model, 0)), chips)
        result["trace_s_variants"] = round(time.perf_counter() - t0, 2)
        c1.pop("_counts")
        c0.pop("_counts")
        totals = RA.extrapolate(c0, c1, c_full, periods_total=cfg.num_layers / model.period)
        result["cost_L0"] = c0
        result["cost_L1"] = c1
    result["cost_full_module"] = dict(c_full)
    result["cost_totals"] = totals

    mf = RA.model_flops(cfg, cell, original_cfg=cfg0)
    result["model_flops_total"] = mf
    result["model_flops_per_chip"] = mf / chips
    terms = RA.roofline_terms(
        totals["flops"], totals["bytes"], totals["coll_bytes"],
        chips=chips, chip=H100, per_device=True,
    )
    # analytic memory floor: params/opt touched once + residual stream
    min_bytes = float(mem["argument_bytes"] + mem["output_bytes"])
    if cell.kind != "decode":
        tokens_chip = cell.tokens_per_step / max(dp, 1)
        min_bytes += 2 * 2 * tokens_chip * cfg.d_model * max(cfg.num_layers, 1)
    result["t_memory_min"] = min_bytes / H100.hbm_bw
    result["bw_utilization_vs_min"] = (
        result["t_memory_min"] / terms["t_memory"] if terms["t_memory"] else 0.0
    )
    result["roofline"] = terms
    result["useful_flops_ratio"] = (
        (mf / chips) / totals["flops"] if totals["flops"] else 0.0
    )
    # fraction of the bound the useful model flops could ideally take
    ideal = (mf / chips) / H100.peak_flops_bf16
    result["roofline_fraction"] = ideal / terms["t_bound"] if terms["t_bound"] else 0.0
    return result


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="", help="suffix for result filenames (hillclimb variants)")
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    ap.add_argument("--attn-impl", default="auto")
    ap.add_argument("--window-slice", action="store_true")
    ap.add_argument("--moe-impl", default="dense", choices=["dense", "ep", "auto"])
    ap.add_argument("--opt-dtype", default=None, choices=[None, "float32", "bfloat16", "int8"])
    ap.add_argument("--no-zero", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=0, help="0 = auto")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--skip-variants", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card's program) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        print(f"repro_torch.launch.dryrun: {exc}", file=sys.stderr)
        raise SystemExit(2)
    os.makedirs(args.out, exist_ok=True)
    rt = Runtime(remat=args.remat, attn_impl=args.attn_impl,
                 decode_window_slice=args.window_slice, moe_impl=args.moe_impl)

    cells = []
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    failures = []
    for arch, shape, mp in cells:
        mesh_tag = "2x16x16" if mp else "16x16"
        name = f"{arch}__{shape}__{mesh_tag}{('__' + args.tag) if args.tag else ''}"
        path = os.path.join(args.out, name + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip] {name}")
            continue
        print(f"[dryrun] {name} ...", flush=True)
        t0 = time.perf_counter()
        try:
            res = dryrun_cell(
                arch, shape,
                multi_pod=mp, rt=rt,
                opt_dtype=args.opt_dtype,
                zero=not args.no_zero,
                compress=args.compress_grads,
                grad_accum=args.grad_accum,
                skip_variants=args.skip_variants,
                device=args.device,
            )
            res["tag"] = args.tag
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            if res.get("applicable"):
                r = res["roofline"]
                print(
                    f"  ok in {time.perf_counter()-t0:.1f}s  bound={r['t_bound']*1e3:.2f}ms "
                    f"dominant={r['dominant']} frac={res['roofline_fraction']:.2f} "
                    f"hbm_raw={res['hbm_per_device']/1e9:.2f}GB "
                    f"hbm_model={res['hbm_per_device_tpu_model']/1e9:.2f}GB fits={res['fits_hbm']}"
                )
            else:
                print(f"  skipped: {res['skip_reason']}")
        except Exception as e:
            failures.append((name, repr(e)))
            print(f"  FAIL {e!r}")
            traceback.print_exc()
    if failures:
        print(f"{len(failures)} FAILURES:")
        for n, e in failures:
            print(" ", n, e)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()

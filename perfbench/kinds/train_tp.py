"""The training loop over a job of ranks, one a chip: ``kinds/train.py``'s
loop (B x S seeded tokens, a fresh batch each step, the program's donated
step) on a mesh of ``traffic["mesh"]`` (data x model) spanning the ranks,
with the optimizer the traffic states (master weights, the moments' type,
gradient compression).

Rank 0 runs in the benchmark's own process (``harness.over_ranks``): it
times the window, and its profiler and the program's spans in it make
the trace.  The other ranks follow it step for step: before each step
every rank meets the others at a barrier of the host's processes, where
rank 0 has left word whether a step comes (no device work, no socket).
Each rank draws the whole weights from the seed on its card and keeps its
share under the program's specs (``sharding.param_specs``, the state's
shapes those of ``AdamW.init`` on the weights' shapes); the optimizer
state starts at zero, the master copies at the weights, in the layout of
the program's specs (``opt_state_specs``); the residuals at zero.

Set-up runs the compared steps (the first ``compared_steps``) through the
same step and feed the window uses.  After the first, each rank reads
from its share of the first moment (m = (1 - b1) g, as stored: int8
codes times their scales) the first gradient its optimizer took; after
the last, its share of each leaf's change.  Rank 0 sums the shares to
whole leaves: a leaf that the ranks hold split is the sum of their
squares, one that each holds whole is its own.  When the window has
closed, each rank reads its peak memory and frees its state, and the
ranks end.  The reference (``reference/train_int8.py``) then follows the
compared steps in this process from the same weights and batches, its
layers spread over the cell's cards.
"""
from __future__ import annotations

import gc
import importlib
import math
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

import devtrace as tr
import harness as H
import program as P
import tokens as T
import weights as W
from kinds import train as kt
from reference import train_int8 as ref_int8

RANK_TIMEOUT_S = 300.0  # each collective's bound, and a rank's report's
# "module:function" run at the start of every rank, returning its undo: a
# test's fault planted underneath the timed path (None in a benchmark run)
PLANT = None


def _at(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _entries(*ts):
    """The tensors ``ts`` a leading entry at a time where they are stacked
    (three or more dimensions), else whole."""
    return zip(*(t.unbind(0) for t in ts)) if ts[0].dim() >= 3 else [ts]


def _sq(t: torch.Tensor) -> float:
    """The sum of squares of ``t`` in float64, summed on its device."""
    return float(sum(x.double().square().sum() for x, in _entries(t)))


def _held(moment) -> tuple:
    """(sum of squares, size) of a moment as a rank holds it: int8 codes
    times their scales, or a tensor; its size is its codes'."""
    if isinstance(moment, dict):
        q, s = moment["q"], moment["scale"]
        return float(sum((qi.double() * si).square().sum() for qi, si in _entries(q, s))), q.numel()
    return _sq(moment), moment.numel()


def _size(meta) -> int:
    return meta["q"].numel() if isinstance(meta, dict) else meta.numel()


def whole(parts, size: int) -> float:
    """A leaf's sum of squares from the ranks' (sum, size) of their
    shares: the sum where the shares split a leaf of ``size``, the first
    where each rank holds it whole."""
    sums, sizes = zip(*parts)
    if all(k == size for k in sizes):
        return sums[0]
    if sum(sizes) == size:
        return sum(sums)
    raise ValueError(f"shares of sizes {sizes} make no leaf of {size}")


def _plant(name):
    if not name:
        return None
    mod, fn = name.split(":")
    return getattr(importlib.import_module(mod), fn)()


def rank_main(spec: dict):
    """One rank of the job (inside the program's rank worker); rank 0's
    readings are returned, the other ranks return None."""
    undo = _plant(spec["plant"])
    try:
        return _rank(spec)
    finally:
        if undo is not None:
            undo()


def _rank(spec: dict):
    world = P.procs.current()
    dev, lead = world.device, world.rank == 0
    cfg, tf, seed = spec["config"], spec["traffic"], spec["seed"]
    marks = [("ranks joined", time.perf_counter() - spec["t_start"])]
    sync = H.syncer(dev)
    H.reset_peak(dev)
    marks.append(("device", time.perf_counter() - spec["t_start"]))
    B, S, V = tf["batch"], tf["seq_len"], cfg["vocab_size"]
    shd = P.sharding
    pc = P.model_config(cfg)
    mesh = P.make_mesh((tf["mesh"]["data"], tf["mesh"]["model"]), ("data", "model"),
                       devices=list(world.units))
    marks.append(("mesh", time.perf_counter() - spec["t_start"]))
    model = P.build_model(pc, P.Runtime(attn_impl=tf["attn_impl"], remat=tf["remat"]))
    optimizer = P.AdamW(P.AdamWConfig(state_dtype=tf["moment_dtype"],
                                      master_weights=tf["master_weights"], **tf["adamw"]))
    drawn = W.draw(cfg, seed, dev)
    like = {"params": P.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                                 drawn)}
    like["opt"] = optimizer.init(like["params"])
    pspecs = shd.param_specs(pc, mesh, like["params"])
    put = shd.named(mesh, {"params": pspecs, "opt": shd.opt_state_specs(pc, mesh, like["opt"])})
    gspecs = P.tree_map(lambda sp, leaf: shd.zero_extend(sp, tuple(leaf.shape), mesh),
                        pspecs, like["params"])
    step = P.make_train_step(model, optimizer, P.Constant(tf["lr"]), compress=tf["compress"],
                             grad_shardings=shd.named(mesh, gspecs),
                             opt_shardings=put["opt"], donate=True)
    rows = P.NamedSharding(mesh, shd.batch_specs(pc, mesh, {"tokens": (B, S)})["tokens"])
    marks.append(("specs and step", time.perf_counter() - spec["t_start"]))

    def batch(i):
        return rows.place(torch.from_numpy(T.batch(seed, i, B, S, V, **tf["tokens"])).to(dev))

    def zeros(sh, meta):
        return sh.place(torch.zeros((), dtype=meta.dtype, device=dev).expand(meta.shape)
                        ).contiguous()

    params = P.tree_map(lambda sh, t: sh.place(t), put["params"], drawn)
    del drawn
    opt = {"m": P.tree_map(zeros, put["opt"]["m"], like["opt"]["m"]),
           "v": P.tree_map(zeros, put["opt"]["v"], like["opt"]["v"]),
           "count": torch.zeros((), dtype=torch.int32, device=dev)}
    if tf["master_weights"]:
        opt["master"] = P.tree_map(lambda sh, p: sh.data_part.place(p.float()),
                                   put["opt"]["master"], params)
    state = {"params": params, "opt": opt, "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if tf["compress"]:
        state["residuals"] = P.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev), params)
    del params, opt
    sync()
    marks.append(("weights and state", time.perf_counter() - spec["t_start"]))
    paths = [k for k, _ in W.leaves(state["params"])]
    n_cmp = tf["compared_steps"]
    losses = []
    changes = []

    def change_sq():
        out = {}
        for k, t in W.leaves(W.draw(cfg, seed, dev)):
            share = _at(put["params"], k).place(t)
            p = _at(state["params"], k)
            out[k] = (_sq(p.float() - share.float()), p.numel())
            del share, t
        return out

    for i in range(n_cmp):
        state, met = step(state, {"tokens": batch(i)})
        losses.append(float(met["loss"]))
        marks.append((f"compared step {i + 1}", time.perf_counter() - spec["t_start"]))
        if i == 0:
            grad_sq = {k: _held(_at(state["opt"]["m"], k)) for k in paths}
        if i in (0, n_cmp - 1):
            changes.append(change_sq())
    readings = [None] * world.size
    dist.all_gather_object(readings, (grad_sq, changes))
    marks.append(("readings", time.perf_counter() - spec["t_start"]))
    box = {"state": state, "next": batch(n_cmp)}
    del state
    gate, go = spec["gate"]

    def told(value=None) -> bool:
        if value is not None:
            go.value = value
        gate.wait(RANK_TIMEOUT_S)
        return bool(go.value)

    done, ends, out = [], [], None
    # the full collection that set-up's objects would set off inside the
    # window (0.16-0.20 s on every rank at once, ten steps in) is set-up's
    gc.collect()

    if lead:
        def one_step(i):
            told(1)
            with tr.span("bench.train_step"):
                box["state"], met = step(box["state"], {"tokens": box["next"]})
            with tr.span("bench.inputs"):
                box["next"] = batch(n_cmp + i + 1)
            with tr.span("bench.synchronise"):
                done.append(float(met["loss"]))
            ends.append(time.perf_counter())

        sync()
        setup_s = time.perf_counter() - spec["t_start"]
        marks.append(("compared steps", setup_s))
        steps, window_s, stretch = H.window(one_step, spec["seconds"],
                                            tf["trace_steps"] if spec["trace"] else 0, sync,
                                            P.flash_launches)
        told(0)
        b1 = tf["adamw"]["b1"]
        out = dict(setup_s=setup_s, steps=steps, window_s=window_s, stretch=stretch, done=done,
                   losses=losses, marks=marks,
                   step_s=[b - a for a, b in zip([spec["t_start"] + setup_s] + ends, ends)],
                   grad_norms={k: math.sqrt(whole([r[0][k] for r in readings],
                                                  _size(_at(like["opt"]["m"], k)))) / (1 - b1)
                               for k in paths},
                   changes=[{k: math.sqrt(whole([r[1][j][k] for r in readings],
                                                _at(like["params"], k).numel()))
                             for k in paths} for j in range(len(changes))])
    else:
        i = 0
        while told():
            box["state"], met = step(box["state"], {"tokens": box["next"]})
            box["next"] = batch(n_cmp + i + 1)
            done.append(float(met["loss"]))
            i += 1
    peaks = [None] * world.size
    dist.all_gather_object(peaks, H.peak_bytes(dev))
    del box, step, model, optimizer
    H.free(dev)
    if out is not None:
        out["peak"] = max(peaks)
    return out


def compare(losses, grad_norms, changes, ref) -> dict:
    """``kinds/train.py``'s gaps, the change's after the last compared
    step, and ``change_first_gap``: the same gap of the change after the
    first step (``changes``: the changes after the first and the last)."""
    out = kt.compare(losses, grad_norms, changes[-1], ref)
    first = kt.compare(losses, grad_norms, changes[0], dict(ref, change_norms=ref["change_first"]))
    out["change_first_gap"] = first["change_gap"]
    return out


def reference(cell, seed: int, devices, **kw) -> dict:
    """The reference's steps of the cell's compared steps from the seed's
    weights and batches; ``kw`` goes to ``reference/train_int8.py``'s
    ``train`` (``mm``, or ``rows``: the batches' rows it takes)."""
    cfg, tf = cell.config, cell.traffic
    rows = kw.pop("rows", tf["batch"])
    batches = [torch.from_numpy(T.batch(seed, i, tf["batch"], tf["seq_len"], cfg["vocab_size"],
                                        **tf["tokens"])[:rows])
               for i in range(tf["compared_steps"])]
    return ref_int8.train(cfg, W.draw(cfg, seed, devices[0]), batches,
                          dict(tf["adamw"], lr=tf["lr"]), devices=devices,
                          master=tf["master_weights"], moments=tf["moment_dtype"],
                          compress=tf["compress"], **kw)


def run(cell, *, seed, seconds, trace, device, t_start, devices=None):
    cfg, tf = cell.config, cell.traffic
    devices = list(devices or [device])
    if len(devices) != tf["mesh"]["data"] * tf["mesh"]["model"]:
        raise ValueError(f"mesh {tf['mesh']} over {len(devices)} devices")
    ctx = torch.multiprocessing.get_context("spawn")  # over_ranks's, whose ranks share these
    spec = dict(config=cfg, traffic=tf, seed=seed, seconds=seconds, trace=trace,
                t_start=t_start, plant=PLANT, gate=(ctx.Barrier(len(devices)), ctx.Value("b", 0)))
    got = H.over_ranks(rank_main, (spec,), devices, timeout=RANK_TIMEOUT_S)
    B, S = tf["batch"], tf["seq_len"]
    run = H.Run(kind="train_tp", config=cfg, traffic=tf, setup_s=got["setup_s"],
                steps=got["steps"], window_s=got["window_s"], stretch=got["stretch"],
                memory_peak_bytes=got["peak"])
    run.tokens = run.steps * B * S
    run.attempted = run.steps
    run.failed = sum(not np.isfinite(x) for x in got["done"])
    for d in dict.fromkeys(devices):
        H.free(d)

    t0 = time.perf_counter()
    H.reference_precision()
    ref = reference(cell, seed, devices)
    for d in dict.fromkeys(devices):
        H.free(d)
    run.reference_s = time.perf_counter() - t0
    run.numbers = compare(got["losses"], got["grad_norms"], got["changes"], ref)
    print(f"train_tp: program losses {got['losses']}, reference {ref['losses']}; numbers "
          f"{run.numbers}", file=sys.stderr)
    print(f"setup: seconds from the start at the end of each part {got['marks']}; the "
          f"window's steps' seconds {got['step_s']} and losses {got['done']}", file=sys.stderr)
    return run

"""The training loop: B x S seeded tokens, a fresh batch each step,
through the program's donated training step.

Set-up draws the weights, builds the state and runs the compared steps
(the first ``compared_steps``) through the same step and feed the window
uses; they warm up every shape.  The window then runs whole steps, each
ending in a read of its loss.  After the window the program's state is
freed and the reference follows the compared steps from the same weights
and batches: each step's loss, each leaf's first gradient as the
optimizer takes it (from the program's first moment after one step:
m = (1 - b1) g), and each leaf's change over the compared steps.
"""
from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

import devtrace as tr
import harness as H
import program as P
import tokens as T
import weights as W
from reference import train as ref_train


def run(cell, *, seed, seconds, trace, device, t_start, devices=None):
    cfg, tf = cell.config, cell.traffic
    marks = [("imports", time.perf_counter() - t_start)]
    sync = H.syncer(device)
    H.reset_peak(device)
    B, S, V = tf["batch"], tf["seq_len"], cfg["vocab_size"]
    opt = dict(tf["adamw"], lr=tf["lr"])
    pc = P.model_config(cfg)
    model = P.build_model(pc, P.Runtime(attn_impl=tf["attn_impl"], remat=tf["remat"]))
    optimizer = P.AdamW(P.AdamWConfig(state_dtype=tf["moment_dtype"], **tf["adamw"]))
    step = P.make_train_step(model, optimizer, P.Constant(tf["lr"]), donate=True)

    def batch(i):
        return torch.from_numpy(T.batch(seed, i, B, S, V, **tf["tokens"])).to(device)

    params = W.draw(cfg, seed, device)
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    del params
    sync()
    marks.append(("weights", time.perf_counter() - t_start))
    n_cmp = tf["compared_steps"]
    losses = []
    for i in range(n_cmp):
        state, met = step(state, {"tokens": batch(i)})
        losses.append(float(met["loss"]))
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(m)) / (1 - opt["b1"])
                          for k, m in W.leaves(state["opt"]["m"])}
    p0 = W.draw(cfg, seed, device)
    change = {k: float(torch.linalg.vector_norm(state_p.float() - p0_k.float()))
              for (k, state_p), (_, p0_k) in zip(W.leaves(state["params"]), W.leaves(p0))}
    del p0
    run = H.Run(kind="train", config=cfg, traffic=tf)
    box = {"state": state, "next": batch(n_cmp)}
    del state
    done = []

    def one_step(i):
        with tr.span("bench.train_step"):
            box["state"], met = step(box["state"], {"tokens": box["next"]})
        with tr.span("bench.inputs"):
            box["next"] = batch(n_cmp + i + 1)
        with tr.span("bench.synchronise"):
            done.append(float(met["loss"]))

    sync()
    run.setup_s = time.perf_counter() - t_start
    marks.append(("compared steps", run.setup_s))
    run.steps, run.window_s, run.stretch = H.window(
        one_step, seconds, tf["trace_steps"] if trace else 0, sync, P.flash_launches)
    run.memory_peak_bytes = H.peak_bytes(device)
    run.tokens = run.steps * B * S
    run.attempted = run.steps
    run.failed = sum(not np.isfinite(x) for x in done)
    del box, step, met, model, optimizer
    H.free(device)

    t0 = time.perf_counter()
    H.reference_precision()
    ref = ref_train.train(cfg, W.draw(cfg, seed, device), [batch(i) for i in range(n_cmp)], opt)
    run.reference_s = time.perf_counter() - t0
    run.numbers = compare(losses, grad_norms, change, ref)
    print(f"train: program losses {losses}, reference {ref['losses']}; numbers "
          f"{run.numbers}", file=sys.stderr)
    print(f"setup: seconds from the start at the end of each part {marks}", file=sys.stderr)
    return run


def compare(losses, grad_norms, change, ref) -> dict:
    """The gaps, each by its worst: a step's loss against the reference's;
    a leaf's first gradient norm, and its norm of change, against the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf.  Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the change: Adam
    moves them by round-off alone.  ``grad_gap_median`` is the median
    leaf's gradient gap: the worst leaf's swings with the noise of one
    small leaf from seed to seed, the median's does not."""
    rg, rc = ref["grad_norms"], ref["change_norms"]
    g_med, c_med = statistics.median(rg.values()), statistics.median(rc.values())
    moved = [k for k in rc if rg[k] >= 1e-3 * g_med]
    grad = [abs(grad_norms[k] - rg[k]) / max(rg[k], g_med) for k in rg]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
        "grad_gap": max(grad),
        "grad_gap_median": statistics.median(grad),
        "change_gap": max(abs(change[k] - rc[k]) / max(rc[k], c_med) for k in moved),
    }

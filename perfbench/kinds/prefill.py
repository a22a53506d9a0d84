"""The prefill loop: a closed loop of prefills, each of B seeded prompts
of S tokens, through the program's prefill entry, each ending in a read
of the served tokens (the greedy token of each prompt).

Set-up draws the weights and runs ``warmup`` prefills.  The window keeps
every prefill's last-position logits and the cache of the last one.
After it, the reference prefills a sample of the window's requests drawn
from the seed: ``compared_rows`` prompts of the last prefill and of each
of ``compared_prefills`` others.  Each sampled prompt's logits and
served token are compared, and for the last prefill's sampled prompts
their whole cache, layer by layer: K, V and the conv buffer
(``cache_err``) and, for the hybrid, each layer's SSM state
(``state_err``).  The prompts of a prefill are independent rows, so a
sample of them is judged as they were served in the full batch.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

import devtrace as tr
import harness as H
import program as P
import tokens as T
import weights as W
from reference.prefill import prefill as ref_prefill

CACHE_KEYS = {"k": "cache_err", "v": "cache_err", "conv": "cache_err", "h": "state_err"}


def rel_max(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max |a - ref| / max |ref|."""
    ref = ref.float()
    return float((a.float() - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def token_gap(logits: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap by which a served (greedy) token's reference logit
    lies below the reference's best, over the rows."""
    served = logits.float().argmax(-1, keepdim=True)
    return float((ref.max(-1).values - ref.gather(-1, served)[..., 0]).max())


def draw_sample(seed: int, steps: int, B: int, prefills: int, rows: int) -> list:
    """(prefill, rows) pairs drawn from the seed: the last prefill and
    ``prefills`` others of the window's ``steps``, each with ``rows`` of
    its B prompts."""
    rng = np.random.default_rng([int(seed), 1])
    last = steps - 1
    chosen = sorted(rng.choice(last, size=min(prefills, last), replace=False).tolist())
    return [(j, sorted(rng.choice(B, size=min(rows, B), replace=False).tolist()))
            for j in chosen + [last]]


def run(cell, *, seed, seconds, trace, device, t_start):
    cfg, tf = cell.config, cell.traffic
    marks = [("imports", time.perf_counter() - t_start)]
    sync = H.syncer(device)
    H.reset_peak(device)
    B, S, V = tf["batch"], tf["seq_len"], cfg["vocab_size"]
    pc = P.model_config(cfg)
    model = P.build_model(pc, P.Runtime(attn_impl=tf["attn_impl"], remat="none"))
    prefill = P.make_prefill(model)
    warm = tf["warmup"]

    def batch(i):
        return torch.from_numpy(T.batch(seed, i, B, S, V, **tf["tokens"])).to(device)

    params = W.draw(cfg, seed, device)
    sync()
    marks.append(("weights", time.perf_counter() - t_start))
    run = H.Run(kind="prefill", config=cfg, traffic=tf)
    kept, box = [], {"next": batch(0)}
    with torch.inference_mode():
        for i in range(warm):
            logits, cache = prefill(params, {"tokens": box["next"]})
            box["next"] = batch(i + 1)
            logits.argmax(-1).cpu()
            del logits, cache

        def one_step(i):
            box.pop("cache", None)  # the previous prefill's cache is handed off
            with tr.span("bench.prefill"):
                logits, box["cache"] = prefill(params, {"tokens": box["next"]})
            with tr.span("bench.inputs"):
                box["next"] = batch(warm + i + 1)
            with tr.span("bench.synchronise"):
                logits[:, -1].argmax(-1).cpu()
            kept.append(logits[:, -1])

        sync()
        run.setup_s = time.perf_counter() - t_start
        marks.append(("warm-up", run.setup_s))
        run.steps, run.window_s, run.stretch = H.window(
            one_step, seconds, tf["trace_steps"] if trace else 0, sync, P.flash_launches)
    run.memory_peak_bytes = H.peak_bytes(device)
    run.tokens = run.steps * B * S
    run.attempted = run.steps
    run.failed = sum(not bool(torch.isfinite(x).all()) for x in kept)
    last = run.steps - 1
    cache = box.pop("cache")
    del box, prefill, model
    H.free(device)

    t0 = time.perf_counter()
    H.reference_precision()
    numbers, worst = {"logits_err": 0.0, "token_gap": 0.0}, {}
    sample = draw_sample(seed, run.steps, B, tf["compared_prefills"], tf["compared_rows"])
    for j, rows in sample:
        idx = torch.tensor(rows, device=device)

        def judge(li, rc):
            for key, name in CACHE_KEYS.items():
                if key in rc:
                    err = rel_max(cache[key][li][idx], rc[key])
                    numbers[name] = max(numbers.get(name, 0.0), err)
                    worst[key] = max(worst.get(key, (0.0, li)), (err, li))

        ref = ref_prefill(cfg, params, batch(warm + j)[idx],
                          on_layer=judge if j == last else None)
        numbers["logits_err"] = max(numbers["logits_err"], rel_max(kept[j][idx], ref))
        numbers["token_gap"] = max(numbers["token_gap"], token_gap(kept[j][idx], ref))
    run.reference_s = time.perf_counter() - t0
    run.numbers = numbers
    print(f"prefill: compared (prefill, rows) {sample} of {run.steps}; worst cache error "
          f"(error, layer) by entry {worst}; numbers {numbers}", file=sys.stderr)
    print(f"setup: seconds from the start at the end of each part {marks}", file=sys.stderr)
    return run

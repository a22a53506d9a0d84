#!/usr/bin/env python3
"""How the model takes its stacked layer parameters apart under autograd,
measured on one card: unbound once a pass against indexed once a layer.

    python3 tools/train_traverse_ablation.py          # from the root of a checkout

``Model._traverse`` unbinds each stacked ``(L, ...)`` leaf once a pass
(``torch.unbind``), so the backward pass stacks each leaf's gradient once.
Indexing ``x[li]`` in the layer loop instead gives each layer's backward
a zero tensor the size of the whole stacked leaf to add its slice into.
The script flips ``repro_torch.models.model._UNBIND`` between the two, so
nothing else of the traversal differs.
This script times one train step of hymba-1.5b at full width (bf16
parameters, float32 AdamW moments, remat full, B 4 x S 2,048, as
``chip_smoke.py``'s ``train_hymba_1_5b_b4s2048``) both ways, in turns
(unbind, index, index, unbind), from one state, and prints s per step,
the peak ``max_memory_allocated`` of each and the loss (which must agree).
The card's name and power limit are printed first.  Needs one CUDA device.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH, B, S, REPS = "hymba-1.5b", 4, 2048, 2


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_traverse_ablation: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Runtime, build_model
    from repro_torch.models import model as model_mod
    from repro_torch.optim import AdamW, WarmupCosine
    from repro_torch.train.step import init_state, make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = get_config(ARCH)
    model = build_model(cfg, Runtime(remat="full"))
    opt = AdamW()
    step = make_train_step(model, opt, WarmupCosine(peak_lr=1e-3, warmup_steps=1,
                                                    decay_steps=100))
    state = init_state(model, opt, 0, device=dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in SyntheticLM(cfg, B, S).global_batch(0).items()}
    ways = {"unbind": True, "index": False}
    res = {k: {"s": [], "peak_gib": [], "loss": []} for k in ways}
    for name in ("unbind", "index", "index", "unbind"):
        model_mod._UNBIND = ways[name]
        for _ in range(REPS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            new, met = step(state, batch)
            loss = float(met["loss"])
            dt = time.perf_counter() - t0
            del new
            res[name]["s"].append(dt)
            res[name]["peak_gib"].append(torch.cuda.max_memory_allocated() / 2 ** 30)
            res[name]["loss"].append(loss)
    model_mod._UNBIND = True
    for name, r in res.items():
        print(f"{name}: s_per_step={r['s']} median={statistics.median(r['s'][1:])!r} "
              f"peak_gib={r['peak_gib']} loss={r['loss']}")
    losses = {r["loss"][0] for r in res.values()}
    print(f"losses agree: {len(losses) == 1} {sorted(losses)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

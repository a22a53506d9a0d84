"""Training launcher (twin of ``repro.launch.train``).

    REPRO_HOST_DEVICES=8 PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-8b --smoke --steps 50 --batch 8 --seq 128 \\
        --model-par 2 --fail-at 25

Runs on the card unless ``--device cpu`` is given (the kernels' plain
versions on the CPU); without a card and without ``--device cpu`` it
exits 2.  ``REPRO_HOST_DEVICES=N`` presents N logical units
(``distributed/meshes.py``).  ``--smoke`` swaps in the reduced config.
``--fail-at`` injects a device failure to exercise checkpoint/restart and
elastic recovery.  ZeRO specs, grad accumulation, int8 optimizer state
and gradient compression are all reachable from here.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import tempfile
from typing import List, Optional

from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import FailureInjector
from repro_torch.models import Runtime, build_model
from repro_torch.optim import AdamW, AdamWConfig, WarmupCosine
from repro_torch.train.loop import Trainer, TrainerConfig


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--opt-dtype", default="float32", choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, default=0, help="inject device failure at this step")
    ap.add_argument("--fail-devices", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Train as the flags say; print the reference's summary line and
    return ``Trainer.run``'s result."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    model = build_model(cfg, Runtime(remat=args.remat))
    opt = AdamW(AdamWConfig(state_dtype=args.opt_dtype))
    sched = WarmupCosine(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                         decay_steps=args.steps)
    data = SyntheticLM(cfg, args.batch, args.seq, DataConfig(seed=0))
    injector = None
    if args.fail_at:
        injector = FailureInjector(schedule={args.fail_at: args.fail_devices})
    trainer = Trainer(
        cfg, model, opt, sched, data,
        TrainerConfig(
            total_steps=args.steps, ckpt_every=args.ckpt_every,
            ckpt_dir=args.ckpt_dir, grad_accum=args.grad_accum,
            compress=args.compress_grads,
        ),
        model_par=args.model_par,
        failure_injector=injector,
        device=args.device,
    )
    out = trainer.run()
    print(
        f"done: step={out['final_step']} loss={out['final_loss']:.4f} "
        f"recoveries={out['recoveries']} stragglers={out['straggler_events']}"
    )
    return out


if __name__ == "__main__":
    try:
        resolve_device(parse_args().device)
    except RuntimeError as exc:
        print(f"repro_torch.launch.train: {exc}", file=sys.stderr)
        sys.exit(2)
    main()

#!/usr/bin/env python3
"""Phase 16's leg ``train_tp_int8_granite_8b``, phases 17 and 19 and
phase 20 (``dryrun_ranks_h100``) of ``chip_smoke.py``, for a node of
several cards.

    python3 tools/train_tp_int8_cards.py [--cards N] [--leg]

Builds the kernels, then (``chip_smoke.train_tp_int8``) trains granite-8b
at full width with int8 AdamW moments and gradient compression, its
``model`` axis across the ranks, each step donated (the new state written
into the given one's tensors): on four cards at all 36 layers in bf16
over NCCL at (1, 4), a card a rank, 6 steps, then ``launch.train --smoke
--model-par 2 --opt-dtype int8 --compress-grads`` through a recovery; on
one card at 4 of its 36 layers in float32 over 2 gloo ranks of the card,
held to one process.  Then it runs phases 17 and 19 as ``chip_smoke.py``
does (granite-8b over 2 ranks, and on four cards qwen3-32b, mamba2-2.7b
and hymba-1.5b over 4 too, each rank's collectives tallied by
``CollectiveClock``), and phase 20 on the cases ``chip_smoke.phase20_cases``
takes from them: the dry-run's rank-0 count of each prefill, decode step
and training step held to rank 0's tally, the leg's ranks' peaks beside
the trace's ``hbm_per_device`` (``chip_smoke.phase_dryrun_ranks``), then
``EcoSched`` on the records' roofline cells.  With ``--leg`` it skips
phases 17 and 19, and phase 20 takes the leg's cases alone
(``chip_smoke.leg_cases``).  It prints each card's name and power limit,
the phases' lines and, last, a JSON summary; any failed check raises.
Without a CUDA device it exits 2.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=None)
    ap.add_argument("--leg", action="store_true",
                    help="the leg and its phase-20 cases only (no serving phases)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("train_tp_int8_cards: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    cards = args.cards or min(torch.cuda.device_count(), 4)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} count "
          f"{torch.cuda.device_count()} cards {cards}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    device = torch.device("cuda", 0)
    torch.cuda.init()  # the allocator's statistics exist from here on
    workdir = ROOT / "build" / "train_tp_int8"
    workdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    leg = CS.train_tp_int8(device, workdir, cards)
    print(f"train_tp_int8_s={time.perf_counter() - t0!r}")
    if args.leg:
        cases = CS.leg_cases(leg)
    else:
        t0 = time.perf_counter()
        tp, _, _ = CS.phase_serve_tp(device, workdir, cards)
        ssm, _, _, _ = CS.phase_serve_tp_ssm(device, workdir, cards)
        print(f"serve_tp_s={time.perf_counter() - t0!r}")
        cases = CS.phase20_cases(tp, ssm, leg)
    t0 = time.perf_counter()
    dr = CS.phase_dryrun_ranks(device, CS.MainPath(), cases)
    print(f"dryrun_ranks_s={time.perf_counter() - t0!r}")
    summary = {"train_tp_int8": {k: v for k, v in leg.items() if k != "phase20"},
               "dryrun_ranks": dr}
    print(json.dumps(summary, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` alone: data-parallel training over ranks
and the co-scheduler with a unit per card.

    python3 tools/train_dp_cards.py [--cards N]

On a node with N cards (default: every card, at most 4) it runs the
elastic scenario on N ranks over NCCL against the one-process Trainer on
card 0 (with one card, also on two ranks of that card over gloo), then
``repro_torch.launch.coschedule`` with each job on its own cards.  It
prints each card's name and power limit, the phase's lines and, last, a
JSON summary; any failed check raises.  Without a CUDA device it exits 2.
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
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("train_dp_cards: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    out = CS.phase_train_dp(torch.device("cuda", 0), ROOT / "build" / "train", cards=args.cards)
    print(f"phase_s={time.perf_counter() - t0!r}")
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())

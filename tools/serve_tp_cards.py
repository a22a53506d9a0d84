#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` alone: tensor-parallel serving over ranks
(with ``--moe``, phase 18 alone: the MoE family; with ``--ssm``, phase 19
alone: the SSM and hybrid families).

    python3 tools/serve_tp_cards.py [--moe | --ssm] [--cards N]

Builds the kernels, then serves granite-8b at full width over 2 ranks
whose ``model`` axis spans them -- 2 gloo ranks of one card, or a card
each over NCCL -- against the one-process kernel route on card 0, and on
several cards qwen3-32b over 4 (or 2) cards: at 16 of its 64 layers
against one process on card 0, and at full depth timed (prefill s, decode
ms a step, the collectives' µs, each rank's peak memory).  Then
``flash_attention`` at the per-rank shapes beside SDPA.  ``--moe``
serves qwen2-moe-a2.7b at full width and depth over 2 gloo ranks of one
card (on several cards over min(cards, 4), a card each, then arctic-480b
at full width over 4 cards), held to one process, with its planted
faults (``chip_smoke.phase_serve_tp_moe``).  ``--ssm`` serves
mamba2-2.7b and hymba-1.5b at full width and depth over 2 gloo ranks of
one card (on several cards over 2 cards, and on 4 over 4 too, with
``launch.train --smoke --model-par 2`` of each through a recovery), held
to one process, with mamba2's planted faults, and times ``ssd_scan`` at
mamba2's heads a rank (``chip_smoke.phase_serve_tp_ssm``).  It prints each
card's name and power limit, the phase's lines and, last, a JSON summary;
any failed check raises.  Without a CUDA device it exits 2.
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
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--moe", action="store_true", help="phase 18 (the MoE family) alone")
    which.add_argument("--ssm", action="store_true",
                       help="phase 19 (the SSM and hybrid families) alone")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("serve_tp_cards: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase = (CS.phase_serve_tp_ssm if args.ssm else
             CS.phase_serve_tp_moe if args.moe else CS.phase_serve_tp)
    out, launches, times, *ssd = phase(torch.device("cuda", 0), ROOT / "build" / "serve_tp",
                                       cards=args.cards)
    print(f"phase_s={time.perf_counter() - t0!r}")
    summary = {"metrics": out, "launches": launches, "flash": times}
    if ssd:
        summary["ssd_scan"] = {f"{k} {dt}": t for (k, dt), t in ssd[0].items()}
    print(json.dumps(summary, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())

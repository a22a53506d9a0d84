"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: whether
the outputs were correct, the steps attempted and failed, the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics and the
trace's breakdown (``--trace 1``), the device, and last each compared
number beside its limit (also the last lines of standard error).  Needs
as many CUDA devices as the cell asks for, and uses the first that many;
exits non-zero with no result line otherwise, or when JAX or the JAX
package has been loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import harness as H

    cell = H.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    device = devices[0]
    run = H.run_cell(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                     device=device, t_start=T_START, devices=devices)
    bad = H.forbidden_modules(sys.modules)
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    out = H.result(cell, run, bool(args.trace), dev)
    print(f"perfbench: card {card_line()}; setup_s {run.setup_s!r}; {run.steps} steps in "
          f"{run.window_s!r} s; reference {run.reference_s!r} s", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

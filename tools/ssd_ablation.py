#!/usr/bin/env python3
"""Where the time of ``ssd_scan``'s kernels goes, by ablation, on one card.

    python3 tools/ssd_ablation.py          # from the root of a checkout

Builds ``src/repro_torch/kernels/csrc/ssd_scan.cu`` as it is and in
variants that each leave one piece of work out (a copy of the source with
one statement removed, compiled by its own ``nvcc`` into
``build/ssd_ablation/``), runs each once at mamba2-2.7b's layer shape
(B 2, S 4,096, 80 heads x 64, N 128, chunk 256) in bf16, and prints each
kernel's device µs per call from ``torch.profiler`` with the call's time
by CUDA events.  A variant's results are wrong by design; what it shows is
how much time the piece it leaves out holds.  The card's name and power
limit are printed first.  Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "ssd_scan.cu"
OUT = ROOT / "build" / "ssd_ablation"

# name: [(statement as it stands in the source, what replaces it)]
VARIANTS = {
    "as_is": [],
    "out: no y stores": [("      if (r_lo < d.Q)\n        __stcs", "      if (false)\n        __stcs"),
                         ("      if (r_hi < d.Q)\n        __stcs", "      if (false)\n        __stcs")],
    "out: no score tiles": [("      for (int v = threadIdx.x; v < kT * kT / 4; v += kThreads) {\n"
                             "        const int ii = v / (kT / 4), jj = (v % (kT / 4)) * 4;\n"
                             "        const int i = i0 + ii, j = j0 + jj;\n        // rows",
                             "      for (int v = threadIdx.x; v < 0; v += kThreads) {\n"
                             "        const int ii = v / (kT / 4), jj = (v % (kT / 4)) * 4;\n"
                             "        const int i = i0 + ii, j = j0 + jj;\n        // rows")],
    "out: no carried-state product": [(
        "      mma_kk<NT, kSplit, true>(acc, sCh, sCl, ldn, m0, sHh, sHl, ldn, n0, NT, d.Np);", "")],
    "out: no intra-chunk product": [(
        "      mma_mn<NT, false, true, kSplit>(acc, sPh, sPl, kLdT, m0, sXh, sXl, ldx, n0, NT, k1);",
        "")],
    "out: no state staging": [("  if (c > 0)  // the state chunk c starts from",
                               "  if (false)  // the state chunk c starts from")],
    "state: no product": [(
        "      mma_mn<NT2, true, kSplit, true>(acc, sXh, sXl, ldx, m0, sBh, sBl, ldn, n0, nt, kT);",
        "")],
    "state: no B * w split": [(
        "      convert<true>(rawB, kT, d.Q - j0, d.Np, sW + j0, sBh, sBl, ldn);", "")],
}
CASE = (2, 4096, 80, 64, 128, 256)  # mamba2-2.7b's layer


def build(item):
    from repro_torch.kernels import _build

    k, (name, edits) = item
    src = SOURCE.read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name!r}: statement not found: {old[:60]!r}")
        src = src.replace(old, new)
    cu, so = OUT / f"v{k}.cu", OUT / f"v{k}.so"
    cu.write_text(src)
    cmd = [_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-shared", "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name!r}: nvcc failed\n{proc.stderr[-3000:]}")
    return name, so


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as CS

    if not torch.cuda.is_available():
        print("ssd_ablation: no CUDA device", file=sys.stderr)
        return 2
    print(CS.smi())
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = list(pool.map(build, enumerate(VARIANTS.items())))
    device = torch.device("cuda", 0)
    B, S, nh, hp, N, Q = CASE
    args = CS.ssd_inputs(CASE, torch.bfloat16, device, seed=99)
    y = torch.empty((B, S, nh, hp), device=device)
    h = torch.empty((B, nh, hp, N), device=device)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, so in libs:
        lib = ctypes.CDLL(str(so))
        lib.ssd_scan_launch.argtypes = [P] * 8 + [I] * 7 + [P]
        lib.ssd_scan_plan.argtypes = [I] * 7 + [ctypes.POINTER(ctypes.c_longlong),
                                                ctypes.POINTER(ctypes.c_int)]
        floats, smem = ctypes.c_longlong(0), ctypes.c_int(0)
        CS.check(lib.ssd_scan_plan(B, S, nh, hp, N, Q, 1, ctypes.byref(floats),
                                   ctypes.byref(smem)) == 0, f"{name}: shape not taken")
        scratch = torch.empty(floats.value, device=device)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def call():
            err = lib.ssd_scan_launch(*(t.data_ptr() for t in args), y.data_ptr(), h.data_ptr(),
                                      scratch.data_ptr(), B, S, nh, hp, N, Q, 1, stream)
            CS.check(err == 0, f"{name}: CUDA error {err}")

        ms = CS.cuda_ms(call, 20)
        _, avgs = CS.profiled(lambda: [call() for _ in range(10)])
        us = {re.search(r"ssd_(\w+?)_kernel", k).group(1): round(t / c, 1)
              for k, (c, t) in CS.device_kernels(avgs).items() if "ssd_" in k}
        print(f"{name}: ms={ms!r} device_us_per_kernel={us}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

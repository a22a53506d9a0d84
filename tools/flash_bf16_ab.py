#!/usr/bin/env python3
"""The bf16 flash kernel against the one it replaced, in turns, on one card.

    python3 tools/flash_bf16_ab.py                # from the root of a checkout
    python3 tools/flash_bf16_ab.py --fetch-only   # where git is, to run later without it

The kernel it replaced is the bf16 route of ``flash_attention.cu`` at
commit 503b9e7 (``PARENT``, the last with the one-warpgroup, cp.async-fed
``flash_kernel_wgmma``).  Its source comes from ``git show``
into ``build/ab/`` (``--fetch-only`` stops there, for a copy of the
checkout that has no ``.git``), and is built alone by ``nvcc`` into a
library of its own in ``build/ab/``; the source as it is builds through
``_build.build``.  Both are called through ``flash_attention.launch_with``
on the same seeded bf16 inputs, held against the plain version at 2e-2
and against each other, and timed by CUDA events in turns (parent,
change, SDPA, SDPA, change, parent; the smaller of each pair is
printed), beside
``scaled_dot_product_attention`` (``enable_gqa``; ``is_causal``, or the
window as a boolean mask) and the bound: the operations the function
needs at 989 TFLOP/s against its bytes at 3.35 TB/s, as ``chip_smoke.py``
counts them.  Rows (B, S, H, KVH, hd, window, softcap, causal):

* 4: hymba-1.5b's prefill (4, 2048, 25, 5, 64, 1024, 0, causal);
* 4q: qwen2-moe-a2.7b's (4, 2048, 16, 16, 128, 0, 0, causal);
* 4g: granite-8b's (4, 2048, 32, 8, 128, 0, 0, causal);
* and every head dim of ``HEAD_DIMS`` at (4, 2048, 16, 4, hd, causal).

Each row also prints the share of the (query, key) pairs each kernel's
tiles compute that its masks throw away (128 x 128 tiles against the
parent's 64 x 64).  The ``-Xptxas -v`` registers and spills of both builds' bf16
kernels are printed first, with ptxas's warnings about them, and the
card's name and power limit first and last.  Needs one CUDA device and
nvcc; about two minutes.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("src/repro_torch/kernels/csrc/flash_attention.cu")
OUT = ROOT / "build" / "ab"
PARENT = "503b9e7"
ROWS = {
    "4": (4, 2048, 25, 5, 64, 1024, 0.0, True),
    "4q": (4, 2048, 16, 16, 128, 0, 0.0, True),
    "4g": (4, 2048, 32, 8, 128, 0, 0.0, True),
}


def parent_source(rev: str) -> Path:
    """The parent's kernel source under build/ab/, from git unless there."""
    path = OUT / f"flash_attention_{rev}.cu"
    if not path.exists():
        text = subprocess.run(["git", "show", f"{rev}:{SOURCE}"], cwd=ROOT, check=True,
                              capture_output=True, text=True).stdout
        OUT.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return path


def masked_share(S, window, causal, bq, bk):
    """Of the (query, key) pairs that query tiles of bq rows compute over
    the key tiles of bk their should_run range takes, the share masked."""
    computed = needed = 0
    for q0 in range(0, S, bq):
        q_last = min(q0 + bq, S) - 1
        kt_end = -(-S // bk)
        if causal:
            kt_end = min(kt_end, q_last // bk + 1)
        kt_begin = (q0 - window + 1) // bk if window > 0 and q0 - window + 1 > 0 else 0
        computed += (q_last - q0 + 1) * (kt_end - kt_begin) * bk
        for r in range(q0, q_last + 1):
            lo = max(0, r - window + 1) if window > 0 else 0
            needed += (r + 1 if causal else S) - lo
    return 1.0 - needed / computed


def build_parent(src: Path):
    """nvcc the parent's source alone into build/ab/; (library, ptxas log)."""
    from repro_torch.kernels import _build

    lib = src.with_suffix(".so")
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def bf16_lines(log: str):
    """ptxas's report of the bf16 kernels: registers, spills and warnings."""
    import chip_smoke as CS

    for fn, (regs, stores, loads) in sorted(CS.ptxas_by_kernel(log).items()):
        if "flash_kernel_w" in fn:
            print(f"  ptxas: {fn} registers={regs} spill_stores={stores} spill_loads={loads}")
    for line in log.splitlines():
        if "warning" in line.lower() and ("wgmma" in line or "setmaxnreg" in line):
            print(f"  ptxas: {line.strip()[:200]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fetch-only", action="store_true")
    args = ap.parse_args()
    src = parent_source(PARENT)
    if args.fetch_only:
        print(src)
        return 0
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import torch.nn.functional as F

    import chip_smoke as CS
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA

    if not torch.cuda.is_available():
        print("flash_bf16_ab: no CUDA device", file=sys.stderr)
        return 2
    print(CS.smi())
    path = _build.build([], ["flash_attention"])
    print(f"change: {path.relative_to(ROOT)}")
    bf16_lines(path.with_suffix(".log").read_text())
    parent_lib, log = build_parent(src)
    print(f"parent ({PARENT}): {parent_lib.relative_to(ROOT)}")
    bf16_lines(log)
    libs = {"parent": _build.load(parent_lib), "change": _build.load(path)}
    device = torch.device("cuda", 0)
    rows = dict(ROWS)
    rows.update({f"hd{hd}": (4, 2048, 16, 4, hd, 0, 0.0, True) for hd in FA.HEAD_DIMS})
    for name, case in rows.items():
        B, S, H, KVH, hd, window, softcap, causal = case
        kw = dict(causal=causal, window=window, softcap=softcap)
        q, k, v = CS.flash_inputs(case, torch.bfloat16, device, seed=99)
        want = FA.flash_attention_plain(q, k, v, **kw).float()
        outs = {}
        for tag, lib in libs.items():
            outs[tag] = FA.launch_with(lib, q, k, v, scale=None, **kw)
            d = float((outs[tag].float() - want).abs().max())
            ok = torch.allclose(outs[tag].float(), want, atol=2e-2, rtol=2e-2)
            print(f"row {name} {case} {tag}: max_abs_err={d!r} within 2e-2: {ok}")
        again = FA.launch_with(libs["change"], q, k, v, scale=None, **kw)
        print(f"row {name} change: two launches bitwise equal: "
              f"{bool(torch.equal(again, outs['change']))}; vs parent max_abs="
              f"{float((outs['change'].float() - outs['parent'].float()).abs().max())!r}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            p = torch.arange(S, device=device)
            sdpa_kw = dict(attn_mask=(p[None, :] <= p[:, None]) & (p[None, :] > p[:, None] - window))
        else:
            sdpa_kw = dict(is_causal=causal)
        runs = {
            "parent": lambda: FA.launch_with(libs["parent"], q, k, v, scale=None, **kw),
            "change": lambda: FA.launch_with(libs["change"], q, k, v, scale=None, **kw),
            "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                           **sdpa_kw),
        }
        ms = {tag: [] for tag in runs}
        for tag in ["parent", "change", "sdpa", "sdpa", "change", "parent"]:
            ms[tag].append(CS.cuda_ms(runs[tag], 50))
        ops = CS.flash_ops(B, S, H, hd, window, causal)
        n_bytes = 2 * (2 * B * S * H * hd + 2 * B * S * KVH * hd)
        bound = max(ops / CS.BF16_OPS_PER_S, n_bytes / CS.HBM_BYTES_PER_S) * 1e3
        print(f"row {name}: " + " ".join(f"{tag}_ms={min(t)!r} {tag}_turns={t}"
                                          for tag, t in ms.items())
              + f" bound_ms={bound!r} ops={ops} bytes={n_bytes} "
              f"change/bound={min(ms['change']) / bound!r} masked_share change="
              f"{masked_share(S, window, causal, 128, 64 if hd == 256 else 128)!r} "
              f"parent={masked_share(S, window, causal, 64, 32 if hd == 256 else 64)!r}")
        del q, k, v, want, outs, again
    print(CS.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())

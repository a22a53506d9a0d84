#!/usr/bin/env python3
"""The bf16 flash kernel against the one it replaced, in turns, on one card.

    python3 tools/flash_bf16_ab.py                # from the root of a checkout
    python3 tools/flash_bf16_ab.py --fetch-only   # where git is, to run later without it
    python3 tools/flash_bf16_ab.py --rows 4q,4e --turns 3

The kernel it replaced is the bf16 route of ``flash_attention.cu`` at
commit 064dfa1 (``PARENT``: ``flash_kernel_ws`` with a block a tile and
O written from registers).  Its source comes from
``git show`` into ``build/ab/`` (``--fetch-only`` stops there, for a copy
of the checkout that has no ``.git``), and is built alone by ``nvcc`` into
a library of its own in ``build/ab/``; the source as it is builds through
``_build.build``.  Both are called through ``flash_attention.launch_with``
on the same seeded bf16 inputs, held against the plain version at 2e-2
and against each other, and timed by CUDA events in turns (parent,
change, SDPA, then the same reversed, ``--turns`` times over; each one's
turns and their smallest are printed), beside
``scaled_dot_product_attention``
(``enable_gqa``; ``is_causal``, or the window as a boolean mask) and the
bound: the operations the function needs at 989 TFLOP/s against its
bytes at 3.35 TB/s, as ``chip_smoke.py`` counts them.  Each row also
prints the name of the kernel SDPA ran and each one's device µs a launch
from ``torch.profiler`` (10 calls), whose gap to the event time is the
host's share.  Rows (B, S, H, KVH, hd, window, softcap, causal), as
``PERF.md`` §6 names them:

* 4: hymba-1.5b's prefill (4, 2048, 25, 5, 64, 1024, 0, causal);
* 4q: qwen2-moe-a2.7b's (4, 2048, 16, 16, 128, 0, 0, causal);
* 4g: granite-8b's (4, 2048, 32, 8, 128, 0, 0, causal);
* 4v: phi-3-vision-4.2b's (4, 2048, 32, 32, 96, 0, 0, causal);
* 4e: whisper-base's encoder (8, 1500, 8, 8, 64, 0, 0, non-causal);
* 4d: whisper-base's decoder prefill (8, 224, 8, 8, 64, 0, 0, causal);
* 4l, 4G: gemma3-4b's local (window 1024) and global layers (4, 2048,
  8, 4, 256, causal);
* and every head dim of ``HEAD_DIMS`` at (4, 2048, 16, 4, hd, causal)
  (``--rows`` picks rows by name; ``hd<n>`` names these).

Each row also prints the share of the (query, key) pairs the kernel's
tiles compute that its masks throw away.  The ``-Xptxas -v`` registers
and spills of both builds' bf16 kernels are printed first, with
ptxas's warnings about them, and the card's name and power limit first
and last.  Needs one CUDA device and nvcc; about three minutes.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("src/repro_torch/kernels/csrc/flash_attention.cu")
OUT = ROOT / "build" / "ab"
PARENT = "064dfa1"
ROWS = {
    "4": (4, 2048, 25, 5, 64, 1024, 0.0, True),
    "4q": (4, 2048, 16, 16, 128, 0, 0.0, True),
    "4g": (4, 2048, 32, 8, 128, 0, 0.0, True),
    "4v": (4, 2048, 32, 32, 96, 0, 0.0, True),
    "4e": (8, 1500, 8, 8, 64, 0, 0.0, False),
    "4d": (8, 224, 8, 8, 64, 0, 0.0, True),
    "4l": (4, 2048, 8, 4, 256, 1024, 0.0, True),
    "4G": (4, 2048, 8, 4, 256, 0, 0.0, True),
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
        if "flash_kernel_ws" in fn:
            print(f"  ptxas: {fn} registers={regs} spill_stores={stores} spill_loads={loads}")
    for line in log.splitlines():
        if "warning" in line.lower() and ("wgmma" in line or "setmaxnreg" in line):
            print(f"  ptxas: {line.strip()[:200]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fetch-only", action="store_true")
    ap.add_argument("--rows", default=None, help="row names, comma-separated (default all)")
    ap.add_argument("--turns", type=int, default=1,
                    help="times the order of turns and its reverse are run")
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
    with ThreadPoolExecutor(2) as pool:  # the two builds side by side
        parent = pool.submit(build_parent, src)
        path = _build.build([], ["flash_attention"])
        parent_lib, log = parent.result()
    print(f"parent ({PARENT}): {parent_lib.relative_to(ROOT)}")
    bf16_lines(log)
    print(f"change: {path.relative_to(ROOT)}")
    bf16_lines(path.with_suffix(".log").read_text())
    libs = {"parent": _build.load(parent_lib), "change": _build.load(path)}
    device = torch.device("cuda", 0)
    rows = dict(ROWS)
    rows.update({f"hd{hd}": (4, 2048, 16, 4, hd, 0, 0.0, True) for hd in FA.HEAD_DIMS})
    if args.rows:
        rows = {name: rows[name] for name in args.rows.split(",")}
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
        runs = {tag: (lambda lib=lib: FA.launch_with(lib, q, k, v, scale=None, **kw))
                for tag, lib in libs.items()}
        runs["sdpa"] = lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                              **sdpa_kw)
        ms = {tag: [] for tag in runs}
        order = list(libs) + ["sdpa"]
        for tag in (order + order[::-1]) * args.turns:
            ms[tag].append(CS.cuda_ms(runs[tag], 50))
        dev = {tag: CS.device_profile(fn) for tag, fn in runs.items()}
        sdpa_name, sdpa_us = CS.top_kernel(dev["sdpa"])
        print(f"row {name}: sdpa_kernel={sdpa_name} " + " ".join(
            f"{tag}_device_us={CS.top_kernel(d)[1]!r}" for tag, d in dev.items()))
        ops = CS.flash_ops(B, S, H, hd, window, causal)
        n_bytes = 2 * (2 * B * S * H * hd + 2 * B * S * KVH * hd)
        bound = max(ops / CS.BF16_OPS_PER_S, n_bytes / CS.HBM_BYTES_PER_S) * 1e3
        print(f"row {name}: " + " ".join(f"{tag}_ms={min(t)!r} {tag}_turns={t}"
                                          for tag, t in ms.items())
              + f" bound_ms={bound!r} ops={ops} bytes={n_bytes} "
              f"change/bound={min(ms['change']) / bound!r} change/sdpa="
              f"{min(ms['change']) / min(ms['sdpa'])!r} masked_share="
              f"{masked_share(S, window, causal, 128, 64 if hd == 256 else 128)!r}")
        del q, k, v, want, outs, again, runs
    print(CS.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())

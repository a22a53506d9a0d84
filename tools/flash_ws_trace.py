#!/usr/bin/env python3
"""Where a round of the bf16 flash kernel's consumers goes, on one card.

    python3 tools/flash_ws_trace.py                       # the source as it is
    python3 tools/flash_ws_trace.py --source build/ab/flash_attention_064dfa1.cu --rows 4q

Builds ``flash_attention.cu`` twice with nvcc, in parallel: as it is, and
with ``-DREPRO_FLASH_WS_TRACE``, where thread 0 of each consumer
warpgroup stores ``clock64`` at nine points of every round of
``flash_kernel_ws``, and at its start and the end of its epilogue (the
first four blocks of the grid and four from its middle).  Prints, from
the plain build:

* ptxas's registers and spills for each ``flash_kernel_ws`` instantiation,
  and its warnings about ``wgmma`` (serialisation) or ``setmaxnreg``;
* each instantiation's SASS (``cuobjdump -sass``) as a stream of
  landmarks -- G HGMMA, A WARPGROUP.ARRIVE, D<n> WARPGROUP.DEPBAR.LE n,
  E MUFU.EX2, T MUFU.TANH, B/b BAR.SYNC/ARV, M SYNCS (mbarrier), J BRA,
  S SHFL, P F2FP (the bf16 pack), f FFMA, x<k> k other instructions --
  and, for each wait for all products (D0) after a wait for S (D1), the
  MUFU.EX2 between the two and after the second up to the next issue:
  the softmax's exps run under P.V only in the first count;

and, from the trace build, at each row (the rows of
``tools/flash_bf16_ab.py``): per consumer, the clocks of a round (rounds
1 .. n-1) and their shares -- waiting for K_j / V_{j-1}, packing P_{j-1}
and waiting for the issue turn, issuing S_j, rescaling O and issuing
P_{j-1}.V_{j-1}, waiting for S_j, the softmax, waiting for
P_{j-1}.V_{j-1}, releasing V, the loop -- beside the clocks the two
products of one consumer's round need at 4,096 bf16 flop a clock an SM;
the share of one consumer's softmax time during which the other's
softmax ran too; and, for a block's first tile, its clocks before its
first full round, in its rounds and after them (the last P.V and the
epilogue), beside the block's clocks from start to end (all its tiles).  ``--dump
DIR`` writes each row's stamps there (``trace_<row>.npy``: blocks x
consumers x rounds x stamps, uint64).  The card's name and power limit
come first and last.  Needs one CUDA device and nvcc; about a minute.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ab"
TRACE = "-DREPRO_FLASH_WS_TRACE"
BLOCKS, ROUNDS, EVENTS = 8, 40, 10  # the kernel's kTrBlocks, kTrRounds, kTrEvents
PHASES = ("wait_kv", "pack_turn", "issue_qk", "rescale_issue_pv", "wait_s", "softmax",
          "wait_pv", "release_v", "loop")
FLOP_PER_CLK = 4096  # dense bf16 on one SM of an H100 SXM (989 TFLOP/s / 132 SMs / 1.83 GHz)
LANDMARKS = (("HGMMA", "G"), ("WARPGROUP.ARRIVE", "A"), ("MUFU.EX2", "E"),
             ("MUFU.TANH", "T"), ("BAR.SYNC", "B"), ("BAR.ARV", "b"), ("SYNCS", "M"),
             ("BRA", "J"), ("SHFL", "S"), ("F2FP", "P"), ("FFMA", "f"))


def build(source, defines):
    """(library, nvcc log) of flash_attention.cu (the package's, through
    _build, unless ``source`` names another file, built alone into
    build/ab/) with ``defines``."""
    from repro_torch.kernels import _build

    if source is None:
        lib = _build.build(list(defines), ["flash_attention"])
        return lib, lib.with_suffix(".log").read_text()
    tag = "".join(re.sub(r"\W", "", d)[:12] for d in defines)
    lib = OUT / f"{Path(source).stem}{tag}.so"
    OUT.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *defines, "-shared", "-o", str(lib),
           str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def ptxas_lines(log):
    import chip_smoke as CS

    for fn, (regs, stores, loads) in sorted(CS.ptxas_by_kernel(log).items()):
        if "flash_kernel_ws" in fn:
            print(f"  ptxas: {fn} registers={regs} spill_stores={stores} spill_loads={loads}")
    for line in log.splitlines():
        if "warning" in line.lower() and ("wgmma" in line or "setmaxnreg" in line):
            print(f"  ptxas: {line.strip()[:240]}")


def sass_landmarks(lib):
    """{function: [landmark tokens]} of the flash_kernel_ws instantiations."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300).stdout
    funcs, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = name if "flash_kernel_ws" in name else None
            if fn:
                funcs[fn] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)(.*)", line)
        if fn is None or not m:
            continue
        op, rest = m.groups()
        if op.startswith("WARPGROUP.DEPBAR"):
            n = re.search(r"gsb0,\s*(0x[0-9a-f]+|\d+)", rest)
            funcs[fn].append(f"D{int(n.group(1), 0) if n else '?'}")
            continue
        if op == "CS2R" and "SR_CLOCK" in rest:
            funcs[fn].append("c")
            continue
        for key, tok in LANDMARKS:
            if op.startswith(key):
                funcs[fn].append(tok)
                break
        else:
            funcs[fn].append("x")
    return funcs


def rle(tokens):
    out, prev, k = [], None, 0
    for t in tokens + [None]:
        if t == prev:
            k += 1
            continue
        if prev is not None:
            out.append(f"{prev}{k}" if prev == "x" else (prev if k == 1 else f"{prev}*{k}"))
        prev, k = t, 1
    return " ".join(out)


def depbar_report(tokens):
    """For each D0 that follows a D1 (a round's wait for S, then for
    P.V): the EX2 between them, and the EX2 after the D0 before the next
    warpgroup arrive (the next issue) -- the exps that do not run under
    P.V.  (Code of both sides of a branch counts: the softcap pass's tanh
    takes EX2 too.)"""
    rows, last_d1 = [], None
    for i, t in enumerate(tokens):
        if t == "D1":
            last_d1 = i
        elif t == "D0" and last_d1 is not None:
            nxt = tokens.index("A", i) if "A" in tokens[i:] else len(tokens)
            rows.append((tokens[last_d1:i].count("E"), tokens[i:nxt].count("E")))
            last_d1 = None
    return rows


def short(fn):
    m = re.search(r"flash_kernel_ws<([^>]*)>", fn)
    return f"flash_kernel_ws<{re.sub(r'[(]int[)]|[(]bool[)]', '', m.group(1))}>" if m else fn[:80]


def demangle(names):
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).parent / "cu++filt"
    if not tool.exists():
        return {n: n for n in names}
    dem = subprocess.run([str(tool), *names], capture_output=True, text=True).stdout.split("\n")
    return dict(zip(names, dem))


def analyse(stamps, hd, bk):
    """Per consumer: mean clocks a round and each phase's share; softmax
    overlap between the consumers."""
    import numpy as np

    per_c = {0: [], 1: []}
    overlap, sm_total = 0, 0
    spans = []  # per block and consumer: before round 1, rounds 1..n-1, after them
    for blk in range(BLOCKS):
        sm = {}
        for c in (0, 1):
            ev = stamps[blk, c].astype(np.int64)
            start, end, last = ev[ROUNDS - 1, 0], ev[ROUNDS - 1, 1], ev[ROUNDS - 1, 2]
            n = int(np.count_nonzero(ev[:ROUNDS - 1, 0]))  # rounds 0 .. n-1 and the last P.V
            sm[c] = []
            if n >= 3 and start and end and last:
                spans.append((ev[1, 0] - start, ev[n - 1, 0] - ev[1, 0], end - ev[n - 1, 0],
                              last - start))
            for j in range(1, n - 1):
                e, nxt = ev[j, :9], ev[j + 1, 0]
                if not (e.all() and nxt):
                    continue
                d = list(np.diff(e)) + [nxt - e[8]]
                per_c[c].append(d)
                sm[c].append((e[5], e[6]))
        for a0, a1 in sm.get(0, []):
            sm_total += a1 - a0
            overlap += sum(max(0, min(a1, b1) - max(a0, b0)) for b0, b1 in sm.get(1, []))
    res = {}
    for c, rounds in per_c.items():
        if rounds:
            arr = np.array(rounds, dtype=np.float64)
            tot = arr.sum()
            res[c] = dict(rounds=len(rounds), clk_per_round=float(arr.sum(1).mean()),
                          shares={p: float(arr[:, i].sum() / tot) for i, p in
                                  enumerate(PHASES)})
    res["softmax_overlap"] = float(overlap / sm_total) if sm_total else None
    if spans:
        before, rounds, after, total = (float(x) for x in
                                        np.array(spans, dtype=np.float64).mean(0))
        res["block_clk"] = dict(before_round_1=before, rounds=rounds, after=after,
                                block=total)
    res["products_clk_per_consumer_round"] = 64 * bk * hd * 4 / FLOP_PER_CLK
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default=None, help="another flash_attention.cu")
    ap.add_argument("-D", dest="defines", action="append", default=[],
                    help="a -D flag for both builds (without the -D)")
    ap.add_argument("--rows", default="4q,4g,4v,4e", help="rows of flash_bf16_ab.ROWS")
    ap.add_argument("--dump", default=None, help="a directory for each row's raw stamps")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import numpy as np
    import torch

    import chip_smoke as CS
    import flash_bf16_ab as AB
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA

    if not torch.cuda.is_available():
        print("flash_ws_trace: no CUDA device", file=sys.stderr)
        return 2
    print(CS.smi())
    defines = [f"-D{d}" for d in args.defines]
    with ThreadPoolExecutor(2) as pool:
        plain = pool.submit(build, args.source, defines)
        traced = pool.submit(build, args.source, [*defines, TRACE])
        (plain_lib, log), (trace_lib, _) = plain.result(), traced.result()
    print(f"source: {args.source or 'src/repro_torch/kernels/csrc/flash_attention.cu'} "
          f"defines={defines}")
    ptxas_lines(log)
    funcs = sass_landmarks(plain_lib)
    names = demangle(list(funcs))
    for fn, toks in sorted(funcs.items(), key=lambda kv: short(names[kv[0]])):
        counts = {t: toks.count(t) for t in ("G", "E", "f", "D0", "D1", "J")}
        print(f"  sass {short(names[fn])}: {counts} EX2 between the waits for S and "
              f"P.V, and after the latter: {depbar_report(toks)}")
        print(f"    {rle(toks)}")
    lib = _build.load(trace_lib)
    lib.flash_attention_trace.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.flash_attention_trace.restype = ctypes.c_int
    buf = np.zeros((BLOCKS, 2, ROUNDS, EVENTS), dtype=np.uint64)
    device = torch.device("cuda", 0)
    for name in args.rows.split(","):
        case = AB.ROWS[name]
        B, S, H, KVH, hd, window, softcap, causal = case
        kw = dict(causal=causal, window=window, softcap=softcap)
        q, k, v = CS.flash_inputs(case, torch.bfloat16, device, seed=99)
        out = FA.launch_with(lib, q, k, v, scale=None, **kw)
        want = FA.flash_attention_plain(q, k, v, **kw)
        err = float((out.float() - want.float()).abs().max())
        torch.cuda.synchronize()
        check = lib.flash_attention_trace(buf.ctypes.data, buf.nbytes)  # clears it
        FA.launch_with(lib, q, k, v, scale=None, **kw)
        torch.cuda.synchronize()
        check = check or lib.flash_attention_trace(buf.ctypes.data, buf.nbytes)
        if check:
            raise RuntimeError(f"flash_attention_trace: CUDA error {check}")
        res = analyse(buf, hd, 64 if hd == 256 else 128)
        print(f"row {name} {case}: max_abs_err={err!r} "
              f"products_clk_per_consumer_round={res['products_clk_per_consumer_round']!r} "
              f"softmax_overlap={res['softmax_overlap']!r} block_clk={res.get('block_clk')}")
        if args.dump:
            Path(args.dump).mkdir(parents=True, exist_ok=True)
            np.save(Path(args.dump) / f"trace_{name}.npy", buf)
        for c in (0, 1):
            if c in res:
                r = res[c]
                print(f"  consumer {c}: rounds={r['rounds']} clk_per_round="
                      f"{r['clk_per_round']!r} " + " ".join(
                          f"{p}={s:.4f}" for p, s in r["shares"].items()))
        del q, k, v, out, want
    print(CS.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Key tile and stage counts of the float32 flash kernel, on one card.

    python3 tools/flash_tf32_tiles.py          # from the root of a checkout

For head dims 64, 96 and 128, builds ``src/repro_torch/kernels/csrc/
flash_attention.cu`` as it is and in variants whose instantiation of
``flash_kernel_tf32`` for that head dim takes another KV tile (BK keys) and
number of ``cp.async`` stages (``-DREPRO_FLASH_TF32_HD=<hd>
-DREPRO_FLASH_TF32_BK=<BK> -DREPRO_FLASH_TF32_ST=<stages>``),
each through ``_build.build`` into a library of its own hash, all started
together.  Each runs ``flash_attention`` in float32 at a config's prefill
shape (hd 64: hymba-1.5b, B 4, S 2048, 25 heads over 5, window 1024; hd 96:
phi3-vision, S 2048, 32 heads; hd 128: granite-8b, S 2048, 32 heads over
8), is held against the plain version at 2e-5, and is timed by CUDA events
in turns (each variant once forward and once backward; the smaller time is
printed).  Beside them runs the source as it is built with one TF32 pass
(``-DREPRO_FLASH_F32_ONE_PASS``, the planted fault): wrong by design, it
shows what the two lo passes cost.  Shared memory per block is Q hi + lo
(512 * hd bytes) and the stages (16 * BK * hd bytes each); with the
registers it sets how many blocks an SM holds.  The card's name and power
limit are printed first and last.  Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
# head dim: (shape (B, S, H, KVH, hd, window, softcap, causal), [(BK, stages)])
CASES = {
    64: ((4, 2048, 25, 5, 64, 1024, 0.0, True), [(32, 2), (32, 1), (64, 2), (64, 1), (16, 2)]),
    96: ((1, 2048, 32, 32, 96, 0, 0.0, True), [(32, 2), (32, 1), (16, 2), (16, 1)]),
    128: ((1, 2048, 32, 8, 128, 0, 0.0, True), [(32, 2), (32, 1), (16, 2), (16, 1)]),
}


def built_tiles(hd):
    """(BK, stages) that the source takes for ``hd`` when no -D is given."""
    m = re.search(rf"REPRO_FLASH_TF32\({hd}, (\d+), (\d+)\)", SOURCE.read_text())
    if m is None:
        raise RuntimeError(f"no default tiles for hd {hd} in {SOURCE.name}")
    return int(m.group(1)), int(m.group(2))


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as CS
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA

    if not torch.cuda.is_available():
        print("flash_tf32_tiles: no CUDA device", file=sys.stderr)
        return 2
    print(CS.smi())
    # (head dim or None, label, -D flags); the source as it is comes first
    variants = [(None, "as is", []),
                (None, "as is, one TF32 pass (wrong by design)", [CS.FLASH_FAULT])]
    for hd, (_, tiles) in CASES.items():
        now = built_tiles(hd)
        variants += [(hd, f"BK {bk}, {st} stage(s)", [f"-DREPRO_FLASH_TF32_HD={hd}",
                                                      f"-DREPRO_FLASH_TF32_BK={bk}",
                                                      f"-DREPRO_FLASH_TF32_ST={st}"])
                     for bk, st in tiles if (bk, st) != now]
    with ThreadPoolExecutor(len(variants)) as pool:
        paths = list(pool.map(lambda v: _build.build(v[2], ["flash_attention"]), variants))
    libs = [_build.load(p) for p in paths]
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    for hd, (case, _) in CASES.items():
        bk, st = built_tiles(hd)
        runs = {f"BK {bk}, {st} stage(s) (as is)": libs[0], variants[1][1]: libs[1]}
        runs.update({label: lib for (h, label, _), lib in zip(variants, libs) if h == hd})
        window, softcap, causal = case[5:]
        kw = dict(causal=causal, window=window, softcap=softcap)
        q, k, v = CS.flash_inputs(case, torch.float32, device, seed=99)
        want = FA.flash_attention_plain(q, k, v, **kw)
        print(f"hd {hd} at {case}")
        ms = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            lib = runs[name]
            if not ms[name]:
                got = FA.launch_with(lib, q, k, v, scale=None, **kw)
                d = float((got - want).abs().max())
                ok = torch.allclose(got, want, atol=2e-5, rtol=2e-5)
                print(f"  {name}: max_abs_err={d!r} within 2e-5: {ok}")
            ms[name].append(CS.cuda_ms(lambda: FA.launch_with(lib, q, k, v, scale=None, **kw), 20))
        for name, t in ms.items():
            print(f"  {name}: ms={min(t)!r} turns={t}")
        del q, k, v, want
    print(CS.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())

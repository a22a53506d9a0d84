#!/usr/bin/env python3
"""The SSM mixer of hymba-1.5b's prefill at the benchmark's prefill shape,
on one card.

    python3 tools/ssd_prefill_probe.py [--batch 96] [--seq 2048] [--seed 0]

From the root of a checkout.  Draws hymba-1.5b at full width and depth in
bf16 on the card (seeded weights and prompts) and serves ``--batch``
prompts of ``--seq`` tokens through ``make_prefill`` on the kernel route
(``attn_impl="pallas"``), as the cell ``prefill_hymba_1_5b_b96s2048``
does.  It prints:

- one timed prefill after a warm-up one: host seconds and the peak of
  memory allocated;
- one traced prefill (``trace.recording``): the ``step.prefill`` root's
  device ms and host seconds, and the ``model.ssd`` and
  ``model.attention`` spans' routes, launches and device ms summed;
- one profiled prefill (``torch.profiler``): the device's busy ms, each
  of ``ssd_scan``'s four kernels' launches and device µs, and the top
  device operations with their share of busy time;
- ``ssd_scan`` alone at the prefill's scan shape (B, S, 50 heads x 64,
  N 16, chunk 256) in bf16 (``chip_smoke.time_ssd``): ms by CUDA events,
  each kernel's device µs a call, and its bound;
- one layer's mixer (``ssd_forward``, seeded weights, a seeded input)
  through the kernel and through the chunked form: ms by CUDA events and
  the peak of memory allocated above what was held before it.

The card's name and power limit come first and a JSON line (``PROBE``)
last.  Without a CUDA device it exits 2.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402

ARCH, TOP = "hymba-1.5b", 16
SSD_KERNELS = ("ssd_cb_kernel", "ssd_state_kernel", "ssd_pass_kernel", "ssd_out_kernel")


def gib(n: float) -> float:
    return n / 2**30


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import trace
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models import Runtime, build_model
    from repro_torch.models import ssd as ssd_mod
    from repro_torch.train import make_prefill

    print(CS.smi(), flush=True)
    device = torch.device("cuda", 0)
    B, S = args.batch, args.seq
    cfg = get_config(ARCH).replace(dtype="bfloat16")
    model = build_model(cfg, Runtime(attn_impl="pallas", remat="none"))
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=device,
                                     dtype=torch.int32)}
    prefill = make_prefill(model)
    out = {"device": torch.cuda.get_device_name(0), "B": B, "S": S, "seed": args.seed}
    with torch.inference_mode():
        prefill(params, batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = SS.STATS["ssd_scan"]
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_peak_gib"] = gib(torch.cuda.max_memory_allocated())
        out["ssd_scan_launches_a_prefill"] = SS.STATS["ssd_scan"] - before

        trace.take()
        with trace.recording():
            prefill(params, batch)
        recs = trace.take()
        root = [r for r in recs if r.name == "step.prefill"]
        CS.check(len(root) == 1, f"{len(root)} step.prefill roots in one prefill")
        out["root_ms"], out["root_host_s"] = root[0].device_ms, (
            root[0].end_ns - root[0].start_ns) * 1e-9
        for name, key, note, kern in (("model.ssd", "ssd", "route", "ssd_scan"),
                                      ("model.attention", "attn", "impl", "flash_attention")):
            spans = [r for r in recs if r.name == name]
            out[f"{key}_spans"] = len(spans)
            out[f"{key}_routes"] = sorted({str(r.counters.get(note)) for r in spans})
            out[f"{key}_launches_per_span"] = sorted({r.launches[kern] for r in spans})
            out[f"{key}_ms_sum"] = sum(r.device_ms for r in spans if r.device_ms is not None)

        _, avgs = CS.profiled(lambda: prefill(params, batch))
        dev = CS.device_kernels(avgs)
        busy = sum(us for _, us in dev.values())
        out["busy_ms"] = busy * 1e-3
        ssd = {k: (c, us) for k, (c, us) in dev.items() if any(n in k for n in SSD_KERNELS)}
        out["ssd_kernels"] = {next(n for n in SSD_KERNELS if n in k): [c, us]
                              for k, (c, us) in ssd.items()}
        n = max((c for c, _ in ssd.values()), default=0)
        out["ssd_scan_device_us_per_launch"] = (sum(us for _, us in ssd.values()) / n
                                                if n else None)
        top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:TOP]
        out["top_kernels"] = [[k[:70], c, round(us * 1e-3, 2), round(100 * us / busy, 2)]
                              for k, (c, us) in top]
    del batch
    torch.cuda.empty_cache()

    case = (B, S, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk)
    t = CS.time_ssd(device, "bfloat16", case)
    out["ssd_scan_alone"] = {k: t[k] for k in ("shape", "ms", "device_us", "device_us_per_kernel",
                                               "bound_ms", "bound_by", "bytes")}

    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    sp = ssd_mod.ssd_init(gen, cfg, torch.bfloat16)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=device).to(torch.bfloat16)
    out["layer"] = {}
    with torch.inference_mode():
        for route, kernel in (("kernel", True), ("chunked", False)):
            def layer():
                return ssd_mod.ssd_forward(sp, x, cfg, use_pallas=kernel)

            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            layer()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - held
            out["layer"][route] = {"ms": CS.cuda_ms(layer, 3), "peak_gib_above_held": gib(peak)}
    print(CS.smi(), flush=True)
    print("PROBE " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

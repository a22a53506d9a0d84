"""The readings that set the upper ends of the limits: the reference put
in the program's place in the nearest precision below the configuration's
(bf16 -> float8 e4m3 weight products), and, for a training cell, the
fault of half the batch left out (the mean taken over the rest), each
compared with the float32 reference by the cell's own numbers, at the
cell's own size.

    python3 perfbench/control.py --workload <name> --seeds 11 12 13

Prints one JSON line a seed and reading.  The benchmark's runs do not run
it; ``tests/test_perfbench_control.py`` runs it at a small size.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

import harness as H
import tokens as T
import weights as W
from kinds import prefill as kp
from kinds import train as kt
from reference import train as ref_train
from reference.model import bf16_mm, fp8_mm
from reference.prefill import prefill as ref_prefill


def train_readings(cell, seed: int, device) -> dict:
    cfg, tf = cell.config, cell.traffic
    B, S, V = tf["batch"], tf["seq_len"], cfg["vocab_size"]
    opt = dict(tf["adamw"], lr=tf["lr"])
    params = W.draw(cfg, seed, device)
    batches = [torch.from_numpy(T.batch(seed, i, B, S, V, **tf["tokens"])).to(device)
               for i in range(tf["compared_steps"])]
    ref = ref_train.train(cfg, params, batches, opt)
    out = {}
    low = ref_train.train(cfg, params, batches, opt, mm=fp8_mm)
    out["control_fp8"] = kt.compare(low["losses"], low["grad_norms"], low["change_norms"], ref)
    half = ref_train.train(cfg, params, [b[: B // 2] for b in batches], opt)
    out["fault_half_batch"] = kt.compare(half["losses"], half["grad_norms"],
                                         half["change_norms"], ref)
    return out


def _prefill_tokens(cell, seed, device):
    cfg, tf = cell.config, cell.traffic
    rows = tf["compared_rows"]  # prompts are independent rows: a run compares this many
    return torch.from_numpy(T.batch(seed, 0, tf["batch"], tf["seq_len"], cfg["vocab_size"],
                                    **tf["tokens"])[:rows]).to(device)


def _judge_against(caches, numbers, per_layer=None):
    def judge(li, c):
        for k, name in kp.CACHE_KEYS.items():
            if k in c:
                err = kp.rel_max(c[k], caches[li][k])
                numbers[name] = max(numbers.get(name, 0.0), err)
                if per_layer is not None:
                    per_layer.setdefault(k, []).append(round(err, 5))
    return judge


def prefill_readings(cell, seed: int, device) -> dict:
    cfg = cell.config
    params = W.draw(cfg, seed, device)
    tokens = _prefill_tokens(cell, seed, device)
    caches = {}
    ref = ref_prefill(cfg, params, tokens,
                      on_layer=lambda li, c: caches.__setitem__(li, dict(c)))
    numbers = {}
    low = ref_prefill(cfg, params, tokens, mm=fp8_mm, on_layer=_judge_against(caches, numbers))
    numbers["logits_err"] = kp.rel_max(low, ref)
    numbers["token_gap"] = kp.token_gap(low, ref)
    return {"control_fp8": numbers}


def _float32(tree):
    """The same weights, stored in float32 (exactly: bf16 widens without
    rounding)."""
    return {k: _float32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def prefill_witness(cell, seed: int, device) -> dict:
    """Each cache entry's error, layer by layer, against the float32
    reference, from three sides on the same weights and prompts: the
    program as timed (bf16), the program in float32 (TF32 off, dense
    attention), and the reference with its weight products rounded to
    bf16.  Where the float32 program agrees to float32 rounding and the
    bf16 reference reads like the bf16 program, the bf16 program's error
    is bf16 rounding."""
    import program as P

    cfg, tf = cell.config, cell.traffic
    params = W.draw(cfg, seed, device)
    tokens = _prefill_tokens(cell, seed, device)
    caches = {}
    ref = ref_prefill(cfg, params, tokens,
                      on_layer=lambda li, c: caches.__setitem__(li, dict(c)))
    out = {}
    sides = {"program_bf16": (cfg, tf["attn_impl"]),
             "program_fp32": (dict(cfg, dtype="float32"), "dense")}
    for side, (c, impl) in sides.items():
        model = P.build_model(P.model_config(c), P.Runtime(attn_impl=impl, remat="none"))
        p = params if c["dtype"] == cfg["dtype"] else _float32(params)
        with torch.inference_mode():
            logits, cache = P.make_prefill(model)(p, {"tokens": tokens})
        numbers, layers = {}, {}
        judge = _judge_against(caches, numbers, layers)
        for li in range(cfg["num_layers"]):
            judge(li, {k: cache[k][li].float() for k in kp.CACHE_KEYS if k in cache})
        numbers["logits_err"] = kp.rel_max(logits[:, -1], ref)
        out[side] = dict(numbers, by_layer=layers)
        del logits, cache, model, p
        H.free(device)
    numbers, layers = {}, {}
    low = ref_prefill(cfg, params, tokens, mm=bf16_mm,
                      on_layer=_judge_against(caches, numbers, layers))
    numbers["logits_err"] = kp.rel_max(low, ref)
    out["reference_bf16_products"] = dict(numbers, by_layer=layers)
    return out


def readings(cell, seed: int, device, witness: bool = False) -> dict:
    H.reference_precision()
    if witness:
        return prefill_witness(cell, seed, device)
    fn = train_readings if cell.traffic["kind"] == "train" else prefill_readings
    return fn(cell, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--witness", action="store_true",
                    help="a prefill cell's cache errors by layer from three sides")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = H.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = readings(cell, seed, torch.device("cuda", 0), args.witness)
        print(json.dumps({"workload": cell.name, "seed": seed, "seconds":
                          time.perf_counter() - t0, **got}), flush=True)
        H.free(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())

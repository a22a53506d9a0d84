"""The readings that set the upper ends of the limits: the reference put
in the program's place in the nearest precision below the configuration's
(bf16 -> float8 e4m3 weight products), and, for a training cell, the
fault of half the batch left out (the mean taken over the rest), each
compared with the float32 reference by the cell's own numbers, at the
cell's own size.  A cell over ranks also reads the reference with its
weight products rounded to bf16 (``witness_bf16_products``): the floor
that bf16 rounding and the int8 codes it flips set.  With ``--fault`` the
program itself runs (a window of one step) with a fault planted
underneath its timed path in every rank (``plant_*`` below), and its
compared numbers are read as a run reads them.

    python3 perfbench/control.py --workload <name> --seeds 11 12 13 [--fault <fault>]

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
from kinds import train_tp as ktp
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


def train_tp_readings(cell, seed: int, devices, sides=None) -> dict:
    """The readings of ``sides`` (all where None) of the cell over ranks,
    each against the float32 reference."""
    ref = ktp.reference(cell, seed, devices)
    kw = {"control_fp8": dict(mm=fp8_mm), "witness_bf16_products": dict(mm=bf16_mm),
          "fault_half_batch": dict(rows=cell.traffic["batch"] // 2)}
    out = {}
    for side in sides or kw:
        other = ktp.reference(cell, seed, devices, **kw[side])
        out[side] = ktp.compare(other["losses"], other["grad_norms"],
                                [other["change_first"], other["change_norms"]], ref)
    return out


def _prefill_tokens(cell, seed, device):
    cfg, tf = cell.config, cell.traffic
    rows = tf["compared_rows"]  # prompts are independent rows: a run compares this many
    return torch.from_numpy(T.batch(seed, 0, tf["batch"], tf["seq_len"], cfg["vocab_size"],
                                    **tf["tokens"])[:rows]).to(device)


def _judge_against(cfg, caches, numbers, per_layer=None):
    def judge(li, c):
        for k, name in kp.cache_keys(cfg).items():
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
    low = ref_prefill(cfg, params, tokens, mm=fp8_mm, on_layer=_judge_against(cfg, caches, numbers))
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
        judge = _judge_against(cfg, caches, numbers, layers)
        for li in range(cfg["num_layers"]):
            judge(li, {k: kp.cache_entry(cfg, cache, k, li).float()
                       for k in kp.cache_keys(cfg) if k in caches[li]})
        numbers["logits_err"] = kp.rel_max(logits[:, -1], ref)
        out[side] = dict(numbers, by_layer=layers)
        del logits, cache, model, p
        H.free(device)
    numbers, layers = {}, {}
    low = ref_prefill(cfg, params, tokens, mm=bf16_mm,
                      on_layer=_judge_against(cfg, caches, numbers, layers))
    numbers["logits_err"] = kp.rel_max(low, ref)
    out["reference_bf16_products"] = dict(numbers, by_layer=layers)
    return out


def plant_state_unchanged():
    """The training step returns the state it was given (its numbers
    computed on a copy)."""
    import program

    make = program.make_train_step

    def broken(model, optimizer, schedule, **kw):
        pure = make(model, optimizer, schedule, **dict(kw, donate=False))

        def step(state, batch):
            return state, pure(state, batch)[1]
        return step

    program.make_train_step = broken
    return lambda: setattr(program, "make_train_step", make)


def plant_half_batch():
    """The training step takes the first half of the batch's rows."""
    import program

    make = program.make_train_step

    def broken(*a, **kw):
        real = make(*a, **kw)
        return lambda state, batch: real(state, {"tokens": batch["tokens"][
            : len(batch["tokens"]) // 2]})

    program.make_train_step = broken
    return lambda: setattr(program, "make_train_step", make)


def plant_exchange_left_out():
    """The sum over the model group at the exit of every model-parallel
    region is left out: each rank goes on with its partial sum."""
    from repro_torch.distributed import ctx

    forward = ctx._Leave.forward
    ctx._Leave.forward = staticmethod(lambda c, x, group: x.view_as(x))
    return lambda: setattr(ctx._Leave, "forward", forward)


def plant_v_decode():
    """AdamW reads its int8 second moment back without the blocks' scales
    (the codes themselves).  A leaf's update decodes its first moment and
    then its second, each once, so every second decode is the second
    moment's."""
    from repro_torch.optim import adamw

    dq8, calls = adamw._dq8, [0]

    def broken(qs, shape):
        calls[0] += 1
        if calls[0] % 2:
            return dq8(qs, shape)
        return dq8({"q": qs["q"], "scale": torch.ones_like(qs["scale"])}, shape)

    adamw._dq8 = broken
    return lambda: setattr(adamw, "_dq8", dq8)


FAULTS = ("state_unchanged", "half_batch", "exchange_left_out", "v_decode")


def fault_readings(cell, seed: int, devices, fault: str) -> dict:
    """The compared numbers of a run of the program over ranks with
    ``fault`` planted in every rank, its window one step."""
    ktp.PLANT = f"control:plant_{fault}"
    try:
        run = H.run_cell(cell, seed=seed, seconds=0.0, trace=False, device=devices[0],
                         t_start=time.perf_counter(), devices=devices)
    finally:
        ktp.PLANT = None
    return {f"fault_{fault}": run.numbers}


def readings(cell, seed: int, device, witness: bool = False, devices=None) -> dict:
    H.reference_precision()
    if witness:
        return prefill_witness(cell, seed, device)
    if cell.traffic["kind"] == "train_tp":
        return train_tp_readings(cell, seed, list(devices or [device]))
    fn = train_readings if cell.traffic["kind"] == "train" else prefill_readings
    return fn(cell, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--witness", action="store_true",
                    help="a prefill cell's cache errors by layer from three sides")
    ap.add_argument("--fault", choices=FAULTS,
                    help="run the program over ranks with this fault planted")
    args = ap.parse_args(argv)
    cell = H.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"control: needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = (fault_readings(cell, seed, devices, args.fault) if args.fault
               else readings(cell, seed, devices[0], args.witness, devices))
        print(json.dumps({"workload": cell.name, "seed": seed, "seconds":
                          time.perf_counter() - t0, **got}), flush=True)
        for d in devices:
            H.free(d)
    return 0


if __name__ == "__main__":
    sys.exit(main())

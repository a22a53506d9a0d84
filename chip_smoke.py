#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py          # from the root of a checkout, one card

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's main paths.  The single-node path -- ``simulate()`` with
``EcoSched(engine="torch", device="cuda")`` -- runs on the paper's
calibrated node (h100/a100/v100, and h100 with a 4-level DVFS ladder), on
the elastic resize path, and on a pod-scale node (M=16, K=4) with an
online backlog of synthetic jobs.  The fleet path -- ``Cluster.simulate``
and ``Cluster.open_run`` over 256 nodes of torch-engine policies -- runs
the two 256-node cells of ``benchmarks/bench_fleet.py`` (bursty arrivals;
elastic completions), whose same-instant bursts reach the card as one
cross-node ``score_reduce_batch`` / ``score_reduce_multi`` launch.  Every
schedule must equal the numpy engine's (``engine="vector"``) bit for bit,
and every kernel of each path must have been launched.  The serving path
-- ``build_model`` + ``make_prefill`` + ``make_decode_step`` of the model
zoo -- serves hymba-1.5b at full width (cell ``serve_hymba_1_5b_p2048``:
4 prompts of 2,048 tokens, 32 decode steps, bf16 and float32), its
prefill launching ``flash_attention`` in every layer (bf16: the
warp-specialised kernel, a TMA producer warpgroup feeding two wgmma
consumer warpgroups; float32: the three-pass TF32 kernel, also on the
tensor cores), against the plain blocked-attention route, and
``ssd_scan`` for the SSM mixer in every layer on every route, each
layer's mixer held to the chunked form on the same input;
``ssd_forward(use_pallas=True)`` runs one full-width mamba2-2.7b layer
through ``ssd_scan`` (cell ``ssd_layer_mamba2_2_7b_s4096``) against the
chunked form.

The control plane -- ``SchedulerService`` over the ``hetero`` preset of
``repro_torch.cli`` (cell ``daemon_hetero``) -- runs in process against
``engine="vector"`` (the same schedules and journal bytes), recovers on
the card from its journal cut short, and runs as a ``python -m
repro_torch.cli daemon`` subprocess on the card that is killed with
SIGKILL and booted again on its journal.  MoE serving
(``serve_qwen2_moe_a2_7b_p2048``) runs phase 8's checks on
qwen2-moe-a2.7b at full width (float32 at 6 of 24 layers) and holds one
MoE layer on the card to the CPU.  Phase 15 runs phase 8's checks on the
families no earlier phase serves, at full width and depth in both types:
the dense gemma3-4b (``serve_gemma3_4b_p2048``: hd 256, a window of 1,024
on 5 of every 6 layers, qk-norm, a tied 262,144-row head), the
vision-language phi-3-vision-4.2b (``serve_phi3_vision_4_2b_p2048``: hd
96, 576 patch embeddings spliced over each prompt's first positions) and
the encoder-decoder whisper-base (``serve_whisper_base_src1500``: a
non-causal encoder over 1,500 frames through ``flash_attention``, a
causal decoder, cross-attention into the frames), and times
``flash_attention`` at their prefill shapes beside SDPA.

Training (phase 12): ``python -m repro_torch.launch.train``'s ``main``
trains hymba-1.5b at full width on the card (cell
``train_hymba_1_5b_b4s2048``: bf16 parameters, float32 AdamW moments,
``--remat full``, 6 steps of 4 x 2,048 tokens), writes its end
checkpoint and restores it bit-exact; one step of 2 full-width layers
in float32 is held to the CPU with ``remat`` none / full / dots; a step
with ``attn_impl="pallas"`` must raise (the kernels have no backward);
the ``Trainer`` recovers from two lost units of 8 logical ones
(``train_elastic_granite_reduced_u4``); and ``moe_apply_ep`` runs one
full-width qwen2-moe block over a (1, 4) mesh of logical units against
the CPU (``moe_ep_layer_qwen2_moe_a2_7b_mp4``).  Co-scheduling (phase
13, ``cosched_trio_u4``): ``python -m repro_torch.launch.coschedule``'s
``main`` trains three reduced jobs on 4 logical units of the card, its
``EcoSched(engine="torch")`` decisions launching ``score_reduce``, each
replayed through ``engine="vector"``.  Roofline (phase 14):
``repro_torch.launch.dryrun.dryrun_cell`` counts hymba-1.5b's prefill,
decode and train steps on fake tensors of the card at phases 8's and
12's shapes (cell ``dryrun_hymba_1_5b_one_card``): nothing allocated,
the counts near ``model_flops``, each bound at most the time the step
took in this run, the train arguments within its measured peak; then
prefill and decode dry-runs of five archs feed ``RooflinePerfModel``,
which drives ``EcoSched(engine="torch")`` on the paper's H100 node
(``roofline_sched_h100_node``) against ``engine="vector"``.  Training
over ranks (phase 16, ``train_dp_granite_reduced_cards``):
``tests/test_multidevice.py``'s elastic scenario at model_par 1 runs on
``min(device_count, 4)`` cards, one process each over NCCL (world size 1
on one card) through ``Trainer.run()``, against the one-process
``Trainer`` on card 0 (world size 1 bit for bit; more ranks every step's
loss within rel. 1e-5), then, on several cards, rescales onto as many
other cards; with one card, also on 2 ranks of it over gloo where gloo
carries the step's collectives on CUDA tensors (else the refused
collective is printed); each rank's collectives' µs per step, step s and
peak memory are printed; then ``repro_torch.launch.coschedule``'s main
runs with a unit per card, its decisions replayed through
``engine="vector"``; then granite-8b at full width trains with int8
AdamW moments and gradient compression, its ``model`` axis across the
ranks (``train_tp_int8_granite_8b``: on one card 4 of its 36 layers in
float32 over 2 gloo ranks of the card, held to one process; on four
cards all 36 layers in bf16 over NCCL), each step donated: the new state
written into the given one's tensors, as the ``Trainer`` does.  Tensor-parallel serving (phase 17,
``serve_tp_dense_cards``): granite-8b at full width and depth over 2
ranks whose ``model`` axis spans them (2 gloo ranks of one card; on
several cards, a card each over NCCL, then qwen3-32b over 4), each rank
holding its share of the reference's Megatron specs and launching
``flash_attention`` on its own heads, held to the one-process kernel
route on the same weights; a rank skipping the attention region's
all-reduce must fail it.  Tensor-parallel MoE serving (phase 18,
``serve_tp_moe_cards``): qwen2-moe-a2.7b at full width and depth over 2
gloo ranks of one card (on several cards over min(cards, 4), a card each
over NCCL; then arctic-480b at full width over 4 cards at 5 of its 35
layers), each rank holding its share of the experts, routing every token
as the other ranks do and summing its partial output with theirs in one
all-reduce a MoE layer, held to one process; a rank skipping that
all-reduce, or computing every expert rather than its own, must fail it.
Tensor-parallel SSM and hybrid serving (phase 19, ``serve_tp_ssm_cards``):
mamba2-2.7b and hymba-1.5b at full width and depth over 2 gloo ranks of
one card (on several cards a card each over NCCL, and on 4 over 4 too,
with ``launch.train --smoke --model-par 2`` of each through a recovery),
each rank holding its SSD heads and ``d_inner`` channels (B and C whole
on every rank, the gated norm's mean square summed over the model group,
one all-reduce a mixer; hymba's FFN columns, its attention whole at 25
heads), held to one process in bf16 and float32 at full depth; a rank
skipping its mixer's all-reduce, or normalising over its own channels,
must fail it; each rank's prefill launches ``ssd_scan`` once a layer;
``ssd_scan`` timed on mamba2's heads a rank.  The dry-run over
ranks (phase 20, ``dryrun_ranks_h100``): rank 0's step of the (1, 2)
mesh -- granite-8b's prefill and decode as phase 17 served them, the
training step of phase 16's int8 leg; on several cards also phase 17's
qwen3-32b and, on four, phase 19's mamba2-2.7b at (1, 4)
(``phase20_cases``) -- counted on fake tensors of the card over a fake
process group must dispatch exactly the collectives, call for call and
byte for byte, that phase's rank 0 did; the records'
roofline cells then drive ``EcoSched(engine="torch")`` with a non-zero
collective term against ``engine="vector"``.

Phases: 1 device and build (and the tensor-core instructions in the SASS
of the flash kernels and the bf16 ssd kernels, the TMA loads of the bf16
flash kernel and its spills; a planted fault's build,
the float32 flash kernel with one TF32 pass, beside it), 2 kernels vs
plain versions, 3 paper node, 4
elastic, 5 pod scale, 6 fleet, 7 kernel timings, 8 serving, 9 SSD layer,
10 the scheduler daemon, 11 MoE serving, 12 training, 13 co-scheduling,
14 roofline, 15 serving the dense, vision and encoder-decoder families,
16 training over ranks, 17 tensor-parallel serving over ranks, 18
tensor-parallel MoE serving over ranks, 19 tensor-parallel SSM and
hybrid serving over ranks, 20 the dry-run's collectives on one rank.
``score_reduce`` carries the idle-node guard in its one launch
(``guard=``); phases 3-5 print its guarded calls, and phase 6 the
guarded segments of the packed launches, one per staged burst.
``ssd_scan`` runs four kernels a call (C.B^T once per chunk, the chunk
states in parallel, the serial state pass, the outputs) on the tensor
cores.  The last two lines are the kernels' JSON record (the float32
flash and ssd kernels have their own entries, ``flash_attention_float32``
and ``ssd_scan_float32``; ``ssd_scan`` is timed at phase 8's hymba
prefill and counted there, ``ssd_scan_mamba2_layer`` at phase 9's) and
``{"ok": true, "device": {...}}``.  Any failed check raises and the exit
code is non-zero; without a CUDA device, or without the repository
around it, the script exits 2 and prints no result.  It imports nothing
of JAX and nothing of the reference package.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

LAM, TAU, NOISE, SEED = 0.35, 0.45, 0.02, 1
TOL = 1e-6  # kernel vs plain version; same float32 ops, so expected 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
H100_RATIOS, H100_FLOOR = (1.0, 0.86, 0.72, 0.58), 0.32
POD_JOBS = 240
# the fleet cells of benchmarks/bench_fleet.py (FULL_SWEEP / ELASTIC_SWEEP
# at 256 nodes): nodes of M=8 units in K=2 domains, one chip per 16-node
# pod cycling H100/A100/V100, 8 pods per region, window 8
FLEET_NODES, FLEET_M, FLEET_K, POD_SIZE, PODS_PER_REGION = 256, 8, 2, 16, 8
FLEET_APPS, FLEET_JOBS, FLEET_WINDOW = 8, 2048, 8
CHIP_SLOW = {"h100": 1.0, "a100": 1.6, "v100": 2.6}
KERNELS = ("score_reduce", "score_reduce_batch", "score_reduce_multi")
BF16_OPS_PER_S = 989e12  # H100 SXM, bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12  # H100 SXM, TF32 tensor cores, dense
# the serving path's flash_attention shapes, each its prefill's:
# (B, S, H, KVH, hd, window, softcap, causal)
HYMBA_FLASH = (4, 2048, 25, 5, 64, 1024, 0.0, True)  # hymba-1.5b (phases 7, 8)
MOE_FLASH = (4, 2048, 16, 16, 128, 0, 0.0, True)  # qwen2-moe-a2.7b (phase 11)
GRANITE_FLASH = (4, 2048, 32, 8, 128, 0, 0.0, True)  # granite-8b (phase 7)
# phase 15's: gemma3-4b's local and global layers (hd 256, G 2),
# phi-3-vision-4.2b's (hd 96, G 1), whisper-base's encoder (non-causal,
# 1,500 frames: a ragged last tile) and decoder
FAMILY_FLASH = dict(
    gemma3_4b_local=(4, 2048, 8, 4, 256, 1024, 0.0, True),
    gemma3_4b_global=(4, 2048, 8, 4, 256, 0, 0.0, True),
    phi3_vision_4_2b=(4, 2048, 32, 32, 96, 0, 0.0, True),
    whisper_base_encoder=(8, 1500, 8, 8, 64, 0, 0.0, False),
    whisper_base_decoder=(8, 224, 8, 8, 64, 0, 0.0, True),
)
# phase 17's: a rank's heads under tensor parallelism, granite-8b at
# model_par 2 (16 over 4 heads) and qwen3-32b at 4 (16 over 2, GQA group 8)
TP_FLASH = dict(
    granite_8b_mp2=(4, 2048, 16, 4, 128, 0, 0.0, True),
    qwen3_32b_mp4=(4, 2048, 16, 2, 128, 0, 0.0, True),
)
# phase 18's: a rank's heads of qwen2-moe-a2.7b at model_par 2 and 4 (16
# over 16 heads), and of arctic-480b at 4 (56 over 8: 14 over 2, GQA group 7)
MOE_TP_FLASH = dict(
    qwen2_moe_a2_7b_mp2=(4, 2048, 8, 8, 128, 0, 0.0, True),
    qwen2_moe_a2_7b_mp4=(4, 2048, 4, 4, 128, 0, 0.0, True),
    arctic_480b_mp4=(4, 2048, 14, 2, 128, 0, 0.0, True),
)
# the model kernels' cases: the reference's kernel tests
# (tests/test_kernels_flash.py, tests/test_kernels_ssd.py) plus the
# serving path's shapes (but granite-8b's, timed in phase 7 only)
FLASH_CASES = (
    (2, 128, 4, 2, 64, 0, 0.0, True), (1, 256, 8, 2, 32, 0, 0.0, True),
    (1, 256, 8, 2, 32, 64, 0.0, True), (2, 128, 2, 2, 64, 0, 30.0, True),
    (1, 128, 4, 1, 128, 32, 0.0, True), (1, 64, 4, 4, 16, 0, 0.0, True),
    (2, 192, 6, 2, 64, 96, 20.0, True), (1, 128, 4, 4, 32, 0, 0.0, False),
    HYMBA_FLASH,
    (1, 2048, 32, 8, 128, 0, 0.0, True),  # granite-like
    (1, 1024, 8, 4, 256, 512, 30.0, True),  # gemma3-like
    (1, 1000, 8, 2, 64, 128, 0.0, True),  # ragged S
    # every head dim of the kernels, ragged S, non-causal and windowed
    (1, 300, 4, 2, 96, 0, 25.0, False), (2, 333, 6, 2, 96, 100, 0.0, True),
    (1, 300, 4, 2, 16, 0, 25.0, False), (1, 300, 4, 2, 256, 0, 0.0, False),
    # hd 128, the bf16 kernel's design point: G 1 and G 4 at a ragged S,
    # a window with softcap, and S 4096 (the K/V ring wraps 16 times)
    (1, 2113, 8, 8, 128, 0, 0.0, True), (1, 2113, 16, 4, 128, 0, 0.0, True),
    (1, 1000, 8, 2, 128, 300, 30.0, True), (1, 4096, 8, 2, 128, 0, 0.0, True),
    MOE_FLASH, *FAMILY_FLASH.values(), *TP_FLASH.values(), *MOE_TP_FLASH.values(),
    # causal, enough tile pairs for a persistent grid, and an odd tile
    # count: the middle tile walks alone
    (4, 1408, 32, 8, 128, 0, 0.0, True),
)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # the reference tests'
# steep scores, as trained weights give them: q and k x FLASH_STEEP (score
# std about 9).  There float32 arithmetic's own error nears 2e-5 (the plain
# float32 version is 0.4-1.0 of it from the exact answer on the CPU at
# these shapes), so these cases hold the kernel to the plain version run
# in float64 on the same inputs, at the same tolerances.
FLASH_STEEP, FLASH_STEEP_CASES = 3.0, (
    (1, 256, 4, 2, 64, 0, 0.0, True), (1, 300, 4, 2, 128, 0, 0.0, False),
    (1, 200, 2, 1, 256, 0, 0.0, True), (2, 512, 8, 2, 128, 0, 0.0, True),
    (1, 1500, 8, 8, 64, 0, 0.0, False),  # whisper-base's encoder, one row
)
FLASH_FAULT = "-DREPRO_FLASH_F32_ONE_PASS"  # planted fault: the lo terms dropped
# ssd: (B, S, nh, hp, N, chunk)
SSD_CASES = (
    (2, 128, 4, 32, 64, 32), (1, 256, 2, 64, 128, 64), (2, 64, 8, 16, 32, 16),
    (1, 128, 4, 32, 64, 128),
    (2, 4096, 80, 64, 128, 256),  # mamba2-2.7b layer
    (4, 2048, 50, 64, 16, 256),  # hymba-1.5b's SSD heads
    # the kernels' edges: one chunk (S = Q), chunk 1024, hp 128 with N 128,
    # N 16, and a chunk and a state size off the 16-row tiles
    (1, 256, 4, 32, 64, 256), (1, 2048, 4, 64, 64, 1024), (2, 512, 8, 128, 128, 256),
    (2, 512, 8, 32, 16, 128), (2, 192, 3, 64, 40, 96),
    # prompts shorter than the chunk at hymba-1.5b's heads: the prefill
    # hands the kernel Q = S, here 1, 37 and 200, off the 16-row tiles
    (2, 1, 50, 64, 16, 1), (2, 37, 50, 64, 16, 37), (2, 200, 50, 64, 16, 200),
    # mamba2-2.7b's layer on a rank's heads at model_par 2 and 4 (phase 19)
    (2, 4096, 40, 64, 128, 256), (2, 4096, 20, 64, 128, 256),
)
SSD_TOL = 2e-4
FLASH_PATH, SSD_PATH = HYMBA_FLASH, SSD_CASES[4]  # phase 7's timed shapes, and SSD_SERVE
SERVE_ARCH, SERVE_B, SERVE_P, SERVE_STEPS, SERVE_CAP = "hymba-1.5b", 4, 2048, 32, 2080
SSD_SERVE = SSD_CASES[5]  # phase 8's scan: hymba-1.5b's heads at its batch and length
# rel. max error (max |diff| / max |plain|) of the kernel route against the
# plain blocked route.  Per layer, each layer fed the plain route's input
# (its attention output and the layer's output), and end to end in float32:
SERVE_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# End to end through all 32 layers in bf16 a one-ulp difference in one
# layer grows with depth in this random-weight model: two plain routes of
# the reference's own (dense vs blocked attention) differ by about 0.05 at
# the logits (NVIDIA H100 80GB HBM3, 700 W).  So the bf16 bound on the
# prefill logits, and on the decode steps, is the larger of 2e-2 and this
# factor times that spread, measured in the same run on the same weights,
# prompts and decode tokens.
SERVE_SPREAD_FACTOR = 1.5
SSD_ARCH, SSD_B, SSD_S = "mamba2-2.7b", 2, 4096
# phase 10: the scheduler daemon on the hetero preset (one H100, A100 and
# V100 node behind the energy-aware dispatcher), driven in process and as
# a `python -m repro_torch.cli daemon` subprocess on the card
DAEMON_PRESET, DAEMON_SUBMITS, DAEMON_OFFSETS, DAEMON_BOOT_S = "hetero", 200, 8, 240.0
# the journal workload of tests/test_service.py: every record kind
DAEMON_OPS = (
    ("submit", "j0", "bert", 10.0), ("submit", "j1", "lbm", 10.0),
    ("submit", "j2", "resnet50", 40.0), ("advance", 60.0),
    ("submit", "j3", "gpt2", 90.0), ("submit", "j4", "MonteCarlo", 90.0),
    ("cancel", "j4"), ("advance", 800.0), ("submit", "j5", "vgg16", 1200.0),
    ("drain",),
)
# phase 11: qwen2-moe-a2.7b at full width; float32 at 6 of its 24 layers
# (57 GB of float32 weights at full depth would leave little room)
MOE_ARCH, MOE_F32_LAYERS = "qwen2-moe-a2.7b", 6
MOE_LAYER_S, MOE_LAYER_TOL = 256, 1e-4  # one MoE layer on the card vs the CPU
# phase 12: training hymba-1.5b at full width (bf16 parameters, float32
# AdamW moments, remat full), 6 steps of B 4 x S 2048
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS = "hymba-1.5b", 4, 2048, 6
# phase 13: the co-scheduled launcher on 4 logical units of the card
COSCHED_UNITS, COSCHED_STEPS = 4, 20
# phase 14: dry-runs on fake tensors of the card, one-card mesh, H100.
# Counted FLOPs / model_flops bands (from CPU counts of the same steps),
# and a bound may exceed the time measured in this run by 5 % at most
ROOF_BANDS = {"prefill": (0.95, 1.10), "decode": (0.90, 1.10), "train": (1.20, 1.45)}
ROOF_BOUND_SLACK = 1.05
# roofline_sched_h100_node: prefill and decode cells of these archs drive
# RooflinePerfModel; steps per job as benchmarks/bench_tpu_pod.py sets them
# for prefill_32k and decode_32k
ROOF_ARCHS = ("hymba-1.5b", "mamba2-2.7b", "phi4-mini-3.8b", "gemma3-4b", "qwen2-moe-a2.7b")
ROOF_STEPS = {"prefill": 20_000, "decode": 500_000}
ROOF_COUNTS = (1, 2, 3, 4)
# phase 15: the dense, vision and encoder-decoder families at full width,
# and their flash_attention shapes (FAMILY_FLASH) timed
# whisper's plain blocked route cuts the queries into chunks that must
# divide the length (the reference's blocked route asserts the same):
# 1,500 frames are no multiple of the config's 1,024, so 500 there
WHISPER_Q_CHUNK = 500
# phase 17: granite-8b served over TP_M ranks (phase 8's batch, cache and
# steps), float32 cut to TP_F32_LAYERS of 36 layers (one card holds the
# one-process model and the ranks' shares beside it); on several cards
# qwen3-32b over min(cards, 4) ranks at full depth, held to one process
# at TP_BIG_ONE_LAYERS of 64 layers (what card 0 holds alone)
TP_ARCH, TP_M, TP_F32_LAYERS = "granite-8b", 2, 8
TP_BIG_ARCH, TP_BIG_ONE_LAYERS = "qwen3-32b", 16
TP_TIMEOUT_S = 900
# phase 18: qwen2-moe-a2.7b served at full width and depth over 2 ranks
# of one card (gloo), or min(cards, 4) cards (NCCL; 30 or 15 of its 60
# experts a rank), phase 8's batch, cache and steps, float32 cut to
# phase 11's MOE_F32_LAYERS; on 4 cards arctic-480b at full width over 4
# (32 of its 128 experts a rank): ARCTIC_LAYERS of its 35 layers timed
# (6.83 GB of weights a layer a rank, and each rank draws a layer's whole
# expert leaf, 17.9 GB in float32 and 8.9 in bf16, before it keeps its
# share: 8 layers ran out of a card's 79 GiB), held to one process on
# card 0 at ARCTIC_ONE_LAYERS (27.3 GB a layer: card 0 alone holds one
# while it stacks the layers' leaves)
MOE_TP_M, ARCTIC_ARCH, ARCTIC_LAYERS, ARCTIC_ONE_LAYERS = 2, "arctic-480b", 5, 1
# phase 19: the SSM and hybrid families served over SSM_TP_M ranks at full
# width and depth (phase 8's batch, cache and steps), float32 at
# SSM_F32_LAYERS (None: full depth; both fit one card beside the ranks'
# shares); on 4 cards over 4 ranks too, and the training launcher at
# model_par 2 through a recovery.  The bf16 bound's spread is also taken
# between two one-process chunked SSD runs, at the config's chunk and half
# of it (the same function, its sums in another order).  flash_attention
# runs whole on every hymba rank (25 heads divide neither 2 nor 4), at row
# 4's shape; ssd_scan is timed on mamba2's heads a rank (40 and 20).
SSM_TP_ARCHS, SSM_TP_M, SSM_F32_LAYERS = ("mamba2-2.7b", "hymba-1.5b"), 2, None
SSM_FAULTS, SSM_TRAIN_STEPS, SSM_FAIL_AT = ("ssm_leave", "local_norm"), 30, 18
SSM_TP_FLASH = dict(hymba_1_5b_mp2=HYMBA_FLASH, hymba_1_5b_mp4=HYMBA_FLASH)
SSM_RANK_SSD = dict(mamba2_2_7b_mp2=SSD_CASES[-2], mamba2_2_7b_mp4=SSD_CASES[-1])


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sass_counts(lib_path):
    """{kernel: (tensor-core instructions (HGMMA, HMMA), TMA loads
    (UTMALDG))} in the SASS of the built library, by ``cuobjdump -sass``
    from the toolkit that built it; None when the toolkit has no
    cuobjdump."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump: {out.stderr.strip()[:300]}")
    fn, counts = None, {}
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += "HGMMA" in line or "HMMA" in line
            counts[fn][1] += "UTMALDG" in line
    return {k: tuple(v) for k, v in counts.items()}


def ptxas_by_kernel(log):
    """{kernel: (registers, spill store bytes, spill load bytes)} from the
    ``-Xptxas -v`` lines of a build log, names demangled by the toolkit's
    ``cu++filt`` where it has one."""
    from repro_torch.kernels import _build

    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = [None, None, None]
        elif fn and "spill stores" in line:
            out[fn][1:] = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
        elif fn and "Used" in line and "registers" in line:
            out[fn][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    names = list(out)
    try:
        tool = Path(_build.nvcc()).parent / "cu++filt"
    except RuntimeError:  # no toolkit: the names stay mangled
        tool = None
    if names and tool is not None and tool.exists():
        dem = subprocess.run([str(tool), *names], capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
        if len(dem) == len(names):
            names = [re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::|\((int|bool)\)",
                            "", d).split("(")[0] for d in dem]
    return {n: tuple(v) for n, v in zip(names, out.values())}


# ---------------------------------------------------------------------------
# Seeded inputs (this script's own copies; nothing is read from disk)
# ---------------------------------------------------------------------------


def synth_specs(W, M, seed, levels=1):
    """Seeded window like ``benchmarks/bench_decision_overhead.synth_window``
    (sublinear speedups, power-law busy power), optionally over a DVFS
    ladder of ``levels`` frequency levels."""
    import numpy as np
    from repro_torch.core.perfmodel import _mk_spec

    rng = np.random.default_rng(seed)
    counts = [g for g in (1, 2, 3, 4, 6, 8, 12, 16) if g <= M]
    specs = []
    for i in range(W):
        a, b = float(rng.uniform(0.35, 0.95)), float(rng.uniform(0.6, 0.9))
        mu = float(rng.uniform(0.1, 0.75))
        t_hat, p_hat = {}, {}
        for g in counts:
            for f in range(levels):
                r = H100_RATIOS[f]
                key = g if levels == 1 else (g, f)
                t_hat[key] = 100.0 / g ** a * (mu + (1.0 - mu) / r)
                p_hat[key] = 300.0 * g ** b * (H100_FLOOR + (1 - H100_FLOOR) * r ** 3)
        specs.append(_mk_spec(f"job{i}", t_hat, p_hat))
    return specs


def node_view(M, K, busy=()):
    from repro_torch.core import NodeView, PlacementState

    st = PlacementState(M, K)
    for g in busy:
        st.allocate(g)
    return NodeView(t=0.0, total_units=M, domains=K, free_units=st.free_count(),
                    running=[object()] * len(busy), free_map=list(st.free),
                    domain_jobs=list(st.domain_jobs))


def pod_truth(n_jobs, M=16, levels=4, seed=7):
    """Seeded pod-scale ground truth and its online arrival stream."""
    import numpy as np
    from repro_torch.core import JobProfile

    rng = np.random.default_rng(seed)
    counts = [g for g in (1, 2, 3, 4, 6, 8, 12, 16) if g <= M]
    ratios = H100_RATIOS[:levels]
    truth, stream, t = {}, [], 0.0
    for i in range(n_jobs):
        name = f"job{i}"
        t1, a = float(rng.uniform(600.0, 6000.0)), float(rng.uniform(0.35, 0.95))
        p0, b = float(rng.uniform(250.0, 500.0)), float(rng.uniform(0.6, 0.9))
        mu = float(rng.uniform(0.1, 0.75))
        runtime = {g: t1 / g ** a for g in counts}
        truth[name] = JobProfile(
            name=name, runtime=runtime,
            busy_power={g: p0 * g ** b for g in counts},
            dram_util={g: 1.0 / (runtime[g] * g) for g in counts},
            freq_time={f: mu + (1.0 - mu) / r for f, r in enumerate(ratios)},
            freq_power={f: H100_FLOOR + (1.0 - H100_FLOOR) * r ** 3
                        for f, r in enumerate(ratios)},
        )
        stream.append((t, name))
        t += float(rng.exponential(120.0))
    return truth, stream


def synth_apps(chip, n_apps=FLEET_APPS, seed=3):
    """``benchmarks/bench_fleet.synth_apps``: three mode families (elastic
    {2,4,8}, rigid {8}, small {1,2}), slower on older chips."""
    import numpy as np
    from repro_torch.core import JobProfile

    s = CHIP_SLOW[chip.name]
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n_apps):
        counts = (1, 2) if i % 3 == 0 else ((8,) if i % 3 == 1 else (2, 4, 8))
        t1 = float(rng.uniform(60.0, 240.0))
        alpha = float(rng.uniform(0.35, 0.95))
        beta = float(rng.uniform(0.6, 0.9))
        p0 = float(rng.uniform(250.0, 400.0))
        out[f"app{i}"] = JobProfile(
            name=f"app{i}",
            runtime={g: s * t1 / g ** alpha for g in counts},
            busy_power={g: (p0 / s ** 0.5) * g ** beta for g in counts},
        )
    return out


def synth_elastic_apps(chip, n_apps=FLEET_APPS, seed=5):
    """``benchmarks/bench_fleet.synth_elastic_apps``: even apps are long
    strong-scaling {4,8} jobs, odd apps short rigid 4-unit anchors whose
    completions free half a node next to them."""
    import numpy as np
    from repro_torch.core import JobProfile

    s = CHIP_SLOW[chip.name]
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n_apps):
        if i % 2 == 0:
            counts = (4, 8)
            t1 = float(rng.uniform(3600.0, 10800.0))
            alpha = float(rng.uniform(0.42, 0.52))
            beta = alpha - float(rng.uniform(0.10, 0.20))
            p0 = float(rng.uniform(250.0, 400.0))
            rt = {g: s * t1 / g ** alpha for g in counts}
            bp = {g: (p0 / s ** 0.5) * g ** beta for g in counts}
        else:
            t4 = float(rng.uniform(600.0, 1800.0))
            p0 = float(rng.uniform(250.0, 400.0))
            rt = {4: s * t4}
            bp = {4: (p0 / s ** 0.5) * 4 ** 0.7}
        out[f"app{i}"] = JobProfile(name=f"app{i}", runtime=rt, busy_power=bp)
    return out


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version on the card
# ---------------------------------------------------------------------------


class Diff:
    def __init__(self):
        self.max_abs = {k: 0.0 for k in KERNELS}
        self.cases = {k: 0 for k in KERNELS}

    def scores(self, name, a, b, tag):
        import torch

        fa, fb = torch.isfinite(a), torch.isfinite(b)
        check(torch.equal(fa, fb), f"{name} {tag}: +inf pattern differs")
        if bool(fa.any()):
            d = float((a[fa] - b[fb]).abs().max())
            check(d <= TOL, f"{name} {tag}: max |diff| {d} > {TOL}")
            self.max_abs[name] = max(self.max_abs[name], d)
        self.cases[name] += 1


def solo_vs_plain(diff, cols, kw, tag, guard=None):
    """``score_reduce`` against its plain version; with ``guard`` also the
    guarded winner, against the plain version's and against a second plain
    call masked with ``mask & guard`` (the two calls it replaces)."""
    from repro_torch.kernels import score_reduce as K

    args = (cols["dev"], cols["g"], cols["n"])
    if guard is None:
        s_k, b_k = K.score_reduce(*args, **kw)
        s_p, b_p = K.score_reduce_plain(*args, **kw)
    else:
        s_k, b_k, j_k = K.score_reduce(*args, guard=guard, **kw)
        s_p, b_p, j_p = K.score_reduce_plain(*args, guard=guard, **kw)
        mask = kw.get("mask")
        both = (guard > 0) if mask is None else (guard > 0) & (mask > 0)
        _, j_two = K.score_reduce_plain(*args, **dict(kw, mask=both.float()))
        check(j_k == j_p == j_two,
              f"score_reduce {tag}: guarded winner {j_k} != plain {j_p} / two calls {j_two}")
        tag += "+guard"
    check(b_k == b_p, f"score_reduce {tag}: winner {b_k} != plain {b_p}")
    diff.scores("score_reduce", s_k, s_p, tag)
    return s_k, b_k


def multi_vs_plain(diff, reqs, device, tag):
    import torch
    from repro_torch.kernels import score_reduce as K

    packed = K.pack_windows(reqs, device)
    s_k, b_k = K.score_reduce_multi(**packed)
    s_p, b_p = K.score_reduce_multi_plain(**packed)
    check(b_k == b_p, f"score_reduce_multi {tag}: winners {b_k} != {b_p}")
    diff.scores("score_reduce_multi", s_k, s_p, tag)
    off = packed["offsets"].tolist()
    for w, (lo, hi) in enumerate(zip(off, off[1:])):  # bitwise = solo
        sl = slice(lo, hi)
        kw = dict(lam=reqs[w]["lam"], g_free=reqs[w]["g_free"], M=reqs[w]["M"],
                  lam_f=reqs[w].get("lam_f", 0.0),
                  f=None if packed["f"] is None else packed["f"][sl],
                  bias=None if packed["bias"] is None else packed["bias"][sl],
                  mask=None if packed["mask"] is None else packed["mask"][sl])
        s_w, b_w = K.score_reduce(packed["dev"][sl], packed["g"][sl],
                                  packed["n"][sl], **kw)
        check(b_w == b_k[w], f"multi {tag} window {w}: {b_k[w]} != solo {b_w}")
        check(torch.equal(s_w, s_k[sl]), f"multi {tag} window {w}: not bitwise")


def batch_vs_plain(diff, reqs, device, tag):
    """``score_reduce_batch`` against its plain version, and each node
    bitwise against a solo ``score_reduce`` on its rows."""
    import torch
    from repro_torch.kernels import score_reduce as K

    packed = K.pack_windows(reqs, device)
    s_k, b_k = K.score_reduce_batch(**packed)
    s_p, b_p = K.score_reduce_batch_plain(**packed)
    check(b_k == b_p, f"score_reduce_batch {tag}: winners differ from plain")
    diff.scores("score_reduce_batch", s_k, s_p, tag)
    off = packed["offsets"].tolist()
    for d, (lo, hi) in enumerate(zip(off, off[1:])):
        sl = slice(lo, hi)
        kw = dict(lam=reqs[d]["lam"], g_free=reqs[d]["g_free"], M=reqs[d]["M"],
                  lam_f=reqs[d].get("lam_f", 0.0),
                  **{k: None if packed[k] is None else packed[k][sl]
                     for k in ("f", "bias", "mask")})
        s_d, b_d = K.score_reduce(packed["dev"][sl], packed["g"][sl],
                                  packed["n"][sl], **kw)
        check(b_d == b_k[d], f"batch {tag} node {d}: {b_k[d]} != solo {b_d}")
        check(torch.equal(s_d, s_k[sl]), f"batch {tag} node {d}: not bitwise")
    return b_k


def guarded_vs_plain(diff, reqs, device, tag, name):
    """``name`` (``score_reduce_multi`` or ``score_reduce_batch``) with the
    idle-node guard (the non-empty rows) on every other segment: scores
    and both winners of every segment bitwise its plain version's, and
    equal to the two kernel calls the guard replaces, one as asked and one
    masked with ``mask & guard``; one launch, its guarded segments counted."""
    import numpy as np
    import torch
    from repro_torch.kernels import score_reduce as K

    reqs = [dict(r, guard=np.asarray(r["n"]) > 0) if k % 2 == 0 and "guard" not in r
            else r for k, r in enumerate(reqs)]
    fn, plain_fn = getattr(K, name), getattr(K, name + "_plain")
    packed = K.pack_windows(reqs, device)
    st = K.STATS[name]
    before = (st.launches, st.guarded)
    s_k, b_k, j_k = fn(**packed)
    check((st.launches, st.guarded) == (before[0] + 1, before[1] + packed["guarded"]),
          f"{name} {tag}: a guarded call is not one launch with its guarded segments")
    s_p, b_p, j_p = plain_fn(**packed)
    check(b_k == b_p and j_k == j_p, f"{name} {tag}+guard: winners differ from plain")
    diff.scores(name, s_k, s_p, tag + "+guard")
    plain = [{k: v for k, v in r.items() if k != "guard"} for r in reqs]
    s_1, b_1 = fn(**K.pack_windows(plain, device))
    masked = []
    for r, q in zip(reqs, plain):
        both = np.asarray(r.get("guard", np.zeros(len(r["n"]), bool)), bool)
        if q.get("mask") is not None:
            both = both & np.asarray(q["mask"], bool)
        masked.append(dict(q, mask=both))
    _, j_2 = fn(**K.pack_windows(masked, device))
    check(torch.equal(s_k, s_1) and b_k == b_1 and j_k == j_2,
          f"{name} {tag}+guard: not the two calls it replaces")
    check(all(j == -1 for r, j in zip(reqs, j_k) if "guard" not in r),
          f"{name} {tag}+guard: a segment without a guard gave a guarded winner")


def ragged_node_reqs(rng, sizes, *, f, bias, mask):
    """One seeded request per node: B_k rows (ragged, 0 included) of S_k
    slots (1 to 8), zero past each row's size, per-node scalars."""
    import numpy as np

    reqs = []
    for k, B in enumerate(sizes):
        S = int(rng.integers(1, 9))
        n = rng.integers(0, S + 1, B).astype(np.float32)
        slot = np.arange(S)[None, :] < n[:, None]
        r = dict(dev=np.where(slot, rng.uniform(0, 2, (B, S)), 0).astype(np.float32),
                 g=np.where(slot, rng.integers(1, 5, (B, S)), 0).astype(np.float32),
                 n=n, lam=LAM + 0.01 * (k % 7), g_free=int(rng.integers(0, 17)), M=16)
        if f:
            r["f"] = np.where(slot, rng.integers(0, 4, (B, S)), 0).astype(np.float32)
            r["lam_f"] = 0.1
        if bias:
            r["bias"] = rng.uniform(0, 0.3, B)
        if mask:
            r["mask"] = rng.uniform(size=B) > 0.3
        reqs.append(r)
    return reqs


def phase_kernels(device) -> Diff:
    import numpy as np
    import torch
    from repro_torch.core import enumerate_scored

    diff = Diff()
    rng = np.random.default_rng(0)
    reqs, n_windows = [], 0
    for M, K in ((4, 2), (8, 2), (8, 4), (16, 4)):
        for W in (4, 5, 8, 17):
            for levels in (1, 4):
                for busy in ((), (M // 4,)):
                    view = node_view(M, K, busy)
                    specs = synth_specs(W, M, seed=M * 100 + W, levels=levels)
                    lam_f = 0.1 if levels > 1 else 0.0
                    batch = enumerate_scored(specs, view, list(view.free_map),
                                             lam=LAM, lam_f=lam_f)
                    cols = batch.device_cols(device, with_f=levels > 1)
                    B = len(batch)
                    bias = torch.from_numpy(
                        rng.uniform(0, 0.3, B).astype(np.float32)).to(device)
                    mask = torch.from_numpy(
                        (rng.uniform(size=B) > 0.3).astype(np.float32)).to(device)
                    kw = dict(lam=LAM, g_free=view.free_units, M=M, f=cols["f"],
                              lam_f=lam_f)
                    tag = f"M{M}K{K}W{W}L{levels}b{len(busy)}"
                    _, best = solo_vs_plain(diff, cols, kw, tag)
                    if levels == 1:  # the float32 winner is the engine's
                        check(batch.total_g[best] == batch.total_g[batch.best_index()],
                              f"{tag}: kernel winner off the engine's frontier")
                    solo_vs_plain(diff, cols, dict(kw, bias=bias, mask=mask), tag + "+bm")
                    solo_vs_plain(diff, cols, dict(kw, mask=cols["nonempty"]), tag + "+ne")
                    solo_vs_plain(diff, cols, kw, tag, guard=cols["nonempty"])
                    solo_vs_plain(diff, cols, dict(kw, bias=bias, mask=mask), tag + "+bm",
                                  guard=cols["nonempty"])
                    dead = torch.zeros_like(cols["n"])
                    _, b_dead = solo_vs_plain(diff, cols, dict(kw, mask=dead), tag + "+dead")
                    check(b_dead == -1, f"{tag}: all-infeasible gave {b_dead}")
                    dev, g, n = batch.padded_cols()
                    reqs.append(dict(dev=dev, g=g, n=n, lam=LAM + 0.01 * n_windows,
                                     g_free=view.free_units, M=M,
                                     f=batch.padded_f() if levels > 1 else None,
                                     lam_f=lam_f, mask=(n > 0)))
                    n_windows += 1
    S_max = max(r["dev"].shape[1] for r in reqs)
    empty = dict(dev=np.zeros((0, S_max), np.float32), g=np.zeros((0, S_max), np.float32),
                 n=np.zeros(0, np.float32), lam=LAM, g_free=4, M=4)
    dead = dict(reqs[3], mask=np.zeros(len(reqs[3]["n"]), bool))
    multi = [empty] + reqs[:40] + [dead, empty] + reqs[40:]
    multi_vs_plain(diff, multi, device, "engine windows")
    guarded_vs_plain(diff, multi, device, "engine windows", "score_reduce_multi")
    # synthetic blocks around the 256-row block edge of the packed kernels
    # and the one-block edge of score_reduce (8192 rows), and far beyond;
    # every block also with the guard (its non-empty rows)
    for B in (1, 255, 256, 257, 1321, 5000, 6181, 8192, 8193, 50000, 70000):
        for S in (1, 2, 4, 8):
            n = rng.integers(0, S + 1, B).astype(np.float32)
            slot = np.arange(S)[None, :] < n[:, None]
            planes = [np.where(slot, x, 0).astype(np.float32) for x in (
                rng.uniform(0, 2, (B, S)), rng.integers(1, 5, (B, S)),
                rng.integers(0, 4, (B, S)))]
            dev, g, f = (torch.from_numpy(p).to(device) for p in planes)
            cols = dict(dev=dev, g=g, n=torch.from_numpy(n).to(device))
            guard = (cols["n"] > 0).float()
            mask = torch.from_numpy((rng.uniform(size=B) > 0.2).astype(np.float32)).to(device)
            bias = torch.from_numpy(rng.uniform(0, 0.1, B).astype(np.float32)).to(device)
            tag = f"B{B}S{S}"
            kw = dict(lam=LAM, g_free=16, M=16)
            solo_vs_plain(diff, cols, kw, tag)
            solo_vs_plain(diff, cols, dict(kw, f=f, lam_f=0.1, bias=bias, mask=mask), tag + "+fbm")
            solo_vs_plain(diff, cols, kw, tag, guard=guard)
            solo_vs_plain(diff, cols, dict(kw, f=f, lam_f=0.1, bias=bias, mask=mask),
                          tag + "+fbm", guard=guard)
            if B in (257, 8193):
                _, b_dead = solo_vs_plain(diff, cols, dict(kw, mask=torch.zeros_like(mask)),
                                          tag + "+dead", guard=guard)
                check(b_dead == -1, f"{tag}: all-infeasible gave {b_dead}")
                solo_vs_plain(diff, cols, dict(kw, mask=mask), tag + "+deadguard",
                              guard=torch.zeros_like(guard))
        if B in (1321, 70000):  # tie-heavy: few distinct slot values
            n = rng.integers(0, 3, B).astype(np.float32)
            slot = np.arange(2)[None, :] < n[:, None]
            dev = np.where(slot, rng.integers(0, 2, (B, 2)) * 0.5, 0).astype(np.float32)
            g = np.where(slot, rng.integers(1, 3, (B, 2)), 0).astype(np.float32)
            cols = {k: torch.from_numpy(a).to(device) for k, a in (("dev", dev), ("g", g), ("n", n))}
            s_t, _ = solo_vs_plain(diff, cols, dict(lam=LAM, g_free=4, M=8), f"B{B} ties",
                                   guard=(cols["n"] > 0).float())
            check(int((s_t == s_t.min()).sum()) > 1, f"B{B} ties: no tie to break")
        if B in (257, 6181):
            parts = np.split(np.arange(B), [B // 3, B // 3, 2 * B // 3])  # one empty
            wreqs = [dict(dev=planes[0][p], g=planes[1][p], n=n[p], f=planes[2][p],
                          lam=LAM, g_free=16, M=16, lam_f=0.1) for p in parts]
            multi_vs_plain(diff, wreqs, device, f"B{B} split")
    z = torch.zeros((0, 4), device=device)
    s0, b0 = solo_vs_plain(diff, dict(dev=z, g=z, n=torch.zeros(0, device=device)),
                           dict(lam=LAM, g_free=4, M=4), "B0")
    check(b0 == -1 and s0.numel() == 0, "B=0 must give (empty, -1)")
    # the cross-node batch: D from 1 to 256 nodes, ragged B_k from 0 to
    # 50,000, S from 1 to 8 per node, f / bias / mask each on and off
    for D in (1, 7, 64, 256):
        sizes = rng.integers(0, 2000, D)
        sizes[rng.integers(0, D)] = 50000 if D > 1 else 257
        if D > 1:
            sizes[0] = 0
        for f, bias, mask in ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 1)):
            reqs = ragged_node_reqs(rng, sizes, f=f, bias=bias, mask=mask)
            bests = batch_vs_plain(diff, reqs, device, f"D{D}f{f}b{bias}m{mask}")
            check(D == 1 or bests[0] == -1, "an empty node must give -1")
            if mask:
                guarded_vs_plain(diff, reqs, device, f"D{D}f{f}b{bias}m{mask}",
                                 "score_reduce_batch")
    edge = ragged_node_reqs(rng, [0, 300, 300, 0], f=True, bias=True, mask=False)
    edge[2]["mask"] = np.zeros(300, bool)  # all-infeasible node
    check(batch_vs_plain(diff, edge, device, "edges")[::2] == [-1, -1],
          "empty and all-masked nodes must give -1")
    check(batch_vs_plain(diff, edge[:1], device, "D1 B0") == [-1], "D=1, B=0")
    # empty, all-masked and all-guard-masked nodes with the guard
    edge[0]["guard"] = np.zeros(0, bool)
    edge[1]["guard"] = np.zeros(300, bool)
    for name in ("score_reduce_batch", "score_reduce_multi"):
        guarded_vs_plain(diff, edge, device, "edges", name)
    if device.type == "cuda":  # a fault during the runs surfaces here
        torch.cuda.synchronize()
    return diff


def flash_inputs(case, dtype, device, seed, amp=1.0):
    """Seeded q, k, v of a ``FLASH_CASES`` entry, made on the card; q and k
    times ``amp``."""
    import torch

    B, S, H, KVH, hd = case[:5]
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = [torch.randn((B, S, n, hd), generator=gen, device=device)
               for n in (H, KVH, KVH)]
    return [t.to(dtype) for t in (q * amp, k * amp, v)]


def ssd_inputs(case, dtype, device, seed):
    """Seeded xh, dt, A, Bm, Cm of an ``SSD_CASES`` entry (the reference
    tests' distributions), made on the card."""
    import torch

    B, S, nh, hp, N, _ = case
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def uni(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    return (rnd(B, S, nh, hp).to(dtype), uni(0.001, 0.1, B, S, nh),
            -uni(0.5, 4.0, nh), rnd(B, S, N).to(dtype), rnd(B, S, N).to(dtype))


def tol_share(got, want, tol) -> float:
    """max |got - want| / (tol + tol |want|): 1.0 uses up an allclose at tol."""
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def phase_model_kernels(device, one_pass):
    """``flash_attention`` and ``ssd_scan`` against their plain versions on
    the same card tensors, float32 and bfloat16; ``one_pass`` is the kernel
    library built with ``FLASH_FAULT``, whose float32 flash kernel must
    fail the check.  Returns each kernel's largest max abs error."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SS

    check(not torch.backends.cuda.matmul.allow_tf32,
          "the plain float32 versions must run without TF32 matmuls")
    # "flash_attention" is the bf16 (wgmma) kernel, the float32 one its own;
    # "ssd_scan" the bf16 instantiation of the ssd kernels, float32 its own
    err = {"flash_attention": 0.0, "flash_attention_float32": 0.0, "ssd_scan": 0.0,
           "ssd_scan_float32": 0.0, "flash_by_case": {}}
    hds = set()
    for i, case in enumerate(FLASH_CASES + FLASH_STEEP_CASES):
        steep = i >= len(FLASH_CASES)
        window, softcap, causal = case[5:]
        kw = dict(causal=causal, window=window, softcap=softcap)
        for name, tol in FLASH_TOL.items():
            q, k, v = flash_inputs(case, getattr(torch, name), device, seed=i,
                                   amp=FLASH_STEEP if steep else 1.0)
            got = FA.flash_attention(q, k, v, **kw).double()
            plain = FA.flash_attention_plain(q, k, v, **kw).double()
            want = (FA.flash_attention_plain(q.double(), k.double(), v.double(), **kw)
                    if steep else plain)
            d = float((got - want).abs().max())
            check(torch.allclose(got, want, atol=tol, rtol=tol),
                  f"flash_attention {case} {name}{' steep' * steep}: max abs err {d} "
                  f"(tol {tol})")
            key = "flash_attention" if name == "bfloat16" else "flash_attention_float32"
            err[key] = max(err[key], d)
            if not steep:
                err["flash_by_case"][case, name] = d
            extra = ""
            if steep:  # the kernel and the plain float32 version, each off the exact answer
                extra = (f" (vs float64; share of tol {tol_share(got, want, tol)!r}; plain "
                         f"{name} vs float64 {tol_share(plain, want, tol)!r}, kernel vs "
                         f"plain {name} {tol_share(got, plain, tol)!r})")
            print(f"  flash_attention {case} {name}{' steep' * steep}: "
                  f"max_abs_err={d!r}{extra}")
        hds.add(case[4])
    check(hds == set(FA.HEAD_DIMS), f"flash cases miss head dims {set(FA.HEAD_DIMS) - hds}")
    # planted fault: the kernel with the window ignored must fail the check
    q, k, v = flash_inputs(FLASH_PATH, torch.bfloat16, device, seed=0)
    bad = FA.flash_attention(q, k, v, causal=True, window=0).float()
    want = FA.flash_attention_plain(q, k, v, causal=True, window=FLASH_PATH[5]).float()
    tol = FLASH_TOL["bfloat16"]
    d = float((bad - want).abs().max())
    check(not torch.allclose(bad, want, atol=tol, rtol=tol),
          f"flash_attention: the check missed the planted fault (window ignored), {d}")
    print(f"  flash_attention {FLASH_PATH} bfloat16, window ignored (planted fault): "
          f"max_abs_err={d!r}, caught")
    # planted fault: the float32 kernel with one TF32 pass (lo terms dropped)
    window, softcap, causal = FLASH_PATH[5:]
    kw = dict(causal=causal, window=window, softcap=softcap)
    tol = FLASH_TOL["float32"]
    q, k, v = flash_inputs(FLASH_PATH, torch.float32, device, seed=0)
    bad = FA.launch_with(one_pass, q, k, v, scale=None, **kw)
    want = FA.flash_attention_plain(q, k, v, **kw)
    d = float((bad - want).abs().max())
    check(not torch.allclose(bad, want, atol=tol, rtol=tol),
          f"flash_attention: the check missed the planted fault (one TF32 pass), {d}")
    print(f"  flash_attention {FLASH_PATH} float32, one TF32 pass (planted fault): "
          f"max_abs_err={d!r}, caught")
    for i, case in enumerate(SSD_CASES):
        for name in ("float32", "bfloat16"):
            args = ssd_inputs(case, getattr(torch, name), device, seed=i)
            y, h = SS.ssd_scan(*args, chunk=case[-1])
            yp, hp = SS.ssd_scan_plain(*args, chunk=case[-1])
            d = max(float((y - yp).abs().max()), float((h - hp).abs().max()))
            check(torch.allclose(y, yp, atol=SSD_TOL, rtol=SSD_TOL)
                  and torch.allclose(h, hp, atol=SSD_TOL, rtol=SSD_TOL),
                  f"ssd_scan {case} {name}: max abs err {d} (tol {SSD_TOL})")
            key = "ssd_scan" if name == "bfloat16" else "ssd_scan_float32"
            err[key] = max(err[key], d)
            print(f"  ssd_scan {case} {name}: max_abs_err={d!r}")
    # steep decays, as trained models have them (A_log up to log 16): a
    # 64-row tile then spans exp(-100) and more
    case = (2, 512, 8, 64, 128, 256)
    for name in ("float32", "bfloat16"):
        x, dt, A, Bm, Cm = ssd_inputs(case, getattr(torch, name), device, seed=7)
        dt, A = dt * 5.0, A * 4.0  # dt in [0.005, 0.5], A in [-16, -2]
        y, h = SS.ssd_scan(x, dt, A, Bm, Cm, chunk=case[-1])
        yp, hp = SS.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=case[-1])
        d = max(float((y - yp).abs().max()), float((h - hp).abs().max()))
        check(torch.allclose(y, yp, atol=SSD_TOL, rtol=SSD_TOL)
              and torch.allclose(h, hp, atol=SSD_TOL, rtol=SSD_TOL),
              f"ssd_scan {case} {name} steep decay: max abs err {d} (tol {SSD_TOL})")
        key = "ssd_scan" if name == "bfloat16" else "ssd_scan_float32"
        err[key] = max(err[key], d)
        print(f"  ssd_scan {case} {name} steep decay: max_abs_err={d!r}")
    check({c[3] for c in SSD_CASES} == set(SS.HEAD_DIMS),
          f"ssd cases miss head dims {set(SS.HEAD_DIMS) - {c[3] for c in SSD_CASES}}")
    # planted fault: the state hand-off dropped, every chunk of the kernel
    # scanned from a zero state, must fail the check
    B, S, nh, hp, N, Q = SSD_PATH
    x, dt, A, Bm, Cm = ssd_inputs(SSD_PATH, torch.bfloat16, device, seed=0)
    bad = torch.cat([SS.ssd_scan(x[:, c:c + Q].contiguous(), dt[:, c:c + Q].contiguous(), A,
                                 Bm[:, c:c + Q].contiguous(), Cm[:, c:c + Q].contiguous(),
                                 chunk=Q)[0] for c in range(0, S, Q)], dim=1)
    want = SS.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=Q)[0]
    d = float((bad - want).abs().max())
    check(not torch.allclose(bad, want, atol=SSD_TOL, rtol=SSD_TOL),
          f"ssd_scan: the check missed the planted fault (state hand-off dropped), {d}")
    print(f"  ssd_scan {SSD_PATH} bfloat16, state hand-off dropped (planted fault): "
          f"max_abs_err={d!r}, caught")
    if device.type == "cuda":
        torch.cuda.synchronize()
    return err


# ---------------------------------------------------------------------------
# Phases 3-5: the main path
# ---------------------------------------------------------------------------


def timed_policy_class():
    from repro_torch.core import EcoSched

    class TimedEcoSched(EcoSched):
        """EcoSched that records each decision's host time and keeps the
        largest kernel inputs the run produced (for phase 6)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.times = []
            self.largest = None  # (rows, batch, g_free, M, lam_f)
            self.largest_multi = None  # (rows, reqs)

        def on_event(self, view, waiting):
            t0 = time.perf_counter()
            out = super().on_event(view, waiting)
            self.times.append(time.perf_counter() - t0)
            dec = self._last_decision
            if dec is not None and (self.largest is None or len(dec[0]) > self.largest[0]):
                self.largest = (len(dec[0]), dec[0], view.free_units,
                                view.alive_units, self.lam_f)
            return out

        def _resize_requests(self, cands, switch_cost):
            reqs = super()._resize_requests(cands, switch_cost)
            rows = sum(len(r["n"]) for r in reqs)
            if self.largest_multi is None or rows > self.largest_multi[0]:
                self.largest_multi = (rows, reqs)
            return reqs

    return TimedEcoSched


class MainPath:
    """What the main-path phases launched (summed over their torch runs)
    and the largest kernel inputs they produced."""

    def __init__(self):
        self.launches = {k: {"launches": 0, "rows": 0, "max_rows": 0, "guarded": 0}
                         for k in KERNELS}
        self.solo = None  # (rows, batch, g_free, M, lam_f)
        self.multi = None  # (rows, reqs)
        self.pod = None  # the pod run's largest solo inputs
        self.batch = None  # (rows, nodes, packed kwargs) of the fleet

    def add(self, stats, pol=None):
        for name, st in stats.items():
            tot = self.launches[name]
            tot["launches"] += st["launches"]
            tot["guarded"] += st["guarded"]
            tot["rows"] += st["rows"]
            tot["max_rows"] = max(tot["max_rows"], st["max_rows"])
        if pol is None:
            return
        if pol.largest and (self.solo is None or pol.largest[0] > self.solo[0]):
            self.solo = pol.largest
        if pol.largest_multi and (self.multi is None
                                  or pol.largest_multi[0] > self.multi[0]):
            self.multi = pol.largest_multi


def fp(res):
    import hashlib

    s = ";".join(f"{r.job}|{r.g}|{r.f}|{r.start!r}|{r.end!r}|{r.domain}|{r.kind}"
                 for r in res.records)
    return hashlib.md5(s.encode()).hexdigest(), res.makespan, res.total_energy


def read_stats():
    from repro_torch.kernels import score_reduce as K

    return {k: dict(launches=v.launches, rows=v.rows, max_rows=v.max_rows,
                    windows=v.windows, max_windows=v.max_windows,
                    guarded=v.guarded)
            for k, v in K.STATS.items()}


def run_pair(truth, node, *, sim_kw, pol_kw, device, label, path,
             noise=NOISE, seed=SEED):
    """One workload through the torch engine (on ``device``) and the numpy
    engine; checks the schedules are identical and the result sane.  The
    launch counts are set to 0 just before the torch run and read just
    after it."""
    import math
    from repro_torch.core import ProfiledPerfModel, simulate
    from repro_torch.kernels import score_reduce as K

    Timed = timed_policy_class()
    out = {}
    for engine in ("torch", "vector"):
        extra = {"device": device} if engine == "torch" else {}
        pol = Timed(ProfiledPerfModel(truth, noise=noise, seed=seed), lam=LAM, tau=TAU,
                    engine=engine, **extra, **pol_kw)
        if engine == "torch":
            K.reset_stats()
        res = simulate(pol, node, truth, **sim_kw)
        if engine == "torch":
            kstats = read_stats()
            path.add(kstats, pol)
        out[engine] = (res, pol)
    (rt, pt), (rv, pv) = out["torch"], out["vector"]
    check(fp(rt) == fp(rv), f"{label}: torch schedule differs from vector {fp(rt)} {fp(rv)}")
    check(math.isfinite(rt.total_energy) and rt.total_energy > 0 and rt.makespan > 0,
          f"{label}: energy/makespan not finite and positive")
    jobs = {a for _, a in sim_kw["arrivals"]} if "arrivals" in sim_kw else set(sim_kw["queue"])
    check({r.job for r in rt.records if r.kind == "run"} == jobs, f"{label}: not all jobs ran")
    print(f"  {label}: fp={fp(rt)[0]} makespan={rt.makespan!r} energy={rt.total_energy!r} "
          f"decisions={len(pt.times)} "
          f"launches={ {k: v['launches'] for k, v in kstats.items()} } "
          f"score_reduce_guarded_calls={kstats['score_reduce']['guarded']}")
    return rt, pt, pv, kstats


def phase_paper(device, path):
    from repro_torch.core import Node, SequentialOptimal, simulate, summarize
    from repro_torch.core import calibration as C

    for system, levels, lam_f in (("h100", 1, 0.0), ("a100", 1, 0.0),
                                  ("v100", 1, 0.0), ("h100", 4, 0.1)):
        truth = C.build_system(system, freq_levels=levels)
        node = Node(4, 2, C.idle_power(system))
        base = simulate(SequentialOptimal(truth), node, truth, queue=list(C.APP_ORDER))
        label = f"{system} freq_levels={levels} lam_f={lam_f}"
        rt, _, _, st = run_pair(
            truth, node, device=device, label=label, path=path,
            pol_kw=dict(lam_f=lam_f),
            sim_kw=dict(queue=list(C.APP_ORDER), charge_profiling=True,
                        slowdown_model=C.cross_numa_slowdown),
        )
        check(st["score_reduce"]["launches"] > 0, f"{label}: no score_reduce launch")
        # the idle node's first decision carries the guard in its one call
        check(st["score_reduce"]["guarded"] > 0, f"{label}: no guarded score_reduce call")
        s = summarize(base, rt)
        print(f"  {label} vs sequential_optimal_gpu: energy_saving={s['energy_saving']!r} "
              f"makespan_improvement={s['makespan_improvement']!r} "
              f"edp_saving={s['edp_saving']!r}")
        if levels > 1:
            check(any(r.f > 0 for r in rt.records), "DVFS run chose no lower level")


def phase_elastic(device, path):
    from repro_torch.core import ElasticConfig, JobProfile, Node
    from repro_torch.core import calibration as C

    truth = C.build_system("h100", freq_levels=3)
    stream = [(120.0 * i, a) for i, a in enumerate(C.APP_ORDER)]
    for batched in (True, False):
        _, _, _, st = run_pair(
            truth, Node(4, 2, C.idle_power("h100")), device=device, path=path,
            label=f"h100 DVFS elastic resize_batch={batched}",
            pol_kw=dict(resize_batch=batched),
            sim_kw=dict(arrivals=stream, slowdown_model=C.cross_numa_slowdown,
                        elastic=ElasticConfig(resize=True)),
        )
        if batched:
            check(st["score_reduce_multi"]["launches"] > 0,
                  "batched elastic run launched no score_reduce_multi")
    # a pair where a completion makes the co-runner's upsize worth it
    pair = {
        "A": ({1: 3500.0, 2: 2000.0, 3: 1600.0, 4: 1450.0},
              {1: 140.0, 2: 250.0, 3: 330.0, 4: 380.0}),
        "B": ({1: 1050.0, 2: 600.0, 4: 435.0}, {1: 140.0, 2: 250.0, 4: 380.0}),
    }
    truth = {k: JobProfile(name=k, runtime=t, busy_power=p,
                           dram_util={g: 1.0 / (t[g] * g) for g in t})
             for k, (t, p) in pair.items()}
    cfg = ElasticConfig(resize=True, ckpt_time=30.0, restart_time=15.0, min_gain_s=60.0)
    for batched in (True, False):
        rt, _, _, _ = run_pair(
            truth, Node(4, 2, 10.0), device=device, path=path,
            label=f"resize pair resize_batch={batched}", noise=0.0, seed=0,
            pol_kw=dict(resize_batch=batched), sim_kw=dict(queue=["A", "B"], elastic=cfg),
        )
        check(rt.resizes > 0, "resize pair did not resize")


def phase_pod(device, path):
    from repro_torch.core import Node

    truth, stream = pod_truth(POD_JOBS)
    _, pt, pv, kstats = run_pair(
        truth, Node(16, 4, 70.0), device=device, path=path,
        label=f"pod M=16 K=4 jobs={POD_JOBS} levels=4 window=17",
        pol_kw=dict(window=17), sim_kw=dict(arrivals=stream),
    )
    st = kstats["score_reduce"]
    n_launch = st["launches"]
    check(n_launch > 0, "pod run launched no score_reduce")
    med_t = statistics.median(pt.times) * 1e6
    med_v = statistics.median(pv.times) * 1e6
    print(f"  pod: decisions={len(pt.times)} kernel_launches={n_launch} "
          f"guarded_calls={st['guarded']} "
          f"rows_per_launch max={st['max_rows']} "
          f"mean={st['rows'] / n_launch!r} median_us_per_decision torch={med_t!r} "
          f"vector={med_v!r} launch_hits={pt.launch_hits} frontier_hits={pt.frontier_hits}")
    path.pod = pt.largest


# ---------------------------------------------------------------------------
# Phase 6: the fleet path, 256 nodes
# ---------------------------------------------------------------------------


def fleet_cluster(engine, device, truth, hier, policies, **pol_kw):
    """bench_fleet's 256-node fleet under ``EnergyAwareDispatcher``, flat or
    wrapped in ``HierarchicalDispatcher`` (16-node pods, 8 per region)."""
    from repro_torch.core import (Cluster, EcoSched, EnergyAwareDispatcher,
                                  HierarchicalDispatcher, NodeSpec, ProfiledPerfModel)
    from repro_torch.roofline.hw import A100, H100, V100

    chips = (H100, A100, V100)
    extra = {"device": device} if engine == "torch" else {}

    def policy_for(spec, t):
        pol = EcoSched(ProfiledPerfModel(t, noise=0.0, seed=1), lam=LAM, tau=TAU,
                       window=FLEET_WINDOW, engine=engine, **extra, **pol_kw)
        policies.append(pol)
        return pol

    disp = EnergyAwareDispatcher()
    if hier:
        disp = HierarchicalDispatcher(disp, pod_size=POD_SIZE,
                                      pods_per_region=PODS_PER_REGION)
    return Cluster(
        [NodeSpec(f"n{i:04d}", chips[(i // POD_SIZE) % len(chips)], units=FLEET_M,
                  domains=FLEET_K) for i in range(FLEET_NODES)],
        truth_for=lambda spec: truth[spec.chip.name], policy_for=policy_for,
        dispatcher=disp,
    )


def fleet_fp(res):
    import hashlib

    s = ";".join(f"{r.job}|{r.node}|{r.g}|{r.f}|{r.start!r}|{r.end!r}|{r.kind}|{r.segment}"
                 for r in res.records)
    return hashlib.md5(s.encode()).hexdigest(), res.makespan, res.total_energy


class LargestBatch:
    """Keeps the packed inputs of the largest ``score_reduce_batch`` call
    the fleet coordinator makes (rows, then nodes), for phase 7.  Wraps the
    name ``repro_torch.core.cluster`` calls; the launch count stays the
    wrapper's own."""

    def __init__(self, path):
        self.path = path

    def __enter__(self):
        import repro_torch.core.cluster as CL

        self.real = real = CL.score_reduce_batch
        path = self.path

        def recording(dev, g, n, offsets, params, **kw):
            key = (dev.shape[0], params.shape[0])
            if path.batch is None or key > path.batch[:2]:
                path.batch = key + (dict(dev=dev, g=g, n=n, offsets=offsets,
                                         params=params, **kw),)
            return real(dev, g, n, offsets, params, **kw)

        CL.score_reduce_batch = recording
        return self

    def __exit__(self, *exc):
        import repro_torch.core.cluster as CL

        CL.score_reduce_batch = self.real


class BurstLaunches:
    """Counts the packed launches each staged burst of the fleet
    coordinator makes (``ClusterRun._stage_arrival_batch`` and
    ``_stage_complete_batch``), from the wrappers' own counts: with the
    idle-node guard folded into the packed launch, a burst makes at most
    one, and no second round."""

    def __init__(self):
        self.per_burst = []

    def __enter__(self):
        import repro_torch.core.cluster as CL
        from repro_torch.kernels import score_reduce as K

        self.real = {m: getattr(CL.ClusterRun, m)
                     for m in ("_stage_arrival_batch", "_stage_complete_batch")}
        per_burst = self.per_burst

        def packed():
            return K.STATS["score_reduce_batch"].launches + K.STATS["score_reduce_multi"].launches

        def wrap(real):
            def staging(run, *a, **kw):
                n0 = packed()
                try:
                    return real(run, *a, **kw)
                finally:
                    per_burst.append(packed() - n0)
            return staging

        for m, real in self.real.items():
            setattr(CL.ClusterRun, m, wrap(real))
        return self

    def __exit__(self, *exc):
        import repro_torch.core.cluster as CL

        for m, real in self.real.items():
            setattr(CL.ClusterRun, m, real)


def fleet_leg(cell, engine, device, *, hier, staged=True, path=None):
    """One run of a fleet cell through the user entry points.  ``cell`` is
    "arrivals" (``Cluster.simulate``) or "elastic" (``Cluster.open_run``
    with resizing, a shared DecisionCache when ``staged``; the solo leg is
    bench_fleet's pre-batching reference: per-job resize loop, no
    COMPLETE staging, private caches, no tie-frontier sharing).  With
    ``path`` the launch counts are set to 0 just before the run, read just
    after and added to the main path's.  Returns (result, seconds,
    policies, counts)."""
    import math

    from repro_torch.core import DecisionCache, ElasticConfig, bursty_stream
    from repro_torch.core.events import EVT_ARRIVAL
    from repro_torch.kernels import score_reduce as K
    from repro_torch.roofline.hw import A100, H100, V100

    pols = []
    apps = [f"app{i}" for i in range(FLEET_APPS)]
    if cell == "arrivals":
        truth = {c.name: synth_apps(c) for c in (H100, A100, V100)}
        cl = fleet_cluster(engine, device, truth, hier, pols, cache=True)
        stream = bursty_stream(apps, rate=4.8, n=FLEET_JOBS, seed=7, burst=16)
    else:
        truth = {c.name: synth_elastic_apps(c) for c in (H100, A100, V100)}
        kw = (dict(cache=DecisionCache(), resize_batch=True) if staged else
              dict(cache=True, resize_batch=False, launch_share=False))
        cl = fleet_cluster(engine, device, truth, hier, pols, **kw)
        stream = sorted(bursty_stream(apps, rate=2.4, n=FLEET_JOBS, seed=7, burst=16),
                        key=lambda a: a.t)
    if path is not None:
        K.reset_stats()
    t0 = time.perf_counter()
    if cell == "arrivals":
        res = cl.simulate(stream)
    else:
        run = cl.open_run(apps=apps, jobs=[(a.name, a.app) for a in stream],
                          elastic=ElasticConfig(resize=True, resize_before_backfill=True))
        if not staged:
            run.loop.prepare_complete = None
        for a in stream:
            if a.t <= 0.0:
                run.route(a, 0.0)
            else:
                run.loop.queue.push(a.t, EVT_ARRIVAL, a)
        run.loop.run()
        res = run.finalize()
    sync(device)
    secs = time.perf_counter() - t0
    counts = read_stats() if path is not None else None
    if path is not None:
        path.add(counts)
    check(math.isfinite(res.total_energy) and res.total_energy > 0 and res.makespan > 0,
          f"fleet {cell}: energy/makespan not finite and positive")
    check({r.job for r in res.records} == {a.name for a in stream},
          f"fleet {cell}: not every job ran")
    return res, secs, pols, counts


def phase_fleet(device, path):
    """Both 256-node cells: the torch engine on the card against the numpy
    engine, hierarchical against flat dispatch, batched against solo;
    then the arrivals cell once more under the profiler."""
    out = {}
    bursts = BurstLaunches()
    with LargestBatch(path), bursts:
        for cell, legs in (
            # the engines in turns (torch, vector, vector, torch), so a
            # slow stretch of the shared host hits both
            ("arrivals", (("torch", True, True), ("vector", True, True),
                          ("vector", False, True), ("torch", False, True))),
            ("elastic", (("torch", True, True), ("vector", True, True),
                         ("torch", True, False), ("torch", False, True))),
        ):
            for engine, hier, staged in legs:
                tag = (f"{cell} {engine} {'hier' if hier else 'flat'} "
                       f"{'batched' if staged else 'solo'}")
                res, secs, pols, counts = fleet_leg(
                    cell, engine, device, hier=hier, staged=staged,
                    path=path if engine == "torch" else None)
                out[(cell, engine, hier, staged)] = (res, pols, counts)
                served = sum(p.stage_served for p in pols)
                rserved = sum(p.resize_stage_served for p in pols)
                # events as bench_fleet counts them: routing decisions
                # plus each job's launch and completion
                print(f"  fleet_{cell}_n{FLEET_NODES} {tag}: fp={fleet_fp(res)[0]} "
                      f"makespan={res.makespan!r} energy={res.total_energy!r} "
                      f"seconds={secs!r} "
                      f"events_per_s={(res.decision_events + 2 * FLEET_JOBS) / secs!r} "
                      f"decisions={res.decision_events} resizes={res.resizes} "
                      f"stage_served={served} resize_stage_served={rserved}")
                print(f"    decision_phases_s={ {k: round(v, 6) for k, v in res.decision_phases.items()} }")
                if counts is not None:
                    for k in ("score_reduce_batch", "score_reduce_multi", "score_reduce"):
                        c = counts[k]
                        n = max(c["launches"], 1)
                        print(f"    {k}: launches={c['launches']} "
                              f"guarded_segments={c['guarded']} "
                              f"nodes_or_windows_per_launch max={c['max_windows']} "
                              f"mean={c['windows'] / n!r} rows_per_launch "
                              f"max={c['max_rows']} mean={c['rows'] / n!r}")
            keys = [k for k in out if k[0] == cell]
            fps = {k: fleet_fp(out[k][0]) for k in keys}
            check(len(set(fps.values())) == 1,
                  f"fleet {cell}: schedules differ across legs {fps}")
    # each cell's own counts: ARRIVAL bursts reach score_reduce_batch and
    # COMPLETE bursts score_reduce_multi, in both cells
    for cell in ("arrivals", "elastic"):
        for hier in (True, False):
            counts = out[(cell, "torch", hier, True)][2]
            for k in ("score_reduce_batch", "score_reduce_multi"):
                check(counts[k]["launches"] > 0,
                      f"{cell} cell ({'hier' if hier else 'flat'}) launched no {k}")
    # the idle-node guard rides in the burst's one packed launch: no burst
    # makes a second, and the guard is carried
    launched = [n for n in bursts.per_burst if n]
    print(f"  staged bursts that launched: {len(launched)}, packed launches per burst "
          f"max={max(launched, default=0)} (second rounds: {sum(n - 1 for n in launched)})")
    check(launched and max(launched) == 1, "a staged burst made more than one packed launch")
    arr = out[("arrivals", "torch", True, True)]
    check(sum(p.stage_served for p in arr[1]) > 0, "arrivals cell served no staged decision")
    check(arr[2]["score_reduce_batch"]["guarded"] > 0 and arr[2]["score_reduce_multi"]["guarded"] > 0,
          "arrivals cell carried no idle-node guard in its packed launches")
    el = out[("elastic", "torch", True, True)]
    check(sum(p.resize_stage_served for p in el[1]) > 0,
          "elastic cell served no staged resize")
    check(el[0].resizes > 0, "elastic cell resized nothing")

    # the arrivals cell's torch run again, under the profiler: device
    # busy and idle share of the whole fleet run
    wall, avgs = profiled(lambda: fleet_leg("arrivals", "torch", device, hier=True))
    dev = device_kernels(avgs)
    busy = sum(us for _, us in dev.values()) * 1e-6
    if busy > 0:
        print(f"  fleet_arrivals_n{FLEET_NODES} torch hier under the profiler: "
              f"wall_s={wall!r} device_busy_s={busy!r} idle_share={1.0 - busy / wall!r}")
        for name, (count, us) in sorted(dev.items()):
            print(f"    profiler device: {name[:60]} count={count} "
                  f"us_per_launch={us / count!r}")
    else:
        print("  fleet run under the profiler: device busy share not measured")


# ---------------------------------------------------------------------------
# Phase 7: times at the main path's largest shapes
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps):
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def host_us(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e6


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_solo(device, B, batch, g_free, M, lam_f):
    """Times of ``score_reduce`` on one main-path batch: back-to-back raw
    launches between CUDA events (``ms``, device time per launch), the
    plain version (``plain_ms``), and the wrapper's host-clock call time
    including its one D2H read, without and with the idle-node guard
    (``call_us``, ``guarded_call_us``)."""
    import ctypes

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import score_reduce as K

    lib = _build.library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    cols = batch.device_cols(device, with_f=bool(lam_f))
    S = cols["dev"].shape[1]
    f = cols["f"]
    kw = dict(lam=LAM, g_free=g_free, M=M, f=f, lam_f=lam_f)
    check(B <= K._ROWS_PER_BLOCK, f"main-path block of {B} rows is not one block")
    out = torch.empty(B + 2, device=device)  # scores, then the two winners

    pinned = torch.empty(2, dtype=torch.int32, pin_memory=True)

    def raw(host=None):
        err = lib.score_reduce_launch(
            cols["dev"].data_ptr(), cols["g"].data_ptr(),
            None if f is None else f.data_ptr(), cols["n"].data_ptr(), None, None,
            cols["nonempty"].data_ptr(), B, S, LAM, float(g_free), float(M),
            float(lam_f), out.data_ptr(), None, host, stream)
        check(err == 0, f"raw score_reduce launch error {err}")

    # the two ways to read the winners back after the launch: copied into
    # pinned memory and synchronised inside the C call (the wrapper's), or
    # .tolist() of the device pair; in turns
    def read_in_call():
        raw(pinned.data_ptr())
        return pinned.tolist()

    def read_tolist():
        raw()
        return out[B:B + 2].view(torch.int32).tolist()

    reads = [host_us(fn, 2000) for fn in (read_in_call, read_tolist, read_tolist, read_in_call)]

    args = (cols["dev"], cols["g"], cols["n"])
    planes = 2 + (f is not None)
    # planes, n and the guard in; scores and two winners out
    n_bytes = 4 * (planes * B * S + 2 * B) + 4 * B + 8
    bms, bby = bound_ms(n_bytes, B * (3 * S + 9))
    return dict(
        B=B, S=S, ms=cuda_ms(raw, 2000),
        plain_ms=cuda_ms(lambda: K.score_reduce_plain(*args, guard=cols["nonempty"], **kw), 200),
        call_us=host_us(lambda: K.score_reduce(*args, **kw), 2000),
        guarded_call_us=host_us(lambda: K.score_reduce(*args, guard=cols["nonempty"], **kw), 2000),
        launch_read_in_call_us=[reads[0], reads[3]], launch_read_tolist_us=[reads[1], reads[2]],
        bound_ms=bms, bound_by=bby,
    )


def time_packed(device, name, p):
    """The same times for ``score_reduce_multi`` or ``score_reduce_batch``
    (one kernel, one block per packed segment) on packed device inputs as
    the path passed them, with the idle-node guard on every segment (its
    non-empty rows) as the fleet's idle nodes carry it: raw launches
    between CUDA events (``ms``), the plain version, and the wrapper's
    host-clock call with its in-call read of the winners, without and with
    the guard (``call_us``, ``guarded_call_us``).  Packing and upload stay
    outside the timed calls."""
    import ctypes

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import score_reduce as K

    lib = _build.library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    (rows, S), W = p["dev"].shape, p["params"].shape[0]
    p = {k: v for k, v in p.items() if k not in ("guard", "guarded")}
    guard = (p["n"] > 0).float()
    out = torch.empty(rows + 2 * W, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def raw():
        err = lib.score_reduce_multi_launch(
            ptr(p["dev"]), ptr(p["g"]), ptr(p["f"]), ptr(p["n"]), ptr(p["bias"]),
            ptr(p["mask"]), guard.data_ptr(), ptr(p["offsets"]), ptr(p["params"]), W, rows,
            S, out.data_ptr(), None, stream)
        check(err == 0, f"raw {name} launch error {err}")

    planes = 2 + (p["f"] is not None)
    cols_in = 2 + (p["bias"] is not None) + (p["mask"] is not None)
    # each input read once (planes, columns with the guard, offsets,
    # params), scores and two winners per segment written once
    n_bytes = (4 * (planes * rows * S + cols_in * rows + (W + 1) + 4 * W)
               + 4 * (rows + 2 * W))
    bms, bby = bound_ms(n_bytes, rows * (3 * S + 10))
    fn = getattr(K, name)
    return dict(
        B=rows, S=S, ms=cuda_ms(raw, 2000),
        plain_ms=cuda_ms(lambda: getattr(K, name + "_plain")(**p, guard=guard), 20),
        call_us=host_us(lambda: fn(**p), 2000),
        guarded_call_us=host_us(lambda: fn(**p, guard=guard), 2000),
        bound_ms=bms, bound_by=bby,
        **{"D" if name == "score_reduce_batch" else "W": W},
    )


def profiled(fn, kernels=(), reps=0, launched=None):
    """Run ``fn`` under ``torch.profiler`` (CPU + CUDA); returns the host
    wall seconds and the key averages of everything that ran.  Where
    ``kernels`` names kernels that ``fn`` launches ``reps`` times each,
    ``launched`` gives the counts of the wrappers that launch them, and
    each must move by exactly ``reps`` in a profiled run: that is the
    launch count, held exactly.  The profiler can lose a record (it has
    listed 2 and 3 of 10 ``flash_kernel_wgmma`` launches, twice running,
    and 199 of 200 ``score_windows_kernel`` ones, while the wrapper's
    count was exact), but it cannot add one: a kernel listed more times
    than the wrappers launched it fails.  A profile that lists fewer is
    taken once more and the line says so; the fuller of the two is
    returned, and the callers give device time per listed launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    best = None
    for attempt in range(2 if kernels else 1):
        torch.cuda.synchronize()
        before = launched() if launched else ()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        moved = [b - a for a, b in zip(before, launched())] if launched else []
        check(moved == [reps] * len(moved),
              f"wrappers launched {moved} times for {reps} calls of {kernels}")
        avgs = prof.key_averages()
        dev = device_kernels(avgs)
        counts = {n: sum(c for k, (c, _) in dev.items() if n in k) for n in kernels}
        check(all(c <= reps for c in counts.values()),
              f"profiler lists launches {counts} for {reps} calls")
        if best is None or sum(counts.values()) > best[0]:
            best = (sum(counts.values()), wall, avgs)
        if all(c == reps for c in counts.values()):
            break
        print(f"  profiler: launches {counts} listed for {reps} calls"
              + ("; profiled once more" if attempt == 0 else "; device us per listed launch"))
    return best[1], best[2]


def device_kernels(avgs):
    """{name: (count, device µs in total)} of the device-side entries
    (kernels and copies).  The host operators that issued them report the
    same device time again as their own, so only entries whose device
    type is CUDA are kept: each device interval is counted once."""
    from torch.autograd import DeviceType

    return {e.key: (e.count, e.self_device_time_total) for e in avgs
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def profile_lines(device, path):
    """Device time of each kernel per launch, the wrapper's host time by
    operation, and the pod run's device busy share, all from the profiler
    (printed; "not measured" when it saw no device activity)."""
    from repro_torch.core import Node, ProfiledPerfModel, simulate
    from repro_torch.kernels import score_reduce as K

    B, batch, g_free, M, lam_f = path.solo
    cols = batch.device_cols(device, with_f=bool(lam_f))
    kw = dict(lam=LAM, g_free=g_free, M=M, f=cols["f"], lam_f=lam_f)
    args = (cols["dev"], cols["g"], cols["n"])
    reps = 200
    packed = K.pack_windows(path.multi[1], device)

    def calls():
        for _ in range(reps):
            K.score_reduce(*args, **kw)
            K.score_reduce_multi(**packed)

    # one score_reduce call is one launch of one kernel, and so is one
    # score_reduce_multi call
    _, avgs = profiled(calls, ("score_reduce_kernel", "score_windows_kernel"), reps,
                       lambda: (K.STATS["score_reduce"].launches,
                                K.STATS["score_reduce_multi"].launches))
    dev = device_kernels(avgs)
    if not dev:
        print("  profiler: no device time seen; kernel device us not measured")
    for name, (count, us) in sorted(dev.items()):
        print(f"  profiler device: {name[:60]} count={count} us_per_launch={us / count!r}")
    top = sorted(avgs, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    print("  profiler host, per score_reduce + score_reduce_multi call: " + ", ".join(
        f"{e.key}={e.self_cpu_time_total / reps!r}us" for e in top))

    # shares score_windows_kernel, so profiled alone: with the guard (the
    # non-empty rows of every node) and without, one launch a call each
    batch = {k: v for k, v in path.batch[2].items() if k not in ("guard", "guarded")}
    guard = (batch["n"] > 0).float()
    for tag, kw in (("", {}), (" with the guard", {"guard": guard})):
        _, avgs = profiled(lambda: [K.score_reduce_batch(**batch, **kw) for _ in range(reps)],
                           ("score_windows_kernel",), reps,
                           lambda: (K.STATS["score_reduce_batch"].launches,))
        dev = device_kernels(avgs)
        for name, (count, us) in sorted(dev.items()):
            print(f"  profiler device, score_reduce_batch alone{tag}: {name[:60]} "
                  f"count={count} us_per_launch={us / count!r}")

    truth, stream = pod_truth(POD_JOBS)
    pol = timed_policy_class()(ProfiledPerfModel(truth, noise=NOISE, seed=SEED),
                               lam=LAM, tau=TAU, engine="torch", device=device,
                               window=17)
    wall, avgs = profiled(lambda: simulate(pol, Node(16, 4, 70.0), truth, arrivals=stream))
    busy = sum(us for _, us in device_kernels(avgs).values()) * 1e-6
    if busy > 0:
        print(f"  pod run under the profiler: wall_s={wall!r} device_busy_s={busy!r} "
              f"idle_share={1.0 - busy / wall!r}")
    else:
        print("  pod run under the profiler: device busy share not measured")


def phase_timings(device, path, diff):
    import torch
    from repro_torch.kernels import score_reduce as K

    t = time_solo(device, *path.pod)
    print(f"  pod run's largest score_reduce: B={t['B']} S={t['S']} "
          f"kernel_ms={t['ms']!r} wrapper_call_us={t['call_us']!r}")
    rows = {"score_reduce": time_solo(device, *path.solo),
            "score_reduce_batch": time_packed(device, "score_reduce_batch",
                                              path.batch[2]),
            "score_reduce_multi": time_packed(device, "score_reduce_multi",
                                              K.pack_windows(path.multi[1], device))}
    replaces = {"score_reduce": "src/repro/kernels/score_reduce.py:138",
                "score_reduce_batch": "src/repro/kernels/score_reduce.py:255",
                "score_reduce_multi": "src/repro/kernels/score_reduce.py:374"}
    kernels = []
    for name, t in rows.items():
        extra = "".join(f" {k}={t[k]}" for k in ("D", "W") if k in t)
        extra += f" guarded_wrapper_call_us={t['guarded_call_us']!r}"
        if "launch_read_in_call_us" in t:
            extra += (f" launch+read_us: in-call pinned copy {t['launch_read_in_call_us']!r},"
                      f" tolist {t['launch_read_tolist_us']!r}")
        print(f"  {name} at B={t['B']} S={t['S']}{extra}: "
              f"kernel_ms={t['ms']!r} plain_ms={t['plain_ms']!r} "
              f"wrapper_call_us={t['call_us']!r} (with its D2H read) "
              f"bound_ms={t['bound_ms']!r} ({t['bound_by']})")
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/score_reduce.cu",
            replaces=replaces[name], launches=path.launches[name]["launches"],
            max_abs_err=diff.max_abs[name], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None))

    # the launch-latency floor of one call: one tiny launch and one read of
    # two ints back
    x = torch.zeros(2, dtype=torch.int32, device=device)

    def floor():
        x.add_(1)
        return x.tolist()

    print(f"  floor (one 2-element launch + one D2H read of two ints): "
          f"call_us={host_us(floor, 2000)!r}")
    profile_lines(device, path)
    return kernels


def flash_ops(B, S, H, hd, window, causal):
    """Operations of one flash_attention call with Sq = Skv = S: 4*hd
    (q.k and p.v, a multiply and an add each) for every unmasked
    (query, key) pair of every batch row and query head."""
    pairs = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = i + 1 if causal else S
        pairs += hi - lo
    return pairs * B * H * 4 * hd


def time_flash(device, dtype="bfloat16", case=FLASH_PATH):
    """``flash_attention`` at ``case`` (hymba-1.5b's prefill shape unless
    given): the kernel by CUDA events, its plain version, and
    ``scaled_dot_product_attention`` with ``enable_gqa`` and the window as
    a boolean mask (without a window: ``is_causal``) as the library
    yardstick, in turns.  bf16 (the serving type) runs the wgmma kernel,
    float32 the three-pass TF32 kernel (its pre-pass included).  The bound
    counts the work the function needs, once, at the card's fastest rate
    for its operand type: bf16 at 989 TFLOP/s, float32 at 495 TFLOP/s
    (TF32), against the bytes.  Beside it, float32's ``bound_ms_issued``
    counts the three TF32 passes the kernel issues and
    ``bound_ms_cuda_cores`` the work once at the 67 TFLOP/s of float32
    outside the tensor cores.  ``library_kernel`` names the kernel SDPA ran
    (the yardstick), ``library_device_us`` its device µs a launch, from
    ``torch.profiler``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    B, S, H, KVH, hd, window, softcap, causal = case
    check(softcap == 0.0, f"time_flash: SDPA has no softcap, case {case}")
    q, k, v = flash_inputs(case, getattr(torch, dtype), device, seed=99)
    kw = dict(causal=causal, window=window, softcap=softcap)
    qp = torch.arange(S, device=device)
    if window:
        mask = (qp[None, :] <= qp[:, None]) & (qp[None, :] > qp[:, None] - window)
        sdpa_kw = dict(attn_mask=mask)
    else:
        sdpa_kw = dict(is_causal=causal)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa_kw)

    def kern():
        return FA.flash_attention(q, k, v, **kw)

    lib_err = float((sdpa().transpose(1, 2).float() - kern().float()).abs().max())
    ops = flash_ops(B, S, H, hd, window, causal)
    size = q.element_size()
    n_bytes = size * (2 * B * S * H * hd + 2 * B * S * KVH * hd)  # q, o; k, v
    passes, rate = (1, BF16_OPS_PER_S) if dtype == "bfloat16" else (3, TF32_OPS_PER_S)
    t_ops, t_bytes = ops / rate, n_bytes / HBM_BYTES_PER_S
    extra = {} if dtype == "bfloat16" else dict(
        bound_ms_issued=max(passes * ops / rate, t_bytes) * 1e3,
        bound_ms_cuda_cores=max(ops / FP32_OPS_PER_S, t_bytes) * 1e3)
    reps = 50 if dtype == "bfloat16" else 20
    ms = [cuda_ms(kern, reps), cuda_ms(sdpa, reps), cuda_ms(sdpa, reps), cuda_ms(kern, reps)]
    # the yardstick by name: the kernel SDPA ran, and its device us a launch
    lib_kernel, lib_us = top_kernel(device_profile(sdpa))
    return dict(shape=case, dtype=dtype, ms=min(ms[0], ms[3]), ms_turns=[ms[0], ms[3]],
                plain_ms=cuda_ms(lambda: FA.flash_attention_plain(q, k, v, **kw), 5),
                library_ms=min(ms[1], ms[2]), library_ms_turns=[ms[1], ms[2]],
                library_kernel=lib_kernel, library_device_us=lib_us,
                library_max_abs_vs_kernel=lib_err,
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops=ops, ops_issued=passes * ops, bytes=n_bytes, **extra)


def time_ssd(device, dtype="bfloat16", case=SSD_PATH):
    """``ssd_scan`` at ``case`` (mamba2-2.7b's layer shape unless given)
    in ``dtype`` (bf16 is the model's type): the call by CUDA events (its
    four kernels), its plain
    version, and each kernel's device µs per call from the profiler.  No
    single PyTorch call computes the SSD scan, so there is no library
    time.  The bound counts the work the function needs, once, at the
    card's fastest rate for its operand type: bf16 at 989 TFLOP/s, float32
    at 495 TFLOP/s (TF32), against the bytes.  Beside it, float32's
    ``bound_ms_issued`` counts the three-term bf16 split the kernels issue
    (three bf16 products each, 989 TFLOP/s) and ``bound_ms_cuda_cores``
    the work once at the 67 TFLOP/s of float32 outside the tensor
    cores."""
    import re

    import torch
    from repro_torch.kernels import ssd_scan as SS

    B, S, nh, hp, N, Q = case
    args = ssd_inputs(case, getattr(torch, dtype), device, seed=99)
    # the products the function needs, two operations a multiply-add: C.B^T
    # once per (batch, chunk), since it is the same for every head, and
    # only its causal half, j <= i; per (batch, head, chunk) the causal
    # half of scores.x, the carried-state term and the state update.  The
    # elementwise decay weights (1.3 % as many operations) are left out.
    tri = Q * (Q + 1) // 2
    ops = 2 * B * (S // Q) * (tri * N + nh * (tri * hp + 2 * Q * N * hp))
    size = args[0].element_size()
    n_bytes = (size * (B * S * nh * hp + 2 * B * S * N) + 4 * (B * S * nh + nh)
               + 4 * (B * S * nh * hp + B * nh * hp * N))
    passes, rate = (1, BF16_OPS_PER_S) if dtype == "bfloat16" else (3, TF32_OPS_PER_S)
    t_ops, t_bytes = ops / rate, n_bytes / HBM_BYTES_PER_S
    extra = {} if dtype == "bfloat16" else dict(
        bound_ms_issued=max(passes * ops / BF16_OPS_PER_S, t_bytes) * 1e3,
        bound_ms_cuda_cores=max(ops / FP32_OPS_PER_S, t_bytes) * 1e3)

    def kern():
        return SS.ssd_scan(*args, chunk=Q)

    ms = [cuda_ms(kern, 20), cuda_ms(kern, 20)]
    reps = 10
    _, avgs = profiled(lambda: [kern() for _ in range(reps)],
                       ("ssd_cb_kernel", "ssd_state_kernel", "ssd_pass_kernel", "ssd_out_kernel"),
                       reps, lambda: (SS.STATS["ssd_scan"],))
    parts = {}
    for k, (count, us) in device_kernels(avgs).items():
        m = re.search(r"(ssd_\w+?_kernel)", k)
        if m:
            parts[m.group(1)] = us / count
    return dict(shape=case, dtype=dtype, ms=min(ms), ms_turns=ms,
                plain_ms=cuda_ms(lambda: SS.ssd_scan_plain(*args, chunk=Q), 5),
                device_us=sum(parts.values()) if parts else None, device_us_per_kernel=parts,
                library_ms=None, bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops=ops, ops_issued=passes * ops, bytes=n_bytes, **extra)


def profile_model_kernel(fn, names, launched, reps=10):
    """Device µs per call of ``fn`` in the kernels named (each launched once
    a call, ``launched`` giving the wrapper's count) under the profiler,
    and each kernel's, per launch the profiler listed; (None, {}) when the
    profiler saw none of them."""
    _, avgs = profiled(lambda: [fn() for _ in range(reps)], names, reps, launched)
    parts = {}
    for k, (count, us) in device_kernels(avgs).items():
        for name in names:
            if name in k:
                parts[name] = us / count
    return (sum(parts.values()) if parts else None), parts


def device_profile(fn, reps=10, tries=3):
    """{kernel: (launches listed, device µs in total)} of ``reps`` calls of
    ``fn`` (after one warm call) under ``torch.profiler``.  A profile that
    lists no device activity at all (the profiler has returned such
    sessions now and then, four in a row late in one run) is taken again,
    ``tries`` times in all; ``{}`` if none lists any."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof.key_averages())
        if kernels:
            return kernels
    return {}


def top_kernel(kernels):
    """(name, device µs a listed launch) of the kernel with the most device
    time in a ``device_profile``; (None, None) when it saw none."""
    if not kernels:
        return None, None
    name, (count, us) = max(kernels.items(), key=lambda kv: kv[1][1])
    return name, us / count


# ---------------------------------------------------------------------------
# Phase 8: the serving path, hymba-1.5b at full width
# ---------------------------------------------------------------------------


def rel_err(a, b) -> float:
    b = b.float()
    return float((a.float() - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def serve_batch(cfg, device, B, P, seed=SEED):
    """A seeded serving batch of the family of ``cfg``, made with numpy: B
    prompts of P tokens; for a patch frontend (phi-3-vision) the
    ``num_frontend_tokens`` patch embeddings spliced over the first
    positions, at the embedding table's scale (std 0.02); for an
    encoder-decoder (whisper) ``max_source_positions`` frame embeddings of
    std 1 (the sinusoids added to them are of that size)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int64)}
    if cfg.frontend == "patch_stub":
        batch["patch_embeds"] = 0.02 * rng.standard_normal(
            (B, cfg.num_frontend_tokens, cfg.d_model), dtype=np.float32)
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = rng.standard_normal(
            (B, cfg.max_source_positions, cfg.d_model), dtype=np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def pad_cache(cache, cap):
    """The self-attention cache's k and v padded to ``cap`` positions; the
    other leaves (an SSM state, whisper's cross cache over the source
    frames) as they are."""
    import torch.nn.functional as F

    return {k: (F.pad(v, (0, 0, 0, 0, 0, cap - v.shape[2])) if k in ("k", "v") else v)
            for k, v in cache.items()}


def moe_block(model, bp, h, positions, is_global, routing=None):
    """One attention + MoE layer of ``model`` (qwen2-moe's block), as
    ``Model._block_prefill`` computes it, with the MoE routing (experts,
    buffer positions, kept slots, weights) taken from ``routing`` when
    given.  Returns (the layer's output, the routing used, its (k, v)
    cache entries)."""
    from repro_torch.models import moe as PM
    from repro_torch.models.common import rms_norm

    cfg = model.cfg
    B, S, _ = h.shape
    q, k, v = model._qkv(bp["attn"], h, positions)
    o = model._self_attention(q, k, v, is_global=is_global)
    h = h + o.reshape(B, S, cfg.q_dim) @ bp["attn"]["wo"]
    x = rms_norm(h, bp["moe_ln"], cfg.norm_eps)
    r = PM.route(bp["moe"], x, cfg, model.rt.capacity_factor) if routing is None else routing
    flat_e, pos_clip, keep, flat_w, C = r
    eo = PM.expert_ffn(bp["moe"]["experts"],
                       PM.dispatch(x, flat_e, pos_clip, cfg.num_experts, C))
    return h + PM.residual_ffn(bp["moe"], x, PM.combine(eo, flat_e, pos_clip, keep,
                                                        flat_w, S)), r, (k, v)


def matched_prefill(kern, plain, params, batch, want_logits):
    """The kernel route's prefill of an MoE model with every MoE layer
    taking the routing the plain route's prefill takes there (its own
    attention, norms and expert products): last-position logits and the
    cache.  The plain route run beside it must give ``want_logits``
    exactly."""
    import torch
    from repro_torch.models.model import _tmap

    cfg = plain.cfg
    hp = hk = plain._embed(params, batch)
    positions = torch.arange(hp.shape[1], device=hp.device)[None, :]
    ks, vs = [], []
    for li in range(cfg.num_layers):
        bp = _tmap(lambda x: x[li], params["blocks"])
        g = cfg.layer_is_global(li % plain.period)
        hp, rp, _ = moe_block(plain, bp, hp, positions, g)
        hk, _, (k, v) = moe_block(kern, bp, hk, positions, g, routing=rp)
        ks.append(k)
        vs.append(v)
    check(torch.equal(plain._head(params, hp[:, -1:, :]), want_logits),
          "matched_prefill: the plain route differs from its prefill")
    return kern._head(params, hk[:, -1:, :]), {"k": torch.stack(ks), "v": torch.stack(vs)}


def layerwise_rel_err(kern, plain, params, batch, extra=None):
    """The largest rel. errors of one layer's attention output and of its
    output, the kernel route's against the plain route's, with every layer
    of both fed the plain route's input to it (so differences cannot
    compound across layers); an encoder-decoder's encoder layers too, and
    both routes' decoder layers then attend across to the plain route's
    encoder output.  A layer's window flag is ``layer_is_global(li %
    period)``, as the model's traversal gives it (gemma3's 34 layers end in
    4 local ones after 5 periods).  In an MoE model a bf16 difference in the
    attention output can move a token across its top-k boundary, which
    changes that token's output by the size of an expert's: so the
    layer's output is compared with the kernel route's MoE taking the
    plain route's routing, and ``extra`` (a dict) gets the error with the
    kernel route's own routing and the tokens whose experts or drops
    differ (``routing_flips`` per layer, of ``tokens``).  Both routes'
    layers take ``ssd_scan`` for an SSM mixer, so where ``extra`` is given
    each mixer also runs through the kernel and through the chunked form
    (``ssd_forward(use_pallas=False)``) on the plain route's input to it,
    and ``extra["layer_ssd_rel_err"]`` gets the largest rel. error of its
    output, state and conv tail."""
    import torch
    from repro_torch.models import ssd as ssd_mod
    from repro_torch.models.common import rms_norm
    from repro_torch.models.model import _tmap

    cfg = plain.cfg
    attn, out, own, flips, ssd = 0.0, 0.0, 0.0, [], 0.0
    if cfg.is_encoder_decoder:  # the encoder's layers, then the plain route's
        h = plain._enc_input(batch["src_embeds"])  # output feeds both decoders
        for li in range(cfg.num_encoder_layers):
            bp = _tmap(lambda x: x[li], params["enc_blocks"])
            q, k, v = plain._enc_qkv(bp["attn"], h)
            attn = max(attn, rel_err(kern._enc_attention(q, k, v),
                                     plain._enc_attention(q, k, v)))
            del q, k, v
            hk, h = kern._enc_block(h, bp), plain._enc_block(h, bp)
            out = max(out, rel_err(hk, h))
        kern._enc_out = plain._enc_out = rms_norm(h, params["enc_norm"], cfg.norm_eps)
    h = plain._embed(params, batch)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for li in range(cfg.num_layers):
        bp = _tmap(lambda x: x[li], params["blocks"])
        g = cfg.layer_is_global(li % plain.period)
        q, k, v = plain._qkv(bp["attn"], h, positions)
        attn = max(attn, rel_err(kern._self_attention(q, k, v, is_global=g),
                                 plain._self_attention(q, k, v, is_global=g)))
        del q, k, v
        if cfg.uses_ssm and extra is not None:
            x, leave = plain._ssm_prenorm(bp, h), not plain._joint(bp)
            got, want = (ssd_mod.ssd_forward(bp["ssm"], x, cfg, leave=leave, use_pallas=kernel)
                         for kernel in (True, False))
            ssd = max(ssd, *(rel_err(a, b) for a, b in zip(got, want)))
            del x, got, want
        if cfg.uses_moe:
            hp, rp, _ = moe_block(plain, bp, h, positions, g)
            if li == 0:  # the helper is the model's layer
                check(torch.equal(hp, plain._block_prefill(bp, h, is_global=g,
                                                           positions=positions)[0]),
                      "moe_block differs from Model._block_prefill")
            hk, _, _ = moe_block(kern, bp, h, positions, g, routing=rp)
            hk_own, rk, _ = moe_block(kern, bp, h, positions, g)
            own = max(own, rel_err(hk_own, hp))
            B, S = h.shape[:2]
            differ = ((rk[0] != rp[0]) | (rk[2] != rp[2])).reshape(B, S, -1).any(-1)
            flips.append(int(differ.sum()))
            del hk_own, rk, rp
            h = hp
        else:
            hk, _ = kern._block_prefill(bp, h, is_global=g, positions=positions)
            h, _ = plain._block_prefill(bp, h, is_global=g, positions=positions)
        out = max(out, rel_err(hk, h))
    kern._enc_out = plain._enc_out = None
    if extra is not None and cfg.uses_moe:
        extra.update(layer_out_rel_err_own_routing=own, routing_flips=flips,
                     tokens=int(h.shape[0] * h.shape[1]))
    if extra is not None and cfg.uses_ssm:
        extra["layer_ssd_rel_err"] = ssd
    return attn, out


def window_ignored(cfg, rt):
    """Phase 8's planted fault: the kernel route with the window ignored."""
    from repro_torch.models import build_model

    return build_model(cfg.replace(sliding_window=0), rt)


def encoder_causal(cfg, rt):
    """whisper's planted fault: the kernel route with the encoder's
    attention made causal (each frame blind to the frames after it)."""
    from repro_torch.models.attention import attention
    from repro_torch.models.model import Model

    class CausalEncoder(Model):
        def _enc_attention(self, q, k, v):
            return attention(q, k, v, causal=True, impl=self.rt.attn_impl,
                             q_chunk=self.cfg.attn_q_chunk, kv_chunk=self.cfg.attn_kv_chunk)

    return CausalEncoder(cfg, rt)


def phase_serve(device, arch=SERVE_ARCH, B=SERVE_B, P=SERVE_P, steps=SERVE_STEPS,
                cap=SERVE_CAP, layers=None, fault=window_ignored, cfg_kw=None):
    """Cell ``serve_hymba_1_5b_p2048`` (``arch`` and the other arguments
    name another cell), in bf16 and float32: seeded weights
    made on the card, prefill through ``attn_impl="pallas"`` (the kernel)
    and ``"blocked"`` (the plain route) on the same weights and prompts,
    then ``steps`` greedy decode steps of the plain run, with the kernel
    run fed the same tokens; in bf16 the reference's other plain route
    (``"dense"``) runs beside them and sets the end-to-end bound.  Then
    each layer of both routes on the plain route's input to it, and the
    same for a planted fault (``fault(cfg, rt)``: by default the kernel
    route with the window ignored), which the per-layer and end-to-end
    checks must catch.  ``layers`` maps a dtype to a cut depth;
    ``cfg_kw`` replaces fields of the config that are no widths (whisper's
    blocked query chunk).  The batch is the family's (``serve_batch``);
    an encoder-decoder's encoder runs on its frames, and each prefill
    launches ``flash_attention`` once a decoder and once an encoder
    layer.  An SSM or hybrid model's prefill launches ``ssd_scan`` once
    a layer on every route (the model takes the kernel for its mixer
    wherever no graph is being built); the per-layer check holds each
    mixer through the kernel against the chunked form.  Launches are
    counted on the prefills through the user entry points (warm-up and
    timed; the counts are set to 0 before the phase; ``ssd_scan``'s in
    each type's metrics).  Returns (``flash_attention`` launches by type,
    metrics by type)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models import Runtime, build_model
    from repro_torch.train import make_decode_step, make_prefill

    base = get_config(arch).replace(**(cfg_kw or {}))
    out, launches = {}, {}
    FA.reset_stats()
    SS.reset_stats()
    for dtype, tol in SERVE_TOL.items():
        cfg = base.replace(dtype=dtype)
        if layers and layers.get(dtype):
            cfg = cfg.replace(num_layers=layers[dtype])
        L = cfg.num_layers + cfg.num_encoder_layers  # launches a prefill
        Ls = cfg.num_layers if cfg.uses_ssm else 0  # ssd_scan's, on every route
        kern = build_model(cfg, Runtime(attn_impl="pallas", remat="none"))
        plain = build_model(cfg, Runtime(attn_impl="blocked", remat="none"))
        routes = {"k": kern, "p": plain}
        if dtype == "bfloat16":
            routes["d"] = build_model(cfg, Runtime(attn_impl="dense", remat="none"))
        gen = torch.Generator(device=device).manual_seed(SEED)
        params = kern.init(gen)
        batch = serve_batch(cfg, device, B, P)
        prefill = {r: make_prefill(mdl) for r, mdl in routes.items()}
        step = {r: make_decode_step(mdl) for r, mdl in routes.items()}
        m = {"layers": cfg.num_layers, "encoder_layers": cfg.num_encoder_layers}
        with torch.inference_mode():
            n0, s0 = FA.STATS["flash_attention"], SS.STATS["ssd_scan"]
            prefill["k"](params, batch)  # warm-up: cuBLAS handles, first launches
            sync(device)
            n1, s1 = FA.STATS["flash_attention"], SS.STATS["ssd_scan"]
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            logits, caches = {}, {}
            logits["k"], caches["k"] = prefill["k"](params, batch)
            sync(device)
            m["prefill_s"] = time.perf_counter() - t0
            if device.type == "cuda":
                m["prefill_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            n2, s2 = FA.STATS["flash_attention"], SS.STATS["ssd_scan"]
            for r in routes.keys() - {"k"}:
                logits[r], caches[r] = prefill[r](params, batch)
            sync(device)
            check(n1 - n0 == L and n2 - n1 == L and FA.STATS["flash_attention"] == n2,
                  f"serve {dtype}: flash_attention launches per prefill "
                  f"{n1 - n0}, {n2 - n1} (want {L}) and "
                  f"{FA.STATS['flash_attention'] - n2} on the plain routes (want 0)")
            s3 = SS.STATS["ssd_scan"]
            check(s1 - s0 == Ls and s2 - s1 == Ls and s3 - s2 == Ls * (len(routes) - 1),
                  f"serve {dtype}: ssd_scan launches per prefill {s1 - s0}, {s2 - s1} and "
                  f"{s3 - s2} over the {len(routes) - 1} plain routes (want {Ls} a prefill)")
            launches[dtype] = n2 - n0  # bf16: the wgmma kernel, float32: the TF32 one
            m["ssd_scan_launches"] = s2 - s0
            check(tuple(logits["k"].shape) == (B, 1, cfg.vocab_size)
                  and bool(torch.isfinite(logits["k"].float()).all()),
                  f"serve {dtype}: prefill logits not finite of shape (B, 1, V)")
            # rel. errors against the plain route: [prefill, step 0, ...]
            errs = {r: [rel_err(logits[r], logits["p"])] for r in routes.keys() - {"p"}}
            if cfg.uses_moe:
                # a token whose top-k sits on a boundary flips its experts
                # on an ulp upstream; the kernel route with the plain
                # route's routing separates the kernel's error from that
                mlog, mcache = matched_prefill(kern, plain, params, batch, logits["p"])
                m["prefill_rel_err_matched_routing"] = rel_err(mlog, logits["p"])
                m["prefill_rel_err_own_routing"] = errs["k"][0]
                if "d" not in routes:  # a fixed bound: hold the kernel's own error
                    errs["k"][0] = m["prefill_rel_err_matched_routing"]
                    caches["k"] = mcache
                    m["decode_from"] = "the matched-routing prefill's cache"
                del mlog, mcache
                n2, s3 = FA.STATS["flash_attention"], SS.STATS["ssd_scan"]  # a comparison's
            caches = {r: pad_cache(c, cap) for r, c in caches.items()}
            tok = logits["p"][:, -1].argmax(-1)[:, None]
            step_s, agree = [], 0
            for i in range(steps):
                lg = {}
                for r in routes.keys() - {"k"}:
                    lg[r], caches[r] = step[r](params, caches[r], tok, P + i)
                sync(device)
                t0 = time.perf_counter()
                lg["k"], caches["k"] = step["k"](params, caches["k"], tok, P + i)
                sync(device)
                step_s.append(time.perf_counter() - t0)
                check(bool(torch.isfinite(lg["k"].float()).all()),
                      f"serve {dtype}: decode step {i} logits not finite")
                for r in errs:
                    errs[r].append(rel_err(lg[r], lg["p"]))
                agree += int(torch.equal(lg["k"][:, -1].argmax(-1), lg["p"][:, -1].argmax(-1)))
                tok = lg["p"][:, -1].argmax(-1)[:, None]
            check(FA.STATS["flash_attention"] == n2, f"serve {dtype}: decode launched flash")
            check(SS.STATS["ssd_scan"] == s3, f"serve {dtype}: decode launched ssd_scan")
            del caches
            m["prefill_rel_err"], m["decode_max_rel_err"] = errs["k"][0], max(errs["k"][1:])
            lim = [tol, tol]
            if "d" in errs:  # the plain routes' own spread, end to end
                m["dense_vs_blocked_prefill"] = errs["d"][0]
                m["dense_vs_blocked_decode_max"] = max(errs["d"][1:])
                lim = [max(tol, SERVE_SPREAD_FACTOR * e)
                       for e in (errs["d"][0], max(errs["d"][1:]))]
            m["e2e_bound_prefill_decode"] = lim
            check(m["prefill_rel_err"] < lim[0],
                  f"serve {dtype}: prefill logits rel err {m['prefill_rel_err']} >= {lim[0]}")
            check(m["decode_max_rel_err"] < lim[1],
                  f"serve {dtype}: decode rel err {m['decode_max_rel_err']} >= {lim[1]}")
            m["layer_attn_rel_err"], m["layer_out_rel_err"] = layerwise_rel_err(
                kern, plain, params, batch, extra=m)
            check(max(m["layer_attn_rel_err"], m["layer_out_rel_err"]) < tol,
                  f"serve {dtype}: a layer's rel errs (attention, output) "
                  f"{m['layer_attn_rel_err']}, {m['layer_out_rel_err']} >= {tol}")
            check(m.get("layer_ssd_rel_err", 0.0) < tol,
                  f"serve {dtype}: a layer's mixer through ssd_scan against the chunked "
                  f"form, rel err {m.get('layer_ssd_rel_err')} >= {tol}")
            # planted fault: by default the kernel route with the window ignored
            fault_model = fault(cfg, kern.rt)
            m["fault_layer_attn_out_rel_err"] = layerwise_rel_err(
                fault_model, plain, params, batch)
            check(max(m["fault_layer_attn_out_rel_err"]) >= tol,
                  f"serve {dtype}: the per-layer check missed the planted fault: "
                  f"{m['fault_layer_attn_out_rel_err']} < {tol}")
            m["fault_prefill_rel_err"] = rel_err(fault_model.prefill(params, batch)[0],
                                                 logits["p"])
            check(m["fault_prefill_rel_err"] >= lim[0],
                  f"serve {dtype}: the end-to-end check missed the planted fault: "
                  f"{m['fault_prefill_rel_err']} < {lim[0]}")
            m.update(
                prefill_tokens_per_s=B * P / m["prefill_s"],
                decode_ms_per_step=statistics.median(step_s) * 1e3,
                decode_tokens_per_s=B / statistics.median(step_s),
                greedy_agree=f"{agree}/{steps}",
            )
            if dtype == "bfloat16" and device.type == "cuda":
                def window():
                    _, c = prefill["k"](params, batch)
                    c = pad_cache(c, cap)
                    t = tok
                    for i in range(4):
                        lg, c = step["k"](params, c, t, P + i)
                        t = lg[:, -1].argmax(-1)[:, None]

                wall, avgs = profiled(window)
                dev = device_kernels(avgs)
                busy = sum(us for _, us in dev.values()) * 1e-6
                flash = [(c, us) for k, (c, us) in dev.items() if "flash_kernel" in k]
                m.update(profiled_wall_s=wall, device_busy_s=busy,
                         idle_share=1.0 - busy / wall if busy > 0 else None,
                         flash_device_us=(sum(us for _, us in flash) / sum(c for c, _ in flash)
                                          if flash else None))
                top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:6]
                m["top_device_kernels"] = [(k[:50], c, round(us, 1)) for k, (c, us) in top]
        out[dtype] = m
        print(f"  serve_{arch} {dtype}: " + " ".join(f"{k}={v!r}" for k, v in m.items()))
        del params, prefill, step, kern, plain, routes, fault_model, logits
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return launches, out


# ---------------------------------------------------------------------------
# Phase 9: one full-width mamba2-2.7b SSD layer through ssd_scan
# ---------------------------------------------------------------------------


def phase_ssd_layer(device, B=SSD_B, S=SSD_S):
    """Cell ``ssd_layer_mamba2_2_7b_s4096``: ``ssd_forward`` of one seeded
    full-width layer, ``use_pallas=True`` (the kernel) against
    ``use_pallas=False`` (the chunked form), float32 and bf16.  The launch
    count is set to 0 before the phase and read after it; returns the
    launches by type."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models import ssd as ssd_mod

    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    out, launches = {}, {}
    SS.reset_stats()
    for dtype in ("float32", "bfloat16"):
        cfg = get_config(SSD_ARCH).replace(dtype=dtype)
        gen = torch.Generator(device=device).manual_seed(SEED)
        p = ssd_mod.ssd_init(gen, cfg, getattr(torch, dtype))
        x = torch.randn((B, S, cfg.d_model), generator=gen, device=device).to(
            getattr(torch, dtype))
        with torch.inference_mode():
            n0 = SS.STATS["ssd_scan"]
            got = ssd_mod.ssd_forward(p, x, cfg, use_pallas=True)
            sync(device)
            check(SS.STATS["ssd_scan"] == n0 + 1, f"ssd layer {dtype}: no ssd_scan launch")
            launches[dtype] = 1  # bf16 and float32 run the two instantiations
            want = ssd_mod.ssd_forward(p, x, cfg, use_pallas=False)
            sync(device)
            errs = [rel_err(a, b) for a, b in zip(got, want)]
            check(all(e < tol[dtype] for e in errs) and bool(torch.isfinite(got[0].float()).all()),
                  f"ssd layer {dtype}: rel errs (out, state, conv) {errs} >= {tol[dtype]}")
            if device.type == "cuda":
                kern_ms = cuda_ms(lambda: ssd_mod.ssd_forward(p, x, cfg, use_pallas=True), 5)
                plain_ms = cuda_ms(lambda: ssd_mod.ssd_forward(p, x, cfg), 5)
            else:
                kern_ms = plain_ms = None
        out[dtype] = dict(rel_err_out_state_conv=errs, layer_ms_kernel=kern_ms,
                          layer_ms_chunked=plain_ms)
        print(f"  ssd_layer_{SSD_ARCH} B={B} S={S} {dtype}: "
              + " ".join(f"{k}={v!r}" for k, v in out[dtype].items()))
    return launches, out


# ---------------------------------------------------------------------------
# Phase 10: the scheduler daemon (control plane) on the card
# ---------------------------------------------------------------------------


def daemon_stream(apps, n=DAEMON_SUBMITS, seed=SEED):
    """A seeded online workload of ``n`` submits over ``apps``: groups of
    3-9 submits at one instant an hour or two apart (same-instant bursts
    that reach several nodes), half of them followed by an advance 10 s
    on, then a drain."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ops, t, i = [], 0.0, 0
    while i < n:
        t += float(rng.choice([3600.0, 7200.0]))
        for _ in range(min(int(rng.choice([3, 6, 9])), n - i)):
            ops.append(("submit", f"s{i}", str(rng.choice(apps)), t))
            i += 1
        if rng.random() < 0.5:
            ops.append(("advance", t + 10.0))
    ops.append(("drain",))
    return ops


def apply_ops(svc, ops):
    for op in ops:
        if op[0] == "submit":
            svc.submit(op[1], op[2], op[3])
        elif op[0] == "cancel":
            svc.cancel(op[1])
        elif op[0] == "advance":
            svc.advance(op[1])
        else:
            svc.advance(None)


def op_request(op):
    """One of ``apply_ops``' ops as a request of the wire protocol."""
    if op[0] == "submit":
        return {"op": "submit", "name": op[1], "app": op[2], "t": op[3]}
    if op[0] == "cancel":
        return {"op": "cancel", "name": op[1]}
    if op[0] == "advance":
        return {"op": "advance", "until": op[1]}
    return {"op": "drain"}


def result_key(res):
    """The fingerprint the service tests compare: the keyed records,
    makespan and total energy of a ``result`` response."""
    check(res.get("ok"), f"daemon result not ok: {res}")
    return (tuple(tuple(r) for r in sorted(res["records"])), res["makespan"],
            res["total_energy"])


def short_path(p):
    """``p`` as a string short enough for a unix socket (108 bytes): the
    path relative to the working directory when the absolute one is long."""
    import os

    s = str(p)
    return s if len(s) < 100 else os.path.relpath(s)


def boot_daemon(sock, jnl, log, extra):
    """Start ``python -m repro_torch.cli daemon`` on the card; returns the
    process once it answers ``ping`` (CUDA context and the kernel
    library's load included in the deadline)."""
    import os
    from repro_torch.core.service import request

    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.cli", "daemon", "--socket", sock,
         "--journal", jnl, "--preset", DAEMON_PRESET, *extra],
        env=env, stdout=log, stderr=subprocess.STDOUT)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < DAEMON_BOOT_S:
        if proc.poll() is not None:
            raise RuntimeError(f"daemon exited on boot with {proc.returncode}")
        try:
            if request(sock, {"op": "ping"}, timeout=10.0).get("pong"):
                return proc, time.perf_counter() - t0
        except (OSError, ValueError):
            time.sleep(0.2)
    proc.kill()
    proc.wait(timeout=30)
    raise RuntimeError(f"daemon never answered ping in {DAEMON_BOOT_S} s")


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def phase_daemon(device, workdir):
    """Cell ``daemon_hetero``.  (a) ``SchedulerService`` over
    ``make_backend_factory("hetero", device=...)`` (node policies
    ``EcoSched(engine="torch")``) on the service tests' ops, on a seeded
    stream of ``DAEMON_SUBMITS`` submits, and on the stream with
    ``elastic=True, freq_levels=3``, each beside the same ops with
    ``engine="vector"``: equal fingerprints and byte-identical journals.
    The kernels' counts are set to 0 just before each torch run and read
    just after.  (b) The elastic leg's journal cut at ``DAEMON_OFFSETS``
    seeded offsets recovers on the card to the same fingerprint.  (c) The
    real daemon, ``python -m repro_torch.cli daemon --preset hetero
    --elastic --freq-levels 3``, on the card: the stream through its
    socket, SIGKILL halfway, a second boot on the same journal, the rest
    of the stream and a drain, and the result must equal (a)'s.  (d) µs
    per request through the socket.  Returns the launches by kernel."""
    import os
    import signal

    import numpy as np
    from repro_torch.cli import make_backend_factory
    from repro_torch.core import SchedulerService
    from repro_torch.core.service import request
    from repro_torch.kernels import score_reduce as K

    workdir.mkdir(parents=True, exist_ok=True)
    apps = make_backend_factory(DAEMON_PRESET, engine="vector")().run.apps
    stream = daemon_stream(apps)
    elastic = dict(elastic=True, freq_levels=3)
    legs = (("ops", {}, DAEMON_OPS), ("stream", {}, stream),
            ("stream_elastic_f3", elastic, stream))
    launches = {k: 0 for k in KERNELS}
    golden = {}
    for leg, kw, ops in legs:
        got = {}
        for engine in ("torch", "vector"):
            jnl = workdir / f"{leg}-{engine}.jnl"
            jnl.unlink(missing_ok=True)
            factory = make_backend_factory(DAEMON_PRESET, engine=engine, device=device,
                                           **kw)
            if engine == "torch":
                K.reset_stats()
            t0 = time.perf_counter()
            svc = SchedulerService(factory, journal_path=str(jnl))
            apply_ops(svc, ops)
            sync(device)
            wall = time.perf_counter() - t0
            if engine == "torch":
                kstats = read_stats()
            got[engine] = (result_key(svc.result()), svc.stats(), wall, jnl.read_bytes())
            svc.close()
        (fp_t, st, wall_t, blob_t), (fp_v, _, wall_v, blob_v) = got["torch"], got["vector"]
        check(fp_t == fp_v, f"daemon {leg}: torch schedule differs from vector")
        check(blob_t == blob_v, f"daemon {leg}: the torch run's journal differs from vector's")
        check(st["replay_divergences"] == 0 and fp_t[1] > 0 and fp_t[2] > 0,
              f"daemon {leg}: bad stats {st}")
        for k in KERNELS:
            launches[k] += kstats[k]["launches"]
        golden[leg] = fp_t
        print(f"  daemon {leg}{' ' + str(kw) if kw else ''}: ops={len(ops)} "
              f"records={len(fp_t[0])} makespan={fp_t[1]!r} energy={fp_t[2]!r} "
              f"counts={st['counts']} rejected={st['rejected']} "
              f"journal_bytes={len(blob_t)} wall_s torch={wall_t!r} vector={wall_v!r} "
              f"launches={ {k: v['launches'] for k, v in kstats.items()} } "
              f"guarded={ {k: v['guarded'] for k, v in kstats.items()} }")
    for k in KERNELS:
        check(launches[k] > 0, f"daemon: {k} was never launched")

    # (b) recovery on the card from the elastic leg's journal cut short
    factory = make_backend_factory(DAEMON_PRESET, device=device, **elastic)
    blob = got["torch"][3]
    head = blob.index(b"\n") + 1
    rng = np.random.default_rng(SEED)
    offsets = sorted({int(o) for o in rng.integers(head, len(blob), size=DAEMON_OFFSETS)})
    replay_s = []
    for off in offsets:
        jnl = workdir / f"crash{off}.jnl"
        jnl.write_bytes(blob[:off])
        t0 = time.perf_counter()
        svc = SchedulerService(factory, journal_path=str(jnl))
        sync(device)
        replay_s.append(time.perf_counter() - t0)
        check(svc.replay_divergences == 0, f"daemon recovery at {off}: divergences")
        apply_ops(svc, stream)
        check(result_key(svc.result()) == golden["stream_elastic_f3"],
              f"daemon recovery at offset {off}: schedule differs from the golden")
        svc.close()
        jnl.unlink()
    print(f"  daemon recovery on {device}: offsets={offsets} of {len(blob)} bytes "
          f"replay_s={replay_s!r}")

    # (c) the real daemon: boot, half the stream, SIGKILL, boot, the rest
    sock = short_path(workdir / "d.sock")
    jnl = short_path(workdir / "d.jnl")
    for p in (workdir / "d.sock", workdir / "d.jnl"):
        p.unlink(missing_ok=True)
    extra = ["--elastic", "--freq-levels", "3"]
    if device.type != "cuda":  # the daemon runs on the card unless asked
        extra += ["--device", device.type]
    reqs = [op_request(op) for op in stream[:-1]]
    half = len(reqs) // 2
    us = {"submit": [], "advance": []}
    proc = None
    with open(workdir / "daemon.log", "w") as log:
        try:
            proc, boot1 = boot_daemon(sock, jnl, log, extra)
            for i, req in enumerate(reqs):
                if i == half:  # no warning, no flush window
                    os.kill(proc.pid, signal.SIGKILL)
                    proc.wait(timeout=30)
                    proc, boot2 = boot_daemon(sock, jnl, log, extra)
                    stats = request(sock, {"op": "stats"})
                    check(stats["replay_divergences"] == 0,
                          f"daemon: divergences after the SIGKILL: {stats}")
                t0 = time.perf_counter()
                resp = request(sock, req)
                us[req["op"]].append((time.perf_counter() - t0) * 1e6)
                check(resp.get("ok") or req["op"] == "submit",
                      f"daemon: {req} answered {resp}")
            check(request(sock, {"op": "drain"}).get("ok"), "daemon: drain failed")
            res = request(sock, {"op": "result"})
            check(result_key(res) == golden["stream_elastic_f3"],
                  "daemon: the SIGKILLed daemon's schedule differs from the golden")
            stats = request(sock, {"op": "stats"})
            check(stats["replay_divergences"] == 0, f"daemon: divergences {stats}")
            check(request(sock, {"op": "shutdown"}).get("shutdown"), "daemon: no shutdown")
            check(proc.wait(timeout=60) == 0, "daemon: non-zero exit after shutdown")
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    print(f"  daemon subprocess --preset {DAEMON_PRESET} {' '.join(extra)}: "
          f"boot_s={boot1!r} reboot_after_sigkill_s={boot2!r} requests={len(reqs)} "
          f"killed_after={half} result equals (a)'s golden, replay_divergences=0")
    for op, xs in us.items():
        print(f"  daemon socket {op}: n={len(xs)} p50_us={pct(xs, 0.5)!r} "
              f"p99_us={pct(xs, 0.99)!r}")
    return launches


# ---------------------------------------------------------------------------
# Phase 11: MoE serving, qwen2-moe-a2.7b at full width
# ---------------------------------------------------------------------------


def causal_ignored(cfg, rt):
    """Phase 11's planted fault: the kernel route with ``causal`` ignored
    (the model has no window to ignore)."""
    from repro_torch.models.attention import attention
    from repro_torch.models.model import Model

    class NonCausal(Model):
        def _self_attention(self, q, k, v, *, is_global):
            return attention(q, k, v, causal=False, softcap=self.cfg.attn_logit_softcap,
                             impl=self.rt.attn_impl, q_chunk=self.cfg.attn_q_chunk,
                             kv_chunk=self.cfg.attn_kv_chunk)

    return NonCausal(cfg, rt)


def moe_unnormalised(p, x, cfg):
    """A planted fault built here, not in the package: ``moe_apply`` with
    the top-k routing weights left as the router's probabilities (not
    renormalised to sum to 1 over a token's k experts)."""
    from repro_torch.models import moe as PM

    B, S, _ = x.shape
    flat_e, pos_clip, keep, _, C = PM.route(p, x, cfg)
    raw = PM.top_k(PM.router_probs(p, x), cfg.num_experts_per_tok)[0]
    eo = PM.expert_ffn(p["experts"], PM.dispatch(x, flat_e, pos_clip, cfg.num_experts, C))
    out = PM.combine(eo, flat_e, pos_clip, keep, raw.reshape(B, -1), S)
    return PM.residual_ffn(p, x, out)


def phase_moe_layer(device):
    """One full-width qwen2-moe MoE layer (float32, B 1 x S ``MOE_LAYER_S``)
    on the card and on the CPU from the same seeded weights: the experts
    each slot goes to, the capacity drops and the output must agree
    (rel. max error < ``MOE_LAYER_TOL``), and the planted fault (routing
    weights not renormalised) must not.  Then the device time of each
    piece of a bf16 layer at the prefill shape (B 4 x S 2048) by CUDA
    events: routing, dispatch, the expert einsums, combine, the shared
    experts; and the profiler's device kernels of one layer."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as PM

    cfg = get_config(MOE_ARCH).replace(dtype="float32")
    cpu = torch.device("cpu")
    gen = torch.Generator(device=cpu).manual_seed(SEED)
    p_cpu = PM.moe_init(gen, cfg, torch.float32)
    x_cpu = torch.randn((1, MOE_LAYER_S, cfg.d_model), generator=gen)
    p_dev = {k: ({kk: vv.to(device) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(device)) for k, v in p_cpu.items()}
    x_dev = x_cpu.to(device)
    m = {}
    with torch.inference_mode():
        want = PM.moe_apply(p_cpu, x_cpu, cfg)
        got = PM.moe_apply(p_dev, x_dev, cfg)
        r_cpu, r_dev = PM.route(p_cpu, x_cpu, cfg), PM.route(p_dev, x_dev, cfg)
        check(torch.equal(r_cpu[0], r_dev[0].cpu()) and torch.equal(r_cpu[2], r_dev[2].cpu()),
              "moe layer: the card routes or drops other slots than the CPU")
        m["dropped_slots"] = int((~r_cpu[2]).sum())
        m["capacity"] = r_cpu[4]
        m["rel_err_vs_cpu"] = rel_err(got.cpu(), want)
        check(m["rel_err_vs_cpu"] < MOE_LAYER_TOL and bool(torch.isfinite(got).all()),
              f"moe layer: card vs CPU rel err {m['rel_err_vs_cpu']} >= {MOE_LAYER_TOL}")
        m["fault_rel_err_vs_cpu"] = rel_err(moe_unnormalised(p_dev, x_dev, cfg).cpu(), want)
        check(m["fault_rel_err_vs_cpu"] >= MOE_LAYER_TOL,
              f"moe layer: the check missed the planted fault: "
              f"{m['fault_rel_err_vs_cpu']} < {MOE_LAYER_TOL}")
    del p_cpu, p_dev
    print(f"  moe layer {MOE_ARCH} float32 B=1 S={MOE_LAYER_S}: "
          + " ".join(f"{k}={v!r}" for k, v in m.items()))
    if device.type != "cuda":
        return m

    # where one bf16 layer's time goes at the prefill shape
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device=device).manual_seed(SEED)
    p = PM.moe_init(gen, cfg, torch.bfloat16)
    x = torch.randn((SERVE_B, SERVE_P, cfg.d_model), generator=gen,
                    device=device).to(torch.bfloat16)
    with torch.inference_mode():
        flat_e, pos_clip, keep, flat_w, C = PM.route(p, x, cfg)
        buf = PM.dispatch(x, flat_e, pos_clip, cfg.num_experts, C)
        eo = PM.expert_ffn(p["experts"], buf)
        out = PM.combine(eo, flat_e, pos_clip, keep, flat_w, SERVE_P)
        pieces = {
            "route": lambda: PM.route(p, x, cfg),
            "dispatch": lambda: PM.dispatch(x, flat_e, pos_clip, cfg.num_experts, C),
            "expert_einsums": lambda: PM.expert_ffn(p["experts"], buf),
            "combine": lambda: PM.combine(eo, flat_e, pos_clip, keep, flat_w, SERVE_P),
            "shared_experts": lambda: PM.residual_ffn(p, x, out),
            "moe_apply": lambda: PM.moe_apply(p, x, cfg),
        }
        split = {k: cuda_ms(fn, 10) for k, fn in pieces.items()}
        wall, avgs = profiled(pieces["moe_apply"])
    dev = device_kernels(avgs)
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"  moe layer {MOE_ARCH} bf16 B={SERVE_B} S={SERVE_P} capacity={C} "
          f"dropped_slots={int((~keep).sum())} ms_by_events="
          + " ".join(f"{k}={v!r}" for k, v in split.items()))
    print(f"  moe layer bf16 under the profiler: wall_s={wall!r} device_busy_us="
          f"{sum(us for _, us in dev.values())!r} top={[(k[:50], c, round(us, 1)) for k, (c, us) in top]}")
    del p, x, buf, eo, out
    torch.cuda.empty_cache()
    m["split_ms"] = split
    return m


def phase_serve_moe(device):
    """Cell ``serve_qwen2_moe_a2_7b_p2048``: phase 8's serving path on
    qwen2-moe-a2.7b at full width in bf16 (float32 at ``MOE_F32_LAYERS``
    layers), the planted fault the kernel route with ``causal`` ignored;
    ``flash_attention`` at its prefill shape by events beside SDPA and the
    bound (its device µs a launch is phase 8's profile of the bf16 route,
    ``flash_device_us``); the MoE layer on the card against the CPU."""
    launches, out = phase_serve(device, arch=MOE_ARCH,
                                layers={"float32": MOE_F32_LAYERS}, fault=causal_ignored)
    t = time_flash(device, "bfloat16", case=MOE_FLASH) if device.type == "cuda" else {}
    if t:  # its device µs a launch is the bf16 serving profile's flash_device_us
        print(f"  flash_attention at {t['shape']} bfloat16: " + " ".join(
            f"{k}={v!r}" for k, v in t.items() if k not in ("shape", "dtype")))
    out["moe_layer"] = phase_moe_layer(device)
    out["flash"] = t
    return launches, out


# ---------------------------------------------------------------------------
# Phase 15: serving the dense, vision and encoder-decoder families
# ---------------------------------------------------------------------------


def family_cells():
    """Phase 15's cells: each a ``phase_serve`` at full width and depth, in
    bf16 and float32, with its family's planted fault."""
    return {
        # B 4 x 2,048 prompt tokens, cache 2,080, 32 decode steps (phase 8's)
        "serve_gemma3_4b_p2048": dict(arch="gemma3-4b", fault=window_ignored),
        # 576 patch embeddings + 1,472 text tokens a prompt
        "serve_phi3_vision_4_2b_p2048": dict(arch="phi-3-vision-4.2b", fault=causal_ignored),
        # 1,500 frames (one 30 s window) a prompt of 224 tokens, cache 448
        "serve_whisper_base_src1500": dict(arch="whisper-base", B=8, P=224, cap=448,
                                           fault=encoder_causal,
                                           cfg_kw={"attn_q_chunk": WHISPER_Q_CHUNK}),
    }


def phase_serve_families(device, cells=None):
    """Cells ``serve_gemma3_4b_p2048`` (34 layers: 5 periods of 5 local and
    1 global layer, then 4 local; hd 256, 8 over 4 heads, window 1,024,
    qk-norm, a tied 262,144-row head), ``serve_phi3_vision_4_2b_p2048``
    (hd 96, 32 over 32 heads, 576 patch embeddings spliced over the first
    positions) and ``serve_whisper_base_src1500`` (a non-causal encoder of
    6 layers over 1,500 frames, a causal decoder of 6 with cross-attention
    into them): phase 8's ``phase_serve`` each, with the counts set to 0
    before each cell and read after it.  Then ``flash_attention`` at each
    new prefill shape (``FAMILY_FLASH``) by events, SDPA in turns, and the
    bound.  Returns (launches by cell and type, metrics by cell and type,
    timings by shape)."""
    import torch

    launches, out, flash = {}, {}, {}
    for cell, kw in (cells or family_cells()).items():
        if device.type == "cuda":
            torch.cuda.empty_cache()
        launches[cell], out[cell] = phase_serve(device, **kw)
        for dtype, n in launches[cell].items():
            check(n > 0, f"{cell}: flash_attention ({dtype}) was never launched")
    if device.type == "cuda":
        torch.cuda.empty_cache()
        for shape, case in FAMILY_FLASH.items():
            flash[shape] = t = time_flash(device, "bfloat16", case=case)
            print(f"  flash_attention {shape} at {case} bfloat16: " + " ".join(
                f"{k}={v!r}" for k, v in t.items() if k not in ("shape", "dtype")))
    return launches, out, flash


def family_launches(launches):
    """Each ``FAMILY_FLASH`` shape's launches in its cell's bf16 prefills:
    the wrapper's count over the cell (checked there to be the attention
    layers times the prefills) split by the layers of that shape."""
    from repro_torch.configs import get_config

    g = get_config("gemma3-4b")
    period = g.local_global_ratio + 1
    glob = sum(g.layer_is_global(li % period) for li in range(g.num_layers))
    n_g = launches["serve_gemma3_4b_p2048"]["bfloat16"] // g.num_layers
    w = get_config("whisper-base")
    n_w = launches["serve_whisper_base_src1500"]["bfloat16"] // (w.num_layers
                                                                 + w.num_encoder_layers)
    return {"gemma3_4b_local": n_g * (g.num_layers - glob), "gemma3_4b_global": n_g * glob,
            "phi3_vision_4_2b": launches["serve_phi3_vision_4_2b_p2048"]["bfloat16"],
            "whisper_base_encoder": n_w * w.num_encoder_layers,
            "whisper_base_decoder": n_w * w.num_layers}


# ---------------------------------------------------------------------------
# Phase 12: training, hymba-1.5b at full width; card vs CPU; the guard;
# elastic recovery; the expert-parallel MoE layer
# ---------------------------------------------------------------------------


def state_to(tree, device):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to(device), tree)


def leafwise_equal(a, b):
    """Paths of the leaves of ``a`` that are not bitwise ``b``'s (type too)."""
    import torch
    from repro_torch.tree import leaves_with_paths

    bl = dict(leaves_with_paths(b))
    return [p for p, t in leaves_with_paths(a)
            if t.dtype != bl[p].dtype or not torch.equal(t, bl[p].to(t.device))]


def train_run(device, workdir, *, arch=TRAIN_ARCH, B=TRAIN_B, S=TRAIN_S, steps=TRAIN_STEPS,
              smoke=False):
    """Cell ``train_hymba_1_5b_b4s2048``: ``repro_torch.launch.train``'s
    ``main`` on ``device`` at full width (bf16 parameters, float32 AdamW
    moments, ``--remat full``); s per step, tokens/s, peak memory and the
    loss at each step; the end checkpoint's bytes and write seconds, its
    restore into a fresh template on the card (bit-exact, leaf for leaf,
    against the trainer's final state) and one more step of the restored
    state under the profiler (idle share, top device operations).  A batch
    that does not fit is halved, and the cut printed."""
    import math
    import shutil
    import torch
    from repro_torch.checkpoint import restore
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed.meshes import NamedSharding, P, make_mesh
    from repro_torch.launch import train as LT
    from repro_torch.models import Runtime, build_model
    from repro_torch.optim import AdamW, AdamWConfig, WarmupCosine
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.tree import eval_shape, tree_map

    ckpt_dir = workdir / "ckpt_train"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    workdir.mkdir(parents=True, exist_ok=True)
    du = shutil.disk_usage(workdir)
    print(f"  disk at {short_path(workdir)}: total={du.total} used={du.used} free={du.free}")
    m = {"batch": B}
    while True:
        argv = ["--arch", arch, "--remat", "full", "--opt-dtype", "float32",
                "--batch", str(B), "--seq", str(S), "--steps", str(steps),
                "--ckpt-dir", str(ckpt_dir), "--ckpt-every", str(10 ** 9),
                "--device", device.type] + (["--smoke"] if smoke else [])
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        try:
            out = LT.main(argv)
            break
        except torch.cuda.OutOfMemoryError:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            check(B > 1, "training does not fit at batch 1")
            print(f"  batch {B} x {S} does not fit on the card; cut to {B // 2}")
            B //= 2
            m["batch"] = B
    losses = [h["loss"] for h in out["history"]]
    check(out["final_step"] == steps and all(math.isfinite(x) for x in losses),
          f"training: step {out['final_step']} of {steps}, losses {losses}")
    dts = [h["dt"] for h in out["history"]]
    m.update(losses=losses, step_s=dts, s_per_step=statistics.median(dts[1:]),
             tokens_per_s=B * S / statistics.median(dts[1:]))
    if device.type == "cuda":
        m["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    step_dir = ckpt_dir / f"step_{steps:010d}"
    m["ckpt_bytes"] = sum(f.stat().st_size for f in step_dir.iterdir())
    m["ckpt_snapshot_s"], m["ckpt_write_s"] = out["ckpt_snapshot_s"], out["ckpt_write_s"]
    args = LT.parse_args(argv)

    # restore into a fresh template on the card: bit-exact, leaf for leaf
    trainer_state = out.pop("state")
    cfg = reduced(get_config(arch)) if smoke else get_config(arch)
    model = build_model(cfg, Runtime(remat="full"))
    opt = AdamW(AdamWConfig(state_dtype="float32"))
    like = eval_shape(lambda: init_state(model, opt, 0, device="cpu"))
    mesh = make_mesh((1, 1), ("data", "model"), device=device)
    shardings = tree_map(lambda t: NamedSharding(mesh, P()), like)
    sync(device)
    t0 = time.perf_counter()
    restored, meta = restore(str(step_dir), like, shardings=shardings)
    sync(device)
    m["restore_s"] = time.perf_counter() - t0
    bad = leafwise_equal(restored, trainer_state)
    check(not bad and meta["step"] == steps,
          f"restore: {len(bad)} leaves differ from the trainer's final state: {bad[:4]}")
    del trainer_state
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"  train {arch} B={B} S={S}: " + " ".join(f"{k}={v!r}" for k, v in m.items()))

    # one more step of the restored state, under the profiler
    data = SyntheticLM(cfg, B, S, DataConfig(seed=0))
    batch = {k: torch.from_numpy(v).to(device) for k, v in data.global_batch(steps).items()}
    sched = WarmupCosine(peak_lr=args.lr, warmup_steps=max(steps // 10, 1), decay_steps=steps)
    step = make_train_step(model, opt, sched, donate=True)  # as the Trainer's
    if device.type == "cuda":
        def one():
            new, met = step(restored, batch)
            float(met["loss"])

        wall, avgs = profiled(one)
        dev = device_kernels(avgs)
        busy = sum(us for _, us in dev.values()) * 1e-6
        top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:8]
        m.update(profiled_step_s=wall, device_busy_s=busy,
                 idle_share=1.0 - busy / wall if busy > 0 else None)
        print(f"  profiled step: wall_s={wall!r} device_busy_s={busy!r} "
              f"idle_share={m['idle_share']!r}")
        for k, (c, us) in top:
            print(f"    top device op: {k[:70]} count={c} device_us={us!r}")
    del restored, batch
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return m


def warm_state(state, seed=SEED):
    """``state`` with AdamW moments drawn from a seed, count and step 10:
    a state in mid-run.  (At count 0 Adam's step is m/(sqrt(v)+eps) ≈
    sign(g) wherever |g| is near eps, which turns float32 rounding of a
    tiny gradient into a whole step; mid-run, v carries earlier gradients.)"""
    import torch
    from repro_torch.tree import tree_map

    gen = torch.Generator(device="cpu").manual_seed(seed)

    def moment(t, scale):
        return (torch.randn(t.shape, generator=gen) * scale).to(t.device, t.dtype)

    out = dict(state)
    out["opt"] = dict(state["opt"],
                      m=tree_map(lambda t: moment(t, 1e-3), state["opt"]["m"]),
                      v=tree_map(lambda t: moment(t, 1e-3).square() + 1e-8, state["opt"]["v"]),
                      count=torch.full_like(state["opt"]["count"], 10))
    out["step"] = torch.full_like(state["step"], 10)
    return out


def train_card_vs_cpu(device, *, arch=TRAIN_ARCH, layers=2, B=1, S=256, smoke=False):
    """One train step of ``arch`` at full width and ``layers`` layers,
    float32, on the card and on the CPU from the same carried state (TF32
    off): loss rel. < 1e-5, grad norm < 1e-4, every updated parameter
    max |Δ| / max |p| < 1e-4; ``remat`` none / full / dots on the card
    within rel. 1e-6 of each other.  Then the repaired guard: the same
    step with ``attn_impl="pallas"`` on the card must raise."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Runtime, build_model
    from repro_torch.optim import AdamW, WarmupCosine
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.tree import leaves_with_paths

    base = get_config(arch)
    cfg = (reduced(base) if smoke else base).replace(num_layers=layers, dtype="float32")
    opt = AdamW()
    sched = WarmupCosine(peak_lr=1e-3, warmup_steps=1, decay_steps=100)
    cpu = torch.device("cpu")
    state_cpu = warm_state(init_state(build_model(cfg, Runtime(remat="none")), opt, SEED,
                                      device=cpu))
    batch_np = SyntheticLM(cfg, B, S).global_batch(0)

    def run(dev, remat, attn="auto"):
        model = build_model(cfg, Runtime(remat=remat, attn_impl=attn))
        st = state_to(state_cpu, dev) if dev.type != "cpu" else state_cpu
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        new, met = make_train_step(model, opt, sched)(st, batch)
        return state_to(new["params"], cpu), {k: float(v) for k, v in met.items()}

    t0 = time.perf_counter()
    want_p, want = run(cpu, "none")
    m = {"cpu_step_s": time.perf_counter() - t0, "loss": want["loss"],
         "grad_norm": want["grad_norm"]}
    got = {}
    for remat in ("none", "full", "dots"):
        p, met = run(device, remat)
        got[remat] = (p, met)
        pl = dict(leaves_with_paths(p))
        worst = max(rel_err(pl[k], w) for k, w in leaves_with_paths(want_p))
        m[f"{remat}_loss_rel"] = abs(met["loss"] - want["loss"]) / abs(want["loss"])
        m[f"{remat}_grad_norm_rel"] = abs(met["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
        m[f"{remat}_param_rel"] = worst
        check(m[f"{remat}_loss_rel"] < 1e-5 and m[f"{remat}_grad_norm_rel"] < 1e-4
              and worst < 1e-4 and np.isfinite(met["loss"]),
              f"train step remat={remat} card vs CPU: {m}")
    for remat in ("full", "dots"):
        p, met = got[remat]
        p0, met0 = got["none"]
        spread = max(abs(met["loss"] - met0["loss"]) / abs(met0["loss"]),
                     max(rel_err(dict(leaves_with_paths(p))[k], w)
                         for k, w in leaves_with_paths(p0)))
        m[f"{remat}_vs_none_rel"] = spread
        check(spread < 1e-6, f"train step remat={remat} vs none on the card: {spread}")
    if device.type == "cuda":  # the repaired guard: no quiet detached kernel output
        try:
            run(device, "none", attn="pallas")
        except RuntimeError as e:
            check("no backward" in str(e), f"guard raised another error: {e}")
            m["pallas_under_grad"] = "raised: " + str(e)[:60]
        else:
            check(False, "a train step with attn_impl='pallas' on the card returned a loss")
    print(f"  train step {cfg.name} x{layers} layers float32 B={B} S={S} card vs CPU: "
          + " ".join(f"{k}={v!r}" for k, v in m.items()))
    return m


def train_elastic(device, workdir):
    """Cell ``train_elastic_granite_reduced_u4``, ``tests/test_multidevice.py``'s
    scenario on logical units of the card: reduced granite-8b (vocab 512,
    float32) on 8 units, ``model_par=2``, master weights, B 8 x S 32, 30
    steps, a checkpoint every 8, two units lost at step 18; it must finish
    at step 30 after one recovery with the final loss of an uninterrupted
    run (rtol 1e-5); then ``rescale`` onto 4 units restores step 30."""
    import shutil
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.fault import FailureInjector
    from repro_torch.distributed.meshes import units
    from repro_torch.models import Runtime, build_model
    from repro_torch.optim import AdamW, AdamWConfig, WarmupCosine
    from repro_torch.train.loop import Trainer, TrainerConfig

    cfg = reduced(get_config("granite-8b")).replace(vocab_size=512, dtype="float32")
    unit_list = units(device, count=8)

    def trainer(tag, injector):
        d = workdir / f"ckpt_elastic_{tag}"
        shutil.rmtree(d, ignore_errors=True)
        return Trainer(
            cfg, build_model(cfg, Runtime(remat="none")), AdamW(AdamWConfig(master_weights=True)),
            WarmupCosine(peak_lr=2e-3, warmup_steps=3, decay_steps=30),
            SyntheticLM(cfg, batch=8, seq_len=32),
            TrainerConfig(total_steps=30, ckpt_every=8, ckpt_dir=str(d), log_every=1000),
            devices=unit_list, model_par=2, failure_injector=injector, device=device)

    t0 = time.perf_counter()
    tr = trainer("fail", FailureInjector(schedule={18: 2}))
    out = tr.run()
    m = {"elastic_s": time.perf_counter() - t0}
    full = trainer("full", None).run()
    m.update(final_step=out["final_step"], recoveries=out["recoveries"],
             final_loss=out["final_loss"], uninterrupted_final_loss=full["final_loss"],
             mesh_after=dict(tr.mesh.shape))
    check(out["final_step"] == 30 and out["recoveries"] == 1,
          f"elastic: step {out['final_step']}, recoveries {out['recoveries']}")
    check(abs(out["final_loss"] - full["final_loss"]) <= 1e-5 * abs(full["final_loss"]),
          f"elastic: final loss {out['final_loss']} vs uninterrupted {full['final_loss']}")
    tr.rescale(unit_list[:4])
    _, step = tr._init_or_restore()
    m["rescaled_to"], m["restored_step"] = dict(tr.mesh.shape), step
    check(step == 30, f"rescale onto 4 units restored step {step}")
    for tag in ("fail", "full"):
        shutil.rmtree(workdir / f"ckpt_elastic_{tag}", ignore_errors=True)
    print("  train_elastic_granite_reduced_u4: " + " ".join(f"{k}={v!r}" for k, v in m.items()))
    return m


def moe_ep_layer(device, smoke=False):
    """Cell ``moe_ep_layer_qwen2_moe_a2_7b_mp4``: one qwen2-moe-a2.7b MoE
    block at full width through ``moe_apply_ep`` under a (1, 4) mesh of
    logical units, float32, B 1 x S 256, on the card and on the CPU: rel.
    err < 1e-4 and the same kept slots in every model column."""
    import math
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.ctx import mesh_context
    from repro_torch.distributed.meshes import make_mesh, units
    from repro_torch.models import moe as PM

    cfg = get_config(MOE_ARCH)
    cfg = (reduced(cfg) if smoke else cfg).replace(dtype="float32")
    cpu = torch.device("cpu")
    gen = torch.Generator(device=cpu).manual_seed(SEED)
    p_cpu = PM.moe_init(gen, cfg, torch.float32)
    x_cpu = torch.randn((1, MOE_LAYER_S, cfg.d_model), generator=gen)
    p_dev = state_to(p_cpu, device)
    mp = 4
    m = {}
    with torch.inference_mode():
        out = {}
        for dev, p, x in ((cpu, p_cpu, x_cpu), (device, p_dev, x_cpu.to(device))):
            mesh = make_mesh((1, mp), ("data", "model"), devices=units(dev, count=mp))
            with mesh_context(mesh):
                out[dev.type] = PM.moe_apply_ep(p, x, cfg, mesh)
        m["rel_err_vs_cpu"] = rel_err(out[device.type].cpu(), out["cpu"])
        E_loc = cfg.num_experts // mp
        k = cfg.num_experts_per_tok
        C = max(1, math.ceil(1.25 * MOE_LAYER_S * k / cfg.num_experts))
        kept = []
        for j in range(mp):
            r = [PM.local_route(x.reshape(-1, cfg.d_model).float() @ p["router"], e_base=j * E_loc,
                                E_loc=E_loc, k=k, C=C)
                 for p, x in ((p_cpu, x_cpu), (p_dev, x_cpu.to(device)))]
            check(all(torch.equal(a, b.cpu()) for a, b in zip(r[0][:3], r[1][:3])),
                  f"moe ep: column {j} keeps other slots on the card than on the CPU")
            kept.append(int(r[0][2].sum()))
        m.update(capacity=C, kept_per_column=kept)
    check(m["rel_err_vs_cpu"] < MOE_LAYER_TOL and bool(torch.isfinite(out[device.type]).all()),
          f"moe ep: card vs CPU rel err {m['rel_err_vs_cpu']} >= {MOE_LAYER_TOL}")
    print(f"  moe_ep_layer {cfg.name} mp={mp} float32 B=1 S={MOE_LAYER_S}: "
          + " ".join(f"{k}={v!r}" for k, v in m.items()))
    del p_dev
    return m


def phase_train(device, workdir, smoke=False):
    """Phase 12: the training slice's cells."""
    kw = dict(arch="granite-8b", B=2, S=64, steps=3, smoke=True) if smoke else {}
    out = {"train": train_run(device, workdir, **kw)}
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    out["card_vs_cpu"] = train_card_vs_cpu(device, **({"S": 32, "smoke": True} if smoke else {}))
    out["elastic"] = train_elastic(device, workdir)
    out["moe_ep"] = moe_ep_layer(device, smoke=smoke)
    return out


# ---------------------------------------------------------------------------
# Phase 13: co-scheduling real training jobs, cosched_trio_u4
# ---------------------------------------------------------------------------


class FixedSpecs:
    """A perf model that returns the specs Phase I measured."""

    def __init__(self, specs):
        self.specs = specs

    def spec(self, name):
        return self.specs[name]

    def profiling_energy(self, name):
        return 0.0


def phase_cosched(device, workdir, steps=COSCHED_STEPS, *, cell="cosched_trio_u4",
                  host_devices=COSCHED_UNITS, jobs=None):
    """Cell ``cosched_trio_u4``: ``repro_torch.launch.coschedule``'s main
    on ``device`` with 4 logical units, K = 2, the reference's default jobs
    (reduced), batch 4, seq 64; ``score_reduce`` must have launched on this
    path; every recorded ``on_event``, replayed through
    ``EcoSched(engine="vector")`` on the same measured specs, must give the
    same launches; every job must finish with a finite loss.  Phase 16
    runs it as ``cosched_cards``: ``host_devices`` None (a unit per card)
    and two of the ``jobs``."""
    import math
    import os
    import shutil
    from repro_torch.core.ecosched import EcoSched
    from repro_torch.kernels import score_reduce as K
    from repro_torch.launch import coschedule as LC

    ckpt = workdir / "cosched"
    shutil.rmtree(ckpt, ignore_errors=True)
    old = os.environ.pop("REPRO_HOST_DEVICES", None)
    if host_devices is not None:
        os.environ["REPRO_HOST_DEVICES"] = str(host_devices)
    try:
        K.reset_stats()
        out = LC.main(["--device", device.type, "--steps", str(steps), "--batch", "4",
                       "--seq", "64", "--domains", "2", "--lam", str(LAM), "--tau", str(TAU),
                       "--ckpt-dir", str(ckpt)] + (["--jobs", jobs] if jobs else []))
        stats = read_stats()
    finally:
        if old is None:
            os.environ.pop("REPRO_HOST_DEVICES", None)
        else:
            os.environ["REPRO_HOST_DEVICES"] = old
    shutil.rmtree(ckpt, ignore_errors=True)
    vec = EcoSched(FixedSpecs(out["specs"]), lam=LAM, tau=TAU, engine="vector")
    for i, (view, asked, launches, _) in enumerate(out["events"]):
        want = vec.on_event(view, list(asked))
        check([(l.job, l.g, l.f) for l in launches] == [(l.job, l.g, l.f) for l in want],
              f"cosched: event {i} launched {launches}, the vector engine {want}")
    losses = {n: r["final_loss"] for n, r in out["results"].items()}
    n_jobs = len(jobs.split(",")) if jobs else 3
    check(len(losses) == n_jobs and all(math.isfinite(x) for x in losses.values()),
          f"cosched: final losses {losses}")
    m = {"units": out["units"], "phase1_s": out["phase1_s"],
         "t_hat": {n: {g: round(t, 6) for g, t in th.items()} for n, th in out["t_hat"].items()},
         "events": len(out["events"]), "makespan_s": out["makespan"], "final_losses": losses,
         "score_reduce_launches": stats["score_reduce"]["launches"],
         "score_reduce_guarded": stats["score_reduce"]["guarded"]}
    print(f"  {cell}: " + " ".join(f"{k}={v!r}" for k, v in m.items()))
    return m


# ---------------------------------------------------------------------------
# Phase 14: the roofline path -- dry-runs on fake tensors of the card, and
# RooflinePerfModel driving EcoSched(engine="torch")
# ---------------------------------------------------------------------------


def roof_cells(train_B):
    """Phases 8's and 12's shapes as dry-run cells (``train_B``: the
    batch phase 12 trained)."""
    from repro_torch.configs.base import ShapeCell

    B, P, cap, S = SERVE_B, SERVE_P, SERVE_CAP, TRAIN_S
    return {"prefill": ShapeCell(f"prefill_b{B}s{P}", "prefill", P, B),
            "decode": ShapeCell(f"decode_b{B}c{cap}", "decode", cap, B),
            "train": ShapeCell(f"train_b{train_B}s{S}", "train", S, train_B)}


def dryrun_one_card(device, arch, cell, **kw):
    """``dryrun_cell`` of ``arch`` at full width on a (1, 1) mesh against
    the H100, on fake tensors of ``device``: the record, its
    ``derive_terms`` and the seconds.  On the card, memory allocated must
    not move and its peak must not rise."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.meshes import AbstractMesh
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline import analysis as RA
    from repro_torch.roofline.hw import H100

    t0 = time.perf_counter()
    rec = dryrun_window(device, lambda: D.dryrun_cell(
        arch, cell, mesh=AbstractMesh((1, 1), ("data", "model")), device=device, **kw))
    wall = time.perf_counter() - t0
    return rec, RA.derive_terms(rec, get_config(arch), cell, H100), wall


def roof_line(arch, cell, rec, terms, wall):
    from repro_torch.configs import get_config
    from repro_torch.roofline import analysis as RA

    floor = RA.hbm_floor_bytes(rec, get_config(arch), cell, dp=1, mp=1)
    ct = rec["cost_totals"]
    return (f"{arch} {cell.name}: flops={ct['flops']!r} "
            f"model_flops={rec['model_flops_total']!r} "
            f"ratio={ct['flops'] / rec['model_flops_total']!r} bytes={ct['bytes']!r} "
            f"transcendentals={ct['transcendentals']!r} hbm_floor_bytes={floor!r} "
            f"argument_bytes={rec['memory']['argument_bytes']} "
            f"peak_bytes={rec['peak_bytes_counted']} t_compute={terms['t_compute']!r} "
            f"t_memory={terms['t_memory']!r} t_memory_hlo={terms['t_memory_hlo']!r} "
            f"t_collective={terms['t_collective']!r} t_bound={terms['t_bound']!r} "
            f"dominant={terms['dominant']} trace_s={rec['trace_s_full']} "
            f"trace_s_variants={rec.get('trace_s_variants')} wall_s={wall!r}")


def roof_truth(cells, chip, counts, units_to_chips=1):
    """``benchmarks/bench_tpu_pod.py``'s ``build_truth``: the roofline
    model's curves with a per-job collective exponent the scheduler does
    not see (inert where the collective term is 0, as on one card)."""
    from repro_torch.core import JobProfile, RooflinePerfModel

    truth = {}
    for i, (name, cell) in enumerate(sorted(cells.items())):
        real = dict(cell)
        real["alpha_coll"] = 0.2 + 0.05 * (i % 5)
        runtime, power = {}, {}
        for g in counts:
            chips = g * units_to_chips
            tc, tm, tl = RooflinePerfModel(
                {name: real}, counts=counts, chip=chip,
                units_to_chips=units_to_chips)._terms_at(real, chips)
            step_t = max(tc, tm, tl)
            runtime[g] = step_t * cell["steps"]
            util = tc / step_t
            per_chip = chip.power_idle + (chip.power_peak - chip.power_idle) * (
                0.3 + 0.7 * util)
            power[g] = per_chip * chips
        truth[name] = JobProfile(name=name, runtime=runtime, busy_power=power)
    return truth


def phase_roofline(device, path, measured):
    """Cells ``dryrun_hymba_1_5b_one_card`` and ``roofline_sched_h100_node``.

    The first dry-runs hymba-1.5b at full width in bf16 on a (1, 1) mesh
    (prefill and decode as phase 8 serves them, train as phase 12 trains:
    remat full, float32 moments, no ZeRO master copy, one microbatch), with
    the reduced-layer variants, and holds (a) nothing allocated on the
    card, (b) counted FLOPs / model_flops in ``ROOF_BANDS``, (c) each
    ``t_bound`` at most ``ROOF_BOUND_SLACK`` times the time ``measured``
    in this run (``{"prefill": s, "decode": s a step, "train": s a step,
    "train_peak": bytes}``), (d) the train cell's argument bytes within
    phase 12's measured peak.  The second dry-runs prefill and decode of
    ``ROOF_ARCHS`` (``--skip-variants``), makes ``RooflinePerfModel`` cells of
    their ``derive_terms`` and simulates the paper's H100 node with
    ``EcoSched(engine="torch")`` against ``engine="vector"``: the same
    schedule, and ``score_reduce`` launched (counted into ``path``)."""
    from repro_torch.core import (EcoSched, Node, RooflinePerfModel, SequentialOptimal,
                                  simulate, summarize)
    from repro_torch.kernels import score_reduce as K
    from repro_torch.models import Runtime
    from repro_torch.roofline.hw import H100

    cells = roof_cells(measured["train_B"])
    rt = Runtime(remat="full", attn_impl="auto")
    out = {"records": {}}
    one_card = {}
    for kind, cell in cells.items():
        kw = dict(rt=rt, grad_accum=1)
        if kind == "train":
            kw.update(opt_dtype="float32", zero=False)
        rec, terms, wall = dryrun_one_card(device, SERVE_ARCH, cell, **kw)
        print("  dryrun_hymba_1_5b_one_card " + roof_line(SERVE_ARCH, cell, rec, terms, wall))
        check(rec["cost_totals"] == rec["cost_full_module"],
              f"{cell.name}: the extrapolated count differs from the full one")
        ratio = rec["cost_totals"]["flops"] / rec["model_flops_total"]
        lo, hi = ROOF_BANDS[kind]
        check(lo <= ratio <= hi, f"{cell.name}: counted / model_flops {ratio} outside [{lo}, {hi}]")
        frac = terms["t_bound"] / measured[kind]
        print(f"  {cell.name}: t_bound / measured = {terms['t_bound']!r} / "
              f"{measured[kind]!r} s = {frac!r}")
        check(frac <= ROOF_BOUND_SLACK,
              f"{cell.name}: bound {terms['t_bound']} s above the measured {measured[kind]} s")
        one_card[kind] = dict(ratio=ratio, bound_fraction=frac, t_bound=terms["t_bound"],
                              trace_s=rec["trace_s_full"], wall_s=wall)
        out["records"][(SERVE_ARCH, kind)] = (rec, terms)
    train, peak = out["records"][(SERVE_ARCH, "train")][0], measured["train_peak"]
    args = train["memory"]["argument_bytes"]
    check(args <= peak, f"train: argument bytes {args} above the measured peak {peak}")
    one_card["train"].update(argument_over_peak=args / peak,
                             counted_peak_over_measured=train["peak_bytes_counted"] / peak)
    print(f"  train: argument_bytes / measured peak = {args / peak!r}; "
          f"counted peak / measured peak = {train['peak_bytes_counted'] / peak!r}")
    out["one_card"] = one_card

    # roofline_sched_h100_node
    sched_cells = {}
    for arch in ROOF_ARCHS:
        for kind in ("prefill", "decode"):
            if (arch, kind) not in out["records"]:
                rec, terms, wall = dryrun_one_card(device, arch, cells[kind], rt=rt,
                                                   skip_variants=True)
                print("  roofline_sched_h100_node " + roof_line(arch, cells[kind], rec, terms,
                                                                 wall))
                out["records"][(arch, kind)] = (rec, terms)
            rec, terms = out["records"][(arch, kind)]
            check(rec["fits_hbm"], f"{arch} {kind}: the dry-run says it does not fit")
            sched_cells[f"{arch}@{kind}"] = {
                "chips_ref": rec["chips"], "t_compute": terms["t_compute"],
                "t_memory": terms["t_memory"], "t_collective": terms["t_collective"],
                "steps": ROOF_STEPS[kind]}
    truth = roof_truth(sched_cells, H100, ROOF_COUNTS)
    node = Node(4, 2, H100.power_idle)
    res = {}
    for engine in ("torch", "vector"):
        pm = RooflinePerfModel(sched_cells, counts=ROOF_COUNTS, chip=H100, units_to_chips=1)
        extra = {"device": device} if engine == "torch" else {}
        pol = EcoSched(pm, lam=LAM, tau=TAU, engine=engine, **extra)
        if engine == "torch":
            K.reset_stats()
        res[engine] = simulate(pol, node, truth, queue=sorted(truth))
        if engine == "torch":
            kstats = read_stats()
            path.add(kstats)
    check(fp(res["torch"]) == fp(res["vector"]),
          f"roofline_sched_h100_node: torch schedule {fp(res['torch'])} differs from "
          f"vector {fp(res['vector'])}")
    n = kstats["score_reduce"]["launches"]
    check(n > 0, "roofline_sched_h100_node: score_reduce was never launched")
    base = simulate(SequentialOptimal(truth), node, truth, queue=sorted(truth))
    s = summarize(base, res["torch"])
    choices = {r.job: r.g for r in res["torch"].records if r.kind == "run"}
    out["sched"] = dict(fp=fp(res["torch"])[0], makespan=res["torch"].makespan,
                        energy=res["torch"].total_energy, launches=n,
                        guarded=kstats["score_reduce"]["guarded"], choices=choices,
                        energy_saving=s["energy_saving"],
                        makespan_improvement=s["makespan_improvement"],
                        edp_saving=s["edp_saving"])
    print("  roofline_sched_h100_node: " + " ".join(f"{k}={v!r}" for k, v in out["sched"].items()))
    return out


# ---------------------------------------------------------------------------
# Phase 16: data-parallel training over ranks, train_dp_granite_reduced_cards
# ---------------------------------------------------------------------------


def dp_probe(mesh):
    """The train step's collectives on the ranks' own devices (all-reduce,
    reduce-scatter, all-gather, through the port's wrappers), each held to
    its answer; {collective: why it was refused} for those the backend
    refuses."""
    import torch
    from repro_torch.distributed.meshes import NamedSharding, P

    n, i = len(mesh.ranks), mesh.index
    x = (torch.arange(4 * n, dtype=torch.float32, device=mesh.device) + 1) * (i + 1)
    share = NamedSharding(mesh, P("data"))
    want = torch.arange(4 * n, dtype=torch.float32, device=mesh.device) + 1
    want = want * (n + 1) / 2  # the ranks' mean of x
    refused = {}
    for name, fn, ok in (
            ("all_reduce", lambda: mesh.mean(x), lambda y: torch.equal(y, want)),
            ("reduce_scatter", lambda: share.reduce(x),
             lambda y: torch.equal(y, want[4 * i:4 * i + 4])),
            ("all_gather", lambda: share.gather(want[4 * i:4 * i + 4].clone()),
             lambda y: torch.equal(y, want))):
        try:
            y = fn()
        except RuntimeError as e:  # the refusal is what this probe reports
            refused[name] = str(e).strip().splitlines()[0][:160]
            continue
        check(ok(y), f"{name} over {mesh.device} gave {y.tolist()}")
    return refused


class CollectiveClock:
    """The port's collectives while entered (``torch.distributed``'s
    all-reduce and ``distributed/meshes.py``'s reduce-scatter and
    all-gather): each call's name, type, elements and µs, waits for the
    other ranks included.  NCCL returns when a collective is queued, so on
    a card it is timed by CUDA events around the call on the caller's
    stream, which waits for the collective; gloo returns when it is done,
    so it is timed on the host.  Each call also keeps its result's bytes
    (the tensor reduced in place, or the gathered or scattered output), as
    the dry-run counts them (``coll_of``).  ``take()`` hands back and
    clears the calls so far; each train step built by ``make_train_step`` while
    entered closes a tally of its own (``per_step_us``).  Read either
    after the device has synchronised.  A group's first collective also
    sets up its communicator, and checkpoints gather between steps: the
    median step is the steady one."""

    def __init__(self, events: bool):
        self.events = events

    def __enter__(self):
        import torch.distributed as dist
        from repro_torch.distributed import meshes
        from repro_torch.train import loop

        self.calls, self._steps = [], []
        self._orig = [(mod, name, getattr(mod, name)) for mod, name in (
            (dist, "all_reduce"), (meshes, "_reduce_scatter"), (meshes, "_all_gather"),
            (loop, "make_train_step"))]
        for mod, name, fn in self._orig:
            setattr(mod, name, self._stepped(fn) if name == "make_train_step"
                    else self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        import torch

        def call(*a, **k):
            t = a[0] if name == "all_reduce" else a[1]  # the input
            res = a[0].numel() * a[0].element_size()  # the result (the output)
            if self.events:
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                out = fn(*a, **k)
                e1.record()
                self.calls.append((name, str(t.dtype), t.numel(), (e0, e1), res))
                return out
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.calls.append((name, str(t.dtype), t.numel(),
                               (time.perf_counter() - t0) * 1e6, res))
            return out
        return call

    def _stepped(self, make):
        def build(*a, **k):
            step = make(*a, **k)

            def counted(state, batch):
                out = step(state, batch)
                self._steps.append(self.calls)
                self.calls = []
                return out
            return counted
        return build

    def __exit__(self, *exc):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)

    @staticmethod
    def _in_us(calls):
        return [(n, d, k, us if isinstance(us, float) else us[0].elapsed_time(us[1]) * 1e3, r)
                for n, d, k, us, r in calls]

    def take(self):
        """The calls since the last ``take()`` (or step), as (name, type,
        elements, µs, result bytes)."""
        out, self.calls = self._in_us(self.calls), []
        return out

    def per_step_us(self):
        """Each train step's collective µs."""
        return [sum(c[3] for c in self._in_us(calls)) for calls in self._steps]


def measured_rank(kw, carry):
    """Phase 16's stand-in for ``repro_torch.train.loop._run_rank``, which
    ``dp_scenario`` installs in its own process so that ``Trainer.run()``
    spawns it in every rank: ``_run_rank`` itself under
    ``CollectiveClock``, after (gloo on a card) the step's collectives are
    checked on this rank's device (``dp_probe``; a refusal fails the job
    once recorded).  Each rank writes its steps, median step seconds,
    collective µs per step (median and largest step) and peak memory to
    ``rank<r>.json`` in the job's directory."""
    import torch
    from repro_torch.distributed import procs
    from repro_torch.distributed.meshes import make_mesh
    from repro_torch.train import loop

    torch.backends.cuda.matmul.allow_tf32 = False
    world = procs.current()
    dev = world.device
    cuda = dev.type == "cuda"  # the CPU in a rehearsal
    m = {"rank": world.rank, "device": str(dev)}
    path = Path(kw["tcfg"].ckpt_dir) / f"rank{world.rank}.json"
    if world.backend == "gloo" and cuda:
        m["refused"] = dp_probe(make_mesh((world.size, 1), ("data", "model"),
                                          devices=list(world.units)))
        if m["refused"]:
            path.write_text(json.dumps(m))
            raise RuntimeError(f"gloo refused {sorted(m['refused'])} on CUDA tensors")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    hist, before = carry[0], len(carry[0])  # the Trainer appends this rank's steps
    with CollectiveClock(events=cuda and world.backend == "nccl") as clock:
        out = loop._run_rank(kw, carry)
    sync(dev)
    coll = clock.per_step_us()
    m.update(steps=len(hist) - before,
             step_s=statistics.median(h["dt"] for h in hist[before:]),
             collective_us_per_step=statistics.median(coll), collective_us_max=max(coll),
             peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else "not measured")
    path.write_text(json.dumps(m))
    return out


def dp_scenario(device, workdir, backend, rank_units):
    """``tests/test_multidevice.py``'s elastic scenario at model_par 1 on
    ``rank_units`` (one rank each) over ``backend``, through
    ``Trainer.run()``: reduced granite-8b (vocab 512, float32), master
    weights, B 8 x S 32, 30 steps, a checkpoint every 8, half the ranks
    lost at step 18 (none at world size 1), against the one-process
    Trainer on ``device`` over as many logical units: world size 1 bit
    for bit, more ranks every step's loss of the 30-step history within
    rel. 1e-5; the final parameters' largest difference (relative to
    their leaf's largest magnitude) and the count of elements over 1e-5
    are reported (Adam's step on a near-zero gradient, a rarely seen
    token's embedding row, swings on the last bits of the reduction
    order).  Each rank's numbers come from ``measured_rank``.  With ranks
    on several cards, the survivors' Trainer then rescales onto as many
    other units and restores step 30 (a third start of processes, left
    out on one card)."""
    import shutil
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.fault import FailureInjector
    from repro_torch.distributed.meshes import units
    from repro_torch.models import Runtime, build_model
    from repro_torch.optim import AdamW, AdamWConfig, WarmupCosine
    from repro_torch.train import loop
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.tree import leaves_with_paths

    W = len(rank_units)
    lost = W // 2
    cfg = reduced(get_config("granite-8b")).replace(vocab_size=512, dtype="float32")
    dirs = {tag: workdir / f"dp_{backend}{W}_{tag}" for tag in ("one", "ranks")}

    def trainer(tag, devices, **kw):
        return Trainer(
            cfg, build_model(cfg, Runtime(remat="none")), AdamW(AdamWConfig(master_weights=True)),
            WarmupCosine(peak_lr=2e-3, warmup_steps=3, decay_steps=30),
            SyntheticLM(cfg, batch=8, seq_len=32),
            TrainerConfig(total_steps=30, ckpt_every=8, ckpt_dir=str(dirs[tag]), log_every=1000,
                          timeout_s=300),
            devices=devices, failure_injector=FailureInjector(schedule={18: lost} if lost else {}),
            device=device, **kw)

    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    one = trainer("one", units(device, count=W)).run()
    m = {"world": W, "backend": backend, "cards": len({u.device for u in rank_units}),
         "one_process_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    tr = trainer("ranks", rank_units, backend=backend)
    orig, loop._run_rank = loop._run_rank, measured_rank
    try:
        got = tr.run()
        failure = None
    except RuntimeError as e:  # a gloo refusal is reported; anything else re-raised below
        failure = e
    finally:
        loop._run_rank = orig
    m["ranks_s"] = time.perf_counter() - t0
    ranks = [json.loads(p.read_text()) for p in sorted(dirs["ranks"].glob("rank*.json"))]
    refused = {r["rank"]: r["refused"] for r in ranks if r.get("refused")}
    if refused:
        m["refused"] = refused
        return m
    if failure is not None:
        raise failure
    check(got["final_step"] == 30 and got["recoveries"] == (1 if lost else 0),
          f"dp {backend} x{W}: step {got['final_step']}, recoveries {got['recoveries']}")
    gl = [h["loss"] for h in got["history"]]
    wl = [h["loss"] for h in one["history"]]
    check(len(gl) == len(wl), f"dp {backend} x{W}: {len(gl)} steps against {len(wl)}")
    one_state = dict(leaves_with_paths(one["state"]))
    if W == 1:
        bad = [k for k, t in leaves_with_paths(got["state"])
               if not torch.equal(t, one_state[k].cpu())]
        check(gl == wl and not bad,
              f"dp {backend} x1 vs one process: losses equal {gl == wl}, leaves differ {bad[:4]}")
        m["vs_one_process"] = "bitwise"
    else:
        rels = [abs(a - b) / abs(b) for a, b in zip(gl, wl)]
        step_rel = max(rels)
        at = rels.index(step_rel)
        m["loss_rel_max_at"] = {"entry": at, "step": got["history"][at]["step"],
                                "ranks": gl[at], "one_process": wl[at]}
        over = 0
        for k, t in leaves_with_paths(got["state"]["params"]):
            w = one_state[f"params/{k}"].cpu()
            over += int(((t - w).abs() > 1e-5 * w.abs().max()).sum())
        m.update(loss_rel_max=step_rel, param_rel_max=max(
            rel_err(t, one_state[f"params/{k}"].cpu())
            for k, t in leaves_with_paths(got["state"]["params"])), params_over_1e5=over)
        check(step_rel <= 1e-5,
              f"dp {backend} x{W} vs one process: a step's loss off by rel. {step_rel}")
    m["per_rank"] = ranks
    if lost and m["cards"] > 1:
        t0 = time.perf_counter()
        tr.rescale(rank_units[:W - lost])
        again = tr.run()
        check(again["final_step"] == 30 and again["history"] == got["history"],
              f"rescale onto {W - lost}: step {again['final_step']}")
        m["rescale"] = {"ranks": W - lost, "restored_step": again["final_step"],
                        "s": time.perf_counter() - t0}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    return m


def phase_train_dp(device, workdir, cards=None, cosched_steps=6):
    """Phase 16, cell ``train_dp_granite_reduced_cards``: ``dp_scenario``
    over NCCL on ``min(device_count, 4)`` cards, one rank each (world size
    1 on one card); with one card, also 2 ranks on it over gloo where gloo
    carries the step's collectives on CUDA tensors (else the collective it
    refused is printed).  Then ``phase_cosched`` as ``cosched_cards``: the
    co-scheduler with each job on its own cards; then ``train_tp_int8``,
    the leg ``train_tp_int8_granite_8b``."""
    import torch
    from repro_torch.distributed.meshes import LogicalDevice

    n = cards or min(torch.cuda.device_count(), 4)
    workdir.mkdir(parents=True, exist_ok=True)
    runs = [("nccl", [LogicalDevice(i, torch.device("cuda", i)) for i in range(n)])]
    if n == 1:
        runs.append(("gloo", [LogicalDevice(i, device) for i in range(2)]))
    out = {"cards": n, "runs": []}
    for backend, rank_units in runs:
        m = dp_scenario(device, workdir, backend, rank_units)
        cross = ("not run (one card)" if m["cards"] == 1 else
                 "refused" if "refused" in m else f"passed on {m['cards']} cards")
        print(f"  train_dp_granite_reduced_cards: world={m['world']} backend={backend} "
              f"cards={m['cards']} cross_card={cross} "
              + " ".join(f"{k}={v!r}" for k, v in m.items()
                         if k not in ("world", "backend", "cards", "per_rank")))
        for r in m.get("per_rank", ()):
            print(f"    rank {r['rank']} on {r['device']}: steps={r['steps']} "
                  f"step_s={r['step_s']!r} collective_us_per_step="
                  f"{r['collective_us_per_step']!r} (largest step "
                  f"{r['collective_us_max']!r}) peak_bytes={r['peak_bytes']}")
        if "refused" in m:
            print(f"  gloo refused on CUDA tensors: {m['refused']}; world size 1 only")
        out["runs"].append(m)
    out["cosched"] = phase_cosched(device, workdir, cosched_steps, cell="cosched_cards",
                                   host_devices=None, jobs="granite-8b,mamba2-2.7b")
    check(out["cosched"]["score_reduce_launches"] > 0,
          "score_reduce was never launched on the multi-card co-scheduling path")
    out["train_tp_int8"] = train_tp_int8(device, workdir, n)
    return out


# ---------------------------------------------------------------------------
# Phase 16's leg train_tp_int8_granite_8b: int8 moments and compression with
# the model axis across ranks
# ---------------------------------------------------------------------------

# granite-8b at full width: on one card TPI_LAYERS of its 36 layers in
# float32 over 2 gloo ranks of the card, held to one process; on four
# cards all 36 in bf16 over NCCL, a card a rank (the donated step holds
# one state: a layer's share at (1, 4) is 0.87 GB of bf16 parameters,
# master copies, residuals and int8 codes)
TPI_ARCH, TPI_LAYERS, TPI_B, TPI_S, TPI_STEPS, TPI_LR = "granite-8b", 4, 4, 2048, 6, 1e-4
TPI_PARAM_TOL = 1e-4  # each parameter's |Δ| against one process, of its leaf's max |p|
TPI_DRYRUN_KW = dict(opt_dtype="int8", compress=True)  # the leg's optimizer in the dry-run


def tpi_cfg(dtype, layers=None):
    """The leg's config: granite-8b in ``dtype`` at ``layers`` layers."""
    return tp_cfg(TPI_ARCH, dtype, layers)


def tpi_parts(cfg, mesh):
    """The leg's model (remat full), optimizer (int8 moments, master
    weights), and its train step with compression, donated as the
    ``Trainer``'s: over ``mesh``'s ranks with the shardings ``Trainer``
    gives them (returned too), or in one process where ``mesh`` is
    None."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import Runtime, build_model
    from repro_torch.optim import AdamW, AdamWConfig, WarmupCosine
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.tree import eval_shape, tree_map

    model = build_model(cfg, Runtime(remat="full"))
    opt = AdamW(AdamWConfig(state_dtype="int8", master_weights=True))
    sched = WarmupCosine(peak_lr=TPI_LR, warmup_steps=1, decay_steps=100)
    like = eval_shape(lambda: init_state(model, opt, 0, compress=True, device="cpu"))
    if mesh is None:
        return (model, opt, make_train_step(model, opt, sched, compress=True, donate=True),
                like, None)
    pspecs = shd.param_specs(cfg, mesh, like["params"])
    specs = {"params": pspecs, "opt": shd.opt_state_specs(cfg, mesh, like["opt"]),
             "step": shd.P(), "residuals": pspecs}
    gspecs = tree_map(lambda sp, leaf: shd.zero_extend(sp, tuple(leaf.shape), mesh),
                      pspecs, like["params"])
    shardings = shd.named(mesh, specs)
    step = make_train_step(model, opt, sched, compress=True,
                           grad_shardings=shd.named(mesh, gspecs),
                           opt_shardings=shardings["opt"], donate=True)
    return model, opt, step, like, shardings


def tpi_state(model, opt, like, device, shardings=None):
    """The leg's mid-run state on ``device``, leaf by leaf from seeds (each
    leaf drawn whole, then placed under ``shardings``, a rank's shares,
    where given): the parameters ``model.init`` draws from SEED
    (``placed_params`` over ranks), float32 master copies of them, first
    moments N(0, 1e-3²), second moments their square plus 1e-6 (a
    second moment that carries earlier gradients: every int8 code is
    nonzero) encoded to int8 codes, residuals N(0, 1e-5²), count and step
    10."""
    import torch
    from repro_torch.train.step import placed_params
    from repro_torch.tree import leaves_with_paths, set_by_path

    gen = torch.Generator(device=device).manual_seed(SEED)
    if shardings is None:
        params = model.init(gen, device=device)
        put = {}
    else:
        params = placed_params(model, gen, shardings["params"], device=device)
        put = dict(leaves_with_paths(shardings))

    def placed(path, t):
        return put[path].place(t) if put else t

    state = {"params": params, "opt": {"m": {}, "v": {}, "master": {}}, "residuals": {}}
    for i, (path, p) in enumerate(leaves_with_paths(like["params"])):
        g = torch.Generator(device=device).manual_seed(SEED + 1 + i)
        m = torch.randn(p.shape, generator=g, device=device) * 1e-3
        for key, moment in (("m", m), ("v", m.square() + 1e-6)):
            codes = opt._encode(moment)
            set_by_path(state["opt"][key], path,
                        {k: placed(f"opt/{key}/{path}/{k}", t) for k, t in codes.items()})
        del m, codes, moment
        r = torch.randn(p.shape, generator=g, device=device) * 1e-5
        set_by_path(state["residuals"], path, placed(f"residuals/{path}", r))
    for path, p in leaves_with_paths(params):
        # the rank's parameters are its share along ``model``: its master
        # copy is that share's along the data axes too
        master = p.to(torch.float32, copy=True)
        set_by_path(state["opt"]["master"], path,
                    put[f"opt/master/{path}"].data_part.place(master) if put else master)
    ten = torch.full((), 10, dtype=torch.int32, device=device)
    state["opt"]["count"], state["step"] = ten, ten.clone()
    return state


def tpi_batches(cfg, mesh, device, n):
    """SyntheticLM's global batches 10, 11, ... of the leg's shape, placed
    as ``mesh``'s rank takes them (on ``device`` without a mesh)."""
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.meshes import NamedSharding

    data = SyntheticLM(cfg, TPI_B, TPI_S)
    out = []
    for k in range(n):
        b = data.global_batch(10 + k)
        if mesh is None:
            out.append({key: torch.from_numpy(v).to(device) for key, v in b.items()})
        else:
            specs = shd.batch_specs(cfg, mesh, {key: v.shape for key, v in b.items()})
            out.append({key: NamedSharding(mesh, specs[key]).place(torch.from_numpy(v))
                        for key, v in b.items()})
    return out


def tpi_one_process(device, cfg, want_path):
    """The leg in one process on ``device``: its state and one donated
    step.  The new parameters, codes, scales and residuals go to
    ``want_path`` (on the host, for the ranks to hold their shares to);
    returns the loss, grad norm, each leaf's largest magnitude, the step's
    seconds and the peak memory."""
    import torch
    from repro_torch.tree import leaves_with_paths

    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    model, opt, step, like, _ = tpi_parts(cfg, None)
    state = tpi_state(model, opt, like, device)
    batch = tpi_batches(cfg, None, device, 1)[0]
    sync(device)
    t0 = time.perf_counter()
    new, met = step(state, batch)  # ``new`` is ``state``, updated in place
    loss = float(met["loss"])
    sync(device)
    m = {"loss": loss, "grad_norm": float(met["grad_norm"]), "step_s": time.perf_counter() - t0}
    del state, batch
    want, maxes = {}, {}
    for path, t in leaves_with_paths(new):
        if path.startswith(("params/", "opt/m/", "opt/v/", "residuals/")):
            want[path] = t.cpu()
            if t.is_floating_point():
                maxes[path] = float(t.abs().max())
    m["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                     if device.type == "cuda" else "not measured")
    del new
    if device.type == "cuda":
        torch.cuda.empty_cache()
    torch.save(want, want_path)
    m["maxes"] = maxes
    return m


def tpi_compare(state, shardings, want_path, maxes):
    """This rank's new state against its shares of the one-process step's
    (``want_path``, read as a memory map).  First the residuals: the
    elements whose compressed code sat on a rounding boundary and rounded
    the other way (their residuals swap sign, as
    ``tests/torch_parity.py`` finds them) are counted, and the largest
    |Δ| elsewhere of the leaf's max kept.  Then each parameter leaf's
    largest |Δ| of its leaf's max |p|, outside those elements (a flipped
    code moves the gradient Adam takes by a quantization step); the codes
    off by one (boundary flips) and the largest code difference; the
    scales' largest |Δ| of their leaf's max."""
    import torch
    from repro_torch.tree import leaves_with_paths

    want = torch.load(want_path, map_location="cpu", mmap=True, weights_only=True)
    got, put = dict(leaves_with_paths(state)), dict(leaves_with_paths(shardings))
    out = {"param_rel_max": 0.0, "code_flips": 0, "codes": 0, "code_diff_max": 0,
           "scale_rel_max": 0.0, "residual_rel_max": 0.0, "residual_flips": 0}
    flipped = {}
    for path in sorted(want, key=lambda p: not p.startswith("residuals/")):
        g, share = got[path], put[path].place(want[path])
        if path.endswith("/q"):
            d = (g.to(torch.int32) - share.to(torch.int32)).abs()
            out["code_flips"] += int((d == 1).sum())
            out["codes"] += d.numel()
            out["code_diff_max"] = max(out["code_diff_max"], int(d.max()))
            continue
        d = (g - share).abs()
        leaf = path.split("/", 1)[1]
        if path.startswith("residuals/"):
            flip = flipped[leaf] = ((g + share).abs() <= 0.01 * d) & (d > 1e-3 * maxes[path])
            out["residual_flips"] += int(flip.sum())
            d = d.masked_fill(flip, 0)
        elif path.startswith("params/") and leaf in flipped:
            d = d.masked_fill(flipped[leaf], 0)
        key = ("param_rel_max" if path.startswith("params/") else
               "scale_rel_max" if path.endswith("/scale") else "residual_rel_max")
        out[key] = max(out[key], float(d.max()) / max(maxes[path], 1e-30))
    return out


def tpi_rank(cfg, want_path, maxes, steps):
    """The leg in each rank: a (1, ranks) mesh over the job's units, the
    leg's state as the rank holds it (``tpi_state``), ``steps`` train steps
    under a ``CollectiveClock``; the first held to the one-process step
    where ``want_path`` is given (``tpi_compare``).  Returns the losses,
    the first step's loss, grad norm and collectives by kind, each step's
    seconds and collective µs, the bytes the rank holds (parameters, int8
    moments, master copies, residuals), the moments' bytes under the
    reference's specs (``launch.dryrun.shard_bytes``) and the peak memory."""
    import torch
    from repro_torch.distributed import procs
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.meshes import AbstractMesh, make_mesh
    from repro_torch.launch.dryrun import shard_bytes
    from repro_torch.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    world = procs.current()
    dev = world.device
    cuda = dev.type == "cuda"
    mesh = make_mesh((1, world.size), ("data", "model"), devices=list(world.units))
    model, opt, step, like, sh = tpi_parts(cfg, mesh)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = tpi_state(model, opt, like, dev, sh)
    batches = tpi_batches(cfg, mesh, dev, steps)
    sync(dev)
    out = {"rank": world.rank, "device": str(dev), "init_s": time.perf_counter() - t0}
    gb = {k: sum(t.nbytes for t in leaves(v)) / 1e9 for k, v in (
        ("params", state["params"]), ("moments", {"m": state["opt"]["m"], "v": state["opt"]["v"]}),
        ("master", state["opt"]["master"]), ("residuals", state["residuals"]))}
    out["held_gb"] = gb
    ospecs = shd.opt_state_specs(cfg, AbstractMesh((1, world.size), ("data", "model")),
                                 like["opt"])
    out["moments_gb_by_specs"] = shard_bytes(
        {"m": like["opt"]["m"], "v": like["opt"]["v"]},
        {"m": ospecs["m"], "v": ospecs["v"]},
        AbstractMesh((1, world.size), ("data", "model"))) / 1e9
    losses, times, coll = [], [], []
    with CollectiveClock(events=cuda and world.backend == "nccl") as clock:
        for k in range(steps):
            clock.take()
            t0 = time.perf_counter()
            state, met = step(state, batches[k])
            losses.append(float(met["loss"]))
            sync(dev)
            times.append(time.perf_counter() - t0)
            calls = clock.take()
            coll.append(sum(c[3] for c in calls))
            if not k:
                out.update(loss=losses[0], grad_norm=float(met["grad_norm"]),
                           step_coll=coll_of(calls))
                if want_path is not None:
                    out["vs_one_process"] = tpi_compare(state, sh, want_path, maxes)
    out.update(losses=losses, step_s=times, collective_us=coll,
               s_per_step=statistics.median(times[1:]) if steps > 1 else times[0],
               collective_us_per_step=statistics.median(coll[1:]) if steps > 1 else coll[0],
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda
               else "not measured")
    return out


def train_tp_int8(device, workdir, cards):
    """Phase 16's leg ``train_tp_int8_granite_8b``: granite-8b at full width
    (d_model 4,096, 32/8 heads at hd 128, d_ff 14,336, vocab 49,152)
    trained with int8 AdamW moments (master weights) and gradient
    compression, ``remat`` full, B TPI_B x S TPI_S, its ``model`` axis
    across ranks (the codes of a leaf split along its last dimension whole
    on every rank).

    On one card: TPI_LAYERS of its 36 layers in float32 (TF32 off), first
    one step in one process on the card (its result to the host), then 2
    gloo ranks of the card at (1, 2): the first step held to the one
    process's (loss and grad norm rel. 1e-5, each parameter within
    TPI_PARAM_TOL of its leaf's max |p| outside the elements whose
    compressed code flipped, no int8 code more than one off; the codes
    off by one and the flipped compressed codes, boundary flips, counted,
    at most 1e-3 of the codes; ``tpi_compare``), then TPI_STEPS steps in
    all.  On four cards: all 36 layers in bf16 over NCCL at (1, 4),
    TPI_STEPS steps with finite losses; then
    ``launch.train --smoke --model-par 2 --opt-dtype int8
    --compress-grads`` through a recovery.  Each rank's s a step (median
    of steps 2 on), collective µs a step, peak memory, the bytes it holds
    and its moments' bytes against the reference's specs are printed.
    Returns the metrics, with rank 0's first step's collectives by kind
    and the config, mesh, cell and the ranks' peaks for phase 20."""
    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed import procs
    from repro_torch.distributed.meshes import LogicalDevice

    cuda = device.type == "cuda"
    four = cuda and cards >= 4
    m = 4 if four else 2
    cfg = tpi_cfg("bfloat16") if four else tpi_cfg("float32", TPI_LAYERS)
    out = {"ranks_n": m, "layers": cfg.num_layers, "dtype": cfg.dtype}
    want_path, maxes = None, None
    if not four:
        want_path = workdir / "tpi_one_process.pt"
        one = tpi_one_process(device, cfg, want_path)
        maxes = one.pop("maxes")
        out["one_process"] = one
        print(f"  train_tp_int8_granite_8b one process ({cfg.num_layers} layers, "
              f"{cfg.dtype}): " + " ".join(f"{k}={v!r}" for k, v in one.items()))
    backend = "nccl" if four else "gloo"
    rank_units = ([LogicalDevice(i, torch.device("cuda", i)) for i in range(m)] if four
                  else [LogicalDevice(i, device) for i in range(m)])
    t0 = time.perf_counter()
    try:
        res = procs.spawn(tpi_rank, (cfg, want_path, maxes, TPI_STEPS), units=rank_units,
                          jobdir=str(workdir / "tpi"), backend=backend, timeout=TP_TIMEOUT_S)
    finally:
        if want_path is not None:
            want_path.unlink(missing_ok=True)
    out["ranks_s"] = time.perf_counter() - t0
    for r in res:
        print(f"    train_tp_int8_granite_8b rank {r['rank']} on {r['device']} ({backend}): "
              + " ".join(f"{k}={v!r}" for k, v in r.items() if k not in ("rank", "device")))
        check(all(math.isfinite(x) for x in r["losses"]),
              f"train_tp_int8 rank {r['rank']}: losses {r['losses']}")
        check(abs(r["held_gb"]["moments"] - r["moments_gb_by_specs"]) < 1e-9,
              f"train_tp_int8 rank {r['rank']}: moments {r['held_gb']['moments']} GB held, "
              f"{r['moments_gb_by_specs']} GB by the reference's specs")
        if want_path is None:
            continue
        v = r["vs_one_process"]
        for k in ("loss", "grad_norm"):
            e = abs(r[k] - one[k]) / abs(one[k])
            check(e <= 1e-5, f"train_tp_int8 rank {r['rank']}: {k} {r[k]} vs {one[k]} (rel {e})")
        check(v["param_rel_max"] <= TPI_PARAM_TOL and v["code_diff_max"] <= 1
              and v["code_flips"] + v["residual_flips"] <= 1e-3 * v["codes"],
              f"train_tp_int8 rank {r['rank']} against one process: {v}")
    out["ranks"] = res
    out["phase20"] = dict(cfg=cfg, mesh=(1, m), tally=res[0]["step_coll"],
                          cell=ShapeCell(f"train_b{TPI_B}s{TPI_S}", "train", TPI_S, TPI_B),
                          peaks_gib=[r["peak_gib"] for r in res])
    if four:
        out["launch_train"] = ssm_train_cards(
            device, workdir, TPI_ARCH, extra=("--opt-dtype", "int8", "--compress-grads"))
    return out


# ---------------------------------------------------------------------------
# Phase 17: tensor-parallel serving over ranks, serve_tp_dense_cards
# ---------------------------------------------------------------------------


# CollectiveClock's names -> the dry-run's kinds
CLOCK_KINDS = {"all_reduce": "all-reduce", "_all_gather": "all-gather",
               "_reduce_scatter": "reduce-scatter"}


def coll_of(calls):
    """{kind: [calls, result bytes, µs]} of ``CollectiveClock.take()``,
    under the dry-run's kinds."""
    out = {}
    for name, _, _, us, res in calls:
        c = out.setdefault(CLOCK_KINDS[name], [0, 0, 0.0])
        c[0] += 1
        c[1] += res
        c[2] += us
    return out


def tally_summary(calls):
    """{"name dtype": [calls, µs]} of ``CollectiveClock.take()``."""
    out = {}
    for name, dtype, _, us, _ in calls:
        c = out.setdefault(f"{name} {dtype}", [0, 0.0])
        c[0] += 1
        c[1] += us
    return out


def attn_proj_skipping_leave(self, o, p):
    """Phase 17's planted fault, put in place of ``Model._attn_proj`` on one
    rank: the attention sublayer keeps its own partial sum instead of the
    model group's.  The rank still takes part in the all-reduce (its result
    dropped), so the ranks stay in step."""
    from repro_torch.distributed.ctx import leave_model

    out = o.reshape(*o.shape[:2], -1) @ p["wo"]
    if self._attn_split(p):
        leave_model(out)
    return out


class RouteLog:
    """Every MoE routing's top-k experts while entered (``models/moe.py``'s
    ``top_k`` wrapped; nothing when ``on`` is false), as int16 tensors on
    the CPU in call order: a check beside the main path, as each one
    read waits for the card, so no timed pass runs under it."""

    def __init__(self, on=True):
        self.on, self.calls = on, []

    def __enter__(self):
        import torch
        from repro_torch.models import moe as PM

        self._orig = PM.top_k
        if self.on:
            def recorded(probs, k):
                vals, idx = self._orig(probs, k)
                self.calls.append(idx.to(torch.int16).cpu())
                return vals, idx

            PM.top_k = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as PM

        PM.top_k = self._orig


class RouteReplay:
    """Each MoE routing's top-k experts taken in turn from ``calls`` (a
    one-process run's ``RouteLog``), weighed by this rank's own router
    probabilities at them: the ranks compute the one-process run's
    routing, as phase 11's float32 comparison gives the kernel route the
    plain route's, so tokens whose experts flip on the last bits do not
    move a float32 comparison.  Nothing when ``calls`` is None; every
    call must be taken."""

    def __init__(self, calls):
        self.calls = calls

    def __enter__(self):
        import torch
        from repro_torch.models import moe as PM

        self._orig, self.taken = PM.top_k, 0
        if self.calls is not None:
            def replayed(probs, k):
                idx = self.calls[self.taken].to(probs.device, torch.long)
                self.taken += 1
                return probs.gather(-1, idx), idx

            PM.top_k = replayed
        return self

    def __exit__(self, exc, *rest):
        from repro_torch.models import moe as PM

        PM.top_k = self._orig
        if exc is None and self.calls is not None:
            check(self.taken == len(self.calls),
                  f"RouteReplay: {self.taken} routings taken of {len(self.calls)}")


def plant_fault(leg):
    """``leg["fault"]`` put in place on rank ``leg["fault_rank"]`` (nothing
    without one): ``"attn_leave"`` (the default, phase 17's:
    ``attn_proj_skipping_leave``), ``"moe_leave"`` / ``"ssm_leave"`` (the
    rank's MoE layers, or SSM mixers, keep their own partial sums: it
    takes part in the all-reduce, its result dropped), ``"local_norm"``
    (the rank's SSM gated norms take the mean square over its own
    channels, the model group's sum taken and dropped) or
    ``"every_expert"`` (the rank computes its routed part over every
    expert rather than its own, so the model group's sum counts that part
    again; every rank gathers the whole expert leaves, so the ranks stay
    in step).  Returns the undo."""
    from repro_torch.distributed import procs
    from repro_torch.distributed.ctx import gather_model
    from repro_torch.models import moe as PM
    from repro_torch.models import ssd as SSD
    from repro_torch.models.common import rms_norm, silu
    from repro_torch.models.model import Model

    if "fault_rank" not in leg:
        return lambda: None
    me = leg["fault_rank"] == procs.current().rank
    fault = leg.get("fault", "attn_leave")
    if fault == "attn_leave":
        orig = Model._attn_proj
        if me:
            Model._attn_proj = attn_proj_skipping_leave
        return lambda: setattr(Model, "_attn_proj", orig)
    if fault in ("moe_leave", "ssm_leave", "local_norm"):
        mod = PM if fault == "moe_leave" else SSD
        name = "_gated_norm" if fault == "local_norm" else "leave_model"
        orig = getattr(mod, name)

        def kept(x):
            orig(x)
            return x

        def own_channels(y, z, scale, cfg, split):
            orig(y, z, scale, cfg, split)
            return rms_norm(y * silu(z), scale, cfg.norm_eps)

        if me:
            setattr(mod, name, own_channels if fault == "local_norm" else kept)
        return lambda: setattr(mod, name, orig)
    check(fault == "every_expert", f"unknown planted fault {fault!r}")
    orig = PM.routed_experts

    def routed(p, x, cfg, capacity_factor=1.25, e_base=0):
        whole = {k: gather_model(t, 0) for k, t in p["experts"].items()}
        if not me:
            return orig(p, x, cfg, capacity_factor, e_base)
        return orig({"router": p["router"], "experts": whole}, x, cfg, capacity_factor)

    PM.routed_experts = routed
    return lambda: setattr(PM, "routed_experts", orig)


def tp_serve_leg(leg, mesh, tally):
    """One leg of ``tp_serve_rank`` in this rank: ``leg["cfg"]`` with seeded
    weights each rank draws whole a layer at a time and keeps its share of
    (``train.step.placed_params``: the one-process weights), served over
    ``mesh`` through ``make_prefill`` / ``make_decode_step`` on the kernel
    route: a prefill (after a warm-up one with ``leg["warm"]``), then one
    decode step per token of ``leg["tokens"]`` (the one-process run's);
    ``leg["routes"]`` records the warm-up prefill's MoE routings
    (``RouteLog``), ``leg["replay"]`` gives the prefill and the decode
    steps a one-process run's (``RouteReplay``), ``leg["fault"]`` plants
    a fault (``plant_fault``).
    Returns (metrics, the logits of the prefill and each step on the CPU,
    None unless ``leg["keep"]``, the routings)."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models import Runtime, build_model
    from repro_torch.train import make_decode_step, make_prefill
    from repro_torch.train.step import placed_params
    from repro_torch.tree import eval_shape, leaves

    dev = mesh.device
    cuda = dev.type == "cuda"
    cfg = leg["cfg"]
    model = build_model(cfg, Runtime(attn_impl="pallas", remat="none"))
    like = eval_shape(lambda: model.init(0, device="cpu"))
    specs = shd.named(mesh, shd.param_specs(cfg, mesh, like))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = placed_params(model, torch.Generator(device=dev).manual_seed(SEED), specs)
    sync(dev)
    m = {"layers": cfg.num_layers, "init_s": time.perf_counter() - t0,
         "held_gb": sum(t.nbytes for t in leaves(params)) / 1e9,
         "whole_gb": sum(t.nbytes for t in leaves(like)) / 1e9}
    B, P = leg["B"], leg["P"]
    batch = serve_batch(cfg, dev, B, P)
    prefill, step = make_prefill(model, mesh), make_decode_step(model, mesh)
    undo = plant_fault(leg)
    logits = []
    try:
        with torch.inference_mode():
            if leg["warm"]:
                with RouteLog(leg.get("routes", False)) as log:
                    prefill(params, batch)
                sync(dev)
        with torch.inference_mode(), RouteReplay(leg.get("replay")):
            tally.take()
            FA.reset_stats()
            SS.reset_stats()
            t0 = time.perf_counter()
            lg, cache = prefill(params, batch)
            sync(dev)
            m["prefill_s"] = time.perf_counter() - t0
            m["flash_launches_per_prefill"] = FA.STATS["flash_attention"]
            m["ssd_launches_per_prefill"] = SS.STATS["ssd_scan"]
            calls = tally.take()
            m["prefill_collectives"] = tally_summary(calls)
            m["prefill_coll"] = coll_of(calls)
            if "k" in cache:
                m["kv_heads"] = cache["k"].shape[3]
            if "h" in cache:  # the rank's SSM heads, and its x channels beside B|C
                m["ssm_heads"], m["conv_channels"] = cache["h"].shape[2], cache["conv"].shape[-1]
            check(bool(torch.isfinite(lg.float()).all()) and tuple(lg.shape) == (B, 1, cfg.vocab_size),
                  f"tp {leg['name']}: prefill logits not finite of shape (B, 1, V)")
            if leg["keep"]:
                logits.append(lg.float().cpu())
            cache = pad_cache(cache, leg["cap"])
            step_s, step_us, dtypes = [], [], set()
            for i, tok in enumerate(leg["tokens"]):
                t0 = time.perf_counter()
                lg, cache = step(params, cache, tok.to(dev), P + i)
                sync(dev)
                step_s.append(time.perf_counter() - t0)
                calls = tally.take()
                if not i:
                    m["decode_coll"] = coll_of(calls)
                step_us.append(sum(c[3] for c in calls))
                dtypes |= {f"{c[0]} {c[1]}" for c in calls}
                check(bool(torch.isfinite(lg.float()).all()),
                      f"tp {leg['name']}: decode step {i} logits not finite")
                if leg["keep"]:
                    logits.append(lg.float().cpu())
            check(FA.STATS["flash_attention"] == m["flash_launches_per_prefill"],
                  f"tp {leg['name']}: decode launched flash_attention")
            check(SS.STATS["ssd_scan"] == m["ssd_launches_per_prefill"],
                  f"tp {leg['name']}: decode launched ssd_scan")
    finally:
        undo()
    if step_s:
        m.update(decode_ms_per_step=statistics.median(step_s) * 1e3,
                 decode_collective_us_per_step=statistics.median(step_us),
                 decode_collective_types=sorted(dtypes))
    m["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else "not measured"
    del params, cache, lg
    if cuda:
        torch.cuda.empty_cache()
    return m, (logits if leg["keep"] else None), (log.calls if leg["warm"] else [])


def tp_serve_rank(legs):
    """Phase 17 in each rank: the ranks' units as one (1, ranks) mesh
    whose ``model`` axis spans them, and each of ``legs`` served over it
    (``tp_serve_leg``) under a ``CollectiveClock``."""
    import torch
    from repro_torch.distributed import procs
    from repro_torch.distributed.meshes import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    world = procs.current()
    us = list(world.units)
    mesh = make_mesh((1, len(us)), ("data", "model"), devices=us)
    check(mesh.n_model == len(us), f"tp: the model axis spans {mesh.n_model} ranks, not {len(us)}")
    out = {"rank": world.rank, "device": str(world.device), "backend": world.backend}
    with CollectiveClock(events=world.backend == "nccl") as tally:
        for leg in legs:
            m, logits, routes = tp_serve_leg(leg, mesh, tally)
            out[leg["name"]] = (m, logits)
            out[leg["name"] + "/routes"] = routes
    return out


def tp_cfg(arch, dtype, layers=None):
    """``arch``'s config in ``dtype``, cut to ``layers`` when given."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).replace(dtype=dtype)
    return cfg.replace(num_layers=layers) if layers else cfg


def tp_one_process(device, cfg, routes, B, P, steps, cap):
    """The one-process run phases 17 and 18 hold the ranks to, on
    ``device``: ``cfg`` with the same seeded weights, prefill and
    ``steps`` greedy decode steps through each of ``routes`` ({name:
    attn_impl, or (attn_impl, overrides of ``cfg``)}; "k", the kernel
    route, sets the tokens).  Returns (logits
    by route, and under "routes" the kernel route's prefill routings of a
    MoE model and each decode step's after them, ``RouteLog``; the tokens
    fed; the kernel route's prefill s after a warm-up one)."""
    import torch
    from repro_torch.models import Runtime, build_model
    from repro_torch.train import make_decode_step, make_prefill

    def built(route):
        impl, kw = (route, {}) if isinstance(route, str) else route
        return build_model(cfg.replace(**kw), Runtime(attn_impl=impl, remat="none"))

    models = {r: built(route) for r, route in routes.items()}
    params = models["k"].init(torch.Generator(device=device).manual_seed(SEED))
    batch = serve_batch(cfg, device, B, P)
    out, caches, tokens = {r: [] for r in routes}, {}, []
    with torch.inference_mode():
        make_prefill(models["k"])(params, batch)
        sync(device)
        t0 = time.perf_counter()
        make_prefill(models["k"])(params, batch)
        sync(device)
        prefill_s = time.perf_counter() - t0
        log = RouteLog(cfg.uses_moe)
        for r, mdl in models.items():
            with log if r == "k" else contextlib.nullcontext():
                lg, c = make_prefill(mdl)(params, batch)
            caches[r] = pad_cache(c, cap)
            out[r].append(lg.float().cpu())
        tok = out["k"][0][:, -1].argmax(-1)[:, None]
        for i in range(steps):
            tokens.append(tok)
            for r, mdl in models.items():
                with log if r == "k" else contextlib.nullcontext():
                    lg, caches[r] = make_decode_step(mdl)(params, caches[r], tok.to(device),
                                                          P + i)
                out[r].append(lg.float().cpu())
            tok = out["k"][-1][:, -1].argmax(-1)[:, None]
    if log.calls:
        out["routes"] = log.calls
    del params, caches
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out, tokens, prefill_s


def tp_bounds(one, dtype, pairs=(("d", "p"),)):
    """The end-to-end bounds on the prefill and the decode logits: phase
    8's, the larger of the type's tolerance and SERVE_SPREAD_FACTOR times
    the one-process routes' own spread where they ran, the largest of
    ``pairs`` (by default dense vs blocked attention; "k" vs "c", the
    chunked SSD at two chunk lengths, phase 19's); and that spread."""
    tol = SERVE_TOL[dtype]
    pairs = [(a, b) for a, b in pairs if a in one and b in one]
    if not pairs:
        return [tol, tol], None
    spread = [max(rel_err(one[a][0], one[b][0]) for a, b in pairs),
              max(rel_err(x, y) for a, b in pairs for x, y in zip(one[a][1:], one[b][1:]))]
    return [max(tol, SERVE_SPREAD_FACTOR * e) for e in spread], spread


def tp_compare(name, ranks, one, lim):
    """Each rank's logits of leg ``name`` against the one-process kernel
    route's: the prefill's and the decode steps' largest rel. errors."""
    errs = []
    for r in ranks:
        _, lg = r[name]
        e = [rel_err(a, b) for a, b in zip(lg, one["k"])]
        errs.append([e[0], max(e[1:]) if len(e) > 1 else None])
    pre = max(e[0] for e in errs)
    dec = max((e[1] for e in errs if e[1] is not None), default=None)
    return {"prefill_rel_err": pre, "decode_max_rel_err": dec, "bound_prefill_decode": lim}


def tp_ranks(device, m, cards):
    """(backend, units) of ``m`` ranks: a card each over NCCL on several
    cards; ``m`` gloo ranks of the one card, or of the CPU in a
    rehearsal."""
    import torch
    from repro_torch.distributed.meshes import LogicalDevice

    if device.type == "cuda" and cards > 1:
        return "nccl", [LogicalDevice(i, torch.device("cuda", i)) for i in range(m)]
    return "gloo", [LogicalDevice(i, device) for i in range(m)]


def tp_run(device, workdir, tag, m, backend, rank_units, legs):
    """``tp_serve_rank`` on ``rank_units`` over ``backend``; prints each
    rank's metrics by leg and returns the ranks' results."""
    from repro_torch.distributed import procs

    t0 = time.perf_counter()
    res = procs.spawn(tp_serve_rank, (legs,), units=rank_units,
                      jobdir=str(workdir / tag), backend=backend, timeout=TP_TIMEOUT_S)
    print(f"  {tag}: {legs[0]['cfg'].name} over {m} ranks ({backend}, cards "
          f"{sorted({str(u.device) for u in rank_units})}) in {time.perf_counter() - t0:.1f} s")
    for r in res:
        for leg in legs:
            lm = r[leg["name"]][0]
            print(f"    rank {r['rank']} on {r['device']} {leg['name']}: "
                  + " ".join(f"{k}={v!r}" for k, v in lm.items()))
            for key, kern, uses in (("flash", "flash_attention", leg["cfg"].uses_attention),
                                    ("ssd", "ssd_scan", leg["cfg"].uses_ssm)):
                n, want = lm[f"{key}_launches_per_prefill"], lm["layers"] if uses else 0
                check(n == want or device.type != "cuda",
                      f"{tag} {leg['name']}: rank {r['rank']} launched {kern} {n} times "
                      f"a prefill (want {want})")
    return res


def phase_serve_tp(device, workdir, cards=None):
    """Phase 17, cell ``serve_tp_dense_cards``: tensor-parallel serving of
    the dense family over ranks, the ``model`` axis across them
    (``make_prefill`` / ``make_decode_step`` over a mesh whose model group
    is the ranks; each rank's weights its share of the reference's
    Megatron specs; ``flash_attention`` on the rank's heads).

    On one card: granite-8b at full width and depth over 2 ranks of the
    card (gloo), bf16, B 4 x 2,048 seeded prompt tokens, a cache of 2,080
    and 32 decode steps fed the one-process run's greedy tokens, held to
    the one-process kernel route on the same weights at phase 8's bf16
    bound (1.5x the one-process dense and blocked routes' own spread);
    then float32 at TP_F32_LAYERS of 36 layers against 1e-4; and a
    planted fault (rank 1 keeping its attention sublayers' partial sums),
    which must fail the prefill check.  On several cards the same over
    NCCL a rank a card, then qwen3-32b over 4 (or 2) cards, bf16: at
    TP_BIG_ONE_LAYERS of 64 layers against one process on card 0, and at
    full depth timed.  Each rank's flash_attention launches a prefill,
    peak memory, bytes held and collectives (count, type and µs) are
    printed; ``flash_attention`` is timed at the per-rank shapes
    (``TP_FLASH``) beside SDPA.  Returns the metrics, the launches over the
    ranks of each per-rank shape's bf16 prefill, and its timings."""
    import torch

    cuda = device.type == "cuda"
    n = cards or (min(torch.cuda.device_count(), 4) if cuda else 1)
    workdir.mkdir(parents=True, exist_ok=True)
    out = {"cards": n}
    shape = dict(B=SERVE_B, P=SERVE_P, cap=SERVE_CAP)
    three = {"k": "pallas", "d": "dense", "p": "blocked"}
    cfg_bf, cfg_f32 = tp_cfg(TP_ARCH, "bfloat16"), tp_cfg(TP_ARCH, "float32", TP_F32_LAYERS)
    one_bf, tok_bf, out["one_process_prefill_s"] = tp_one_process(
        device, cfg_bf, three, steps=SERVE_STEPS, **shape)
    one_f32, tok_f32, _ = tp_one_process(device, cfg_f32, {"k": "pallas"}, steps=SERVE_STEPS,
                                         **shape)
    lim_bf, out["one_process_dense_vs_blocked"] = tp_bounds(one_bf, "bfloat16")
    lim_f32, _ = tp_bounds(one_f32, "float32")
    backend, rank_units = tp_ranks(device, TP_M, n)
    base = dict(shape, keep=True, warm=backend == "nccl")
    legs = [dict(base, name="bfloat16", cfg=cfg_bf, tokens=tok_bf),
            dict(base, name="float32", cfg=cfg_f32, tokens=tok_f32),
            dict(base, name="fault", cfg=cfg_f32, tokens=[], fault_rank=1, warm=False)]
    tag = f"serve_tp_{TP_ARCH.replace('-', '_').replace('.', '_')}_mp{TP_M}"
    res = tp_run(device, workdir, tag, TP_M, backend, rank_units, legs)
    for name, one, lim in (("bfloat16", one_bf, lim_bf), ("float32", one_f32, lim_f32)):
        c = out[name] = tp_compare(name, res, one, lim)
        check(c["prefill_rel_err"] < lim[0] and c["decode_max_rel_err"] < lim[1],
              f"tp {TP_ARCH} {name}: rel errs (prefill, decode) {c['prefill_rel_err']}, "
              f"{c['decode_max_rel_err']} against one process, bounds {lim}")
    f = out["fault"] = tp_compare("fault", res, one_f32, lim_f32)["prefill_rel_err"]
    check(f >= max(lim_f32[0], lim_bf[0]),
          f"tp {TP_ARCH}: the planted fault passed the prefill check ({f} < {lim_f32[0]})")
    out["ranks"] = {r["rank"]: {leg: r[leg][0] for leg in ("bfloat16", "float32")} for r in res}
    launches = {"granite_8b_mp2": sum(r["bfloat16"][0]["flash_launches_per_prefill"]
                                      for r in res)}
    print(f"  {tag}: " + " ".join(f"{k}={out[k]!r}" for k in
                                  ("one_process_prefill_s", "one_process_dense_vs_blocked",
                                   "bfloat16", "float32", "fault")))
    if n >= 2:
        m = 4 if n >= 4 else 2
        cut = tp_cfg(TP_BIG_ARCH, "bfloat16", TP_BIG_ONE_LAYERS)
        one_q, tok_q, out["qwen3_one_process_prefill_s"] = tp_one_process(
            device, cut, three, steps=SERVE_STEPS, **shape)
        lim_q, out["qwen3_dense_vs_blocked"] = tp_bounds(one_q, "bfloat16")
        legs = [dict(shape, name="cut", cfg=cut, tokens=tok_q, keep=True, warm=False),
                dict(shape, name="full", cfg=tp_cfg(TP_BIG_ARCH, "bfloat16"), tokens=tok_q,
                     keep=False, warm=True)]
        tag = f"serve_tp_qwen3_32b_mp{m}"
        res = tp_run(device, workdir, tag, m, *tp_ranks(device, m, n), legs)
        c = out["qwen3_cut"] = tp_compare("cut", res, one_q, lim_q)
        check(c["prefill_rel_err"] < lim_q[0] and c["decode_max_rel_err"] < lim_q[1],
              f"tp {TP_BIG_ARCH} at {TP_BIG_ONE_LAYERS} layers: rel errs {c} against one "
              "process")
        out["qwen3_full"], out["qwen3_mp"] = {r["rank"]: r["full"][0] for r in res}, m
        if m == 4:
            launches["qwen3_32b_mp4"] = sum(r["full"][0]["flash_launches_per_prefill"]
                                            for r in res)
        print(f"  {tag}: qwen3_cut={c!r}")
    times = {}
    if cuda:
        for shape, case in TP_FLASH.items():
            times[shape] = t = time_flash(device, "bfloat16", case=case)
            print(f"  flash_attention {shape} at {case} bfloat16: " + " ".join(
                f"{k}={v!r}" for k, v in t.items() if k not in ("shape", "dtype")))
    return out, launches, times


def moe_routing(name, ranks, one=None):
    """Leg ``name``'s routings (``RouteLog``, each MoE layer's top-k
    experts of the warm-up prefill, the ranks' own): whether every rank
    picked rank 0's experts for every token, and, against the one-process
    kernel route's prefill (``one["routes"]``), the tokens whose expert
    set flips, in all and in the layer with the most."""
    import torch

    got = [r[name + "/routes"] for r in ranks]
    out = {"routings": len(got[0]),
           "ranks_agree": all(len(g) == len(got[0]) and all(
               torch.equal(a, b) for a, b in zip(g, got[0])) for g in got)}
    if one is not None:  # its prefill's routings come first
        check(len(one["routes"]) >= len(got[0]) > 0,
              f"{name}: {len(got[0])} routings on the ranks, {len(one['routes'])} in one process")
        flips = [int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                 for a, b in zip(got[0], one["routes"])]
        out.update(routing_flips=sum(flips), routing_flips_max_layer=max(flips),
                   tokens_a_layer=int(got[0][0].shape[0] * got[0][0].shape[1]))
    return out


MOE_FAULTS = ("moe_leave", "every_expert")


def moe_leg_checks(tag, name, c, lim):
    """Leg ``name`` of ``tag`` within its bounds against one process, and
    its ranks routing alike."""
    check(c["ranks_agree"], f"{tag} {name}: the ranks of the model group routed apart")
    check(c["prefill_rel_err"] < lim[0] and c["decode_max_rel_err"] < lim[1],
          f"{tag} {name}: rel errs (prefill, decode) {c['prefill_rel_err']}, "
          f"{c['decode_max_rel_err']} against one process, bounds {lim}")


def phase_serve_tp_arctic(device, workdir, cards):
    """Phase 18's arctic-480b legs, on 4 of ``cards`` cards: at full width
    over 4 ranks (NCCL), held to one process on card 0 in bf16 at
    ARCTIC_ONE_LAYERS (phase 8's batch, cache and decode steps) and timed
    at ARCTIC_LAYERS, every rank routing alike.  Returns the metrics and
    the ranks' ``flash_attention`` launches of the timed prefill."""
    import os

    out = {}
    shape = dict(B=SERVE_B, P=SERVE_P, cap=SERVE_CAP)
    cut = tp_cfg(ARCTIC_ARCH, "bfloat16", ARCTIC_ONE_LAYERS)
    one, tokens, out["one_process_prefill_s"] = tp_one_process(
        device, cut, {"k": "pallas", "d": "dense", "p": "blocked"}, steps=SERVE_STEPS, **shape)
    lim, out["dense_vs_blocked"] = tp_bounds(one, "bfloat16")
    legs = [dict(shape, name="cut", cfg=cut, tokens=tokens, keep=True, warm=True, routes=True),
            dict(shape, name="full", cfg=tp_cfg(ARCTIC_ARCH, "bfloat16", ARCTIC_LAYERS),
                 tokens=tokens, keep=False, warm=True, routes=True)]
    tag = "serve_tp_arctic_480b_mp4"
    # A rank draws each layer's whole expert leaves (17.9 GB a leaf in
    # float32) and keeps a quarter of each: in fixed segments the cache
    # fragments (stacking 5 layers' shares found no 10.4 GiB block in 38.5
    # GiB reserved), so the ranks map their memory in expandable ones.
    old = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        res = tp_run(device, workdir, tag, 4, *tp_ranks(device, 4, cards), legs)
    finally:
        if old is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = old
    c = out["cut"] = dict(tp_compare("cut", res, one, lim), **moe_routing("cut", res, one))
    moe_leg_checks(tag, f"cut at {ARCTIC_ONE_LAYERS} layers", c, lim)
    full = out["full_routing"] = moe_routing("full", res)
    check(full["ranks_agree"], f"{tag} full: the ranks of the model group routed apart")
    out["full"] = {r["rank"]: r["full"][0] for r in res}
    print(f"  {tag}: cut={c!r} full routing={full!r}")
    return out, sum(r["full"][0]["flash_launches_per_prefill"] for r in res)


def phase_serve_tp_moe(device, workdir, cards=None):
    """Phase 18, cell ``serve_tp_moe_cards``: tensor-parallel serving of
    the MoE family over ranks whose ``model`` axis spans them
    (``make_prefill`` / ``make_decode_step`` over the mesh; each rank
    holding its share of the reference's specs: E/m experts, its columns
    of the shared experts and of the dense FFN, its heads; every token
    routed on every rank, one all-reduce a MoE layer).

    qwen2-moe-a2.7b at full width and depth, first in one process on
    ``device`` (bf16 through the kernel, dense and blocked routes, and
    float32 at MOE_F32_LAYERS; their logits, tokens and routings written
    to ``workdir`` and the card freed), then over MOE_TP_M gloo ranks of
    the one card, or min(cards, 4) cards over NCCL: bf16 with phase 8's
    batch, cache and 32 decode steps fed the one-process greedy tokens,
    held to the one-process kernel route at phase 8's bound, float32
    against 1e-4 with the one-process routing replayed (phase 11's
    matched routing: a float32 token whose experts flip on the last bits
    moves the logits past 1e-4); each planted fault of MOE_FAULTS on rank
    1, under the same replay, must fail the prefill check.  Every rank
    must route every token as rank 0 does in its own warm-up prefill; the
    tokens whose experts flip there against one process are counted.  On 4
    cards, arctic-480b at full width over 4 (``phase_serve_tp_arctic``).
    Each rank's
    ``flash_attention`` launches a prefill, peak memory, bytes held and
    collectives (count, type, µs) are printed; ``flash_attention`` is
    timed at the per-rank shapes (``MOE_TP_FLASH``) beside SDPA.  Returns
    the metrics, the launches over the ranks of each per-rank shape's bf16
    prefill, and its timings."""
    import torch

    cuda = device.type == "cuda"
    n = cards or (min(torch.cuda.device_count(), 4) if cuda else 1)
    m = MOE_TP_M if n == 1 else min(n, 4)
    workdir.mkdir(parents=True, exist_ok=True)
    out = {"cards": n, "model_par": m}
    shape = dict(B=SERVE_B, P=SERVE_P, cap=SERVE_CAP)
    three = {"k": "pallas", "d": "dense", "p": "blocked"}
    cfg_bf, cfg_f32 = tp_cfg(MOE_ARCH, "bfloat16"), tp_cfg(MOE_ARCH, "float32", MOE_F32_LAYERS)
    one_bf, tok_bf, out["one_process_prefill_s"] = tp_one_process(
        device, cfg_bf, three, steps=SERVE_STEPS, **shape)
    one_f32, tok_f32, _ = tp_one_process(device, cfg_f32, {"k": "pallas"}, steps=SERVE_STEPS,
                                         **shape)
    torch.save({"bfloat16": (one_bf, tok_bf), "float32": (one_f32, tok_f32)},
               workdir / "qwen2_moe_one_process.pt")
    lim_bf, out["one_process_dense_vs_blocked"] = tp_bounds(one_bf, "bfloat16")
    lim_f32, _ = tp_bounds(one_f32, "float32")
    backend, rank_units = tp_ranks(device, m, n)
    base = dict(shape, keep=True, warm=True, routes=True)
    # float32 takes the one-process routing (phase 11's matched routing):
    # its prefill's and decode steps', or the prefill's alone for a fault
    L32 = cfg_f32.num_layers
    legs = [dict(base, name="bfloat16", cfg=cfg_bf, tokens=tok_bf),
            dict(base, name="float32", cfg=cfg_f32, tokens=tok_f32, replay=one_f32["routes"]),
            *(dict(base, name=f"fault_{f}", cfg=cfg_f32, tokens=[], fault_rank=1, fault=f,
                   warm=False, replay=one_f32["routes"][:L32]) for f in MOE_FAULTS)]
    tag = f"serve_tp_qwen2_moe_a2_7b_mp{m}"
    res = tp_run(device, workdir, tag, m, backend, rank_units, legs)
    for name, one, lim in (("bfloat16", one_bf, lim_bf), ("float32", one_f32, lim_f32)):
        out[name] = dict(tp_compare(name, res, one, lim), **moe_routing(name, res, one))
    print(f"  {tag}: bfloat16={out['bfloat16']!r} float32={out['float32']!r}")
    for name, lim in (("bfloat16", lim_bf), ("float32", lim_f32)):
        moe_leg_checks(tag, name, out[name], lim)
    for f in MOE_FAULTS:
        e = out[f"fault_{f}"] = tp_compare(f"fault_{f}", res, one_f32, lim_f32)["prefill_rel_err"]
        check(e >= max(lim_f32[0], lim_bf[0]),
              f"{tag}: the planted fault {f} passed the prefill check ({e} < {lim_f32[0]})")
    out["ranks"] = {r["rank"]: {leg: r[leg][0] for leg in ("bfloat16", "float32")} for r in res}
    launches = {f"qwen2_moe_a2_7b_mp{m}": sum(r["bfloat16"][0]["flash_launches_per_prefill"]
                                              for r in res)}
    print(f"  {tag}: " + " ".join(f"{k}={out[k]!r}" for k in (
        "one_process_prefill_s", "one_process_dense_vs_blocked",
        *(f"fault_{f}" for f in MOE_FAULTS))))
    if n >= 4:
        out["arctic"], launches["arctic_480b_mp4"] = phase_serve_tp_arctic(device, workdir, n)
    times = {}
    if cuda:
        for key, case in MOE_TP_FLASH.items():
            times[key] = t = time_flash(device, "bfloat16", case=case)
            print(f"  flash_attention {key} at {case} bfloat16: " + " ".join(
                f"{k}={v!r}" for k, v in t.items() if k not in ("shape", "dtype")))
    return out, launches, times


# ---------------------------------------------------------------------------
# Phase 19: tensor-parallel SSM and hybrid serving over ranks, serve_tp_ssm_cards
# ---------------------------------------------------------------------------


def tag_of(arch, m):
    return f"serve_tp_{arch.replace('-', '_').replace('.', '_')}_mp{m}"


def ssm_serve_over(device, workdir, arch, m, n, one, faults=()):
    """``arch`` served over ``m`` ranks (``tp_ranks``: gloo ranks of the
    one card, or a card each over NCCL): bf16 and float32 legs held to the
    one-process kernel route ``one`` ({dtype: (logits, tokens, bound,
    config)}), and each of ``faults`` on rank 1 (a float32 prefill) failing
    the prefill check.  Returns the metrics and the ranks' bf16
    ``flash_attention`` launches a prefill."""
    shape = dict(B=SERVE_B, P=SERVE_P, cap=SERVE_CAP)
    backend, rank_units = tp_ranks(device, m, n)
    base = dict(shape, keep=True, warm=backend == "nccl")
    f32 = one["float32"][3]
    legs = [dict(base, name=dt, cfg=one[dt][3], tokens=one[dt][1]) for dt in one]
    legs += [dict(base, name=f"fault_{f}", cfg=f32, tokens=[], fault_rank=1, fault=f,
                  warm=False) for f in faults]
    tag = tag_of(arch, m)
    res = tp_run(device, workdir, tag, m, backend, rank_units, legs)
    out = {"backend": backend}
    for dt, (lg, _, lim, _) in one.items():
        c = out[dt] = tp_compare(dt, res, {"k": lg}, lim)
        check(c["prefill_rel_err"] < lim[0] and c["decode_max_rel_err"] < lim[1],
              f"{tag} {dt}: rel errs (prefill, decode) {c['prefill_rel_err']}, "
              f"{c['decode_max_rel_err']} against one process, bounds {lim}")
    for f in faults:
        e = out[f"fault_{f}"] = tp_compare(f"fault_{f}", res, {"k": one["float32"][0]},
                                           one["float32"][2])["prefill_rel_err"]
        check(e >= max(one["float32"][2][0], one["bfloat16"][2][0]),
              f"{tag}: the planted fault {f} passed the prefill check ({e})")
    out["ranks"] = {r["rank"]: {dt: r[dt][0] for dt in one} for r in res}
    print(f"  {tag}: " + " ".join(f"{k}={v!r}" for k, v in out.items() if k != "ranks"))
    return out, sum(r["bfloat16"][0]["flash_launches_per_prefill"] for r in res)


def ssm_train_cards(device, workdir, arch, extra=()):
    """``python -m repro_torch.launch.train --arch ARCH --smoke --model-par
    2`` (and the flags ``extra``) on the node's cards (a rank a card over
    NCCL), SSM_TRAIN_STEPS steps with 2 cards lost at SSM_FAIL_AT: it must
    reach the last step after one recovery.  Returns its summary line and
    seconds."""
    import os

    ckpt = workdir / f"train_{arch}"
    if ckpt.exists():
        import shutil

        shutil.rmtree(ckpt)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--smoke",
           "--model-par", "2", "--steps", str(SSM_TRAIN_STEPS), "--fail-at", str(SSM_FAIL_AT),
           "--fail-devices", "2", "--ckpt-every", "8", "--ckpt-dir", str(ckpt), *extra]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=TP_TIMEOUT_S)
    secs = time.perf_counter() - t0
    done = [ln for ln in p.stdout.splitlines() if ln.startswith("done:")]
    check(p.returncode == 0 and done, f"launch.train {arch} --model-par 2 exited "
          f"{p.returncode}:\n{p.stderr[-3000:]}")
    check(f"step={SSM_TRAIN_STEPS} " in done[-1] and "recoveries=1 " in done[-1],
          f"launch.train {arch} --model-par 2: {done[-1]}")
    print(f"  launch.train {arch} --smoke --model-par 2 {' '.join(extra)} --fail-at "
          f"{SSM_FAIL_AT} --fail-devices 2: {done[-1]} in {secs:.1f} s")
    return done[-1], secs


def phase_serve_tp_ssm(device, workdir, cards=None):
    """Phase 19, cell ``serve_tp_ssm_cards``: tensor-parallel serving of
    the SSM family (mamba2-2.7b) and the hybrid family (hymba-1.5b) over
    ranks whose ``model`` axis spans them (``make_prefill`` /
    ``make_decode_step`` over the mesh; each rank holding its share of the
    reference's Megatron specs: its SSD heads and ``d_inner`` channels
    where they divide the axis, B and C computed whole on every rank, the
    gated norm's mean square summed over the model group, one all-reduce a
    mixer; hymba's FFN columns; its 25 attention heads and 32,001-token
    vocabulary whole on every rank).

    Each arch at full width and depth, first in one process on
    ``device`` (bf16 through the kernel route at the config's SSD chunk and
    at half of it, hymba also through the dense and blocked attention
    routes; float32 at SSM_F32_LAYERS), then over SSM_TP_M ranks (2 gloo
    ranks of the one card, or 2 cards over NCCL): bf16 with phase 8's
    batch, cache and 32 decode steps fed the one-process greedy tokens,
    held to the one-process kernel route at the larger of 2e-2 and
    SERVE_SPREAD_FACTOR times the one-process routes' spread (chunk vs
    half chunk; hymba also dense vs blocked), float32 against 1e-4; on
    mamba2 each planted fault of SSM_FAULTS on rank 1 must fail the
    prefill check.  With 4 cards both over 4 cards (mamba2 20 heads a
    rank, hymba's SSM whole), and ``launch.train --smoke --model-par 2``
    of each through a recovery (``ssm_train_cards``).  Each rank's
    ``flash_attention`` and ``ssd_scan`` launches a prefill (one a layer
    on the card; ``tp_run`` checks both), SSM heads and conv channels,
    peak memory, bytes held and collectives (count, type, µs) are printed;
    ``flash_attention`` is timed at hymba's shape on every rank
    (``SSM_TP_FLASH``) and ``ssd_scan`` at mamba2's heads a rank
    (``SSM_RANK_SSD``) beside their plain versions.  Returns the metrics,
    the launches over the ranks of each per-rank shape's bf16 prefill, and
    the flash and ssd timings."""
    import torch

    cuda = device.type == "cuda"
    n = cards or (min(torch.cuda.device_count(), 4) if cuda else 1)
    workdir.mkdir(parents=True, exist_ok=True)
    out = {"cards": n}
    shape = dict(B=SERVE_B, P=SERVE_P, cap=SERVE_CAP)
    launches = {}
    for arch in SSM_TP_ARCHS:
        cfg_bf = tp_cfg(arch, "bfloat16")
        cfg_f32 = tp_cfg(arch, "float32", SSM_F32_LAYERS)
        routes = {"k": "pallas", "c": ("pallas", {"ssm_chunk": cfg_bf.ssm_chunk // 2})}
        pairs = [("k", "c")]
        if cfg_bf.uses_attention:
            routes.update(d="dense", p="blocked")
            pairs.append(("d", "p"))
        one_bf, tok_bf, prefill_s = tp_one_process(device, cfg_bf, routes, steps=SERVE_STEPS,
                                                   **shape)
        one_f32, tok_f32, _ = tp_one_process(device, cfg_f32, {"k": "pallas"},
                                             steps=SERVE_STEPS, **shape)
        lim_bf, spread = tp_bounds(one_bf, "bfloat16", pairs)
        lim_f32, _ = tp_bounds(one_f32, "float32")
        a = out[arch] = {"one_process_prefill_s": prefill_s, "one_process_spread": spread,
                         "chunk_vs_half_chunk": tp_bounds(one_bf, "bfloat16", [("k", "c")])[1]}
        one = {"bfloat16": (one_bf["k"], tok_bf, lim_bf, cfg_bf),
               "float32": (one_f32["k"], tok_f32, lim_f32, cfg_f32)}
        del one_bf, one_f32
        faults = SSM_FAULTS if not cfg_bf.uses_attention else ()
        for m in (SSM_TP_M, 4) if n >= 4 else (SSM_TP_M,):
            a[f"mp{m}"], flash = ssm_serve_over(device, workdir, arch, m, n, one, faults)
            faults = ()
            if cfg_bf.uses_attention:
                launches[tag_of(arch, m)[len("serve_tp_"):]] = flash
        if n >= 4:
            a["train_cards"] = ssm_train_cards(device, workdir, arch)
    flash_t, ssd_t = {}, {}
    if cuda:
        for key, case in SSM_TP_FLASH.items():
            if key in launches:
                flash_t[key] = t = time_flash(device, "bfloat16", case=case)
                print(f"  flash_attention {key} at {case} bfloat16: " + " ".join(
                    f"{k}={v!r}" for k, v in t.items() if k not in ("shape", "dtype")))
        for key, case in SSM_RANK_SSD.items():
            for dt in ("bfloat16", "float32"):
                ssd_t[key, dt] = t = time_ssd(device, dt, case=case)
                print(f"  ssd_scan {key} at {case} {dt}: " + " ".join(
                    f"{k}={v!r}" for k, v in t.items() if k not in ("shape", "dtype")))
    return out, launches, flash_t, ssd_t


# ---------------------------------------------------------------------------
# Phase 20: the dry-run's collectives on one rank of a multi-chip mesh,
# dryrun_ranks_h100
# ---------------------------------------------------------------------------

# train steps a job runs in the scheduled roofline cells (prefill and
# decode take ROOF_STEPS)
ROOF_TRAIN_STEPS = 2_000


def serve_case(arch, m, ranks, cfg):
    """Phase 20's prefill and decode cases of a serving leg over (1, ``m``)
    ranks (``ranks``: each rank's metrics by leg, as phases 17 and 19
    return them; the bf16 leg's): rank 0's collectives of the prefill and
    of the first decode step, and the cells phase 8's batch and cache
    give."""
    from repro_torch.configs.base import ShapeCell

    m0 = ranks[0]["bfloat16"]
    cells = {"prefill": ShapeCell(f"prefill_b{SERVE_B}s{SERVE_P}", "prefill", SERVE_P, SERVE_B),
             "decode": ShapeCell(f"decode_b{SERVE_B}c{SERVE_CAP}", "decode", SERVE_CAP,
                                 SERVE_B)}
    return [dict(arch=arch, cfg=cfg, cell=cells[k], mesh=(1, m), tally=m0[f"{k}_coll"],
                 kw={}, record=True) for k in ("prefill", "decode")]


def phase20_cases(tp, ssm, leg):
    """Phase 20's cases from what the earlier phases ran: granite-8b's
    prefill and decode over TP_M ranks (phase 17); on several cards
    qwen3-32b's over phase 17's ranks and, on four, mamba2-2.7b's over 4
    (phase 19); then phase 16's int8 leg's (``leg_cases``)."""
    cases = serve_case(TP_ARCH, TP_M, tp["ranks"], tp_cfg(TP_ARCH, "bfloat16"))
    if "qwen3_full" in tp:
        cases += serve_case(TP_BIG_ARCH, tp["qwen3_mp"],
                            {r: {"bfloat16": m} for r, m in tp["qwen3_full"].items()},
                            tp_cfg(TP_BIG_ARCH, "bfloat16"))
    arch = SSM_TP_ARCHS[0]
    if "mp4" in ssm.get(arch, {}):
        cases += serve_case(arch, 4, ssm[arch]["mp4"]["ranks"], tp_cfg(arch, "bfloat16"))
    return cases + leg_cases(leg)


def leg_cases(leg):
    """Phase 20's cases of phase 16's int8 leg: its training step at its
    own config, held to rank 0's tally and printed beside the ranks'
    peaks, and the arch's whole config recorded at the leg's mesh and
    cell."""
    from repro_torch.configs import get_config

    p20 = leg["phase20"]
    return [
        dict(arch=TPI_ARCH, cfg=p20["cfg"], cell=p20["cell"], mesh=p20["mesh"],
             tally=p20["tally"], kw=TPI_DRYRUN_KW, record=False, peaks_gib=p20["peaks_gib"]),
        dict(arch=TPI_ARCH, cfg=get_config(TPI_ARCH), cell=p20["cell"], mesh=p20["mesh"],
             tally=None, kw=TPI_DRYRUN_KW, record=True)]


def dryrun_window(device, fn):
    """``fn()`` with the card's memory watched: allocated memory must not
    move and its peak must not rise."""
    import torch
    from repro_torch.roofline import analysis as RA

    on_card = device.type == "cuda"
    if on_card:
        # PyTorch initialises the CUDA context for fake tensors once per
        # process and device with a 4-byte tensor
        # (torch/_subclasses/fake_tensor.py, init_gpu_context): taken here,
        # before the window, so the window holds the dry-run alone
        with RA.fake_mode():
            torch.empty(0, device=device)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    out = fn()
    if on_card:
        after, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
        check(after == before and peak == before,
              f"dry-run allocated on the card: {before} -> {after} bytes, peak {peak}")
    return out


def phase_dryrun_ranks(device, path, cases):
    """Phase 20, cell ``dryrun_ranks_h100``: the dry-run of each of
    ``cases`` (dicts of ``arch``, the ``cfg`` a phase ran, its ``cell``,
    its ``mesh`` (1, m), rank 0's collectives by kind there (``tally``,
    ``coll_of``), the trace's options ``kw``, whether a record of the
    arch's own config is made, ``record``, and for a training step the
    ranks' measured peaks, ``peaks_gib``, printed beside the trace's
    ``hbm_per_device`` and rank 0's counted peak): rank 0's step of the mesh
    counted on fake tensors of the card (``launch.dryrun``'s rank trace)
    must dispatch exactly the calls and result bytes the phase's rank 0
    did, kind by kind; beside each, ``coll_bytes / H100.ici_bw`` and the
    collective µs measured.  Then ``RooflinePerfModel`` on cells built
    from the records (``chips_ref`` the mesh's chips) drives
    ``EcoSched(engine="torch")`` on the paper's ``Node(4, 2)`` against
    ``engine="vector"``: the same schedule, ``score_reduce`` launched
    (counted into ``path``), and t̂(g) printed for g = 1-4 with and without
    the collective term.  Allocated memory must not move across the
    dry-runs."""
    from repro_torch.configs import get_config
    from repro_torch.core import EcoSched, Node, RooflinePerfModel, simulate
    from repro_torch.distributed.meshes import AbstractMesh
    from repro_torch.kernels import score_reduce as K
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline import analysis as RA
    from repro_torch.roofline.hw import H100

    from repro_torch.models import Runtime

    rt = Runtime(remat="full", attn_impl="auto")  # the plain routes: the same collectives
    out = {"cases": [], "sched": {}}
    sched_cells = {}
    for c in cases:
        cfg, cell, mesh = c["cfg"], c["cell"], AbstractMesh(c["mesh"], ("data", "model"))
        name = f"{c['arch']}@{cell.kind}@1x{c['mesh'][1]}"
        t0 = time.perf_counter()
        rec = None
        if c["record"]:
            rec = dryrun_window(device, lambda: D.dryrun_cell(
                c["arch"], cell, mesh=mesh, rt=rt, skip_variants=True, device=device,
                grad_accum=1, **c["kw"]))
        if rec is not None and not rec["pad_changes"] and cfg == get_config(c["arch"]).replace(
                dtype=cfg.dtype):
            counts = rec["counts_full"]
            got = {k: rec["cost_full_module"][f"coll_{k}"] for k in RA.COLLECTIVE_KINDS}
        else:  # the phase ran another config (a cut, or unpadded): count that one
            tr = dryrun_window(device, lambda: D.trace_cell(
                cfg, cell, mesh, rt, grad_accum=1, device=device, **c["kw"]))
            rc = tr.rank_costs
            counts = rc["_counts"]
            got = {k: rc[f"coll_{k}"] for k in RA.COLLECTIVE_KINDS}
        wall = time.perf_counter() - t0
        want = {k: (c["tally"] or {}).get(k, [0, 0, 0.0]) for k in RA.COLLECTIVE_KINDS}
        bad = {k: ((counts[k], got[k]), tuple(want[k][:2])) for k in RA.COLLECTIVE_KINDS
               if c["tally"] is not None and (counts[k] != want[k][0] or got[k] != want[k][1])}
        measured_us = sum(v[2] for v in want.values())
        row = dict(name=name, layers=cfg.num_layers, calls={k: counts[k] for k in counts
                                                              if counts[k]},
                   coll_bytes=sum(got.values()),
                   coll_over_ici_us=sum(got.values()) / H100.ici_bw * 1e6,
                   measured_collective_us=measured_us if c["tally"] is not None else None,
                   wall_s=wall)
        if c.get("peaks_gib"):  # the leg's own step, traced above (no record)
            row.update(measured_peak_gib_by_rank=c["peaks_gib"],
                       hbm_per_device_gib=D.device_memory(tr, math.prod(c["mesh"]))[1] / 2 ** 30,
                       rank_trace_peak_gib=rc["peak_bytes"] / 2 ** 30)
        print(f"  dryrun_ranks_h100 {name} ({cfg.num_layers} layers, {cfg.dtype}): "
              + " ".join(f"{k}={v!r}" for k, v in row.items() if k != "name"))
        check(not bad, f"dryrun_ranks_h100 {name}: the rank trace's (calls, bytes) differ from "
                       f"rank 0's tally: {bad}")
        out["cases"].append(row)
        if rec is not None:
            check(rec["coll_counted"] and rec["cost_totals"]["coll_bytes"] > 0,
                  f"dryrun_ranks_h100 {name}: the record counts no collectives")
            terms = RA.derive_terms(rec, get_config(c["arch"]), cell, H100)
            sched_cells[name] = {
                "chips_ref": rec["chips"], "t_compute": terms["t_compute"],
                "t_memory": terms["t_memory"], "t_collective": terms["t_collective"],
                "steps": ROOF_TRAIN_STEPS if cell.kind == "train" else ROOF_STEPS[cell.kind]}
    # the roofline schedule with the collective term
    truth = roof_truth(sched_cells, H100, ROOF_COUNTS)
    node = Node(4, 2, H100.power_idle)
    res = {}
    for engine in ("torch", "vector"):
        pm = RooflinePerfModel(sched_cells, counts=ROOF_COUNTS, chip=H100, units_to_chips=1)
        extra = {"device": device} if engine == "torch" else {}
        pol = EcoSched(pm, lam=LAM, tau=TAU, engine=engine, **extra)
        if engine == "torch":
            K.reset_stats()
        res[engine] = simulate(pol, node, truth, queue=sorted(truth))
        if engine == "torch":
            kstats = read_stats()
            path.add(kstats)
    check(fp(res["torch"]) == fp(res["vector"]),
          f"dryrun_ranks_h100: torch schedule {fp(res['torch'])} differs from vector "
          f"{fp(res['vector'])}")
    n = kstats["score_reduce"]["launches"]
    check(n > 0, "dryrun_ranks_h100: score_reduce was never launched")
    pm = RooflinePerfModel(sched_cells, counts=ROOF_COUNTS, chip=H100, units_to_chips=1)
    for job, cell in sorted(sched_cells.items()):
        terms = {g: pm._terms_at(cell, g) for g in ROOF_COUNTS}
        print(f"  t_hat({job}) g=1-4 with the collective term: "
              f"{[max(terms[g]) for g in ROOF_COUNTS]!r}; without: "
              f"{[max(terms[g][:2]) for g in ROOF_COUNTS]!r}")
    choices = {r.job: r.g for r in res["torch"].records if r.kind == "run"}
    out["sched"] = dict(fp=fp(res["torch"])[0], makespan=res["torch"].makespan,
                        energy=res["torch"].total_energy, launches=n,
                        guarded=kstats["score_reduce"]["guarded"], choices=choices)
    print("  dryrun_ranks_h100 schedule: " + " ".join(f"{k}={v!r}"
                                                     for k, v in out["sched"].items()))
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch package under {SRC}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    laps = {}

    def lap(phase):
        laps[phase] = round(time.perf_counter() - t_start - sum(laps.values()), 3)

    device = torch.device("cuda", 0)
    card = smi()
    print("== phase 1: device and build")
    print(f"  nvidia-smi: {card}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    # the planted fault's build (flash_attention.cu alone, one TF32 pass,
    # a library of its own hash) runs beside the real one
    with ThreadPoolExecutor(2) as pool:
        fault_build = pool.submit(_build.build, [FLASH_FAULT], ["flash_attention"])
        _build.library()
        build_s = time.perf_counter() - t0
        one_pass = _build.load(fault_build.result())
    print(f"  kernels built in {build_s:.3f} s ({'cached' if cached else 'fresh'}) "
          f"-> {_build.library_path().relative_to(ROOT)}; with {FLASH_FAULT} "
          f"(planted fault) in {time.perf_counter() - t0:.3f} s")
    from repro_torch.kernels import flash_attention as FA

    log = _build.library_path().with_suffix(".log").read_text()
    for line in log.splitlines():
        if line.startswith(("$", "compile_s", "build_s")):
            print(f"  nvcc: {line.split(' -')[0] if line[0] == '$' else line}")
    ptxas = ptxas_by_kernel(log)
    for fn, (regs, stores, loads) in sorted(ptxas.items()):
        print(f"  ptxas: {fn} registers={regs} spill_stores={stores} spill_loads={loads}")
    # the bf16 flash kernel spills nothing: a walking and a one-tile
    # instantiation a head dim, one-tile only at hd 256
    n_ws = 2 * len(FA.HEAD_DIMS) - 1
    ws = {fn: v for fn, v in ptxas.items() if "flash_kernel_ws" in fn}
    check(len(ws) == n_ws and all(v[1:] == (0, 0) for v in ws.values()),
          f"flash_kernel_ws: want {n_ws} instantiations without spills, ptxas says {ws}")
    sass = sass_counts(_build.library_path())
    if sass is None:
        print("  sass: no cuobjdump in the toolkit; tensor-core instructions not counted")
    else:  # both flash kernels must run their products on the tensor cores
        for name, n_inst in (("flash_kernel_ws", n_ws), ("flash_kernel_tf32", 6)):
            wg = {k: n for k, (n, _) in sass.items() if name in k}
            check(len(wg) == n_inst and all(n > 0 for n in wg.values()),
                  f"{name} lacks HGMMA/HMMA in its SASS: {wg}")
        # and the bf16 one loads its tiles by TMA
        tma = {k: n for k, (_, n) in sass.items() if "flash_kernel_ws" in k}
        check(len(tma) == n_ws and all(n > 0 for n in tma.values()),
              f"flash_kernel_ws lacks UTMALDG in its SASS: {tma}")
        # and the bf16 ssd kernels (C.B^T, chunk states, outputs) theirs
        ssd = {k: n for k, (n, _) in sass.items() if "ssd_" in k and "bfloat16" in k}
        check(len(ssd) == 9 and all(n > 0 for n in ssd.values()),
              f"the bf16 ssd kernels lack HMMA/HGMMA in their SASS: {ssd}")
        for k, (n, m) in sorted(sass.items()):
            if n or "flash" in k or "ssd_" in k:
                print(f"  sass: {k[:110]} HGMMA/HMMA={n} UTMALDG={m}")

    lap("1")
    print("== phase 2: kernels vs plain versions on the card")
    # plain float32 versions in exact float32 (no TF32 matmuls) from here on
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"  torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")
    diff = phase_kernels(device)
    print(f"  cases={diff.cases} max_abs_err={diff.max_abs}")
    model_err = phase_model_kernels(device, one_pass)
    print(f"  model kernels: max_abs_err="
          f"{ {k: v for k, v in model_err.items() if k != 'flash_by_case'} }")
    lap("2")

    path = MainPath()
    print("== phase 3: main path, paper node")
    phase_paper(device, path)
    lap("3")
    print("== phase 4: main path, elastic")
    phase_elastic(device, path)
    lap("4")
    print("== phase 5: main path, pod scale")
    phase_pod(device, path)
    lap("5")
    print("== phase 6: fleet path, 256 nodes")
    phase_fleet(device, path)
    lap("6")
    for name, st in path.launches.items():
        check(st["launches"] > 0, f"{name} was never launched on the main paths")
    print(f"  main-path launches: {path.launches}")

    print("== phase 7: kernel times at the main paths' largest shapes")
    kernels = phase_timings(device, path, diff)
    model_times = {"flash_attention": time_flash(device, "bfloat16"),
                   "flash_attention_float32": time_flash(device, "float32"),
                   "ssd_scan": time_ssd(device, "bfloat16", SSD_SERVE),
                   "ssd_scan_float32": time_ssd(device, "float32", SSD_SERVE),
                   "ssd_scan_mamba2_layer": time_ssd(device, "bfloat16"),
                   "ssd_scan_mamba2_layer_float32": time_ssd(device, "float32")}
    from repro_torch.kernels import ssd_scan as SS

    window, softcap, causal = FLASH_PATH[5:]
    for name, dtype, kerns in (
            ("flash_attention", torch.bfloat16, ("flash_kernel_ws",)),
            ("flash_attention_float32", torch.float32,
             ("flash_split_kv_kernel", "flash_kernel_tf32"))):
        fl = flash_inputs(FLASH_PATH, dtype, device, seed=99)
        t = model_times[name]
        t["device_us"], t["device_us_per_kernel"] = profile_model_kernel(
            lambda: FA.flash_attention(*fl, causal=causal, window=window, softcap=softcap),
            kerns, lambda: (FA.STATS["flash_attention"],))
    # granite-8b's prefill (hd 128, GQA group 4): the bf16 kernel beside SDPA,
    # and its device us a launch
    t = model_times["flash_attention_granite"] = time_flash(device, "bfloat16", GRANITE_FLASH)
    window, softcap, causal = GRANITE_FLASH[5:]
    fl = flash_inputs(GRANITE_FLASH, torch.bfloat16, device, seed=99)
    t["device_us"], t["device_us_per_kernel"] = profile_model_kernel(
        lambda: FA.flash_attention(*fl, causal=causal, window=window, softcap=softcap),
        ("flash_kernel_ws",), lambda: (FA.STATS["flash_attention"],))
    del fl
    for name, t in model_times.items():
        print(f"  {name} at {t['shape']} {t.get('dtype', 'bfloat16')}: " + " ".join(
            f"{k}={v!r}" for k, v in t.items() if k not in ("shape", "dtype")))
    lap("7")

    print("== phase 8: serving path, serve_hymba_1_5b_p2048")
    flash_launches, served = phase_serve(device)
    for dtype, n in flash_launches.items():
        check(n > 0, f"flash_attention ({dtype}) was never launched on the serving path")
    lap("8")
    print("== phase 9: SSD layer, ssd_layer_mamba2_2_7b_s4096")
    ssd_launches, _ = phase_ssd_layer(device)
    for dtype, n in ssd_launches.items():
        check(n > 0, f"ssd_scan ({dtype}) was never launched on the SSD layer")
    lap("9")
    for dtype, m in served.items():
        check(m["ssd_scan_launches"] > 0,
              f"ssd_scan ({dtype}) was never launched on the serving path")
    print(f"  serving and SSD launches: flash_attention={flash_launches} "
          f"ssd_scan={ {d: m['ssd_scan_launches'] for d, m in served.items()} } "
          f"(phase 9: {ssd_launches})")
    print("== phase 10: control plane, daemon_hetero")
    daemon_launches = phase_daemon(device, ROOT / "build" / "daemon")
    print(f"  daemon launches: {daemon_launches}")
    lap("10")
    print("== phase 11: MoE serving, serve_qwen2_moe_a2_7b_p2048")
    torch.cuda.empty_cache()
    moe_launches, _ = phase_serve_moe(device)
    for dtype, n in moe_launches.items():
        check(n > 0, f"flash_attention ({dtype}) was never launched on the MoE serving path")
    print(f"  MoE serving launches: flash_attention={moe_launches}")
    lap("11")
    print("== phase 12: training, train_hymba_1_5b_b4s2048, train_elastic_granite_reduced_u4, "
          "moe_ep_layer_qwen2_moe_a2_7b_mp4")
    torch.cuda.empty_cache()
    trained = phase_train(device, ROOT / "build" / "train")["train"]
    lap("12")
    print("== phase 13: co-scheduling real training jobs, cosched_trio_u4")
    cosched = phase_cosched(device, ROOT / "build" / "train")
    check(cosched["score_reduce_launches"] > 0,
          "score_reduce was never launched on the co-scheduling path")
    print(f"  co-scheduling launches: score_reduce={cosched['score_reduce_launches']}")
    lap("13")
    print("== phase 14: roofline, dryrun_hymba_1_5b_one_card, roofline_sched_h100_node")
    roof = phase_roofline(device, path, {
        "prefill": served["bfloat16"]["prefill_s"],
        "decode": served["bfloat16"]["decode_ms_per_step"] / 1e3,
        "train": trained["s_per_step"], "train_B": trained["batch"],
        "train_peak": trained["peak_gib"] * 2 ** 30})
    print(f"  roofline launches: score_reduce={roof['sched']['launches']}; "
          f"main-path launches: {path.launches}")
    for k in kernels:  # the scheduler kernels' counts now include phase 14's
        if k["name"] in path.launches:
            k["launches"] = path.launches[k["name"]]["launches"]
    lap("14")
    print("== phase 15: dense, vision and encoder-decoder serving, serve_gemma3_4b_p2048, "
          "serve_phi3_vision_4_2b_p2048, serve_whisper_base_src1500")
    torch.cuda.empty_cache()
    family, _, family_flash = phase_serve_families(device)
    print(f"  family serving launches: flash_attention={family}")
    lap("15")
    # ssd_scan at phase 8's hymba prefill, with its launches there; at
    # mamba2's layer, phase 9's
    for name, err, src, line, n in (
            ("flash_attention", "flash_attention", "flash_attention.cu",
             "flash_attention.py:127", flash_launches["bfloat16"]),
            ("flash_attention_float32", "flash_attention_float32", "flash_attention.cu",
             "flash_attention.py:127", flash_launches["float32"]),
            ("ssd_scan", "ssd_scan", "ssd_scan.cu", "ssd_scan.py:102",
             served["bfloat16"]["ssd_scan_launches"]),
            ("ssd_scan_float32", "ssd_scan_float32", "ssd_scan.cu", "ssd_scan.py:102",
             served["float32"]["ssd_scan_launches"]),
            ("ssd_scan_mamba2_layer", "ssd_scan", "ssd_scan.cu", "ssd_scan.py:102",
             ssd_launches["bfloat16"]),
            ("ssd_scan_mamba2_layer_float32", "ssd_scan_float32", "ssd_scan.cu",
             "ssd_scan.py:102", ssd_launches["float32"])):
        t = model_times[name]
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=f"src/repro/kernels/{line}", launches=n,
            max_abs_err=model_err[err], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"]))
    for shape, n in family_launches(family).items():
        t = family_flash[shape]
        kernels.append(dict(
            name=f"flash_attention_{shape}", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:127", launches=n,
            max_abs_err=model_err["flash_by_case"][FAMILY_FLASH[shape], "bfloat16"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    print("== phase 16: data-parallel training over ranks, train_dp_granite_reduced_cards")
    torch.cuda.empty_cache()
    dp = phase_train_dp(device, ROOT / "build" / "train")
    print(f"  multi-card co-scheduling launches: "
          f"score_reduce={dp['cosched']['score_reduce_launches']}")
    lap("16")
    print("== phase 17: tensor-parallel serving over ranks, serve_tp_dense_cards")
    torch.cuda.empty_cache()
    tp, tp_launches, tp_flash = phase_serve_tp(device, ROOT / "build" / "serve_tp")
    print(f"  tensor-parallel serving launches (over the ranks): flash_attention={tp_launches}")
    for shape, n in tp_launches.items():
        check(n > 0, f"flash_attention ({shape}) was never launched on the ranks' heads")
        t = tp_flash[shape]
        kernels.append(dict(
            name=f"flash_attention_{shape}", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:127", launches=n,
            max_abs_err=model_err["flash_by_case"][TP_FLASH[shape], "bfloat16"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    lap("17")
    print("== phase 18: tensor-parallel MoE serving over ranks, serve_tp_moe_cards")
    torch.cuda.empty_cache()
    _, moe_tp_launches, moe_tp_flash = phase_serve_tp_moe(device, ROOT / "build" / "serve_tp")
    print(f"  tensor-parallel MoE serving launches (over the ranks): "
          f"flash_attention={moe_tp_launches}")
    for shape, n in moe_tp_launches.items():
        check(n > 0, f"flash_attention ({shape}) was never launched on the ranks' heads")
        t = moe_tp_flash[shape]
        kernels.append(dict(
            name=f"flash_attention_{shape}", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:127", launches=n,
            max_abs_err=model_err["flash_by_case"][MOE_TP_FLASH[shape], "bfloat16"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    lap("18")
    print("== phase 19: tensor-parallel SSM and hybrid serving over ranks, serve_tp_ssm_cards")
    torch.cuda.empty_cache()
    ssm_tp, ssm_tp_launches, ssm_tp_flash, _ = phase_serve_tp_ssm(device,
                                                                 ROOT / "build" / "serve_tp")
    print(f"  tensor-parallel SSM and hybrid serving launches (over the ranks): "
          f"flash_attention={ssm_tp_launches}")
    for shape, n in ssm_tp_launches.items():
        check(n > 0, f"flash_attention ({shape}) was never launched on the hymba ranks")
        t = ssm_tp_flash[shape]
        kernels.append(dict(
            name=f"flash_attention_{shape}", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:127", launches=n,
            max_abs_err=model_err["flash_by_case"][SSM_TP_FLASH[shape], "bfloat16"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    lap("19")
    print("== phase 20: the dry-run's collectives on one rank of a multi-chip mesh, "
          "dryrun_ranks_h100")
    phase_dryrun_ranks(device, path, phase20_cases(tp, ssm_tp, dp["train_tp_int8"]))
    for k in kernels:  # the scheduler kernels' counts now include phase 20's
        if k["name"] in path.launches:
            k["launches"] = path.launches[k["name"]]["launches"]
    lap("20")
    print(f"  phase_seconds={laps} total_s={time.perf_counter() - t_start:.1f}")
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The work counts: the closed form of the kept pairs against a count by
brute force, and the configurations' counts against numbers worked by
hand here."""
import json

import pytest

from perfbench_tiny import HERE

import flops
from families import hybrid


def _brute_pairs(S, window):
    return sum(1 for i in range(S) for j in range(S)
               if j <= i and (window <= 0 or j > i - window))


@pytest.mark.parametrize("S,window", [(1, 0), (7, 0), (64, 0), (64, 16), (64, 64),
                                      (64, 100), (130, 1), (130, 129), (300, 37)])
def test_causal_pairs_closed_form(S, window):
    assert flops.causal_pairs(S, window) == _brute_pairs(S, window)


def _cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_granite_prefill_by_hand():
    # per token and layer: q 4096*4096, k and v 4096*1024 each, o 4096*4096,
    # the FFN 3*4096*14336 multiply-adds
    layer = 4096 * 4096 * 2 + 2 * 4096 * 1024 + 3 * 4096 * 14336
    assert layer == 218_103_808
    tokens = 8 * 2048
    pairs = 2048 * 2049 // 2  # causal, no window
    attn = 8 * 36 * 2 * 128 * 32 * pairs  # q.k and p.v multiply-adds
    head = 8 * 1 * 4096 * 49152  # the last position of each prompt
    want = 2 * (tokens * 36 * layer + attn + head)
    assert flops.prefill_flops(_cfg("granite-8b"), 8, 2048) == want
    assert want == 267_189_378_613_248


def test_hymba_counts_by_hand():
    # attention 1600*(1600+2*320)+1600*1600, the SSD projections
    # 1600*(2*3200+2*16+50)+3200*1600, the conv 4*(3200+32), the FFN 3*1600*5504
    layer = 1600 * 2240 + 1600 * 1600 + 1600 * 6482 + 3200 * 1600 + 4 * 3232 + 3 * 1600 * 5504
    assert flops.layer_weight_macs(_cfg("hymba-1.5b")) == layer
    # window 1,024 at S 2,048: 1024*1025/2 + 1024*1024 pairs
    pairs = 524_800 + 1_048_576
    assert flops.causal_pairs(2048, 1024) == pairs
    # SSD a chunk of 256: C.B and scores.x over 256*257/2 pairs (N 16; 50 heads of
    # 64), the chunk's state and its read-out 2*256*50*64*16, the recurrence 50*64*16
    chunk = 32_896 * 16 + 32_896 * 3200 + 2 * 256 * 3200 * 16 + 3200 * 16
    assert hybrid.ssd_macs(_cfg("hymba-1.5b"), 2048) == 8 * chunk
    fwd = 4 * 2048 * 32 * layer + 4 * 32 * 2 * 64 * 25 * pairs + 4 * 32 * 8 * chunk
    train = 3 * 2 * (fwd + 4 * 2048 * 1600 * 32001)
    assert flops.train_step_flops(_cfg("hymba-1.5b"), 4, 2048) == train


def test_flash_work():
    # granite's call: every kept pair of every row and head, 4*hd operations
    assert flops.flash_ops(8, 2048, 32, 128, 0) == 4 * 128 * 8 * 32 * 2_098_176
    # q and o of 32 heads, k and v of 8, bf16
    assert flops.flash_bytes(8, 2048, 32, 8, 128, 2) == 2 * 8 * 2048 * 128 * (32 + 8) * 2

"""Seeded token batches: an affine token chain t+1 = (a*t + b) mod V,
with a share of the positions drawn from a Zipf head of the vocabulary.

The same arithmetic as the port's synthetic data pipeline, copied so that
the benchmark makes its own inputs: batch ``index`` of a run is a pure
function of (seed, index, V), so the program and the reference are given
the same tokens, and a later run with the same seed gets them again.
"""
from __future__ import annotations

import numpy as np


def batch(seed: int, index: int, B: int, S: int, V: int, *, noise_p: float = 0.2,
          chain_mult: int = 3, chain_add: int = 7, zipf_head: int = 1024) -> np.ndarray:
    """(B, S) int32 tokens of batch ``index``."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), int(index), int(V)]))
    head = min(zipf_head, V)
    w = 1.0 / np.arange(1, head + 1, dtype=np.float64)
    cdf = np.cumsum(w / w.sum())
    toks = np.empty((B, S), np.int64)
    toks[:, 0] = rng.integers(0, V, (B, 1), dtype=np.int64)[:, 0]
    noise = rng.random((B, S)) < noise_p
    zipf = np.searchsorted(cdf, rng.random((B, S)))
    for i in range(1, S):
        nxt = (toks[:, i - 1] * chain_mult + chain_add) % V
        toks[:, i] = np.where(noise[:, i], zipf[:, i], nxt)
    return toks.astype(np.int32)

"""Deterministic synthetic token pipeline (a copy of ``repro.data.synthetic``:
numpy only, so both packages draw the same batches bit for bit).

Every batch is a pure function of (seed, step, shard) — reproducible across
restarts and elastic re-sharding, with no host-to-host coordination: each
data-parallel host slices its rows of the global batch by index
(``host_slice``).  The stream has learnable structure (an affine
token-chain corrupted with Zipf noise) so the end-to-end training examples
show a real loss curve, and a known floor: CE can approach
``-(1-p)·log(1-p)...`` of the mixture rather than ``log V``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeCell


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    noise_p: float = 0.2  # fraction of tokens drawn from a Zipf tail
    chain_mult: int = 3
    chain_add: int = 7


class SyntheticLM:
    """Markov-chain token stream: t+1 = (a·t + b) mod V, with Zipf noise."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int, dcfg: DataConfig = DataConfig()):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.dcfg = dcfg
        # Zipf weights over a 1024-token "head" of the vocab
        head = min(1024, cfg.vocab_size)
        w = 1.0 / np.arange(1, head + 1, dtype=np.float64)
        self._zipf_head = head
        self._zipf_cdf = np.cumsum(w / w.sum())

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.dcfg.seed, step, self.cfg.vocab_size])
        )

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg, B, S = self.cfg, self.batch, self.seq_len
        rng = self._rng(step)
        V = cfg.vocab_size
        t0 = rng.integers(0, V, (B, 1), dtype=np.int64)
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = t0[:, 0]
        noise_mask = rng.random((B, S)) < self.dcfg.noise_p
        zipf_draws = np.searchsorted(self._zipf_cdf, rng.random((B, S)))
        for i in range(1, S):
            nxt = (toks[:, i - 1] * self.dcfg.chain_mult + self.dcfg.chain_add) % V
            toks[:, i] = np.where(noise_mask[:, i], zipf_draws[:, i], nxt)
        batch: Dict[str, np.ndarray] = {"tokens": toks.astype(np.int32)}
        if cfg.frontend == "patch_stub":
            batch["patch_embeds"] = rng.standard_normal(
                (B, cfg.num_frontend_tokens, cfg.d_model), np.float32
            )
        if cfg.is_encoder_decoder:
            batch["src_embeds"] = rng.standard_normal((B, S, cfg.d_model), np.float32)
        return batch

    def host_slice(self, step: int, host_idx: int, num_hosts: int) -> Dict[str, np.ndarray]:
        """The rows of the global batch owned by this host (no comm)."""
        assert self.batch % num_hosts == 0, (self.batch, num_hosts)
        per = self.batch // num_hosts
        g = self.global_batch(step)
        return {k: v[host_idx * per : (host_idx + 1) * per] for k, v in g.items()}


def make_dataset(cfg: ModelConfig, cell: ShapeCell, seed: int = 0) -> SyntheticLM:
    return SyntheticLM(cfg, cell.global_batch, cell.seq_len, DataConfig(seed=seed))

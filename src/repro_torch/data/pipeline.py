"""Deterministic, shardable synthetic data pipeline (a copy of the JAX
package's ``data/pipeline.py``: numpy only, the same streams bit for bit).

Every batch is a pure function of ``(seed, step)`` via counter-based
hashing, so:

  * restart-exactness: resuming from a checkpoint at step k reproduces the
    identical token stream (no iterator state to snapshot);
  * shard-awareness: each data shard materialises only its slice — the
    global batch never exists on one host;
  * straggler re-assignment: a re-balanced mesh re-slices the same global
    stream without skew.

Tokens follow a Zipf-ish unigram mixture with local n-gram structure so the
loss curve is non-trivial (pure uniform tokens give a flat CE at ln V).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..configs.base import ArchConfig, ShapeConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_alpha: float = 1.1
    ngram_period: int = 8  # deterministic local structure


class SyntheticLM:
    """Counter-based synthetic LM stream."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, dcfg: DataConfig = DataConfig()):
        self.cfg = cfg
        self.shape = shape
        self.dcfg = dcfg
        # fixed unigram table (vocab-sized ranking permutation)
        rng = np.random.default_rng(dcfg.seed + 1234)
        self._rank_of = rng.permutation(cfg.vocab_size)

    def _tokens(self, step: int, row_lo: int, row_hi: int) -> np.ndarray:
        S = self.shape.seq_len
        rows = np.arange(row_lo, row_hi, dtype=np.uint64)
        cols = np.arange(S, dtype=np.uint64)
        # counter-based hash: (seed, step, row, col) -> u64
        x = (
            rows[:, None] * np.uint64(0x9E3779B97F4A7C15)
            + cols[None, :] * np.uint64(0xBF58476D1CE4E5B9)
            + np.uint64(self.dcfg.seed * 2654435761 + step * 0x94D049BB)
        )
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        u = (x >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        u = np.clip(u, 1e-12, 1.0)  # u=0 would blow up the inverse CDF
        # Zipf-ish rank via inverse CDF, clipped to vocab (clip as float —
        # the unclipped value overflows int64)
        V = self.cfg.vocab_size
        alpha = self.dcfg.zipf_alpha
        rank = np.minimum(
            u ** (-1.0 / (alpha - 1.0)) - 1.0, float(V - 1)
        ).astype(np.int64)
        tok = self._rank_of[rank]
        # periodic n-gram structure: every ngram_period-th token repeats the
        # previous one, giving the model something learnable
        per = self.dcfg.ngram_period
        tok[:, per - 1 :: per] = tok[:, per - 2 :: per][:, : tok[:, per - 1 :: per].shape[1]]
        return tok.astype(np.int32)

    def global_batch(self, step: int) -> Dict[str, Optional[np.ndarray]]:
        toks = self._tokens(step, 0, self.shape.global_batch)
        if self.cfg.frontend != "none":
            # stubbed modality frontend: deterministic frame/patch embeddings
            emb = self._embeds(step, 0, self.shape.global_batch)
            return {"tokens": None, "embeds": emb, "labels": toks}
        return {"tokens": toks, "embeds": None, "labels": toks}

    def shard_batch(self, step: int, shard: int, n_shards: int):
        B = self.shape.global_batch
        per = B // n_shards
        lo, hi = shard * per, (shard + 1) * per
        toks = self._tokens(step, lo, hi)
        if self.cfg.frontend != "none":
            return {
                "tokens": None,
                "embeds": self._embeds(step, lo, hi),
                "labels": toks,
            }
        return {"tokens": toks, "embeds": None, "labels": toks}

    def _embeds(self, step: int, lo: int, hi: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.dcfg.seed * 1_000_003 + step) % (2**31) + lo
        )
        return rng.standard_normal(
            (hi - lo, self.shape.seq_len, self.cfg.d_model), dtype=np.float32
        ) * 0.02

"""Deterministic synthetic token pipeline (per-host sharded, restartable).

A copy of the JAX package's ``data/pipeline.py`` (numpy only): its batches
are the same, bit for bit, so a run of either package sees one stream.

Production shape: each host generates only its shard of the global batch
(``host_slice``), the stream is a pure function of (seed, step) so restart
from a checkpointed step reproduces the exact batch sequence (no data-loader
state files), and the generator models a power-law unigram distribution with
local n-gram structure so cross-entropy actually *decreases* during the e2e
example runs (a uniform stream cannot be learned).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1
    ngram_period: int = 8     # deterministic local structure


class SyntheticLM:
    """batch(step) → dict(tokens, labels, positions), pure in (seed, step)."""

    def __init__(self, cfg: DataConfig, host_index: int = 0, host_count: int = 1):
        assert cfg.global_batch % host_count == 0
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count
        # fixed unigram table (shared across hosts)
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_alpha)
        self.probs = probs / probs.sum()
        # per-token deterministic successor table → learnable bigram structure
        self.successor = rng.permutation(cfg.vocab_size)

    def batch(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed * 1_000_003 + step) * 65_537 + self.host_index)
        draws = rng.choice(c.vocab_size, size=(self.local_batch, c.seq_len + 1),
                           p=self.probs)
        # every `ngram_period`-th position is the deterministic successor of
        # the previous token — a learnable signal
        out = draws.copy()
        idx = np.arange(1, c.seq_len + 1)
        mask = (idx % c.ngram_period) == 0
        out[:, idx[mask]] = self.successor[out[:, idx[mask] - 1]]
        tokens = out[:, :-1].astype(np.int32)
        labels = out[:, 1:].astype(np.int32)
        positions = np.broadcast_to(
            np.arange(c.seq_len, dtype=np.int32)[None], tokens.shape)
        return {"tokens": tokens, "labels": labels, "positions": positions.copy()}

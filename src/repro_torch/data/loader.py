"""Packed LM batch pipeline: corpus -> token stream -> (B, S+1) batches,
deterministically sharded per data-parallel host group.

A copy of ``repro/data/loader.py`` (the port imports nothing of the
reference package): batches stay numpy int32 and are drawn from a numpy
``default_rng`` keyed by ``(seed, step, host_index, host_count)``, so the
port's batches are the reference's, byte for byte.  The train step moves
each batch onto its device."""
from __future__ import annotations

import numpy as np

from .synthetic import generate_text
from .tokenizer import ByteTokenizer


def make_corpus_tokens(vocab: int, n_sentences: int = 20000,
                       seed: int = 0) -> np.ndarray:
    return ByteTokenizer(vocab).encode(generate_text(n_sentences, seed))


class LMBatchLoader:
    """Infinite iterator of next-token-prediction batches.

    Supports deterministic resume (state = step counter) and host sharding
    (host i of n draws disjoint strided windows) — the loader side of elastic
    restart: any (step, host_count) pair maps to the same global sample set.
    """

    def __init__(self, tokens: np.ndarray, batch: int, seq_len: int,
                 host_index: int = 0, host_count: int = 1, seed: int = 17):
        self.tokens = np.asarray(tokens, dtype=np.int32)
        self.batch = batch
        self.seq = seq_len
        self.host_index = host_index
        self.host_count = host_count
        self.seed = seed
        self.step = 0
        if len(self.tokens) < seq_len + 2:
            raise ValueError("corpus too small for seq_len")

    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, st: dict) -> None:
        self.step = int(st["step"])

    def next_batch(self) -> np.ndarray:
        rng = np.random.default_rng(
            (self.seed, self.step, self.host_index, self.host_count))
        hi = len(self.tokens) - self.seq - 1
        starts = rng.integers(0, hi, size=self.batch)
        out = np.stack([self.tokens[s: s + self.seq + 1] for s in starts])
        self.step += 1
        return out

    def eval_batches(self, n: int, batch: int | None = None):
        """Deterministic held-out-style windows for perplexity eval."""
        batch = batch or self.batch
        rng = np.random.default_rng((self.seed, 10 ** 9))
        hi = len(self.tokens) - self.seq - 1
        for _ in range(n):
            starts = rng.integers(0, hi, size=batch)
            yield np.stack([self.tokens[s: s + self.seq + 1] for s in starts])

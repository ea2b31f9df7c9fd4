"""Byte-level tokenizer (vocab 256 + special ids folded by modulo for smaller
model vocabs). No external vocab files — fully offline.

A copy of ``repro/data/tokenizer.py``: the port imports nothing of the
reference package."""
from __future__ import annotations

import numpy as np


class ByteTokenizer:
    def __init__(self, vocab: int = 256):
        self.vocab = vocab

    def encode(self, text: str) -> np.ndarray:
        toks = np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int32)
        if self.vocab < 256:
            toks = toks % self.vocab
        return toks

    def decode(self, toks) -> str:
        return bytes(int(t) % 256 for t in toks).decode("utf-8", errors="replace")

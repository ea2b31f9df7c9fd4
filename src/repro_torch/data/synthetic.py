"""Deterministic synthetic corpus: a seeded template-grammar text generator.

A copy of ``repro/data/synthetic.py`` (the port imports nothing of the
reference package): the same seed gives the same text, byte for byte.

Produces structured English-like text with learnable statistics (fixed word
inventory, grammar templates, punctuation, rare-token tail) so that a small
LM trained for a few hundred steps develops real next-token structure — which
is what the quantization quality benchmarks need to measure perplexity deltas
against.  Fully offline and reproducible.
"""
from __future__ import annotations

import numpy as np

_SUBJECTS = ("the fox", "a raven", "the quiet stream", "an old engineer",
             "the compiler", "a careful reader", "the tensor", "the machine",
             "a curious child", "the gardener", "the signal", "an open door")
_VERBS = ("leaped over", "watched", "compiled", "measured", "followed",
          "rewrote", "balanced", "sharded", "quantized", "traced",
          "remembered", "repaired")
_OBJECTS = ("the golden light", "a distant hill", "the long array",
            "its own reflection", "the morning fog", "a stack of pages",
            "the second stream", "a row of numbers", "the floating point",
            "the silent yard", "an even lattice", "the narrow bridge")
_ADVERBS = ("slowly", "twice", "without error", "in the afternoon",
            "with great care", "again", "almost silently", "by hand")


def generate_text(n_sentences: int, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_sentences):
        s = rng.choice(_SUBJECTS)
        v = rng.choice(_VERBS)
        o = rng.choice(_OBJECTS)
        parts = [s, v, o]
        if rng.random() < 0.5:
            parts.append(rng.choice(_ADVERBS))
        sent = " ".join(parts) + ". "
        if rng.random() < 0.1:
            sent = sent.capitalize()
        out.append(sent)
    return "".join(out)

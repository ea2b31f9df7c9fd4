"""Plain PyTorch version of the RaBitQ code-search kernel (port of
``repro/kernels/rabitq_quant/ref.py``): ``core/rabitq.quantize``."""
from __future__ import annotations

import torch

from repro_torch.core import rabitq


def quantize_ref(w: torch.Tensor, bits: int, n_candidates: int = 12):
    q = rabitq.quantize(w, bits, n_candidates=n_candidates)
    return q.codes, q.rescale

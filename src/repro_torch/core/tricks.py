"""Pre-quantization tricks (paper App. C.3), port of ``repro/core/tricks.py``.

  * Centralization — subtract the mean column s from every column of W
    before quantizing; the exact correction (X s) 1^T is a matvec at
    inference.
  * Column-outlier excluding — the top ``outlier_frac`` input dimensions by
    calibrated activation column norm bypass quantization: their weight rows
    are stored in fp16 and applied exactly.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Centralized", "centralize", "split_outlier_dims", "outlier_indices"]


class Centralized(NamedTuple):
    w_centered: torch.Tensor  # (d, c)
    mean_col: torch.Tensor    # (d,) the exact mean column s


def centralize(w: torch.Tensor) -> Centralized:
    s = torch.mean(w, dim=1)
    return Centralized(w - s[:, None], s)


def outlier_indices(col_norms: np.ndarray, frac: float
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(outlier_idx, keep_idx) — top ``frac`` of input dims by activation norm.

    Host-side numpy, exactly as the reference: the split is static metadata
    baked into the quantized layer, indices sorted ascending.
    """
    d = int(col_norms.shape[0])
    k = int(np.ceil(frac * d)) if frac > 0 else 0
    if k == 0:
        return np.zeros((0,), np.int32), np.arange(d, dtype=np.int32)
    out = np.argsort(col_norms)[::-1][:k]
    out = np.sort(out).astype(np.int32)
    keep = np.setdiff1d(np.arange(d, dtype=np.int32), out, assume_unique=True)
    return out, keep


def split_outlier_dims(w: torch.Tensor, out_idx: torch.Tensor,
                       keep_idx: torch.Tensor):
    """Split weight rows into (W_outlier (k, c) fp, W_rest (d', c))."""
    return w[out_idx, :], w[keep_idx, :]

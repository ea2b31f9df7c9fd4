"""Plain PyTorch version of the RHT kernel (port of
``repro/kernels/hadamard/ref.py``): ``core/hadamard``'s Kronecker-matmul
transform, which the CUDA kernel's butterfly must match."""
from __future__ import annotations

import torch

from repro_torch.core import hadamard as hcore


def practical_rht_ref(x: torch.Tensor, signs1: torch.Tensor,
                      signs2: torch.Tensor | None) -> torch.Tensor:
    """Alg. 5 over the last axis: the first d_hat coordinates with signs1,
    then the last d_hat (overlap transformed twice) with signs2."""
    return hcore.practical_rht(x, signs1, signs2, axis=-1)

"""Plain PyTorch version of the flash-attention kernel (port of
``repro/kernels/flash_attention/ref.py``): the port's sequence-mode
attention, ``models/attention.flash_attention``, as the reference's oracle is
its jnp scan."""
from __future__ import annotations

import torch

from repro_torch.models.attention import flash_attention


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: int | None = None) -> torch.Tensor:
    return flash_attention(q, k, v, causal=causal, window=window)

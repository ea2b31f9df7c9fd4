"""PyTorch/CUDA port of the RaanA system (``src/repro`` is the JAX reference).

The layout mirrors the reference package file for file, so
``repro_torch/core/qlinear.py`` is held against ``repro/core/qlinear.py``.
Plain tensor code is PyTorch; every Pallas kernel on the ported path is a
hand-written CUDA kernel under ``csrc/`` with a plain PyTorch twin beside its
wrapper.  This package never imports ``jax`` or anything of ``repro``.

Entry points (``PagedServer``, ``init_params``, ``quantize_linear``) run on
``cuda`` unless the caller passes ``device="cpu"``; with no card and no
explicit CPU they raise instead of quietly running on the host.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU only
    when asked for by name.  Raises when CUDA is wanted but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on a CUDA device by default and "
            "none is available; pass device='cpu' to run the plain versions "
            "on the host")
    if dev.type == "cuda" and dev.index is None:
        # tensors report an indexed device; compare like with like
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

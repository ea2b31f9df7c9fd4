"""Feed-forward blocks: fused-gate SwiGLU/GeGLU and plain GELU.

Port of ``repro/models/ffn.py``, with the calibration ctx threaded through
under the reference's tap names (``{name}.wi``, ``{name}.wo``).

Under tensor-parallel serving (``runtime/tp.py``) ``wi`` arrives sliced by
column (gate|up interleaved per rank, so the local split is right) while
``wo`` stays replicated; ``gather_cols`` reassembles the full hidden width
before the down-projection and is a shape-driven no-op at TP=1.  Under
model-parallel training (``row_parallel``) ``wo`` is sliced by input row
too: the local hidden columns meet their own rows, and the partial sums
are all-reduced (``reduce_from_model``; ``copy_to_model`` sums the input's
gradient).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.runtime.tp import (copy_to_model, gather_cols, in_dim,
                                    reduce_from_model)

from .common import LinearCtx, linear


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default form


def glu_ffn(p: dict, x: torch.Tensor, act: str = "silu",
            ctx: LinearCtx | None = None, name: str = "mlp",
            row_parallel: bool = False) -> torch.Tensor:
    """wi (d, 2f) fuses gate|up; wo (f, d)."""
    if row_parallel:
        x = copy_to_model(x)
    gu = linear(p["wi"], x, ctx, f"{name}.wi")
    gate, up = torch.chunk(gu, 2, dim=-1)
    g = F.silu(gate) if act == "silu" else _gelu(gate)
    h = gather_cols(g * up, in_dim(p["wo"]))
    y = linear(p["wo"], h, ctx, f"{name}.wo")
    return reduce_from_model(y) if row_parallel else y


def gelu_ffn(p: dict, x: torch.Tensor, ctx: LinearCtx | None = None,
             name: str = "mlp", row_parallel: bool = False) -> torch.Tensor:
    """Plain 2-matrix GELU MLP."""
    if row_parallel:
        x = copy_to_model(x)
    h = _gelu(linear(p["wi"], x, ctx, f"{name}.wi"))
    h = gather_cols(h, in_dim(p["wo"]))
    y = linear(p["wo"], h, ctx, f"{name}.wo")
    return reduce_from_model(y) if row_parallel else y

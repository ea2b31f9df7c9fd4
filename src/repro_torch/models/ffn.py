"""Feed-forward blocks: fused-gate SwiGLU/GeGLU and plain GELU.

Port of ``repro/models/ffn.py``, with the calibration ctx threaded through
under the reference's tap names (``{name}.wi``, ``{name}.wo``).

Under tensor-parallel serving (``runtime/tp.py``) ``wi`` arrives sliced by
column (gate|up interleaved per rank, so the local split is right) while
``wo`` stays replicated; ``gather_cols`` reassembles the full hidden width
before the down-projection and is a shape-driven no-op at TP=1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.runtime.tp import gather_cols, in_dim

from .common import LinearCtx, linear


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default form


def glu_ffn(p: dict, x: torch.Tensor, act: str = "silu",
            ctx: LinearCtx | None = None, name: str = "mlp") -> torch.Tensor:
    """wi (d, 2f) fuses gate|up; wo (f, d)."""
    gu = linear(p["wi"], x, ctx, f"{name}.wi")
    gate, up = torch.chunk(gu, 2, dim=-1)
    g = F.silu(gate) if act == "silu" else _gelu(gate)
    h = gather_cols(g * up, in_dim(p["wo"]))
    return linear(p["wo"], h, ctx, f"{name}.wo")


def gelu_ffn(p: dict, x: torch.Tensor, ctx: LinearCtx | None = None,
             name: str = "mlp") -> torch.Tensor:
    """Plain 2-matrix GELU MLP."""
    h = _gelu(linear(p["wi"], x, ctx, f"{name}.wi"))
    h = gather_cols(h, in_dim(p["wo"]))
    return linear(p["wo"], h, ctx, f"{name}.wo")

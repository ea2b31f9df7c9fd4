"""Feed-forward blocks: fused-gate SwiGLU/GeGLU and plain GELU.

Port of ``repro/models/ffn.py``, with the calibration ctx threaded through
under the reference's tap names (``{name}.wi``, ``{name}.wo``).  The
tensor-parallel column gathers of the reference are identities at TP = 1
and come with the TP slice (ROADMAP).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import LinearCtx, linear


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default form


def glu_ffn(p: dict, x: torch.Tensor, act: str = "silu",
            ctx: LinearCtx | None = None, name: str = "mlp") -> torch.Tensor:
    """wi (d, 2f) fuses gate|up; wo (f, d)."""
    gu = linear(p["wi"], x, ctx, f"{name}.wi")
    gate, up = torch.chunk(gu, 2, dim=-1)
    g = F.silu(gate) if act == "silu" else _gelu(gate)
    return linear(p["wo"], g * up, ctx, f"{name}.wo")


def gelu_ffn(p: dict, x: torch.Tensor, ctx: LinearCtx | None = None,
             name: str = "mlp") -> torch.Tensor:
    """Plain 2-matrix GELU MLP."""
    h = _gelu(linear(p["wi"], x, ctx, f"{name}.wi"))
    return linear(p["wo"], h, ctx, f"{name}.wo")

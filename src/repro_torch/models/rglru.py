"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427),
port of ``repro/models/rglru.py``.

Block = (gate branch: GeLU(W_g x)) * (recurrence branch: RG-LRU(conv1d(W_x
x))) -> W_o.  The RG-LRU is a gated diagonal linear recurrence

    r_t = sigmoid(BD_a xc_t);  i_t = sigmoid(BD_x xc_t)
    a_t = exp(c * r_t * log sigmoid(Lambda))          (per channel, in (0,1))
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * xc_t)

over a sequence by a parallel prefix scan, and as one step at decode.  Gate
projections are block-diagonal with one block per head.

The reference's scan is ``jax.lax.associative_scan``; ``associative_scan``
here is the same recursive odd/even algorithm written out in torch (it
pairs the same elements in the same order), so the prefix is combined in
the reference's order and a sequence of S costs O(log S) elementwise
launches rather than S.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import LinearCtx, linear
from .ffn import _gelu

RGLRU_C = 8.0
CONV_WIDTH = 4


@dataclasses.dataclass
class RGLRUState:
    h: torch.Tensor     # (B, dr) recurrent state
    conv: torch.Tensor  # (B, CONV_WIDTH-1, dr) trailing conv inputs

    @staticmethod
    def init(b: int, dr: int, dtype=torch.float32,
             device=None) -> "RGLRUState":
        return RGLRUState(
            h=torch.zeros((b, dr), dtype=torch.float32, device=device),
            conv=torch.zeros((b, CONV_WIDTH - 1, dr), dtype=dtype,
                             device=device))


def _block_diag(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (..., dr) @ block-diagonal w (nb, dr/nb, dr/nb) -> (..., dr)."""
    nb, bs, _ = w.shape
    xb = x.reshape(*x.shape[:-1], nb, bs)
    yb = torch.einsum("...nb,nbc->...nc", xb, w.to(x.dtype))
    return yb.reshape(x.shape)


def _gates(p: dict, xc: torch.Tensor):
    r = torch.sigmoid(_block_diag(p["wa"], xc) + p["ba"])
    i = torch.sigmoid(_block_diag(p["wx"], xc) + p["bx"])
    log_a = (RGLRU_C * r.to(torch.float32)
             * F.logsigmoid(p["lambda"].to(torch.float32)))
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i.to(torch.float32) * xc.to(torch.float32))
    return a, gated_in


def _conv1d_seq(p: dict, h: torch.Tensor,
                hist: torch.Tensor | None = None) -> torch.Tensor:
    """Causal per-channel conv, width CONV_WIDTH, over (B, S, dr).

    ``hist`` (B, CONV_WIDTH-1, dr): trailing inputs from a previous chunk
    (mid-sequence continuation); zeros when absent."""
    w = p["conv_w"].to(h.dtype)                               # (W, dr)
    if hist is None:
        acc = h * w[-1]
        for i in range(1, CONV_WIDTH):
            acc = acc + F.pad(h, (0, 0, i, 0))[:, :-i] * w[-1 - i]
        return acc + p["conv_b"].to(h.dtype)
    s = h.shape[1]
    full = torch.cat([hist.to(h.dtype), h], dim=1)            # (B, W-1+S, dr)
    acc = h * w[-1]
    for i in range(1, CONV_WIDTH):
        acc = acc + full[:, CONV_WIDTH - 1 - i: CONV_WIDTH - 1 - i + s] * w[
            -1 - i]
    return acc + p["conv_b"].to(h.dtype)


def _combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along axis 1: even[0], odd[0], even[1], ... (len(even) - len(odd) in
    {0, 1})."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n, *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(elems: tuple) -> tuple:
    """Inclusive scan of ``_combine`` over axis 1, by
    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs, scan
    those recursively, then fill in the even positions."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine(tuple(e[:, 0:-1:2] for e in elems),
                       tuple(e[:, 1::2] for e in elems))
    odd = associative_scan(reduced)
    if n % 2 == 0:
        even = _combine(tuple(e[:, :-1] for e in odd),
                        tuple(e[:, 2::2] for e in elems))
    else:
        even = _combine(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], dim=1)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def conv_tail(hx: torch.Tensor) -> torch.Tensor:
    """Last CONV_WIDTH-1 conv inputs (left-padded for short sequences)."""
    b, s, dr = hx.shape
    need = CONV_WIDTH - 1
    if s >= need:
        return hx[:, s - need:]
    return torch.cat([hx.new_zeros((b, need - s, dr)), hx], dim=1)


def rglru_block(p: dict, x: torch.Tensor, ctx: LinearCtx | None = None,
                name: str = "rglru", return_state: bool = False,
                state: RGLRUState | None = None):
    """Sequence mode: x (B, S, d) -> (B, S, d) [, RGLRUState].

    ``state`` resumes mid-sequence (chunked prefill): the recurrence starts
    from ``state.h`` and the causal conv sees ``state.conv`` history."""
    g = _gelu(linear(p["wg"], x, ctx, f"{name}.wg"))
    hx = linear(p["wi"], x, ctx, f"{name}.wi")
    xc = _conv1d_seq(p, hx, None if state is None else state.conv)
    a, b = _gates(p, xc)
    a_cum, h = associative_scan((a, b))
    if state is not None:
        h = h + a_cum * state.h.to(h.dtype)[:, None]
    out = (g.to(torch.float32) * h).to(x.dtype)
    y = linear(p["wo"], out, ctx, f"{name}.wo")
    if return_state:
        if state is None:
            w = conv_tail(hx)
        else:
            w = torch.cat([state.conv.to(hx.dtype), hx],
                          dim=1)[:, -(CONV_WIDTH - 1):]
        return y, RGLRUState(h=h[:, -1], conv=w)
    return y


def rglru_decode(p: dict, x: torch.Tensor, state: RGLRUState,
                 ctx: LinearCtx | None = None, name: str = "rglru"):
    """One step: x (B, d) -> (out (B, d), new RGLRUState)."""
    g = _gelu(linear(p["wg"], x, ctx, f"{name}.wg"))
    hx = linear(p["wi"], x, ctx, f"{name}.wi")                # (B, dr)
    w = p["conv_w"].to(hx.dtype)
    hist = torch.cat([state.conv, hx[:, None, :]], dim=1)     # (B, W, dr)
    xc = torch.einsum("bwd,wd->bd", hist, w) + p["conv_b"].to(hx.dtype)
    a, b = _gates(p, xc)
    h_new = a * state.h + b
    out = (g.to(torch.float32) * h_new).to(x.dtype)
    out = linear(p["wo"], out, ctx, f"{name}.wo")
    return out, RGLRUState(h=h_new, conv=hist[:, 1:])

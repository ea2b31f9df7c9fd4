"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``repro/models/moe.py``).

Dispatch: sort the token -> expert assignments by expert id (stably), rank
each token within its expert, scatter into an (E, C, d) buffer, run the
grouped expert GEMMs, and combine with the routing weights.  Tokens past
capacity are dropped; an aux load-balance loss is returned for the loss
(calibration differentiates through it).

Where a loose port would diverge from the reference:

  * top-k ties: ``jax.lax.top_k`` returns the lower expert index first among
    equal probabilities, ``torch.topk`` promises no order.  An inactive
    decode slot's hidden state is exactly 0, so its 8 router probabilities
    are exactly equal, and which experts it picks decides which active
    tokens the capacity drops.  A stable descending sort picks as the
    reference does.
  * the capacity is a Python float expression, as in the reference;
  * the combine adds ``top_k`` contributions per token onto 0; at top-2
    (Mixtral) that is 0 + a + b, and a + b == b + a in IEEE arithmetic, so
    ``index_add`` is independent of the order it applies them in.

The tensor-parallel column gather of the reference is an identity at TP = 1
and comes with the TP slice (ROADMAP).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.qlinear import QuantizedGrouped

from .common import LinearCtx
from .ffn import _gelu


def _expert_matmul(w, xbuf: torch.Tensor, ctx: LinearCtx | None = None,
                   name: str | None = None) -> torch.Tensor:
    """Grouped GEMM (E,C,d) x (E,d,f) with ``QuantizedGrouped`` dispatch and
    the same calibration taps and perturbations as ``common.linear``."""
    if isinstance(w, QuantizedGrouped):
        return w.apply(xbuf).to(xbuf.dtype)
    y = torch.einsum("ecd,edf->ecf", xbuf, w.to(xbuf.dtype))
    if ctx is not None and name is not None:
        if ctx.collect:
            with torch.no_grad():
                xf = xbuf.detach().to(torch.float32)
                sq = xf * xf
                ctx.taps[name] = dict(
                    x_fro_sq=torch.sum(sq),
                    x_col_sq=torch.sum(sq, dim=(0, 1)),
                    w_fro=torch.linalg.norm(w.to(torch.float32)),
                    n_rows=float(xbuf.shape[0] * xbuf.shape[1]),
                    d=int(w.shape[1]), c=int(w.shape[2]),
                    h_shape=tuple(y.shape), grouped=True,
                    n_groups=int(w.shape[0]))
            if ctx.perturb is not None and name not in ctx.perturb:
                ctx.perturb[name] = torch.zeros(
                    y.shape, dtype=torch.float32, device=y.device,
                    requires_grad=True)
        if ctx.perturb is not None and name in ctx.perturb:
            y = y + ctx.perturb[name].to(y.dtype)
    return y


def top_k_lowest_index(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries per row, the lower index
    first among equal values — ``jax.lax.top_k``'s order."""
    ids = torch.argsort(probs, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(probs, -1, ids), ids


def moe_ffn(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, act: str = "silu",
            ctx: LinearCtx | None = None, name: str = "moe"):
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar).

    Params: router (d, E) fp32; wi (E, d, 2f); wo (E, f, d).  The
    reference's shared experts (DeepSeek-V2's swi/swo) come with MLA."""
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)
    logits = xf.to(torch.float32) @ p["router"].to(torch.float32)    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k_lowest_index(probs, top_k)         # (T, K)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    # --- load-balance aux loss (Switch-style) ---
    me = torch.mean(probs, dim=0)                                    # (E,)
    ce = torch.zeros((n_experts,), dtype=torch.float32, device=dev)
    ce = ce.index_add(0, expert_ids.reshape(-1), torch.full(
        (t * top_k,), 1.0 / (t * top_k), dtype=torch.float32, device=dev))
    aux = n_experts * torch.sum(me * ce)

    # --- sort-based dispatch ---
    capacity = int(max(top_k, capacity_factor * t * top_k / n_experts))
    flat_expert = expert_ids.reshape(-1)                             # (T*K,)
    flat_token = torch.arange(t * top_k, device=dev) // top_k
    flat_gate = gate_vals.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    e_sorted = flat_expert[order]
    t_sorted = flat_token[order]
    g_sorted = flat_gate[order]
    # rank within expert = index - start offset of that expert's run
    # (counted with index_add: bincount on CUDA reads its max on the host)
    counts = torch.zeros((n_experts,), dtype=e_sorted.dtype,
                         device=dev).index_add(0, e_sorted,
                                               torch.ones_like(e_sorted))
    starts = torch.cumsum(counts, 0) - counts                        # (E,)
    rank = torch.arange(t * top_k, device=dev) - starts[e_sorted]
    keep = rank < capacity
    slot = torch.where(keep, rank, torch.full_like(rank, capacity))  # overflow row
    rows = torch.where(keep[:, None], xf[t_sorted], torch.zeros_like(xf[t_sorted]))
    xbuf = torch.zeros((n_experts, capacity + 1, d), dtype=xf.dtype,
                       device=dev).index_put((e_sorted, slot), rows,
                                             accumulate=True)
    xbuf = xbuf[:, :capacity]                                        # (E, C, d)

    # --- grouped expert GEMMs ---
    gu = _expert_matmul(p["wi"], xbuf, ctx, f"{name}.wi")
    gate_h, up = torch.chunk(gu, 2, dim=-1)
    h = (F.silu(gate_h) if act == "silu" else _gelu(gate_h)) * up
    ybuf = _expert_matmul(p["wo"], h, ctx, f"{name}.wo")             # (E, C, d)

    # --- combine (order-independent at top-2, see the module note) ---
    gathered = ybuf[e_sorted, torch.clamp(slot, max=capacity - 1)]   # (T*K, d)
    contrib = gathered * g_sorted[:, None].to(gathered.dtype)
    contrib = torch.where(keep[:, None], contrib, torch.zeros_like(contrib))
    y = torch.zeros((t, d), dtype=xf.dtype, device=dev).index_add(
        0, t_sorted, contrib.to(xf.dtype))
    return y.reshape(b, s, d), aux

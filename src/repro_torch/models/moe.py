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
  * the combine adds ``top_k`` contributions per token onto 0, in the
    order the reference's scatter-add applies them (the dispatch order:
    ascending expert id), one add per k.  A scatter with atomics on the
    card would sum DeepSeek-V2's six in an order that changes from run to
    run, and a graph replay and an eager run of one step could then
    differ in the last bit.

Under tensor-parallel serving (``runtime/tp.py``) the expert ``wi`` and
the shared experts' ``swi`` arrive sliced by column and ``wo`` / ``swo``
replicated; ``gather_cols`` reassembles the full hidden width before each
down-projection, a no-op at TP = 1, as in the reference.

Under model-parallel training (``runtime/steps.make_train_step(mesh=)``)
a data rank routes its share of the microbatch, and the microbatch is
the data ranks' rows in rank order.  So one all-gather of each rank's
(E,) expert counts over the data group gives every rank what one device
computes over the whole microbatch: the capacity (from the whole
microbatch's token count), each assignment's rank within its expert
(the expert's count on the earlier data ranks plus its rank here, so the
same assignments drop), and the aux loss's ``ce``.  Each rank adds E ·
Σ me_local · ce_global, ``ce`` carrying no gradient as in the reference;
the mean over dp that the ZeRO gathers' backward takes then gives the
whole microbatch's aux and its gradient, with no collective on the
autograd path.  The rank's buffer holds min(capacity, T_local · K) rows
an expert, sized from shapes alone.

Over the model axis every rank of a model group holds the same rows.
With expert parallelism (``wi`` / ``wo`` sliced on their expert axis,
E / tp experts a rank) each rank dispatches its rows to its own experts
only, and one ``reduce_from_model`` sums the ranks' partial combines; no
all-to-all is needed in this layout, since no rank holds rows another
needs.  The intra-expert fallback (``wi`` by glu-permuted column, ``wo``
by row) dispatches to every expert and sums the same way; the shared
experts (``swi`` by column, ``swo`` by row) add their partial sum before
that one all-reduce.  The router stays whole: ``copy_to_model`` goes on
the normalised gates and on the dispatched rows only, so the gates'
and the rows' partial gradients are summed over the ranks while the aux
loss, whole on every rank, reaches the router once.

``count_overflow(counter)`` is a measuring aid with no counterpart in the
reference: every ``moe_ffn`` call run (or captured) inside it adds the
token-expert assignments its capacity dropped to ``counter`` in place, so
a captured step keeps adding on each replay.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from repro_torch.core.qlinear import QuantizedGrouped
from repro_torch.runtime import tp as tpmod
from repro_torch.runtime.tp import gather_cols, in_dim

from .common import LinearCtx, linear
from .ffn import _gelu


_OVERFLOW: contextvars.ContextVar[torch.Tensor | None] = (
    contextvars.ContextVar("repro_torch_moe_overflow", default=None))


@contextlib.contextmanager
def count_overflow(counter: torch.Tensor):
    """Scoped: ``moe_ffn`` adds its dropped assignments to ``counter`` (a
    0-d int64 tensor on the device of the tokens)."""
    token = _OVERFLOW.set(counter)
    try:
        yield
    finally:
        _OVERFLOW.reset(token)


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
            ctx: LinearCtx | None = None, name: str = "moe",
            experts_sliced: bool = False, shared_sliced: bool = False):
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar).

    Params: router (d, E) fp32; wi (E, d, 2f); wo (E, f, d); optional
    shared experts (DeepSeek-V2): swi (d, 2fs), swo (fs, d).

    ``experts_sliced`` / ``shared_sliced``: a model-parallel training
    rank's routed / shared experts are its slice (see the module note)."""
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)
    logits = xf.to(torch.float32) @ p["router"].to(torch.float32)    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k_lowest_index(probs, top_k)         # (T, K)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    data = tpmod.current_data_group()
    dp = 1 if data is None else data.size
    if experts_sliced:
        gate_vals = tpmod.copy_to_model(gate_vals)

    # --- sort-based dispatch ---
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

    # --- load-balance aux loss (Switch-style) and the capacity ---
    me = torch.mean(probs, dim=0)                                    # (E,)
    if dp == 1:
        ce = torch.zeros((n_experts,), dtype=torch.float32, device=dev)
        ce = ce.index_add(0, expert_ids.reshape(-1), torch.full(
            (t * top_k,), 1.0 / (t * top_k), dtype=torch.float32,
            device=dev))
        capacity = int(max(top_k, capacity_factor * t * top_k / n_experts))
        rows_per_expert = capacity
        grank = rank
    else:
        # the microbatch is the data ranks' rows in rank order: a token's
        # rank within its expert over the whole of it is its expert's
        # count on the earlier ranks plus its rank here
        every = tpmod.all_gather_flat(counts, data).view(dp, n_experts)
        ce = every.sum(0).to(torch.float32) / (dp * t * top_k)
        capacity = int(max(top_k,
                           capacity_factor * dp * t * top_k / n_experts))
        rows_per_expert = min(capacity, t * top_k)
        grank = rank + every[:data.rank].sum(0)[e_sorted]
    aux = n_experts * torch.sum(me * ce)
    keep = grank < capacity
    sink = _OVERFLOW.get()
    if sink is not None:
        sink.add_(torch.sum(~keep))
    # the rank's experts: all of them, or under expert parallelism its
    # model coordinate's E / tp
    e_loc = p["wi"].shape[0]
    e_idx = e_sorted
    if e_loc < n_experts:
        e_idx = e_sorted - tpmod.current_group().rank * e_loc
        keep = keep & (e_idx >= 0) & (e_idx < e_loc)
        e_idx = torch.clamp(e_idx, 0, e_loc - 1)
    slot = torch.where(keep, rank,
                       torch.full_like(rank, rows_per_expert))   # overflow row
    xd = tpmod.copy_to_model(xf) if experts_sliced else xf
    rows = torch.where(keep[:, None], xd[t_sorted],
                       torch.zeros_like(xd[t_sorted]))
    xbuf = torch.zeros((e_loc, rows_per_expert + 1, d), dtype=xf.dtype,
                       device=dev).index_put((e_idx, slot), rows,
                                             accumulate=True)
    xbuf = xbuf[:, :rows_per_expert]                             # (E, C, d)

    # --- grouped expert GEMMs ---
    gu = _expert_matmul(p["wi"], xbuf, ctx, f"{name}.wi")
    gate_h, up = torch.chunk(gu, 2, dim=-1)
    h = (F.silu(gate_h) if act == "silu" else _gelu(gate_h)) * up
    h = gather_cols(h, p["wo"].shape[1])                             # TP
    ybuf = _expert_matmul(p["wo"], h, ctx, f"{name}.wo")             # (E, C, d)

    # --- combine, in dispatch order per token (see the module note) ---
    gathered = ybuf[e_idx, torch.clamp(slot, max=rows_per_expert - 1)]
    contrib = gathered * g_sorted[:, None].to(gathered.dtype)        # (T*K, d)
    contrib = torch.where(keep[:, None], contrib, torch.zeros_like(contrib))
    # back to (T, K), each token's entries by ascending expert id
    by_token = torch.empty_like(contrib).index_copy_(0, order, contrib)
    kord = torch.argsort(expert_ids, dim=-1, stable=True)            # (T, K)
    by_token = torch.gather(by_token.reshape(t, top_k, d), 1,
                            kord[..., None].expand(t, top_k, d))
    y = torch.zeros((t, d), dtype=xf.dtype, device=dev)
    for k in range(top_k):
        y = y + by_token[:, k].to(xf.dtype)

    # --- shared experts (DeepSeek-V2) ---
    partial = experts_sliced          # y holds this rank's share of a sum
    if "swi" in p:
        xs = xf
        if shared_sliced:
            xs = xd if experts_sliced else tpmod.copy_to_model(xf)
        gu_s = linear(p["swi"], xs, ctx, f"{name}.swi")
        gsh, ush = torch.chunk(gu_s, 2, dim=-1)
        hs = (F.silu(gsh) if act == "silu" else _gelu(gsh)) * ush
        hs = gather_cols(hs, in_dim(p["swo"]))
        ys = linear(p["swo"], hs, ctx, f"{name}.swo")
        if partial != shared_sliced:     # one partial sum: reduce it alone
            if partial:
                y = tpmod.reduce_from_model(y)
            else:
                ys = tpmod.reduce_from_model(ys)
            partial = False
        y = y + ys
    if partial:
        y = tpmod.reduce_from_model(y)
    return y.reshape(b, s, d), aux

"""Attention: sequence-mode GQA for calibration and the paged-cache helpers
(port of ``repro/models/attention.py:23-101, 145-266``).

``flash_attention`` is the reference's jnp scan as plain torch: an einsum,
a masked softmax in f32, autograd through it (calibration differentiates
the loss through every layer).  It is not SDPA, so the flash-attention
kernel's later port has a plain counterpart.

The serving engine stores K/V in a fixed arena of (num_blocks, block_size,
KV, hd) blocks shared by all requests; each request owns a row of a block
table mapping logical block -> physical block.  A request at absolute
position p writes logical slot p % ring_cap.  Physical block 0 is the null
block: unallocated table entries and writes from inactive slots land there
and are never read as valid.

Chunked-prefill attention is plain jnp in the reference, so it is plain
torch here; the decode read and the speculative verify / catch-up read go
through the paged flash-decode kernel.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd), H = KV*G -> (B,Sq,H,hd); queries at
    positions 0..Sq-1.  ``window``: attend to the last ``window`` keys."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.to(torch.float32).reshape(b, sq, kv, g, hd) * hd ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(torch.float32))
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def paged_gather_kv(arena: torch.Tensor, block_table: torch.Tensor
                    ) -> torch.Tensor:
    """arena (N, bs, ...), block_table (B, MB) int32 -> (B, MB*bs, ...)."""
    g = arena[block_table.to(torch.int64)]       # (B, MB, bs, ...)
    b, mb, bs = g.shape[:3]
    return g.reshape(b, mb * bs, *arena.shape[2:])


def paged_slot_positions(pos: torch.Tensor, ring_cap: torch.Tensor,
                         length: int) -> torch.Tensor:
    """Absolute position stored in each logical slot, -1 if never written.

    ``pos`` (B,): tokens inserted so far; ``ring_cap`` (B,): per-request
    ring capacity; slot s holds the largest p <= pos-1 with p % cap == s.
    Tensor ``%`` is a floor-mod, as jnp's is.
    """
    idx = torch.arange(length, dtype=torch.int64, device=pos.device)[None, :]
    last = (pos.to(torch.int64) - 1)[:, None]
    c = ring_cap.to(torch.int64)[:, None]
    stored = last - (last - idx) % c
    return torch.where((idx < c) & (stored >= 0), stored,
                       torch.full_like(stored, -1))


def paged_write_indices(pos: torch.Tensor, ring_cap, block_table: torch.Tensor,
                        block_size: int, active: torch.Tensor | None = None):
    """(physical block, in-block offset) for writing position ``pos``.

    pos/ring_cap (B,) with block_table (B, MB), or a span of positions with
    one request's (MB,) row.  Inactive slots are redirected to the null
    block 0 so one scatter serves the whole batch."""
    li = (pos.to(torch.int64) % ring_cap)
    off = li % block_size
    bt = block_table.to(torch.int64)
    if bt.ndim == 1:                                # one request's row
        pb = bt[li // block_size]
    else:
        rows = torch.arange(bt.shape[0], device=bt.device)
        pb = bt[rows, li // block_size]
    if active is not None:
        pb = torch.where(active, pb, torch.zeros_like(pb))
        off = torch.where(active, off, torch.zeros_like(off))
    return pb, off


def paged_multi_write_indices(positions: torch.Tensor, ring_cap: torch.Tensor,
                              block_tables: torch.Tensor, block_size: int,
                              write_mask: torch.Tensor | None = None,
                              active: torch.Tensor | None = None):
    """(physical block, in-block offset) for writing a span of positions:
    ``positions`` (B, W) absolute, ``ring_cap`` (B,), ``block_tables``
    (B, MB).  Positions whose ``write_mask`` (B, W) entry is False go to
    the null block 0, so one fixed-shape scatter serves every slot: an
    inactive slot's (``active`` (B,) False) to offset 0, an active slot's
    (a catch-up position whose K/V is already valid) to the last offset.

    The reference sends both to offset 0 (``repro/models/attention.py:
    191-211``).  An inactive slot's ring holds one token, so its attention
    reads offset 0 back; when it alone writes there, it reads its own K/V
    (zeros: its hidden state is 0), as in a decode step, whatever a chunk
    graph's warm-up left there.  A masked catch-up position carries real
    K/V, and among several writers of one element the winner is
    unspecified on the card; read by an inactive slot, it made the slot's
    hidden state, and through the MoE capacity its slot takes, Mixtral's
    speculating tokens change from run to run.  Nobody reads the last
    offset (``block_size`` >= 2)."""
    li = positions.to(torch.int64) % ring_cap.to(torch.int64)[:, None]
    off = li % block_size
    pb = torch.gather(block_tables.to(torch.int64), 1, li // block_size)
    if write_mask is not None:
        sink = torch.full_like(off, block_size - 1)
        if active is not None:
            sink = torch.where(active[:, None], sink, torch.zeros_like(sink))
        pb = torch.where(write_mask, pb, torch.zeros_like(pb))
        off = torch.where(write_mask, off, sink)
    return pb, off


def paged_decode_attention(q: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, block_table: torch.Tensor,
                           pos: torch.Tensor, ring_cap: torch.Tensor, *,
                           window: int | None = None) -> torch.Tensor:
    """One-token attention over the paged arena: q (B,1,H,hd); pos (B,) =
    tokens inserted including the current one (already in the arena).
    Dispatches through ``kernels.paged_attention.ops``."""
    from repro_torch.kernels.paged_attention import ops as pops  # no cycle
    return pops.paged_attention(q, k_arena, v_arena, block_table, pos,
                                ring_cap, window=window)


def paged_prefill_attention(q: torch.Tensor, k_hist: torch.Tensor,
                            v_hist: torch.Tensor, hist_pos: torch.Tensor,
                            k_new: torch.Tensor, v_new: torch.Tensor,
                            q_pos: torch.Tensor, *,
                            window: int | None = None) -> torch.Tensor:
    """Chunked-prefill attention: chunk queries over gathered history + chunk.

    q (B,C,H,hd); k_hist/v_hist (B,L,KV,hd) with stored positions
    ``hist_pos`` (B,L) (-1 = invalid); k_new/v_new (B,C,KV,hd) are this
    chunk's keys at absolute positions ``q_pos`` (B,C)."""
    b, c, h, hd = q.shape
    kv = k_hist.shape[2]
    g = h // kv
    scale = hd ** -0.5
    k_all = torch.cat([k_hist, k_new.to(k_hist.dtype)], dim=1)
    v_all = torch.cat([v_hist, v_new.to(v_hist.dtype)], dim=1)
    kpos = torch.cat([hist_pos, q_pos.to(hist_pos.dtype)], dim=1)   # (B, L+C)
    qf = (q.to(torch.float32) * scale).to(k_all.dtype)
    qf = qf.reshape(b, c, kv, g, hd)
    s = torch.einsum("bckgd,bskd->bkgcs", qf.to(torch.float32),
                     k_all.to(torch.float32))                       # (b,kv,g,C,L+C)
    qp = q_pos.to(kpos.dtype)
    mask = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qp[:, :, None])
    if window is not None:
        mask &= (qp[:, :, None] - kpos[:, None, :]) < window
    s = torch.where(mask[:, None, None, :, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgcs,bskd->bckgd", p.to(v_all.dtype).to(torch.float32),
                       v_all.to(torch.float32))
    return out.reshape(b, c, h, hd).to(q.dtype)

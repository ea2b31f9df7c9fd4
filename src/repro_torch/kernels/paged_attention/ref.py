"""Plain PyTorch version of paged flash-decode attention.

Unlike the reference's dense-gather oracle (``repro/kernels/paged_attention/
ref.py``), this twin walks the block table block by block with the kernel's
own online softmax, floor-mod stored-position mask, explicit re-mask after
the exp and trailing-block skip, so the CPU tests exercise the kernel's
masking logic.  Its result equals the dense softmax up to f32 rounding.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import NEG_INF


def paged_attention_ref(q: torch.Tensor, k_arena: torch.Tensor,
                        v_arena: torch.Tensor, block_table: torch.Tensor,
                        pos: torch.Tensor, ring_cap: torch.Tensor, *,
                        window: int | None = None) -> torch.Tensor:
    """q (B, W, H, hd) at absolute positions pos-W..pos-1 (their K/V already
    in the arena); arenas (N, bs, KV, hd); block_table (B, MB); pos (B,)
    tokens inserted including the last query; ring_cap (B,) -> (B, W, H, hd)."""
    b, w, h, hd = q.shape
    _, bs, kv, _ = k_arena.shape
    g = h // kv
    mb = block_table.shape[1]
    dev = q.device
    scale = hd ** -0.5
    # (B, W, H, hd) -> (B, KV, W*G, hd), rows w-major within a KV group
    qf = (q.to(torch.float32) * scale).reshape(b, w, kv, g, hd)
    qf = qf.permute(0, 2, 1, 3, 4).reshape(b, kv, w * g, hd)
    cnt = torch.clamp(pos.to(torch.int64), min=1)
    cap = torch.clamp(ring_cap.to(torch.int64), min=1)
    last = cnt - 1
    nblk = torch.clamp((torch.minimum(cnt, cap) + bs - 1) // bs, 1, mb)
    rows = torch.arange(w * g, device=dev) // g
    qpos = cnt[:, None] - w + rows[None, :]                     # (B, R)
    m = torch.full((b, kv, w * g, 1), NEG_INF, device=dev)
    l = torch.zeros((b, kv, w * g, 1), device=dev)
    acc = torch.zeros((b, kv, w * g, hd), device=dev)
    bt = block_table.to(torch.int64)
    for j in range(int(nblk.max())):
        kb = k_arena[bt[:, j]].to(torch.float32)                # (B, bs, KV, hd)
        vb = v_arena[bt[:, j]].to(torch.float32)
        s = torch.einsum("bkrd,btkd->bkrt", qf, kb)             # (B, KV, R, bs)
        idx = j * bs + torch.arange(bs, device=dev)
        stored = last[:, None] - (last[:, None] - idx[None, :]) % cap[:, None]
        live = ((idx[None, :] < cap[:, None]) & (stored >= 0)
                & (j < nblk)[:, None])                          # (B, bs)
        mask = live[:, None, :] & (stored[:, None, :] <= qpos[:, :, None])
        if window is not None:
            mask &= (qpos[:, :, None] - stored[:, None, :]) < window
        mask = mask[:, None]                                    # (B, 1, R, bs)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        # explicit re-mask: a fully masked block has s == m_new == NEG_INF
        p = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * alpha + p @ vb.permute(0, 2, 1, 3)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    out = out.reshape(b, kv, w, g, hd).permute(0, 2, 1, 3, 4)
    return out.reshape(b, w, h, hd).to(q.dtype)

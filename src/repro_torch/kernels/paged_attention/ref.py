"""Plain PyTorch versions of paged flash-decode attention, and the dense
gather path.

``paged_attention_ref`` is the plain version the wrapper runs on the host
and the card's kernel is held against.  Unlike the reference's dense-gather
oracle (``repro/kernels/paged_attention/ref.py``), it walks the block table
block by block with the kernel's online softmax, floor-mod stored-position
mask, explicit re-mask after the exp and trailing-block skip.  Its result
equals the dense softmax up to f32 rounding.  It reads its block count back
to the host, so a step that runs it cannot be captured as a CUDA graph.

``paged_attention_gather`` is the reference's dense gather, ported as it
is: every request's blocks gathered into a dense copy, then one masked
softmax.  It is the serving path under ``ops.paged_kernel(False)`` (the
CLI's ``--no-paged-kernel``), an A/B baseline beside the kernel, not its
yardstick; it reads nothing back to the host, so its steps are captured
like the kernel's.

``paged_attention_plan_walk`` follows the CUDA kernel's partition exactly
(``csrc/paged_attention.cu``): each request's splits (``split_plan``), the
32-key tiles of a split, each warp's 8-key slice of a tile with its own
online softmax, the merge of the warps in warp order, then of the splits in
split order, or the direct output of a request with one split.  The CPU
tests hold it against the reference, so the plan's corner cases (empty
splits, a ring that wraps inside a tile, a window that starts inside one)
are tested where the kernel cannot run.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import (NEG_INF, paged_gather_kv,
                                          paged_slot_positions)

# The launch plan the kernel and its walk share (csrc/paged_attention.cu:
# kTileKeys = kWarps * kKeysPerWarp; the wrapper passes TILE_KEYS and
# MIN_SPLIT_KEYS, and the kernel refuses another tile size).
TILE_KEYS = 32          # keys per pipeline stage of the K/V ring
WARPS = 4               # warps per CTA; warp w owns keys [8w, 8w + 8)
MIN_SPLIT_KEYS = 128    # a request's splits average at least this many keys


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


def paged_attention_gather(q: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, block_table: torch.Tensor,
                           pos: torch.Tensor, ring_cap: torch.Tensor, *,
                           window: int | None = None) -> torch.Tensor:
    """The reference's ``paged_attention_ref`` (``repro/kernels/
    paged_attention/ref.py``): the same contract as ``paged_attention_ref``,
    computed over a dense ``(B, MB*bs, KV, hd)`` gather of each request's
    blocks with validity from each slot's stored position.  With a bf16
    arena the scaled queries and the probabilities are rounded to bf16 and
    both products accumulate in f32, as the reference's einsums with
    ``preferred_element_type=f32`` do."""
    b, w, h, hd = q.shape
    k = paged_gather_kv(k_arena, block_table)                # (B, L, KV, hd)
    v = paged_gather_kv(v_arena, block_table)
    length, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = (q.to(torch.float32) * hd ** -0.5).to(k.dtype).to(torch.float32)
    qf = qf.reshape(b, w, kv, g, hd)
    s = torch.einsum("bwkgd,bskd->bkgws", qf, k.to(torch.float32))
    stored = paged_slot_positions(pos, ring_cap, length)    # (B, L)
    qpos = ((pos.to(torch.int64) - w)[:, None]
            + torch.arange(w, device=q.device)[None, :])     # (B, W)
    valid = ((stored >= 0)[:, None, :]
             & (stored[:, None, :] <= qpos[:, :, None]))     # (B, W, L)
    if window is not None:
        valid &= (qpos[:, :, None] - stored[:, None, :]) < window
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype).to(torch.float32)
    out = torch.einsum("bkgws,bskd->bwkgd", p, v.to(torch.float32))
    return out.reshape(b, w, h, hd).to(q.dtype)


def split_plan(cnt: torch.Tensor, cap: torch.Tensor, bs: int, mb: int,
               splits: int, min_split_keys: int = MIN_SPLIT_KEYS):
    """Each request's walk under ``splits`` grid splits, as the kernel's
    ``plan_of`` computes it from cnt = max(pos, 1) and cap = max(ring, 1):
    nkeys = nblk * bs keys in tiles of TILE_KEYS, s_eff = clip(nkeys //
    min_split_keys, 1, splits) splits of ``per`` tiles each (split s walks
    tiles [s * per, min((s + 1) * per, tiles))).  -> (nkeys, s_eff, tiles,
    per), each (B,) int64."""
    nblk = torch.clamp((torch.minimum(cnt, cap) + bs - 1) // bs, 1, mb)
    nkeys = nblk * bs
    s_eff = torch.clamp(nkeys // min_split_keys, 1, splits)
    tiles = (nkeys + TILE_KEYS - 1) // TILE_KEYS
    per = (tiles + s_eff - 1) // s_eff
    return nkeys, s_eff, tiles, per


def _merge(parts):
    """Online-softmax partials (m, l, acc) merged in list order."""
    m_max = parts[0][0]
    for m, _, _ in parts[1:]:
        m_max = torch.maximum(m_max, m)
    l_sum = torch.zeros_like(parts[0][1])
    acc_sum = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        e = torch.exp(m - m_max)
        l_sum = l_sum + l * e
        acc_sum = acc_sum + acc * e
    return m_max, l_sum, acc_sum


def paged_attention_plan_walk(q: torch.Tensor, k_arena: torch.Tensor,
                              v_arena: torch.Tensor,
                              block_table: torch.Tensor, pos: torch.Tensor,
                              ring_cap: torch.Tensor, *,
                              window: int | None = None, splits: int = 1,
                              min_split_keys: int = MIN_SPLIT_KEYS
                              ) -> torch.Tensor:
    """``paged_attention_ref``'s function, computed along the kernel's
    partition with ``splits`` grid splits (see the module docstring)."""
    b, w, h, hd = q.shape
    _, bs, kv, _ = k_arena.shape
    g = h // kv
    mb = block_table.shape[1]
    dev = q.device
    qf = (q.to(torch.float32) * hd ** -0.5).reshape(b, w, kv, g, hd)
    qf = qf.permute(0, 2, 1, 3, 4).reshape(b, kv, w * g, hd)
    cnt = torch.clamp(pos.to(torch.int64), min=1)
    cap = torch.clamp(ring_cap.to(torch.int64), min=1)
    last = cnt - 1
    nkeys, s_eff, tiles, per = split_plan(cnt, cap, bs, mb, splits,
                                          min_split_keys)
    rows = torch.arange(w * g, device=dev) // g
    qpos = cnt[:, None] - w + rows[None, :]                     # (B, R)
    bt = block_table.to(torch.int64)
    kpw = TILE_KEYS // WARPS
    split_parts = []
    for s in range(splits):
        t0 = s * per
        t1 = torch.minimum(t0 + per, tiles)
        k1 = torch.minimum(t1 * TILE_KEYS, nkeys)               # keys read
        warp_parts = []
        for wi in range(WARPS):
            m = torch.full((b, kv, w * g, 1), NEG_INF, device=dev)
            l = torch.zeros((b, kv, w * g, 1), device=dev)
            acc = torch.zeros((b, kv, w * g, hd), device=dev)
            for i in range(int(per.max())):
                t = t0 + i                                      # (B,)
                idx = (t[:, None] * TILE_KEYS + wi * kpw
                       + torch.arange(kpw, device=dev)[None, :])  # (B, 8)
                j = torch.clamp(idx // bs, max=mb - 1)
                blk = torch.gather(bt, 1, j)
                kb = k_arena[blk, idx % bs].to(torch.float32)  # B 8 KV hd
                vb = v_arena[blk, idx % bs].to(torch.float32)
                sc = torch.einsum("bkrd,btkd->bkrt", qf, kb)    # (B, KV, R, 8)
                stored = last[:, None] - (last[:, None] - idx) % cap[:, None]
                live = ((t < t1)[:, None] & (idx < k1[:, None])
                        & (idx < cap[:, None]) & (stored >= 0))   # (B, 8)
                mask = live[:, None, :] & (stored[:, None, :]
                                           <= qpos[:, :, None])
                if window is not None:
                    mask &= (qpos[:, :, None] - stored[:, None, :]) < window
                mask = mask[:, None]                            # (B, 1, R, 8)
                sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
                m_new = torch.maximum(m, torch.amax(sc, dim=-1, keepdim=True))
                p = torch.where(mask, torch.exp(sc - m_new),
                                torch.zeros_like(sc))
                alpha = torch.exp(m - m_new)
                l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
                acc = acc * alpha + p @ vb.permute(0, 2, 1, 3)
                m = m_new
            warp_parts.append((m, l, acc))
        split_parts.append(_merge(warp_parts))
    _, l0, acc0 = split_parts[0]
    direct = acc0 / torch.clamp(l0, min=1e-30)
    _, l_all, acc_all = _merge(split_parts)
    combined = acc_all / torch.clamp(l_all, min=1e-30)
    out = torch.where((s_eff == 1)[:, None, None, None], direct, combined)
    out = out.reshape(b, kv, w, g, hd).permute(0, 2, 1, 3, 4)
    return out.reshape(b, w, h, hd).to(q.dtype)

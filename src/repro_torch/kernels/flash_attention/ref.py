"""Plain PyTorch versions of the flash-attention kernel (port of
``repro/kernels/flash_attention/ref.py``).

``attention_ref`` is the port's sequence-mode attention,
``models/attention.flash_attention``, as the reference's oracle is its jnp
scan: the yardstick the kernel is held against on the card.

``flash_tile_walk`` walks the CUDA kernel's tiles (``csrc/flash_attention.cu``)
on the host in the kernel's order: 128-query CTAs of 16-row warps, the key
tiles of 64 inside the CTA's causal/window band, a warp skipping the tiles
wholly outside its rows' band, the online softmax in base 2 with the
reference's finite NEG_INF, and P rounded to bf16 for P V where the kernel
rounds it (bf16 inputs).  The tests and ``chip_smoke.py`` use it to show
that the kernel's tiling, skips and rounding compute the reference's
function; no model path calls it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.attention import flash_attention

BQ, BK, WARP_ROWS = 128, 64, 16     # the kernel's tiles
NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: int | None = None) -> torch.Tensor:
    return flash_attention(q, k, v, causal=causal, window=window)


def flash_tile_walk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd) -> (B,Sq,H,hd) in q's dtype, computed
    tile by tile as the kernel computes it (f32 arithmetic on the inputs'
    values)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    scale_log2 = hd ** -0.5 * math.log2(math.e)
    w = window or 0
    qf = q.to(torch.float32).transpose(1, 2)                    # (B,H,Sq,hd)
    idx = torch.arange(h, device=q.device) // (h // kv)         # GQA map
    kf = k.to(torch.float32).transpose(1, 2)[:, idx]            # (B,H,Sk,hd)
    vf = v.to(torch.float32).transpose(1, 2)[:, idx]
    out = torch.empty_like(qf)
    for q0 in range(0, sq, BQ):
        q_last = min(q0 + BQ, sq) - 1
        k_begin = max(0, q0 - w + 1) if w > 0 else 0
        k_end = min(sk, q_last + 1) if causal else sk
        tiles = range(k_begin // BK * BK, k_end, BK)
        for qw0 in range(q0, q_last + 1, WARP_ROWS):
            rows = torch.arange(qw0, min(qw0 + WARP_ROWS, sq),
                                device=q.device)
            qb = qf[:, :, rows]
            m = torch.full(qb.shape[:-1], NEG_INF, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros_like(qb)
            for k0 in tiles:
                if ((causal and k0 > qw0 + WARP_ROWS - 1)
                        or (w > 0 and qw0 - (k0 + BK - 1) >= w)):
                    continue                 # wholly outside the band
                keys = torch.arange(k0, min(k0 + BK, sk), device=q.device)
                s = (qb @ kf[:, :, keys].transpose(-1, -2)) * scale_log2
                valid = torch.ones((len(rows), len(keys)), dtype=torch.bool,
                                   device=q.device)
                if causal:
                    valid &= keys[None, :] <= rows[:, None]
                if w > 0:
                    valid &= (rows[:, None] - keys[None, :]) < w
                s = torch.where(valid, s, torch.full_like(s, NEG_INF))
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                if bf16:
                    p = p.to(torch.bfloat16).to(torch.float32)
                acc = acc * alpha[..., None] + p @ vf[:, :, keys]
                m = m_new
            out[:, :, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)

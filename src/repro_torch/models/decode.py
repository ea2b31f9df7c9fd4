"""Paged serving steps for attention decoders (port of the attention branches
of ``repro/models/decode.py``: ``_attn_qkv``, ``layer_decode_paged`` /
``decode_step_paged`` and ``layer_prefill_chunk`` / ``prefill_chunk_paged``).

K/V live in one (num_blocks, block_size, KV, hd) arena per layer, addressed
through per-request block tables.  Every projection dispatches through
``common.linear``, so quantized layers run the fused RHT + dequant GEMM, and
the decode read runs the paged flash-decode kernel.

The reference's jitted steps donate the arenas so XLA aliases them in and
out; here the arenas are updated in place (``index_put_``) instead, and the
steps return the same cache objects.  The decode step takes only
fixed-shape tensors (tokens, pos, active, block_tables, ring_cap), so batch
churn changes their contents, never their shapes — the property a CUDA
graph capture of the step needs.
"""
from __future__ import annotations

import torch

from . import attention as attnmod
from .common import apply_norm, apply_rope, linear
from .config import ModelConfig
from .transformer import _ffn_apply, _qk_normalize, embed_tokens


def attn_capacity(cfg: ModelConfig, context: int) -> int:
    return min(context, cfg.window) if cfg.window else context


def _attn_qkv(cfg: ModelConfig, p: dict, hn: torch.Tensor,
              positions: torch.Tensor):
    """q/k/v projections + qk-norm + rope.  hn (B, S, d); positions (B, S)."""
    b, s, _ = hn.shape
    hd = cfg.hd
    q = linear(p["wq"], hn).reshape(b, s, -1, hd)
    k = linear(p["wk"], hn).reshape(b, s, -1, hd)
    v = linear(p["wv"], hn).reshape(b, s, -1, hd)
    q, k = _qk_normalize(p, q, k)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def layer_decode_paged(cfg: ModelConfig, lp: dict, h: torch.Tensor,
                       cache: dict, pos: torch.Tensor, active: torch.Tensor,
                       block_tables: torch.Tensor,
                       ring_cap: torch.Tensor) -> torch.Tensor:
    """One layer, one token per slot.  h (S, 1, d); pos (S,) int32 the fed
    token's absolute position; active (S,) bool; block_tables (S, MB)
    int32; ring_cap (S,) int32.  Writes this token's K/V into the arena in
    place, then attends over the arena."""
    b = h.shape[0]
    hn = apply_norm(cfg.norm, h, lp["ln1"])
    p = lp["attn"]
    q, k, v = _attn_qkv(cfg, p, hn, pos[:, None])
    block_size = cache["k"].shape[1]
    pb, off = attnmod.paged_write_indices(pos, ring_cap, block_tables,
                                          block_size, active)
    cache["k"].index_put_((pb, off), k[:, 0].to(cache["k"].dtype))
    cache["v"].index_put_((pb, off), v[:, 0].to(cache["v"].dtype))
    out = attnmod.paged_decode_attention(q, cache["k"], cache["v"],
                                         block_tables, pos + 1, ring_cap,
                                         window=cfg.window)
    h = h + linear(p["wo"], out.reshape(b, 1, -1)).to(h.dtype)
    h2 = apply_norm(cfg.norm, h, lp["ln2"])
    y, _ = _ffn_apply(cfg, lp, h2)
    return h + y.to(h.dtype)


def decode_step_paged(cfg: ModelConfig, params: dict, caches: list,
                      tokens: torch.Tensor, pos: torch.Tensor,
                      active: torch.Tensor, block_tables: torch.Tensor,
                      ring_cap: torch.Tensor):
    """One decode step for the whole slot set: tokens (S, 1) -> (logits
    (S, V), caches).  Inactive slots run inert (embeddings zeroed, arena
    writes redirected to the null block)."""
    h = embed_tokens(cfg, params, tokens)
    h = torch.where(active[:, None, None], h, torch.zeros_like(h))
    for lp, cache in zip(params["layers"], caches):
        h = layer_decode_paged(cfg, lp, h, cache, pos, active, block_tables,
                               ring_cap)
    h = apply_norm(cfg.norm, h, params["final_norm"])
    logits = linear(params["lm_head"], h)
    return logits[:, 0], caches


def layer_prefill_chunk(cfg: ModelConfig, lp: dict, h: torch.Tensor,
                        cache: dict, pos0: int, bt_row: torch.Tensor,
                        ring_cap: int) -> torch.Tensor:
    """One layer over one request's prompt chunk h (1, C, d) starting at
    absolute position ``pos0``, reading history from and writing the chunk
    into the arena through the request's block-table row."""
    b, c, _ = h.shape
    hn = apply_norm(cfg.norm, h, lp["ln1"])
    chunk_pos = pos0 + torch.arange(c, dtype=torch.int64, device=h.device)
    p = lp["attn"]
    q, k, v = _attn_qkv(cfg, p, hn, chunk_pos[None])
    k_hist = attnmod.paged_gather_kv(cache["k"], bt_row[None])
    v_hist = attnmod.paged_gather_kv(cache["v"], bt_row[None])
    pos0_t = torch.full((1,), pos0, dtype=torch.int64, device=h.device)
    cap_t = torch.full((1,), ring_cap, dtype=torch.int64, device=h.device)
    hist_pos = attnmod.paged_slot_positions(pos0_t, cap_t, k_hist.shape[1])
    out = attnmod.paged_prefill_attention(q, k_hist, v_hist, hist_pos, k, v,
                                          chunk_pos[None], window=cfg.window)
    mix = linear(p["wo"], out.reshape(b, c, -1))
    block_size = cache["k"].shape[1]
    pb, off = attnmod.paged_write_indices(chunk_pos, ring_cap, bt_row,
                                          block_size)
    cache["k"].index_put_((pb, off), k[0].to(cache["k"].dtype))
    cache["v"].index_put_((pb, off), v[0].to(cache["v"].dtype))
    h = h + mix.to(h.dtype)
    h2 = apply_norm(cfg.norm, h, lp["ln2"])
    y, _ = _ffn_apply(cfg, lp, h2)
    return h + y.to(h.dtype)


def prefill_chunk_paged(cfg: ModelConfig, params: dict, caches: list,
                        tokens: torch.Tensor, pos0: int, bt_row: torch.Tensor,
                        ring_cap: int):
    """One prompt chunk for one request: tokens (1, C) starting at absolute
    position ``pos0`` -> (last-token logits (1, V), caches)."""
    h = embed_tokens(cfg, params, tokens)
    for lp, cache in zip(params["layers"], caches):
        h = layer_prefill_chunk(cfg, lp, h, cache, pos0, bt_row, ring_cap)
    h = apply_norm(cfg.norm, h, params["final_norm"])
    return linear(params["lm_head"], h[:, -1]), caches

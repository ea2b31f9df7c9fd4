"""Paged serving steps for attention decoders (port of the attention branches
of ``repro/models/decode.py``: ``_attn_qkv``, ``layer_decode_paged`` /
``decode_step_paged``, ``layer_verify_paged`` / ``decode_verify_paged`` and
``layer_prefill_chunk`` / ``prefill_chunk_paged``).

K/V live in one (num_blocks, block_size, KV, hd) arena per layer, addressed
through per-request block tables.  Every projection dispatches through
``common.linear``, so quantized layers run the fused RHT + dequant GEMM, and
the decode read runs the paged flash-decode kernel.

The reference's jitted steps donate the arenas so XLA aliases them in and
out; here the arenas are updated in place (``index_put_``) instead, and the
steps return the same cache objects.  Both steps take only tensors whose
shapes are fixed by the engine: the decode step (tokens, pos, active,
block_tables, ring_cap) by the slot count, the prompt chunk (tokens, pos0,
bt_row, ring_cap) by the chunk length C.  Batch churn and a request's
progress change their contents, never their shapes, and nothing here reads
a value back to the host — what a CUDA graph capture of a step needs
(``serve/graphs.py``).
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


def layer_verify_paged(cfg: ModelConfig, lp: dict, h: torch.Tensor,
                       cache: dict, pos0: torch.Tensor, active: torch.Tensor,
                       block_tables: torch.Tensor, ring_cap: torch.Tensor,
                       write_mask: torch.Tensor) -> torch.Tensor:
    """One layer, W tokens per slot (speculative verify, draft catch-up).
    h (S, W, d); pos0 (S,) int32 each slot's first position; active (S,)
    bool; write_mask (S, W) bool selects the positions that commit K/V
    (the others go to the null block: ``paged_multi_write_indices``).
    The span's K/V is written first, then one paged attention read at
    pos0 + W covers history and span: causality within the span follows
    from the stored-position mask, so the logits at pos0 + i see the first
    i + 1 fed tokens.  A masked position is an inactive slot's or a
    catch-up position whose identical K/V is already in the arena;
    ``PoolConfig.lookahead`` reserves the ring capacity the writes past
    the frontier land in."""
    b, w, _ = h.shape
    hn = apply_norm(cfg.norm, h, lp["ln1"])
    positions = pos0[:, None] + torch.arange(w, dtype=torch.int32,
                                             device=h.device)[None, :]
    p = lp["attn"]
    q, k, v = _attn_qkv(cfg, p, hn, positions)
    block_size = cache["k"].shape[1]
    pb, off = attnmod.paged_multi_write_indices(positions, ring_cap,
                                                block_tables, block_size,
                                                write_mask, active)
    cache["k"].index_put_((pb, off), k.to(cache["k"].dtype))
    cache["v"].index_put_((pb, off), v.to(cache["v"].dtype))
    out = attnmod.paged_decode_attention(q, cache["k"], cache["v"],
                                         block_tables, pos0 + w, ring_cap,
                                         window=cfg.window)
    h = h + linear(p["wo"], out.reshape(b, w, -1)).to(h.dtype)
    h2 = apply_norm(cfg.norm, h, lp["ln2"])
    y, _ = _ffn_apply(cfg, lp, h2)          # MoE routes all S * W tokens
    return h + y.to(h.dtype)


def decode_verify_paged(cfg: ModelConfig, params: dict, caches: list,
                        tokens: torch.Tensor, pos0: torch.Tensor,
                        active: torch.Tensor, block_tables: torch.Tensor,
                        ring_cap: torch.Tensor, write_mask: torch.Tensor):
    """Score W tokens per slot in one step: tokens (S, W) from positions
    ``pos0`` (S,) -> (logits (S, W, V), caches).  The target verifies a
    draft's k proposals at W = k + 1, and the draft catches up at W = 2.
    Inactive slots run inert (embeddings zeroed, writes on the null
    block)."""
    h = embed_tokens(cfg, params, tokens)
    h = torch.where(active[:, None, None], h, torch.zeros_like(h))
    wmask = write_mask & active[:, None]
    for lp, cache in zip(params["layers"], caches):
        h = layer_verify_paged(cfg, lp, h, cache, pos0, active,
                               block_tables, ring_cap, wmask)
    h = apply_norm(cfg.norm, h, params["final_norm"])
    return linear(params["lm_head"], h), caches


def layer_prefill_chunk(cfg: ModelConfig, lp: dict, h: torch.Tensor,
                        cache: dict, pos0: torch.Tensor, bt_row: torch.Tensor,
                        ring_cap: torch.Tensor) -> torch.Tensor:
    """One layer over one request's prompt chunk h (1, C, d) starting at
    absolute position ``pos0`` (a 0-d int32 tensor, as is ``ring_cap``),
    reading history from and writing the chunk into the arena through the
    request's block-table row."""
    b, c, _ = h.shape
    hn = apply_norm(cfg.norm, h, lp["ln1"])
    chunk_pos = pos0.to(torch.int64) + torch.arange(c, dtype=torch.int64,
                                                    device=h.device)
    p = lp["attn"]
    q, k, v = _attn_qkv(cfg, p, hn, chunk_pos[None])
    k_hist = attnmod.paged_gather_kv(cache["k"], bt_row[None])
    v_hist = attnmod.paged_gather_kv(cache["v"], bt_row[None])
    hist_pos = attnmod.paged_slot_positions(pos0[None], ring_cap[None],
                                            k_hist.shape[1])
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
                        tokens: torch.Tensor, pos0: torch.Tensor,
                        bt_row: torch.Tensor, ring_cap: torch.Tensor):
    """One prompt chunk for one request: tokens (1, C) starting at absolute
    position ``pos0`` -> (last-token logits (1, V), caches).  ``pos0`` and
    ``ring_cap`` are 0-d int32 tensors, as the reference's ``_chunk`` takes
    ``jnp.int32`` scalars, so the chunk's shapes depend on C alone."""
    h = embed_tokens(cfg, params, tokens)
    for lp, cache in zip(params["layers"], caches):
        h = layer_prefill_chunk(cfg, lp, h, cache, pos0, bt_row, ring_cap)
    h = apply_norm(cfg.norm, h, params["final_norm"])
    return linear(params["lm_head"], h[:, -1]), caches

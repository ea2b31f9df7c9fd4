"""Serving steps for attention decoders (port of the attention branches of
``repro/models/decode.py``): the lockstep path (``init_caches``,
``prefill``, ``decode_step``) and the paged steps (``_attn_qkv``,
``layer_decode_paged`` / ``decode_step_paged``, ``layer_verify_paged`` /
``decode_verify_paged`` and ``layer_prefill_chunk`` /
``prefill_chunk_paged``).

The lockstep path is the baseline the paged engine is measured against
(``launch/serve.BatchedServer``): a batch prefills together into one dense
``attention.KVCache`` per layer (a ring of ``min(context, window)`` slots),
then decodes in lockstep.  Its decode step takes ``pos`` as a one-element
tensor and writes the cache in place, so one CUDA graph capture serves
every step.  Other mixers (MLA, RWKV, RG-LRU) raise ``NotImplementedError``
(ROADMAP Queue 1 item 5).

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

from repro_torch.kernels.paged_attention import ops as pops

from . import attention as attnmod
from .common import apply_norm, apply_rope, linear
from .config import ModelConfig
from .transformer import _ffn_apply, _qk_normalize, embed_tokens


def attn_capacity(cfg: ModelConfig, context: int) -> int:
    return min(context, cfg.window) if cfg.window else context


# ------------------------------------------------------------ lockstep path


def _unported_mixer(mixer: str) -> NotImplementedError:
    return NotImplementedError(
        f"the port's serving path has no {mixer!r} mixer yet: attention "
        "only (ROADMAP Queue 1 item 5)")


def init_layer_cache(cfg: ModelConfig, mixer: str, b: int, context: int,
                     dtype=torch.float32, device=None) -> dict:
    """One layer's lockstep cache: ``{"kv": KVCache}`` for attention."""
    if mixer != "attn":
        raise _unported_mixer(mixer)
    return {"kv": attnmod.KVCache.init(b, attn_capacity(cfg, context),
                                       cfg.n_kv, cfg.hd, dtype, device)}


def init_caches(cfg: ModelConfig, b: int, context: int, dtype=torch.float32,
                device=None) -> list:
    """One cache per layer (the layers are unrolled, as ``params``'s are)."""
    return [init_layer_cache(cfg, mx, b, context, dtype, device)
            for mx in cfg.pattern]


def _ring_fill(cache: attnmod.KVCache, k: torch.Tensor,
               v: torch.Tensor) -> attnmod.KVCache:
    """Fill a ring cache from a whole prefix (B, S, KV, hd) in place: the
    last ``cap`` positions, each at slot position % cap."""
    cap, s = cache.k.shape[1], k.shape[1]
    if s <= cap:
        cache.k[:, :s] = k.to(cache.k.dtype)
        cache.v[:, :s] = v.to(cache.v.dtype)
        return cache
    tail = torch.arange(s - cap, s, device=k.device)
    slots = tail % cap
    cache.k.index_copy_(1, slots, k[:, tail].to(cache.k.dtype))
    cache.v.index_copy_(1, slots, v[:, tail].to(cache.v.dtype))
    return cache


def layer_prefill(cfg: ModelConfig, mixer: str, lp: dict, h: torch.Tensor,
                  positions: torch.Tensor, cache: dict):
    """A whole sequence through one layer, filling its cache in place ->
    (h, aux, cache).  h (B, S, d); positions (B, S)."""
    if mixer != "attn":
        raise _unported_mixer(mixer)
    b, s, _ = h.shape
    hn = apply_norm(cfg.norm, h, lp["ln1"])
    p = lp["attn"]
    q, k, v = _attn_qkv(cfg, p, hn, positions)
    out = attnmod.flash_attention(q, k, v, causal=True, window=cfg.window)
    mix = linear(p["wo"], out.reshape(b, s, cfg.n_heads * cfg.hd))
    _ring_fill(cache["kv"], k, v)
    h = h + mix.to(h.dtype)
    h2 = apply_norm(cfg.norm, h, lp["ln2"])
    y, aux = _ffn_apply(cfg, lp, h2)
    return h + y.to(h.dtype), aux, cache


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            context: int | None = None, caches: list | None = None):
    """Run the prefix -> (logits (B, S, V), caches, pos = S).  ``caches``
    (from ``init_caches`` for this batch and context) are filled in place;
    without them fresh f32 ones of ``context`` (default S) positions are
    made."""
    h = embed_tokens(cfg, params, tokens)
    b, s, _ = h.shape
    if caches is None:
        caches = init_caches(cfg, b, context or s, device=h.device)
    positions = torch.arange(s, dtype=torch.int32,
                             device=h.device)[None, :].expand(b, s)
    for mx, lp, cache in zip(cfg.pattern, params["layers"], caches):
        h, _, _ = layer_prefill(cfg, mx, lp, h, positions, cache)
    h = apply_norm(cfg.norm, h, params["final_norm"])
    return linear(params["lm_head"], h), caches, s


def layer_decode(cfg: ModelConfig, mixer: str, lp: dict, h: torch.Tensor,
                 cache: dict, pos: torch.Tensor) -> torch.Tensor:
    """One layer, one token: h (B, 1, d) at absolute position ``pos`` (a
    one-element int32 tensor) -> h; the token's K/V go into the ring in
    place."""
    if mixer != "attn":
        raise _unported_mixer(mixer)
    b = h.shape[0]
    hn = apply_norm(cfg.norm, h, lp["ln1"])
    p = lp["attn"]
    posb = pos.reshape(1, 1).expand(b, 1)
    q, k, v = _attn_qkv(cfg, p, hn, posb)
    kvc = attnmod.cache_insert(cache["kv"], k, v, pos)
    out = attnmod.decode_attention(q, kvc, pos + 1)
    h = h + linear(p["wo"], out.reshape(b, 1, cfg.n_heads * cfg.hd)).to(
        h.dtype)
    h2 = apply_norm(cfg.norm, h, lp["ln2"])
    y, _ = _ffn_apply(cfg, lp, h2)
    return h + y.to(h.dtype)


def decode_step(cfg: ModelConfig, params: dict, caches: list,
                tokens: torch.Tensor, pos: torch.Tensor):
    """One token for the whole batch: tokens (B, 1) -> (logits (B, V),
    caches).  ``pos`` (a one-element int32 tensor) is the number of tokens
    already in the cache; reads nothing back to the host."""
    h = embed_tokens(cfg, params, tokens)
    for mx, lp, cache in zip(cfg.pattern, params["layers"], caches):
        h = layer_decode(cfg, mx, lp, h, cache, pos)
    h = apply_norm(cfg.norm, h, params["final_norm"])
    return linear(params["lm_head"], h)[:, 0], caches


def caches_context(caches: list, cfg: ModelConfig) -> int:
    """Positional extent a sinusoidal table needs (the reference's
    ``caches_context``): at least 2048, else the caches' capacity."""
    for cache in caches:
        for entry in cache.values():
            return max(2048, entry.k.shape[1])
    return 2048


# ---------------------------------------------------------------- paged path


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
    the frontier land in.  Under ``paged_kernel(False)`` (the dense
    gather) the order is the reference's gather branch instead: the
    history is gathered from the arena before the span's writes and
    attended together with the span's own K/V, as a prompt chunk does."""
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
    gather = not pops.kernel_enabled()
    if gather:
        # the reference's gather branch: history read before the writes
        k_hist = attnmod.paged_gather_kv(cache["k"], block_tables)
        v_hist = attnmod.paged_gather_kv(cache["v"], block_tables)
        hist_pos = attnmod.paged_slot_positions(pos0, ring_cap,
                                                k_hist.shape[1])
    cache["k"].index_put_((pb, off), k.to(cache["k"].dtype))
    cache["v"].index_put_((pb, off), v.to(cache["v"].dtype))
    if gather:
        out = attnmod.paged_prefill_attention(q, k_hist, v_hist, hist_pos, k,
                                              v, positions, window=cfg.window)
    else:
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

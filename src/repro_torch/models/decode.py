"""Serving steps for every decoder family (port of ``repro/models/
decode.py``): the lockstep path (``init_caches``, ``prefill``,
``decode_step``) and the paged steps (``_attn_qkv``, ``layer_decode_paged``
/ ``decode_step_paged``, ``layer_verify_paged`` / ``decode_verify_paged``
and ``layer_prefill_chunk`` / ``prefill_chunk_paged``), for attention, MLA,
RWKV6 and RG-LRU mixers and their mixes, with RoPE or Qwen2-VL's mrope.

Whisper (encoder-decoder) runs the lockstep path only, as in the
reference: ``prefill`` encodes the frames once and caches each decoder
layer's cross-attention K/V (``xk`` / ``xv``, (B, T, KV, hd) in the
dtype of the linear that made them, f32, whatever the self-attention
cache's dtype), which every decode step reads whole; the sinusoidal table
is added to the decoder's input, at ``pos`` by a tensor index in a decode
step.  The paged steps refuse encoder-decoder archs in the reference's
words.  mrope's paged steps take (B, W) positions and expand them to the
three equal streams of text tokens (an ``expand``, no copy, so the CUDA
graphs still capture); the lockstep ``prefill`` also takes (3, B, S)
vision-grid positions, and its decode steps continue from ``pos``.

Layers run in execution order over ``params["layers"]`` with layer i's
mixer ``cfg.pattern[i]``: the order the reference's ``_apply_layers``
gives its scanned full periods and then the remainder (``bridge.py`` lays
the layers out so).  Each layer's cache is a dict: ``{"kv": KVCache}``
(lockstep attention), ``{"k", "v"}`` (a paged attention layer's block
arenas), ``{"mla": MLACache}``, ``{"rwkv": RWKVState}`` or ``{"rglru":
RGLRUState}``; in the paged pool the last three hold one row per engine
slot.

The lockstep path is the baseline the paged engine is measured against
(``launch/serve.BatchedServer``): a batch prefills together into one cache
per layer (attention a ring of ``min(context, window)`` slots, MLA a
latent row of ``context``), then decodes in lockstep.  Its decode step
takes ``pos`` as a one-element tensor and writes the caches in place, so
one CUDA graph capture serves every step.

K/V live in one (num_blocks, block_size, KV, hd) arena per attention
layer, addressed through per-request block tables.  Every projection
dispatches through ``common.linear``, so quantized layers run the fused
RHT + dequant GEMM, and the decode read runs the paged flash-decode
kernel.

Tensor parallelism (``runtime/tp.py``): the paged and the lockstep steps
gather the ranks' head slices before ``wo`` (``gather_heads``) and the
vocab slices of the logits (``gather_cols``), at the reference's places;
both are shape-driven no-ops at full width, so TP=1 runs the same code.
A rank's lockstep caches hold its KV heads (``init_caches(kv_heads=)``).

The reference's jitted steps donate their caches so XLA aliases them in
and out; here every cache is updated in place (``index_put_``,
``index_copy_``, ``copy_``) and the steps return the same cache objects.
Both steps take only tensors whose shapes are fixed by the engine: the
decode step (tokens, pos, active, block_tables, ring_cap) by the slot
count, the prompt chunk (tokens, pos0, bt_row, ring_cap, slot) by the
chunk length C.  Batch churn and a request's progress change their
contents, never their shapes, and nothing here reads a value back to the
host (a chunk's recurrent state starts from zero at pos0 == 0 by a tensor
select, not a branch) -- what a CUDA graph capture of a step needs
(``serve/graphs.py``).  Speculation's verify step is attention-only, as in
the reference: the engine bypasses speculation for the other mixers.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.paged_attention import ops as pops
from repro_torch.runtime import tp as tpmod

from . import attention as attnmod
from . import mla as mlamod
from . import rglru as rglrumod
from . import rwkv6 as rwkvmod
from .common import apply_norm, linear, sinusoidal_positions
from .config import ModelConfig
from .transformer import (_default_positions, _ffn_apply, _qk_normalize,
                          embed_tokens, encode, rotate_qk)

ENC_DEC_PAGED = "paged serving does not support encoder-decoder archs"


def attn_capacity(cfg: ModelConfig, context: int) -> int:
    return min(context, cfg.window) if cfg.window else context


# ------------------------------------------------------------ lockstep path


def init_layer_cache(cfg: ModelConfig, mixer: str, b: int, context: int,
                     dtype=torch.float32, device=None,
                     kv_heads: int | None = None) -> dict:
    """One layer's lockstep cache (recurrent state is f32 whatever
    ``dtype``, as the reference's).  An encoder-decoder layer's ``xk`` /
    ``xv`` join it in ``prefill``.  ``kv_heads``: an attention ring's KV
    heads (a tensor-parallel rank's ``runtime/tp.local_kv_heads``;
    default all ``cfg.n_kv``)."""
    if mixer == "attn":
        return {"kv": attnmod.KVCache.init(b, attn_capacity(cfg, context),
                                           kv_heads or cfg.n_kv, cfg.hd,
                                           dtype, device)}
    if mixer == "mla":
        return {"mla": mlamod.MLACache.init(b, context, cfg.mla.kv_lora,
                                            cfg.mla.qk_rope, dtype, device)}
    if mixer == "rwkv":
        return {"rwkv": rwkvmod.RWKVState.init(b, cfg.n_heads, cfg.hd,
                                               cfg.d_model, dtype, device)}
    if mixer == "rglru":
        return {"rglru": rglrumod.RGLRUState.init(
            b, cfg.rglru_width or cfg.d_model, dtype, device)}
    raise ValueError(f"unknown mixer {mixer!r}")


def init_caches(cfg: ModelConfig, b: int, context: int, dtype=torch.float32,
                device=None, kv_heads: int | None = None) -> list:
    """One cache per layer (the layers are unrolled, as ``params``'s are)."""
    return [init_layer_cache(cfg, mx, b, context, dtype, device, kv_heads)
            for mx in cfg.pattern]


def cache_tensors(cache: dict) -> list:
    """Every tensor of one layer's cache."""
    out = []
    for entry in cache.values():
        if isinstance(entry, torch.Tensor):
            out.append(entry)
        else:
            out.extend(getattr(entry, f.name)
                       for f in dataclasses.fields(entry))
    return out


def _store(old, new) -> None:
    """Write state ``new`` into ``old``'s tensors in place."""
    for f in dataclasses.fields(old):
        dst = getattr(old, f.name)
        dst.copy_(getattr(new, f.name).to(dst.dtype))


def _store_masked(old, new, active: torch.Tensor) -> None:
    """``old``'s rows take ``new``'s where ``active`` (the reference's
    ``_mask_state``), in place."""
    for f in dataclasses.fields(old):
        dst = getattr(old, f.name)
        m = active.reshape(active.shape[0], *([1] * (dst.ndim - 1)))
        dst.copy_(torch.where(m, getattr(new, f.name).to(dst.dtype), dst))


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
    (h, aux, cache).  h (B, S, d); positions (B, S), or (3, B, S) for
    mrope; an encoder-decoder layer attends over the cache's ``xk`` /
    ``xv`` after its self-attention."""
    b, s, _ = h.shape
    hn = apply_norm(cfg.norm, h, lp["ln1"])
    if mixer == "attn":
        p = lp["attn"]
        q, k, v = _attn_qkv(cfg, p, hn, positions)
        out = attnmod.flash_attention(q, k, v, causal=True,
                                      window=cfg.window)
        out = tpmod.gather_heads(out, cfg.n_heads)
        mix = linear(p["wo"], out.reshape(b, s, cfg.n_heads * cfg.hd))
        _ring_fill(cache["kv"], k, v)
    elif mixer == "mla":
        m, p = cfg.mla, lp["mla"]
        mix, (c_kv, k_rope) = mlamod.mla_full(p, hn, m, positions,
                                              return_latent=True)
        mc = cache["mla"]
        mc.c_kv[:, :s] = c_kv.to(mc.c_kv.dtype)
        mc.k_rope[:, :s] = k_rope.to(mc.k_rope.dtype)
    elif mixer == "rwkv":
        mix, st = rwkvmod.time_mix(lp["tm"], hn, n_heads=cfg.n_heads,
                                   head_dim=cfg.hd, return_state=True)
    elif mixer == "rglru":
        mix, st = rglrumod.rglru_block(lp["rglru"], hn, return_state=True)
        _store(cache["rglru"], st)
    else:
        raise ValueError(mixer)
    h = h + mix.to(h.dtype)
    if cfg.enc_dec:
        hx = apply_norm(cfg.norm, h, lp["ln_x"])
        q = linear(lp["xattn"]["wq"], hx).reshape(b, s, cfg.n_heads, cfg.hd)
        out = attnmod.flash_attention(q, cache["xk"], cache["xv"],
                                      causal=False)
        h = h + linear(lp["xattn"]["wo"], out.reshape(b, s, -1))
    h2 = apply_norm(cfg.norm, h, lp["ln2"])
    if mixer == "rwkv":
        y, aux = rwkvmod.channel_mix(lp["cm"], h2), 0.0
        _store(cache["rwkv"], rwkvmod.RWKVState(
            s=st, x_prev_tm=hn[:, -1], x_prev_cm=h2[:, -1]))
    else:
        y, aux = _ffn_apply(cfg, lp, h2)
    return h + y.to(h.dtype), aux, cache


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            positions: torch.Tensor | None = None,
            enc_embeds: torch.Tensor | None = None,
            context: int | None = None, caches: list | None = None):
    """Run the prefix -> (logits (B, S, V), caches, pos = S).  ``caches``
    (from ``init_caches`` for this batch and context) are filled in place;
    without them fresh f32 ones of ``context`` (default S) positions are
    made.  ``positions``: (B, S), or mrope's (3, B, S) (default 0..S-1).
    An encoder-decoder model encodes ``enc_embeds`` (B, T, d) and caches
    each layer's cross K/V."""
    h = embed_tokens(cfg, params, tokens)
    b, s, d = h.shape
    if caches is None:
        caches = init_caches(cfg, b, context or s, device=h.device)
    if cfg.enc_dec:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name} needs encoder frames (enc_embeds)")
        encoder_out = encode(cfg, params, enc_embeds)
        t = encoder_out.shape[1]
        for lp, cache in zip(params["layers"], caches):
            for key, w in (("xk", "wk"), ("xv", "wv")):   # the linear's dtype
                cache[key] = linear(lp["xattn"][w], encoder_out).reshape(
                    b, t, cfg.n_kv, cfg.hd)
    if cfg.pos == "sinusoidal":
        h = h + sinusoidal_positions(s, d, h.device).to(h.dtype)[None]
    if positions is None:
        positions = _default_positions(cfg, b, s, h.device)
    for mx, lp, cache in zip(cfg.pattern, params["layers"], caches):
        h, _, _ = layer_prefill(cfg, mx, lp, h, positions, cache)
    h = apply_norm(cfg.norm, h, params["final_norm"])
    return tpmod.gather_cols(linear(params["lm_head"], h), cfg.vocab), \
        caches, s


def layer_decode(cfg: ModelConfig, mixer: str, lp: dict, h: torch.Tensor,
                 cache: dict, pos: torch.Tensor) -> torch.Tensor:
    """One layer, one token: h (B, 1, d) at absolute position ``pos`` (a
    one-element int32 tensor) -> h; the cache is advanced in place.  mrope
    takes ``pos`` on all three streams, as the reference's step does."""
    b = h.shape[0]
    hn = apply_norm(cfg.norm, h, lp["ln1"])
    if mixer == "attn":
        p = lp["attn"]
        posb = _streams(cfg, pos.reshape(1, 1).expand(b, 1))
        q, k, v = _attn_qkv(cfg, p, hn, posb)
        kvc = attnmod.cache_insert(cache["kv"], k, v, pos)
        out = attnmod.decode_attention(q, kvc, pos + 1)
        out = tpmod.gather_heads(out, cfg.n_heads)
        mix = linear(p["wo"], out.reshape(b, 1, cfg.n_heads * cfg.hd))
    elif mixer == "mla":
        mix, _ = mlamod.mla_decode(lp["mla"], hn, cfg.mla, cache["mla"], pos)
    elif mixer == "rwkv":
        mix, st = rwkvmod.time_mix_decode(lp["tm"], hn[:, 0], cache["rwkv"],
                                          n_heads=cfg.n_heads,
                                          head_dim=cfg.hd)
        mix = mix[:, None, :]
    elif mixer == "rglru":
        mix, st = rglrumod.rglru_decode(lp["rglru"], hn[:, 0],
                                        cache["rglru"])
        mix = mix[:, None, :]
        _store(cache["rglru"], st)
    else:
        raise ValueError(mixer)
    h = h + mix.to(h.dtype)
    if cfg.enc_dec:
        hx = apply_norm(cfg.norm, h, lp["ln_x"])
        q = linear(lp["xattn"]["wq"], hx).reshape(b, 1, cfg.n_heads, cfg.hd)
        xk = cache["xk"]
        every = torch.full((1,), xk.shape[1], dtype=torch.int32,
                           device=xk.device)        # all T frames valid
        out = attnmod.decode_attention(
            q, attnmod.KVCache(k=xk, v=cache["xv"]), every)
        h = h + linear(lp["xattn"]["wo"], out.reshape(b, 1, -1))
    h2 = apply_norm(cfg.norm, h, lp["ln2"])
    if mixer == "rwkv":
        y = rwkvmod.channel_mix(lp["cm"], h2[:, 0],
                                cache["rwkv"].x_prev_cm)[:, None, :]
        _store(cache["rwkv"], dataclasses.replace(st, x_prev_cm=h2[:, 0]))
    else:
        y, _ = _ffn_apply(cfg, lp, h2)
    return h + y.to(h.dtype)


def decode_step(cfg: ModelConfig, params: dict, caches: list,
                tokens: torch.Tensor, pos: torch.Tensor):
    """One token for the whole batch: tokens (B, 1) -> (logits (B, V),
    caches).  ``pos`` (a one-element int32 tensor) is the number of tokens
    already in the cache; reads nothing back to the host (the sinusoidal
    row is taken by a tensor index, clamped to the table as the
    reference's ``dynamic_slice`` is)."""
    h = embed_tokens(cfg, params, tokens)
    if cfg.pos == "sinusoidal":
        table = sinusoidal_positions(caches_context(caches, cfg),
                                     h.shape[-1], h.device)
        row = pos.reshape(1).to(torch.int64).clamp(0, table.shape[0] - 1)
        h = h + table.index_select(0, row)[None].to(h.dtype)
    for mx, lp, cache in zip(cfg.pattern, params["layers"], caches):
        h = layer_decode(cfg, mx, lp, h, cache, pos)
    h = apply_norm(cfg.norm, h, params["final_norm"])
    return tpmod.gather_cols(linear(params["lm_head"], h)[:, 0],
                             cfg.vocab), caches


def caches_context(caches: list, cfg: ModelConfig) -> int:
    """Positional extent a sinusoidal table needs (the reference's
    ``caches_context``): at least 2048, else the first cache's capacity
    (an attention ring's or an MLA row's; a Whisper layer's ring comes
    before its cross K/V, whose T frames do not count)."""
    for cache in caches:
        for t in cache_tensors(cache):
            if t.ndim >= 3:
                return max(2048, t.shape[1])
    return 2048


# ---------------------------------------------------------------- paged path


def _streams(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """(B, W) positions as ``_attn_qkv`` takes them: mrope's (3, B, W)
    equal streams by an ``expand`` (no copy), else as they are."""
    if cfg.pos == "mrope":
        return positions[None].expand(3, *positions.shape)
    return positions


def _attn_qkv(cfg: ModelConfig, p: dict, hn: torch.Tensor,
              positions: torch.Tensor):
    """q/k/v projections + qk-norm + rope / mrope.  hn (B, S, d);
    positions (B, S), or (3, B, S) for mrope."""
    b, s, _ = hn.shape
    hd = cfg.hd
    q = linear(p["wq"], hn).reshape(b, s, -1, hd)
    k = linear(p["wk"], hn).reshape(b, s, -1, hd)
    v = linear(p["wv"], hn).reshape(b, s, -1, hd)
    q, k = _qk_normalize(p, q, k)
    q, k = rotate_qk(cfg, q, k, positions)
    return q, k, v


def _attn_decode_paged(cfg: ModelConfig, p: dict, hn: torch.Tensor,
                       cache: dict, pos: torch.Tensor, active: torch.Tensor,
                       block_tables: torch.Tensor,
                       ring_cap: torch.Tensor) -> torch.Tensor:
    """An attention layer's mixer, one token per slot: this token's K/V
    into the arena in place, then the paged read over the arena."""
    b = hn.shape[0]
    q, k, v = _attn_qkv(cfg, p, hn, _streams(cfg, pos[:, None]))
    block_size = cache["k"].shape[1]
    pb, off = attnmod.paged_write_indices(pos, ring_cap, block_tables,
                                          block_size, active)
    cache["k"].index_put_((pb, off), k[:, 0].to(cache["k"].dtype))
    cache["v"].index_put_((pb, off), v[:, 0].to(cache["v"].dtype))
    out = attnmod.paged_decode_attention(q, cache["k"], cache["v"],
                                         block_tables, pos + 1, ring_cap,
                                         window=cfg.window)
    out = tpmod.gather_heads(out, cfg.n_heads)
    return linear(p["wo"], out.reshape(b, 1, -1))


def layer_decode_paged(cfg: ModelConfig, mixer: str, lp: dict,
                       h: torch.Tensor, cache: dict, pos: torch.Tensor,
                       active: torch.Tensor, block_tables: torch.Tensor,
                       ring_cap: torch.Tensor) -> torch.Tensor:
    """One layer, one token per slot.  h (S, 1, d); pos (S,) int32 the fed
    token's absolute position; active (S,) bool; block_tables (S, MB)
    int32; ring_cap (S,) int32.  An attention layer writes this token's
    K/V into the arena, an MLA layer its latents into each active slot's
    row, a recurrent layer its new state into each active slot's row (an
    inactive slot's row keeps its value), all in place."""
    hn = apply_norm(cfg.norm, h, lp["ln1"])
    if mixer == "attn":
        mix = _attn_decode_paged(cfg, lp["attn"], hn, cache, pos, active,
                                 block_tables, ring_cap)
    elif mixer == "mla":
        mix, _ = mlamod.mla_decode_paged(lp["mla"], hn, cfg.mla,
                                         cache["mla"], pos, active)
    elif mixer == "rwkv":
        mix, st = rwkvmod.time_mix_decode(lp["tm"], hn[:, 0], cache["rwkv"],
                                          n_heads=cfg.n_heads,
                                          head_dim=cfg.hd)
        mix = mix[:, None, :]
    elif mixer == "rglru":
        mix, st = rglrumod.rglru_decode(lp["rglru"], hn[:, 0],
                                        cache["rglru"])
        mix = mix[:, None, :]
        _store_masked(cache["rglru"], st, active)
    else:
        raise ValueError(mixer)
    h = h + mix.to(h.dtype)
    h2 = apply_norm(cfg.norm, h, lp["ln2"])
    if mixer == "rwkv":
        y = rwkvmod.channel_mix(lp["cm"], h2[:, 0],
                                cache["rwkv"].x_prev_cm)[:, None, :]
        _store_masked(cache["rwkv"],
                      dataclasses.replace(st, x_prev_cm=h2[:, 0]), active)
    else:
        y, _ = _ffn_apply(cfg, lp, h2)
    return h + y.to(h.dtype)


def decode_step_paged(cfg: ModelConfig, params: dict, caches: list,
                      tokens: torch.Tensor, pos: torch.Tensor,
                      active: torch.Tensor, block_tables: torch.Tensor,
                      ring_cap: torch.Tensor):
    """One decode step for the whole slot set: tokens (S, 1) -> (logits
    (S, V), caches).  Inactive slots run inert (embeddings zeroed, arena
    writes redirected to the null block, state rows kept)."""
    if cfg.enc_dec:
        raise NotImplementedError(ENC_DEC_PAGED)
    h = embed_tokens(cfg, params, tokens)
    h = torch.where(active[:, None, None], h, torch.zeros_like(h))
    for mx, lp, cache in zip(cfg.pattern, params["layers"], caches):
        h = layer_decode_paged(cfg, mx, lp, h, cache, pos, active,
                               block_tables, ring_cap)
    h = apply_norm(cfg.norm, h, params["final_norm"])
    logits = tpmod.gather_cols(linear(params["lm_head"], h), cfg.vocab)
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
    q, k, v = _attn_qkv(cfg, p, hn, _streams(cfg, positions))
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
    out = tpmod.gather_heads(out, cfg.n_heads)
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
    block).  Attention layers only: recurrent and MLA state cannot take
    back rejected tokens, so the engine bypasses speculation for them."""
    if cfg.enc_dec:
        raise NotImplementedError(ENC_DEC_PAGED)
    if any(mx != "attn" for mx in cfg.pattern):
        raise NotImplementedError(
            "speculative verify supports attention mixers only; recurrent "
            "and MLA archs bypass speculation")
    h = embed_tokens(cfg, params, tokens)
    h = torch.where(active[:, None, None], h, torch.zeros_like(h))
    wmask = write_mask & active[:, None]
    for lp, cache in zip(params["layers"], caches):
        h = layer_verify_paged(cfg, lp, h, cache, pos0, active,
                               block_tables, ring_cap, wmask)
    h = apply_norm(cfg.norm, h, params["final_norm"])
    return tpmod.gather_cols(linear(params["lm_head"], h), cfg.vocab), caches


def _slot_state(state, pos0: torch.Tensor, one: torch.Tensor):
    """Row ``one`` (a one-element int64 tensor) of a per-slot state, as a
    batch of one, zero at pos0 == 0 (a fresh request on a recycled slot)
    by a select on the card, not a host branch."""
    def row(t):
        r = t.index_select(0, one)
        return torch.where(pos0 > 0, r, torch.zeros_like(r))
    return type(state)(**{f.name: row(getattr(state, f.name))
                          for f in dataclasses.fields(state)})


def _store_row(state, new, one: torch.Tensor, live: torch.Tensor) -> None:
    """``new`` (a batch of one) into row ``one`` of a per-slot state, where
    ``live`` (0-d bool; an inert chunk keeps the row)."""
    for f in dataclasses.fields(state):
        dst = getattr(state, f.name)
        row = torch.where(live, getattr(new, f.name).to(dst.dtype),
                          dst.index_select(0, one))
        dst.index_copy_(0, one, row)


def _attn_prefill_chunk(cfg: ModelConfig, p: dict, hn: torch.Tensor,
                        cache: dict, pos0: torch.Tensor,
                        bt_row: torch.Tensor,
                        ring_cap: torch.Tensor) -> torch.Tensor:
    """An attention layer's mixer over one request's chunk: history read
    from the arena through the block-table row, then the chunk written."""
    b, c, _ = hn.shape
    chunk_pos = pos0.to(torch.int64) + torch.arange(c, dtype=torch.int64,
                                                    device=hn.device)
    q, k, v = _attn_qkv(cfg, p, hn, _streams(cfg, chunk_pos[None]))
    k_hist = attnmod.paged_gather_kv(cache["k"], bt_row[None])
    v_hist = attnmod.paged_gather_kv(cache["v"], bt_row[None])
    hist_pos = attnmod.paged_slot_positions(pos0[None], ring_cap[None],
                                            k_hist.shape[1])
    out = attnmod.paged_prefill_attention(q, k_hist, v_hist, hist_pos, k, v,
                                          chunk_pos[None], window=cfg.window)
    out = tpmod.gather_heads(out, cfg.n_heads)
    mix = linear(p["wo"], out.reshape(b, c, -1))
    block_size = cache["k"].shape[1]
    pb, off = attnmod.paged_write_indices(chunk_pos, ring_cap, bt_row,
                                          block_size)
    cache["k"].index_put_((pb, off), k[0].to(cache["k"].dtype))
    cache["v"].index_put_((pb, off), v[0].to(cache["v"].dtype))
    return mix


def layer_prefill_chunk(cfg: ModelConfig, mixer: str, lp: dict,
                        h: torch.Tensor, cache: dict, pos0: torch.Tensor,
                        bt_row: torch.Tensor, ring_cap: torch.Tensor,
                        slot: torch.Tensor | None = None,
                        active: torch.Tensor | None = None) -> torch.Tensor:
    """One layer over one request's prompt chunk h (1, C, d) starting at
    absolute position ``pos0`` (a 0-d int32 tensor, as are ``ring_cap``
    and ``slot``).  An attention layer reads history from and writes the
    chunk into the arena through the request's block-table row; MLA and
    recurrent layers read and write the request's row ``slot`` of their
    per-slot state (recurrent state starts from zeros at pos0 == 0).
    ``active`` (0-d bool, True when None) False makes the chunk inert for
    that state: its row keeps its values, as an inactive slot's does in a
    decode step (the engine warms up and captures a chunk on inert inputs
    while other requests hold their rows)."""
    hn = apply_norm(cfg.norm, h, lp["ln1"])
    one = None if slot is None else slot.to(torch.int64).reshape(1)
    if mixer != "attn" and one is None:
        raise ValueError(f"a {mixer!r} layer's prompt chunk needs its slot")
    live = (torch.ones((), dtype=torch.bool, device=h.device)
            if active is None else active.to(torch.bool))
    if mixer == "attn":
        mix = _attn_prefill_chunk(cfg, lp["attn"], hn, cache, pos0, bt_row,
                                  ring_cap)
    elif mixer == "mla":
        mix, _ = mlamod.mla_prefill_chunk(lp["mla"], hn, cfg.mla,
                                          cache["mla"], pos0, slot, live)
    elif mixer == "rwkv":
        st0 = _slot_state(cache["rwkv"], pos0, one)
        mix, s_new = rwkvmod.time_mix(lp["tm"], hn, n_heads=cfg.n_heads,
                                      head_dim=cfg.hd, return_state=True,
                                      state=st0)
    elif mixer == "rglru":
        st0 = _slot_state(cache["rglru"], pos0, one)
        mix, st = rglrumod.rglru_block(lp["rglru"], hn, return_state=True,
                                       state=st0)
        _store_row(cache["rglru"], st, one, live)
    else:
        raise ValueError(mixer)
    h = h + mix.to(h.dtype)
    h2 = apply_norm(cfg.norm, h, lp["ln2"])
    if mixer == "rwkv":
        y = rwkvmod.channel_mix(lp["cm"], h2, st0.x_prev_cm)
        _store_row(cache["rwkv"], rwkvmod.RWKVState(
            s=s_new, x_prev_tm=hn[:, -1], x_prev_cm=h2[:, -1]), one, live)
    else:
        y, _ = _ffn_apply(cfg, lp, h2)
    return h + y.to(h.dtype)


def prefill_chunk_paged(cfg: ModelConfig, params: dict, caches: list,
                        tokens: torch.Tensor, pos0: torch.Tensor,
                        bt_row: torch.Tensor, ring_cap: torch.Tensor,
                        slot: torch.Tensor | None = None,
                        active: torch.Tensor | None = None):
    """One prompt chunk for one request: tokens (1, C) starting at absolute
    position ``pos0`` -> (last-token logits (1, V), caches).  ``pos0``,
    ``ring_cap`` and ``slot`` (the request's engine slot, which MLA and
    recurrent layers need) are 0-d int32 tensors, as the reference's
    ``_chunk`` takes ``jnp.int32`` scalars, so the chunk's shapes depend
    on C alone; ``active`` as ``layer_prefill_chunk``'s."""
    if cfg.enc_dec:
        raise NotImplementedError(ENC_DEC_PAGED)
    h = embed_tokens(cfg, params, tokens)
    for mx, lp, cache in zip(cfg.pattern, params["layers"], caches):
        h = layer_prefill_chunk(cfg, mx, lp, h, cache, pos0, bt_row,
                                ring_cap, slot, active)
    h = apply_norm(cfg.norm, h, params["final_norm"])
    logits = tpmod.gather_cols(linear(params["lm_head"], h[:, -1]), cfg.vocab)
    return logits, caches

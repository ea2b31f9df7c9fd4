"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), port of
``repro/models/mla.py``.

The KV state is compressed to a per-token latent c_kv (kv_lora dims) plus a
shared rotary key (qk_rope dims).  Prefill and calibration expand K/V and
attend with qk width qk_nope + qk_rope and v width v_head
(``attention.flash_attention`` takes the two widths); decode and the
serving engine's prompt chunks use the absorbed form (W_uk folded into the
query, W_uv applied after the softmax), so the cache stays (B, cap,
kv_lora + qk_rope).  ``wkv_b`` stays dense: decode reshapes it into W_uk
and W_uv.

The reference's einsums contract against the cache in its storage dtype
with f32 results (``preferred_element_type``); here the operands are
rounded to that dtype and contracted in f32, the same products.

Caches are written in place (the lockstep decode at ``pos % cap``, the
paged decode at each active slot's position, a prompt chunk into its slot's
row), so a captured serving step keeps reading the storage it was captured
on; each function returns the cache object it was given.
"""
from __future__ import annotations

import dataclasses

import torch

from . import attention as attn
from .common import LinearCtx, apply_rope, linear, rms_norm


@dataclasses.dataclass
class MLACache:
    c_kv: torch.Tensor    # (B, cap, kv_lora)
    k_rope: torch.Tensor  # (B, cap, qk_rope)

    @staticmethod
    def init(b: int, cap: int, kv_lora: int, qk_rope: int,
             dtype=torch.float32, device=None) -> "MLACache":
        return MLACache(
            c_kv=torch.zeros((b, cap, kv_lora), dtype=dtype, device=device),
            k_rope=torch.zeros((b, cap, qk_rope), dtype=dtype, device=device))


def _project_q(p: dict, x: torch.Tensor, mcfg, positions, ctx, name):
    cq = rms_norm(linear(p["wq_a"], x, ctx, f"{name}.wq_a"), p["q_norm"])
    q = linear(p["wq_b"], cq, ctx, f"{name}.wq_b")
    b, s = x.shape[:2]
    q = q.reshape(b, s, mcfg.n_heads, mcfg.qk_nope + mcfg.qk_rope)
    q_nope, q_rope = q[..., :mcfg.qk_nope], q[..., mcfg.qk_nope:]
    q_rope = apply_rope(q_rope, positions)
    return q_nope, q_rope


def _project_kv_latent(p: dict, x: torch.Tensor, mcfg, positions, ctx, name):
    kv_a = linear(p["wkv_a"], x, ctx, f"{name}.wkv_a")
    c_kv = rms_norm(kv_a[..., :mcfg.kv_lora], p["kv_norm"])
    k_rope = kv_a[..., mcfg.kv_lora:]
    b, s = x.shape[:2]
    k_rope = apply_rope(k_rope.reshape(b, s, 1, mcfg.qk_rope),
                        positions)[:, :, 0]
    return c_kv, k_rope


def mla_full(p: dict, x: torch.Tensor, mcfg, positions: torch.Tensor,
             ctx: LinearCtx | None = None, name: str = "mla",
             return_latent: bool = False):
    """Calibration / prefill path: expand K, V, causal attention.  With
    ``return_latent`` -> (out, (c_kv, k_rope)): the latent rows a prefill
    caches, from the same ``wkv_a`` projection (the reference projects
    twice and XLA merges the two; run eagerly, that would be a second
    GEMM)."""
    b, s, _ = x.shape
    h, dn, dr, dv = mcfg.n_heads, mcfg.qk_nope, mcfg.qk_rope, mcfg.v_head
    q_nope, q_rope = _project_q(p, x, mcfg, positions, ctx, name)
    c_kv, k_rope = _project_kv_latent(p, x, mcfg, positions, ctx, name)
    kv = linear(p["wkv_b"], c_kv, ctx, f"{name}.wkv_b").reshape(b, s, h,
                                                                 dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                  dim=-1)
    out = attn.flash_attention(q, k, v, causal=True)
    out = linear(p["wo"], out.reshape(b, s, h * dv), ctx, f"{name}.wo")
    return (out, (c_kv, k_rope)) if return_latent else out


def _f32(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to the cache's dtype, as an f32 operand."""
    return x.to(dtype).to(torch.float32)


def _absorbed(p: dict, mcfg, q_nope: torch.Tensor, q_rope: torch.Tensor,
              c_kv: torch.Tensor, k_rope: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Absorbed attention of queries q_nope (..., h, dn), q_rope (..., h,
    dr) over latent rows c_kv (B, L, kv_lora), k_rope (B, L, dr); ``valid``
    broadcasts against the scores (B, ..., h, L).  -> (..., h, dv) f32."""
    h, dn, dr, dv = mcfg.n_heads, mcfg.qk_nope, mcfg.qk_rope, mcfg.v_head
    cd = c_kv.dtype
    w_b = p["wkv_b"].reshape(mcfg.kv_lora, h, dn + dv)
    w_uk, w_uv = _f32(w_b[..., :dn], cd), _f32(w_b[..., dn:], cd)
    c = c_kv.to(torch.float32)
    kr = k_rope.to(torch.float32)
    qc = torch.einsum("b...hd,lhd->b...hl", _f32(q_nope, cd), w_uk)
    s = torch.einsum("b...hl,bsl->b...hs", _f32(qc, cd), c)
    s = s + torch.einsum("b...hr,bsr->b...hs", _f32(q_rope, cd), kr)
    s = s * (dn + dr) ** -0.5
    s = torch.where(valid, s, torch.full_like(s, attn.NEG_INF))
    probs = torch.softmax(s, dim=-1)
    ctx_c = torch.einsum("b...hs,bsl->b...hl", _f32(probs, cd), c)
    return torch.einsum("b...hl,lhd->b...hd", _f32(ctx_c, cd), w_uv)


def mla_decode(p: dict, x: torch.Tensor, mcfg, cache: MLACache,
               pos: torch.Tensor, ctx: LinearCtx | None = None,
               name: str = "mla"):
    """Lockstep absorbed decode: x (B, 1, d) at position ``pos`` (a
    one-element int tensor); the token's latents go into slot pos % cap in
    place.  -> (out (B, 1, d), cache)."""
    b = x.shape[0]
    h, dv = mcfg.n_heads, mcfg.v_head
    positions = pos.reshape(1, 1).expand(b, 1).to(torch.int32)
    q_nope, q_rope = _project_q(p, x, mcfg, positions, ctx, name)
    c_new, kr_new = _project_kv_latent(p, x, mcfg, positions, ctx, name)
    cap = cache.c_kv.shape[1]
    slot = pos.reshape(1).to(torch.int64) % cap
    cache.c_kv.index_copy_(1, slot, c_new.to(cache.c_kv.dtype))
    cache.k_rope.index_copy_(1, slot, kr_new.to(cache.k_rope.dtype))
    live = torch.minimum(pos.reshape(1).to(torch.int64) + 1,
                         torch.full_like(slot, cap))
    valid = torch.arange(cap, device=x.device)[None, None, :] < live
    out = _absorbed(p, mcfg, q_nope[:, 0], q_rope[:, 0], cache.c_kv,
                    cache.k_rope, valid)
    out = out.reshape(b, 1, h * dv).to(x.dtype)
    return linear(p["wo"], out, ctx, f"{name}.wo"), cache


def mla_decode_paged(p: dict, x: torch.Tensor, mcfg, cache: MLACache,
                     pos: torch.Tensor, active: torch.Tensor,
                     ctx: LinearCtx | None = None, name: str = "mla"):
    """Slot-indexed absorbed decode for the paged engine.  ``cache`` holds
    one row per engine slot (S, cap, ...), linear layout; ``pos`` (S,) is
    each slot's token count before this step; an inactive slot's write
    rewrites its row's current value, so the step keeps a fixed slot count
    while the batch churns.  -> (out (S, 1, d), cache)."""
    b = x.shape[0]
    h, dv = mcfg.n_heads, mcfg.v_head
    positions = pos[:, None].to(torch.int32)
    q_nope, q_rope = _project_q(p, x, mcfg, positions, ctx, name)
    c_new, kr_new = _project_kv_latent(p, x, mcfg, positions, ctx, name)
    cap = cache.c_kv.shape[1]
    rows = torch.arange(b, device=x.device)
    slot_pos = torch.clamp(pos.to(torch.int64), max=cap - 1)
    for arena, new in ((cache.c_kv, c_new), (cache.k_rope, kr_new)):
        old = arena[rows, slot_pos]
        arena.index_put_((rows, slot_pos),
                         torch.where(active[:, None], new[:, 0].to(
                             arena.dtype), old))
    live = torch.clamp(pos.to(torch.int64) + 1, max=cap)
    valid = (torch.arange(cap, device=x.device)[None, :]
             < live[:, None])[:, None, :]                    # (S, 1, cap)
    out = _absorbed(p, mcfg, q_nope[:, 0], q_rope[:, 0], cache.c_kv,
                    cache.k_rope, valid)
    out = out.reshape(b, 1, h * dv).to(x.dtype)
    return linear(p["wo"], out, ctx, f"{name}.wo"), cache


def mla_prefill_chunk(p: dict, x: torch.Tensor, mcfg, cache: MLACache,
                      pos0: torch.Tensor, slot: torch.Tensor,
                      active: torch.Tensor | None = None,
                      ctx: LinearCtx | None = None, name: str = "mla"):
    """Chunked-prefill continuation for one engine slot, absorbed form.
    x (1, C, d) is the prompt chunk from absolute position ``pos0`` (0-d
    int tensor); its latents are written into row ``slot`` (0-d) at
    positions pos0.. (the start clamped to cap - C, as the reference's
    ``dynamic_update_slice``), and the chunk attends causally over the row
    up to itself; ``active`` (0-d bool) False keeps the row's values (an
    inert chunk).  -> (out (1, C, d), cache)."""
    b, c, _ = x.shape
    h, dv = mcfg.n_heads, mcfg.v_head
    dev = x.device
    positions = (pos0.to(torch.int64) + torch.arange(c, device=dev))[None]
    q_nope, q_rope = _project_q(p, x, mcfg, positions, ctx, name)
    c_new, kr_new = _project_kv_latent(p, x, mcfg, positions, ctx, name)
    cap = cache.c_kv.shape[1]
    start = torch.clamp(pos0.to(torch.int64), 0, cap - c)
    idx = start + torch.arange(c, device=dev)
    rows = slot.to(torch.int64).reshape(1).expand(c)
    for arena, new in ((cache.c_kv, c_new), (cache.k_rope, kr_new)):
        new = new[0].to(arena.dtype)
        if active is not None:
            new = torch.where(active, new, arena[rows, idx])
        arena.index_put_((rows, idx), new)
    one = slot.to(torch.int64).reshape(1)
    row_c = cache.c_kv.index_select(0, one)                    # (1, cap, l)
    row_kr = cache.k_rope.index_select(0, one)
    valid = (torch.arange(cap, device=dev)[None, None, :]
             <= positions[..., None])[:, :, None, :]           # (1, C, 1, cap)
    out = _absorbed(p, mcfg, q_nope, q_rope, row_c, row_kr, valid)
    out = out.reshape(b, c, h * dv).to(x.dtype)
    return linear(p["wo"], out, ctx, f"{name}.wo"), cache

"""Parameter init, the sequence-mode forward and loss, and the layer blocks
the serving path needs.

Port of the parts of ``repro/models/transformer.py`` that decode and
calibration use: ``init_params`` for attention decoders with GLU/GELU or
MoE FFNs, ``embed_tokens``, ``_qk_normalize``, ``_ffn_apply`` (returning
the FFN output and the MoE aux loss), and the unrolled ``forward`` /
``loss_fn`` with their ``LinearCtx`` taps (layer names ``L{i}``, so tap
names equal the reference's: ``L3.attn.wq``, ``L3.mlp.wi``,
``L3.moe.wi``, ..., ``lm_head``).

Param layout (the reference's, with the layers unrolled):

  params = {"embed": (V, d), "layers": [layer_0, ..., layer_{L-1}],
            "final_norm": {...}, "lm_head": (d, V)}

PyTorch runs eagerly, so there is no scan and no stacked layer axis:
``layers`` is a list of per-layer dicts whether the model is fp or
quantized (``bridge.py`` unrolls the reference's stacked trees).
Weights come from a ``torch.Generator``; they differ from the reference's
``jax.random`` draws, so parity tests carry weights across instead.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import resolve_device

from . import attention as attnmod
from . import ffn as ffnmod
from . import moe as moemod
from .common import (LinearCtx, apply_norm, apply_rope, cross_entropy,
                     dense_init, linear, norm_params, rms_norm)
from .config import ModelConfig


def _init_attn(cfg: ModelConfig, gen, device, dtype) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    p = {"wq": dense_init(gen, d, h * hd, device, dtype),
         "wk": dense_init(gen, d, kv * hd, device, dtype),
         "wv": dense_init(gen, d, kv * hd, device, dtype),
         "wo": dense_init(gen, h * hd, d, device, dtype,
                          scale=(h * hd) ** -0.5)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
    return p


def _init_ffn(cfg: ModelConfig, gen, device, dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    width = f if cfg.ffn_kind() == "gelu" else 2 * f
    return {"wi": dense_init(gen, d, width, device, dtype),
            "wo": dense_init(gen, f, d, device, dtype, scale=f ** -0.5)}


def _init_moe(cfg: ModelConfig, gen, device, dtype) -> dict:
    mo = cfg.moe
    d, fe = cfg.d_model, mo.d_ff_expert

    def experts(d_in, d_out):
        w = torch.randn((mo.n_experts, d_in, d_out), generator=gen,
                        device=device, dtype=torch.float32)
        return w.mul_(d_in ** -0.5).to(dtype)     # 3.8 GB at full width
    return {"router": dense_init(gen, d, mo.n_experts, device),
            "wi": experts(d, 2 * fe),
            "wo": experts(fe, d)}


def check_supported(cfg: ModelConfig) -> None:
    """The port serves attention decoders with GLU/GELU or (unshared) MoE
    FFNs and RoPE so far."""
    if (cfg.enc_dec or any(mx != "attn" for mx in cfg.pattern)
            or cfg.ffn_kind() not in ("glu", "gelu", "moe")
            or (cfg.moe is not None and cfg.moe.n_shared)
            or cfg.pos not in ("rope", "none")):
        raise NotImplementedError(
            f"{cfg.name}: the port supports attention decoders with GLU/GELU "
            "or MoE FFNs and RoPE so far (ROADMAP Queue 1)")


def init_layer(cfg: ModelConfig, generator: torch.Generator, device,
               dtype=torch.float32) -> dict:
    """One decoder layer's params, drawn from ``generator`` on ``device``."""
    p = {"ln1": norm_params(cfg.norm, cfg.d_model, device),
         "ln2": norm_params(cfg.norm, cfg.d_model, device),
         "attn": _init_attn(cfg, generator, device, dtype)}
    if cfg.ffn_kind() == "moe":
        p["moe"] = _init_moe(cfg, generator, device, dtype)
    else:
        p["mlp"] = _init_ffn(cfg, generator, device, dtype)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, dtype=torch.float32) -> dict:
    """Random-init params on ``device`` (CUDA unless ``"cpu"``), drawn from
    ``generator`` (a fresh one seeded 0 on that device if None)."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    layers = [init_layer(cfg, generator, dev, dtype)
              for _ in range(cfg.n_layers)]
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                        device=dev, dtype=torch.float32) * 0.02
    params: dict[str, Any] = {
        "embed": embed.to(dtype),
        "layers": layers,
        "final_norm": norm_params(cfg.norm, cfg.d_model, dev),
        "lm_head": dense_init(generator, cfg.d_model, cfg.vocab, dev, dtype),
    }
    return params


def _qk_normalize(p: dict, q, k):
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k


def embed_tokens(cfg: ModelConfig, params: dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.to(torch.int64)]


def _ffn_apply(cfg: ModelConfig, lp: dict, h2: torch.Tensor,
               ctx: LinearCtx | None = None, name: str = "layer"):
    """The layer's FFN -> (y, aux); aux is the MoE load-balance loss (0.0
    for dense FFNs)."""
    fk = cfg.ffn_kind()
    if fk == "moe":
        return moemod.moe_ffn(lp["moe"], h2, n_experts=cfg.moe.n_experts,
                              top_k=cfg.moe.top_k,
                              capacity_factor=cfg.moe.capacity_factor,
                              act=cfg.act, ctx=ctx, name=f"{name}.moe")
    if fk == "gelu":
        return ffnmod.gelu_ffn(lp["mlp"], h2, ctx, f"{name}.mlp"), 0.0
    return ffnmod.glu_ffn(lp["mlp"], h2, act=cfg.act, ctx=ctx,
                          name=f"{name}.mlp"), 0.0


def _attn_seq(cfg: ModelConfig, p: dict, x: torch.Tensor,
              positions: torch.Tensor, ctx, name: str) -> torch.Tensor:
    """Self-attention over a whole sequence x (B, S, d)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = linear(p["wq"], x, ctx, f"{name}.wq").reshape(b, s, h, hd)
    k = linear(p["wk"], x, ctx, f"{name}.wk").reshape(b, s, kv, hd)
    v = linear(p["wv"], x, ctx, f"{name}.wv").reshape(b, s, kv, hd)
    q, k = _qk_normalize(p, q, k)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = attnmod.flash_attention(q, k, v, window=cfg.window)
    return linear(p["wo"], out.reshape(b, s, h * hd), ctx, f"{name}.wo")


def layer_seq(cfg: ModelConfig, lp: dict, h: torch.Tensor,
              positions: torch.Tensor, ctx=None, name: str = "layer"):
    """One attention layer in sequence mode (the reference's ``layer_seq``
    for the ``attn`` mixer) -> (h, aux_loss)."""
    hn = apply_norm(cfg.norm, h, lp["ln1"])
    mix = _attn_seq(cfg, lp["attn"], hn, positions, ctx, f"{name}.attn")
    h = h + mix.to(h.dtype)
    h2 = apply_norm(cfg.norm, h, lp["ln2"])
    y, aux = _ffn_apply(cfg, lp, h2, ctx, name)
    return h + y.to(h.dtype), aux


def _default_positions(cfg: ModelConfig, b: int, s: int, device,
                       offset: int = 0) -> torch.Tensor:
    pos = offset + torch.arange(s, dtype=torch.int32, device=device)[None, :]
    return pos.expand(b, s)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            ctx: Optional[LinearCtx] = None):
    """Sequence-mode forward, layers unrolled -> (logits (B, S, V), aux)."""
    h = embed_tokens(cfg, params, tokens)
    b, s, _ = h.shape
    positions = _default_positions(cfg, b, s, h.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, lp in enumerate(params["layers"]):
        h, aux = layer_seq(cfg, lp, h, positions, ctx, f"L{i}")
        aux_total = aux_total + aux
    h = apply_norm(cfg.norm, h, params["final_norm"])
    return linear(params["lm_head"], h, ctx, "lm_head"), aux_total


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            ctx: Optional[LinearCtx] = None) -> torch.Tensor:
    """Mean next-token NLL (+ the MoE aux loss, which calibration
    differentiates through too).  batch: tokens (B, S+1) [, mask (B, S)]."""
    tokens = batch["tokens"]
    logits, aux = forward(cfg, params, tokens[:, :-1], ctx=ctx)
    loss = cross_entropy(logits, tokens[:, 1:], batch.get("mask"))
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_coef * aux
    return loss

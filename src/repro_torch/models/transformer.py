"""Parameter init, the sequence-mode forward and loss, and the layer blocks
the serving path needs.

Port of the parts of ``repro/models/transformer.py`` that decode and
calibration use: ``init_params`` for dense attention decoders with GLU/GELU
FFNs, ``embed_tokens``, ``_qk_normalize``, ``_ffn_apply``, and the
unrolled ``forward`` / ``loss_fn`` with their ``LinearCtx`` taps (layer
names ``L{i}``, so tap names equal the reference's: ``L3.attn.wq``,
``L3.mlp.wi``, ..., ``lm_head``).

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


def check_supported(cfg: ModelConfig) -> None:
    """The port serves dense attention decoders with GLU/GELU FFNs so far."""
    if (cfg.enc_dec or any(mx != "attn" for mx in cfg.pattern)
            or cfg.ffn_kind() not in ("glu", "gelu") or cfg.pos not in
            ("rope", "none")):
        raise NotImplementedError(
            f"{cfg.name}: the port supports dense attention decoders with "
            "GLU/GELU FFNs and RoPE so far (ROADMAP Queue 1)")


def init_layer(cfg: ModelConfig, generator: torch.Generator, device,
               dtype=torch.float32) -> dict:
    """One decoder layer's params, drawn from ``generator`` on ``device``."""
    return {"ln1": norm_params(cfg.norm, cfg.d_model, device),
            "ln2": norm_params(cfg.norm, cfg.d_model, device),
            "attn": _init_attn(cfg, generator, device, dtype),
            "mlp": _init_ffn(cfg, generator, device, dtype)}


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
               ctx: LinearCtx | None = None,
               name: str = "layer") -> torch.Tensor:
    if cfg.ffn_kind() == "gelu":
        return ffnmod.gelu_ffn(lp["mlp"], h2, ctx, f"{name}.mlp")
    return ffnmod.glu_ffn(lp["mlp"], h2, act=cfg.act, ctx=ctx,
                          name=f"{name}.mlp")


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
              positions: torch.Tensor, ctx=None,
              name: str = "layer") -> torch.Tensor:
    """One attention layer in sequence mode (the reference's ``layer_seq``
    for the ``attn`` mixer; no MoE, so no aux loss)."""
    hn = apply_norm(cfg.norm, h, lp["ln1"])
    mix = _attn_seq(cfg, lp["attn"], hn, positions, ctx, f"{name}.attn")
    h = h + mix.to(h.dtype)
    h2 = apply_norm(cfg.norm, h, lp["ln2"])
    return h + _ffn_apply(cfg, lp, h2, ctx, name).to(h.dtype)


def _default_positions(cfg: ModelConfig, b: int, s: int, device,
                       offset: int = 0) -> torch.Tensor:
    pos = offset + torch.arange(s, dtype=torch.int32, device=device)[None, :]
    return pos.expand(b, s)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            ctx: Optional[LinearCtx] = None) -> torch.Tensor:
    """Sequence-mode forward, layers unrolled -> logits (B, S, V)."""
    h = embed_tokens(cfg, params, tokens)
    b, s, _ = h.shape
    positions = _default_positions(cfg, b, s, h.device)
    for i, lp in enumerate(params["layers"]):
        h = layer_seq(cfg, lp, h, positions, ctx, f"L{i}")
    h = apply_norm(cfg.norm, h, params["final_norm"])
    return linear(params["lm_head"], h, ctx, "lm_head")


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            ctx: Optional[LinearCtx] = None) -> torch.Tensor:
    """Mean next-token NLL.  batch: tokens (B, S+1) [, mask (B, S)]."""
    tokens = batch["tokens"]
    logits = forward(cfg, params, tokens[:, :-1], ctx=ctx)
    return cross_entropy(logits, tokens[:, 1:], batch.get("mask"))

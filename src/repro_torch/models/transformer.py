"""Parameter init and the layer blocks the serving path needs.

Port of the parts of ``repro/models/transformer.py`` that decode uses:
``init_params`` for dense attention decoders with GLU/GELU FFNs,
``embed_tokens``, ``_qk_normalize`` and ``_ffn_apply``.

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

from typing import Any

import torch

from repro_torch import resolve_device

from . import ffn as ffnmod
from .common import dense_init, norm_params, rms_norm
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


def _ffn_apply(cfg: ModelConfig, lp: dict, h2: torch.Tensor) -> torch.Tensor:
    if cfg.ffn_kind() == "gelu":
        return ffnmod.gelu_ffn(lp["mlp"], h2)
    return ffnmod.glu_ffn(lp["mlp"], h2, act=cfg.act)

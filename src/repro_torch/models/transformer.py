"""Parameter init, the sequence-mode forward and loss, and the layer blocks
the serving path needs.

Port of ``repro/models/transformer.py`` for every family of the
reference's registry: ``init_params`` for attention (GQA), MLA, RWKV6 and
RG-LRU mixers with GLU/GELU, MoE (with DeepSeek-V2's shared experts) or
RWKV channel-mix FFNs, Whisper's encoder stack and its decoder layers'
cross-attention (``ln_x`` / ``xattn``, no qk-norm); ``embed_tokens``,
``_qk_normalize``, ``_ffn_apply`` (returning the FFN output and the MoE
aux loss), ``layer_seq`` per mixer, ``encode`` (non-causal, sinusoidal
positions, ``enc_norm``), and the unrolled ``forward`` / ``loss_fn`` with
their ``LinearCtx`` taps (layer names ``L{i}`` and ``enc{i}``, so tap
names equal the reference's: ``L3.attn.wq``, ``L3.xattn.wk``,
``enc5.mlp.wi``, ``L3.mla.wq_a``, ``L3.tm.wr``, ``L3.rglru.wi``,
``L3.moe.swi``, ..., ``lm_head``).  Positions are (B, S), or (3, B, S)
for mrope (Qwen2-VL's temporal / height / width streams, which the vision
stub would emit); Whisper adds a sinusoidal table to its decoder and
encoder inputs instead.

Param layout (the reference's, with the layers unrolled):

  params = {"embed": (V, d), "layers": [layer_0, ..., layer_{L-1}],
            ["enc_layers": [enc_0, ..., enc_{E-1}], "enc_norm": {...},]
            "final_norm": {...}, "lm_head": (d, V)}

PyTorch runs eagerly, so there is no scan and no stacked layer axis:
``layers`` (and Whisper's ``enc_layers``) is a list of per-layer dicts in
execution order, whether the model is fp or quantized, and layer i's mixer
is ``cfg.pattern[i]`` (``bridge.py`` unrolls the reference's stacked
trees, period by period).
Weights come from a ``torch.Generator``; they differ from the reference's
``jax.random`` draws, so parity tests carry weights across instead.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.runtime import tp as tpmod
from repro_torch.runtime.sharding import gathered

from . import attention as attnmod
from . import ffn as ffnmod
from . import mla as mlamod
from . import moe as moemod
from . import rglru as rglrumod
from . import rwkv6 as rwkvmod
from .common import (LinearCtx, apply_mrope, apply_norm, apply_rope,
                     dense_init, linear, mean_nll, norm_params, rms_norm,
                     sinusoidal_positions, token_nll)
from .config import ModelConfig


def _init_attn(cfg: ModelConfig, gen, device, dtype,
               cross: bool = False) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    p = {"wq": dense_init(gen, d, h * hd, device, dtype),
         "wk": dense_init(gen, d, kv * hd, device, dtype),
         "wv": dense_init(gen, d, kv * hd, device, dtype),
         "wo": dense_init(gen, h * hd, d, device, dtype,
                          scale=(h * hd) ** -0.5)}
    if cfg.qk_norm and not cross:
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
    p = {"router": dense_init(gen, d, mo.n_experts, device),
         "wi": experts(d, 2 * fe),
         "wo": experts(fe, d)}
    if mo.n_shared:
        fs = fe * mo.n_shared
        p["swi"] = dense_init(gen, d, 2 * fs, device, dtype)
        p["swo"] = dense_init(gen, fs, d, device, dtype, scale=fs ** -0.5)
    return p


def _randn(gen, shape, device, scale: float, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * scale).to(dtype)


def _const(shape, value: float, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=torch.float32, device=device)


def _init_mla(cfg: ModelConfig, gen, device, dtype) -> dict:
    m, d = cfg.mla, cfg.d_model
    return {
        "wq_a": dense_init(gen, d, m.q_lora, device, dtype),
        "q_norm": _const((m.q_lora,), 1.0, device),
        "wq_b": dense_init(gen, m.q_lora,
                           m.n_heads * (m.qk_nope + m.qk_rope), device, dtype),
        "wkv_a": dense_init(gen, d, m.kv_lora + m.qk_rope, device, dtype),
        "kv_norm": _const((m.kv_lora,), 1.0, device),
        "wkv_b": dense_init(gen, m.kv_lora, m.n_heads * (m.qk_nope + m.v_head),
                            device, dtype),
        "wo": dense_init(gen, m.n_heads * m.v_head, d, device, dtype,
                         scale=(m.n_heads * m.v_head) ** -0.5),
    }


def _init_rwkv_tm(cfg: ModelConfig, gen, device, dtype) -> dict:
    d, h, dk = cfg.d_model, cfg.n_heads, cfg.hd
    lr = rwkvmod.LORA_R
    return {
        "mu_x": _const((d,), 0.5, device),
        "mu_rkvwg": _const((5, d), 0.5, device),
        "tm_w1": dense_init(gen, d, 5 * lr, device, dtype, scale=1e-2),
        "tm_w2": _randn(gen, (5, lr, d), device, 1e-2, dtype),
        "w0": _const((d,), 0.0, device),
        "dw_a": dense_init(gen, d, rwkvmod.DECAY_R, device, dtype, scale=1e-2),
        "dw_b": dense_init(gen, rwkvmod.DECAY_R, d, device, dtype, scale=1e-2),
        "u": _const((h, dk), 0.0, device),
        "ln_x": _const((d,), 1.0, device),
        "wr": dense_init(gen, d, d, device, dtype),
        "wk": dense_init(gen, d, d, device, dtype),
        "wv": dense_init(gen, d, d, device, dtype),
        "wg": dense_init(gen, d, d, device, dtype),
        "wo": dense_init(gen, d, d, device, dtype),
    }


def _init_rwkv_cm(cfg: ModelConfig, gen, device, dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"mu_k": _const((d,), 0.5, device),
            "mu_r": _const((d,), 0.5, device),
            "ck": dense_init(gen, d, f, device, dtype),
            "cv": dense_init(gen, f, d, device, dtype, scale=f ** -0.5),
            "cr": dense_init(gen, d, d, device, dtype)}


def _init_rglru(cfg: ModelConfig, gen, device, dtype) -> dict:
    d = cfg.d_model
    dr = cfg.rglru_width or d
    nb = cfg.n_heads
    bs = dr // nb
    return {
        "wg": dense_init(gen, d, dr, device, dtype),
        "wi": dense_init(gen, d, dr, device, dtype),
        "conv_w": _randn(gen, (rglrumod.CONV_WIDTH, dr), device, 0.1, dtype),
        "conv_b": _const((dr,), 0.0, device),
        "wa": _randn(gen, (nb, bs, bs), device, bs ** -0.5, dtype),
        "ba": _const((dr,), 2.0, device),     # bias toward remembering
        "bx": _const((dr,), 0.0, device),
        "wx": _randn(gen, (nb, bs, bs), device, bs ** -0.5, dtype),
        "lambda": torch.linspace(2.0, 5.0, dr, dtype=torch.float32,
                                 device=device),
        "wo": dense_init(gen, dr, d, device, dtype, scale=dr ** -0.5),
    }


_MIXER_INIT = {"attn": ("attn", _init_attn), "mla": ("mla", _init_mla),
               "rwkv": ("tm", _init_rwkv_tm), "rglru": ("rglru", _init_rglru)}


def init_layer(cfg: ModelConfig, generator: torch.Generator, device,
               dtype=torch.float32, mixer: str = "attn",
               cross: bool = False) -> dict:
    """One layer's params for ``mixer``, drawn from ``generator`` on
    ``device``; ``cross`` adds a decoder layer's cross-attention block
    (``ln_x``, ``xattn``)."""
    key, init = _MIXER_INIT[mixer]
    p = {"ln1": norm_params(cfg.norm, cfg.d_model, device),
         "ln2": norm_params(cfg.norm, cfg.d_model, device),
         key: init(cfg, generator, device, dtype)}
    fk = cfg.ffn_kind()
    if fk == "moe":
        p["moe"] = _init_moe(cfg, generator, device, dtype)
    elif fk == "cm":
        p["cm"] = _init_rwkv_cm(cfg, generator, device, dtype)
    else:
        p["mlp"] = _init_ffn(cfg, generator, device, dtype)
    if cross:
        p["ln_x"] = norm_params(cfg.norm, cfg.d_model, device)
        p["xattn"] = _init_attn(cfg, generator, device, dtype, cross=True)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, dtype=torch.float32) -> dict:
    """Random-init params on ``device`` (CUDA unless ``"cpu"``), drawn from
    ``generator`` (a fresh one seeded 0 on that device if None)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    layers = [init_layer(cfg, generator, dev, dtype, mixer,
                         cross=cfg.enc_dec) for mixer in cfg.pattern]
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                        device=dev, dtype=torch.float32) * 0.02
    params: dict[str, Any] = {
        "embed": embed.to(dtype),
        "layers": layers,
        "final_norm": norm_params(cfg.norm, cfg.d_model, dev),
        "lm_head": dense_init(generator, cfg.d_model, cfg.vocab, dev, dtype),
    }
    if cfg.enc_dec:
        params["enc_layers"] = [init_layer(cfg, generator, dev, dtype)
                                for _ in range(cfg.n_enc_layers)]
        params["enc_norm"] = norm_params(cfg.norm, cfg.d_model, dev)
    return params


def _qk_normalize(p: dict, q, k, sliced: bool = False):
    """Per-head q/k RMS norms; ``sliced``: q and k hold a model-parallel
    rank's heads, so the shared scales' gradients are summed over the
    ranks."""
    if "q_norm" in p:
        qs, ks = p["q_norm"], p["k_norm"]
        if sliced:
            qs, ks = tpmod.copy_to_model(qs), tpmod.copy_to_model(ks)
        q = rms_norm(q, qs)
        k = rms_norm(k, ks)
    return q, k


def embed_tokens(cfg: ModelConfig, params: dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    return gathered(params["embed"])[tokens.to(torch.int64)]


def _ffn_apply(cfg: ModelConfig, lp: dict, h2: torch.Tensor,
               ctx: LinearCtx | None = None, name: str = "layer"):
    """The layer's FFN -> (y, aux); aux is the MoE load-balance loss (0.0
    for the others).  RWKV's channel mix here is the sequence form with a
    zero shift register (the serving paths carry theirs)."""
    fk = cfg.ffn_kind()
    # model-parallel training slices the FFN's wo by input row
    row = fk in ("glu", "gelu") and tpmod.model_sliced(
        lp["mlp"]["wo"], cfg.d_ff, axis=0)
    if fk == "moe":
        mo, mp = cfg.moe, lp["moe"]
        # model-parallel training: experts whole over the ranks or sliced
        # within each, the shared experts by column and row
        experts = (tpmod.model_sliced(mp["wo"], mo.n_experts, axis=0)
                   or tpmod.model_sliced(mp["wo"], mo.d_ff_expert, axis=1))
        shared = "swo" in mp and tpmod.model_sliced(
            mp["swo"], mo.d_ff_expert * mo.n_shared, axis=0)
        return moemod.moe_ffn(mp, h2, n_experts=mo.n_experts,
                              top_k=mo.top_k,
                              capacity_factor=mo.capacity_factor,
                              act=cfg.act, ctx=ctx, name=f"{name}.moe",
                              experts_sliced=experts, shared_sliced=shared)
    if fk == "cm":
        return rwkvmod.channel_mix(lp["cm"], h2, None, ctx, f"{name}.cm"), 0.0
    if fk == "gelu":
        return ffnmod.gelu_ffn(lp["mlp"], h2, ctx, f"{name}.mlp",
                               row_parallel=row), 0.0
    return ffnmod.glu_ffn(lp["mlp"], h2, act=cfg.act, ctx=ctx,
                          name=f"{name}.mlp", row_parallel=row), 0.0


def rotate_qk(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
              positions: torch.Tensor):
    """RoPE on (B, S) positions or mrope on (3, B, S); other position
    kinds leave q and k as they are."""
    if cfg.pos == "rope":
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    if cfg.pos == "mrope":
        return (apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta),
                apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta))
    return q, k


def _attn_seq(cfg: ModelConfig, p: dict, x: torch.Tensor, positions, ctx,
              name: str, *, causal: bool = True, window: int | None = None,
              kv_src: torch.Tensor | None = None,
              use_rope: bool = True) -> torch.Tensor:
    """Attention over a whole sequence x (B, S, d): self-attention, or
    cross-attention over ``kv_src`` (B, T, d) (non-causal, no rotation).
    Under model-parallel training (``wo`` sliced by input row) the rank
    runs its own heads and all-reduces ``wo``'s partial sums."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    row = tpmod.model_sliced(p["wo"], h * hd, axis=0)
    if row:
        x = tpmod.copy_to_model(x)
        h, kv = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    src = x if kv_src is None else kv_src
    sk = src.shape[1]
    q = linear(p["wq"], x, ctx, f"{name}.wq").reshape(b, s, h, hd)
    k = linear(p["wk"], src, ctx, f"{name}.wk").reshape(b, sk, kv, hd)
    v = linear(p["wv"], src, ctx, f"{name}.wv").reshape(b, sk, kv, hd)
    q, k = _qk_normalize(p, q, k, row)
    if use_rope:
        q, k = rotate_qk(cfg, q, k, positions)
    out = attnmod.flash_attention(q, k, v, causal=causal, window=window)
    y = linear(p["wo"], out.reshape(b, s, h * hd), ctx, f"{name}.wo")
    return tpmod.reduce_from_model(y) if row else y


def layer_seq(cfg: ModelConfig, mixer: str, lp: dict, h: torch.Tensor,
              positions, ctx=None, name: str = "layer",
              encoder_out: torch.Tensor | None = None, causal: bool = True):
    """One layer in sequence mode (the reference's ``layer_seq``) ->
    (h, aux_loss).  ``causal=False``: an encoder layer (no window);
    ``encoder_out``: a decoder layer's cross-attention source.  ``lp`` may
    be a ZeRO unit (``runtime/sharding.py``), gathered here, inside the
    layer's checkpoint region."""
    lp = gathered(lp)
    hn = apply_norm(cfg.norm, h, lp["ln1"])
    if mixer == "attn":
        mix = _attn_seq(cfg, lp["attn"], hn, positions, ctx, f"{name}.attn",
                        causal=causal, window=cfg.window if causal else None)
    elif mixer == "mla":
        mix = mlamod.mla_full(lp["mla"], hn, cfg.mla, positions, ctx,
                              f"{name}.mla")
    elif mixer == "rwkv":
        mix = rwkvmod.time_mix(lp["tm"], hn, n_heads=cfg.n_heads,
                               head_dim=cfg.hd, ctx=ctx, name=f"{name}.tm")
    elif mixer == "rglru":
        mix = rglrumod.rglru_block(lp["rglru"], hn, ctx, f"{name}.rglru")
    else:
        raise ValueError(mixer)
    h = h + mix.to(h.dtype)
    if encoder_out is not None:
        hx = apply_norm(cfg.norm, h, lp["ln_x"])
        h = h + _attn_seq(cfg, lp["xattn"], hx, None, ctx, f"{name}.xattn",
                          causal=False, kv_src=encoder_out, use_rope=False)
    h2 = apply_norm(cfg.norm, h, lp["ln2"])
    y, aux = _ffn_apply(cfg, lp, h2, ctx, name)
    return h + y.to(h.dtype), aux


def _default_positions(cfg: ModelConfig, b: int, s: int, device,
                       offset: int = 0) -> torch.Tensor:
    """0..S-1 from ``offset``: (B, S), or (3, B, S) for mrope (the three
    streams equal, as text tokens' are)."""
    pos = offset + torch.arange(s, dtype=torch.int32, device=device)[None, :]
    if cfg.pos == "mrope":
        return pos[None].expand(3, b, s)
    return pos.expand(b, s)


def _scoped_layer(groups, *args):
    with tpmod.scope(*groups):
        return layer_seq(*args)


def _layer(remat: bool, *args):
    """``layer_seq(*args)``, under ``torch.utils.checkpoint`` with
    ``remat``.  The recompute runs in autograd's device thread on the
    card, which does not see this thread's TP scope, so the scope's model
    and data groups go in as an argument."""
    if remat:
        return torch.utils.checkpoint.checkpoint(
            _scoped_layer,
            (tpmod.current_group(), tpmod.current_data_group()), *args,
            use_reentrant=False)
    return layer_seq(*args)


def encode(cfg: ModelConfig, params: dict, enc_embeds: torch.Tensor,
           ctx: Optional[LinearCtx] = None,
           remat: bool = False) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings (B, T, d): the
    sinusoidal table added, ``enc_layers`` non-causal (taps ``enc{i}``),
    then ``enc_norm``."""
    _, t, d = enc_embeds.shape
    h = enc_embeds + sinusoidal_positions(t, d, enc_embeds.device).to(
        enc_embeds.dtype)[None]
    for i, lp in enumerate(params["enc_layers"]):
        h, _ = _layer(remat, cfg, "attn", lp, h, None, ctx, f"enc{i}", None,
                      False)
    return apply_norm(cfg.norm, h, params["enc_norm"])


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            positions: torch.Tensor | None = None,
            encoder_out: torch.Tensor | None = None,
            enc_embeds: torch.Tensor | None = None,
            ctx: Optional[LinearCtx] = None, remat: bool = False):
    """Sequence-mode forward, layers unrolled -> (logits (B, S, V), aux).

    ``positions``: (B, S), or (3, B, S) for mrope (default 0..S-1).  An
    encoder-decoder model takes ``encoder_out`` or encodes ``enc_embeds``.
    ``remat``: each layer under ``torch.utils.checkpoint`` (non-reentrant),
    so its activations are recomputed in the backward instead of kept; the
    numbers do not change."""
    h = embed_tokens(cfg, params, tokens)
    b, s, d = h.shape
    if cfg.enc_dec and encoder_out is None:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name} needs encoder frames (enc_embeds)")
        encoder_out = encode(cfg, params, enc_embeds, ctx, remat)
    if cfg.pos == "sinusoidal":
        h = h + sinusoidal_positions(s, d, h.device).to(h.dtype)[None]
    if positions is None:
        positions = _default_positions(cfg, b, s, h.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, (mixer, lp) in enumerate(zip(cfg.pattern, params["layers"])):
        h, aux = _layer(remat, cfg, mixer, lp, h, positions, ctx, f"L{i}",
                        encoder_out)
        aux_total = aux_total + aux
    h = apply_norm(cfg.norm, h, gathered(params["final_norm"]))
    head = gathered(params["lm_head"])
    if tpmod.model_sliced(head, cfg.vocab):     # vocab-parallel training
        h = tpmod.copy_to_model(h)
    return linear(head, h, ctx, "lm_head"), aux_total


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            ctx: Optional[LinearCtx] = None, remat: bool = False,
            mask_total: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token NLL (+ the MoE aux loss, which calibration and
    training differentiate through).  batch: tokens (B, S+1) [, mask (B,
    S), positions (B, S+1) or mrope's (3, B, S+1), cut to the inputs' S;
    enc_embeds (B, T, d)]; ``remat`` as ``forward``'s; ``mask_total`` as
    ``common.mean_nll``'s.  Vocab-sliced logits (model-parallel training)
    take ``runtime/tp.vocab_parallel_nll``."""
    tokens = batch["tokens"]
    inputs = tokens[:, :-1]
    positions = batch.get("positions")
    if positions is not None:
        positions = positions[..., :inputs.shape[1]]
    logits, aux = forward(cfg, params, inputs, positions=positions,
                          enc_embeds=batch.get("enc_embeds"), ctx=ctx,
                          remat=remat)
    labels = tokens[:, 1:]
    if tpmod.model_sliced(logits, cfg.vocab):
        nll = tpmod.vocab_parallel_nll(logits, labels)
    else:
        nll = token_nll(logits, labels)
    loss = mean_nll(nll, batch.get("mask"), mask_total)
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_coef * aux
    return loss

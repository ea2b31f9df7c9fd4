"""Step builders (port of ``repro/runtime/steps.py``): the microbatched
train step (gradient accumulation, remat, int8 gradient compression) and
the serve prefill / decode steps.

The reference returns functions for ``jax.jit``; PyTorch runs them
eagerly, with autograd for the gradients.  ``train_step`` reads nothing
back to the host: its metrics are device tensors.

``remat=True`` maps to ``torch.utils.checkpoint`` per decoder layer
(``transformer.forward(remat=True)``): each layer's activations are
recomputed in the backward, so at full width the step keeps one layer's
activations at a time instead of every layer's.  (The reference
checkpoints at the loss boundary, which in PyTorch would recompute the
whole forward and keep all of it again.)  Either way the numbers do not
change.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import decode as decmod
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.tree import flatten, unflatten

from .compression import compress_decompress_grads


def _value_and_grad(cfg: ModelConfig, params, batch: dict, remat: bool):
    """(loss, gradients as a flat list in the params' leaf order, the
    params' structure).  The caller's tensors are not marked as requiring
    grad: the loss runs on detached aliases of them."""
    flat, treedef = flatten(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss = tf.loss_fn(cfg, unflatten(treedef, live), batch, remat=remat)
        grads = torch.autograd.grad(loss, live, materialize_grads=True)
    return loss.detach(), list(grads), treedef


def _split(batch: dict, microbatches: int) -> list[dict]:
    """The batch cut into ``microbatches`` equal parts on its batch axis:
    the leading one, mrope's (3, B, S) ``positions`` their second."""
    def cut(k, v):
        if k == "positions" and v.dim() == 3:
            return v.reshape(3, microbatches, -1, *v.shape[2:]).transpose(0, 1)
        return v.reshape(microbatches, -1, *v.shape[1:])
    parts = {k: cut(k, v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(microbatches)]


def make_train_step(cfg: ModelConfig, *, microbatches: int = 1,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, remat: bool = True,
                    grad_compression: Optional[str] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) with metrics ``loss``, ``grad_norm`` and ``lr``.

    ``batch``: ``tokens`` (B, S+1) [, ``mask`` (B, S), ``positions``
    (B, S+1) or mrope's (3, B, S+1), ``enc_embeds`` (B, T, d)] on the
    params' device.  Gradient accumulation: with ``microbatches`` > 1 the
    batch is split on its batch axis, each part runs one forward and
    backward, the f32 gradients and the losses are summed in order and
    scaled by ``1 / microbatches``.  The learning rate is the cosine schedule at the step
    the optimizer state holds before the update (0 for the first)."""
    if grad_compression not in (None, "int8"):
        raise ValueError(f"grad_compression {grad_compression!r}: None or "
                         "'int8'")

    def compute_grads(params, batch):
        if microbatches == 1:
            loss, grads, treedef = _value_and_grad(cfg, params, batch, remat)
            return loss, unflatten(treedef, grads)
        loss_acc, gacc, treedef = None, None, None
        for mb in _split(batch, microbatches):
            loss, grads, treedef = _value_and_grad(cfg, params, mb, remat)
            grads = [g.to(torch.float32) for g in grads]
            if gacc is None:
                loss_acc, gacc = loss, grads
            else:
                loss_acc = loss_acc + loss
                torch._foreach_add_(gacc, grads)
        scale = 1.0 / microbatches
        torch._foreach_mul_(gacc, scale)
        return loss_acc * scale, unflatten(treedef, gacc)

    def train_step(params, opt_state, batch):
        loss, grads = compute_grads(params, batch)
        if grad_compression == "int8":
            grads = compress_decompress_grads(grads)
        lr = cosine_schedule(opt_state.step, peak_lr, warmup, total_steps)
        params, opt_state, gnorm = adamw_update(params, grads, opt_state, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, context: int,
                      cache_dtype=torch.bfloat16,
                      kv_heads: int | None = None):
    """prefill_step(params, batch) -> (last position's logits (B, V), the
    lockstep caches of ``context`` positions).  ``batch``: ``tokens`` (B,
    S) [, ``positions`` (B, S) or mrope's (3, B, S), ``enc_embeds`` (B, T,
    d) for an encoder-decoder model].  The self-attention caches are in
    ``cache_dtype``; Whisper's cross K/V keep their linear's dtype (f32),
    as the reference's do.  ``kv_heads``: the caches' KV heads (a
    tensor-parallel rank's share; default all)."""
    def prefill_step(params, batch):
        tokens = batch["tokens"]
        caches = decmod.init_caches(cfg, tokens.shape[0], context,
                                    dtype=cache_dtype, device=tokens.device,
                                    kv_heads=kv_heads)
        logits, caches, _ = decmod.prefill(
            cfg, params, tokens, positions=batch.get("positions"),
            enc_embeds=batch.get("enc_embeds"), context=context,
            caches=caches)
        return logits[:, -1, :], caches
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One-token decode: (params, caches, tokens (B, 1), pos) -> (logits
    (B, V), caches); ``pos`` an int or a one-element int32 tensor."""
    def serve_step(params, caches, tokens, pos):
        pos = torch.as_tensor(pos, dtype=torch.int32,
                              device=tokens.device).reshape(1)
        return decmod.decode_step(cfg, params, caches, tokens, pos)
    return serve_step

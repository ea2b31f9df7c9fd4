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

``make_train_step(mesh=)`` runs one rank of a (data dp, model tp) mesh
(``runtime/sharding.TrainMesh``): its params and moments are the rank's
ZeRO shards of its tensor-parallel slices (``sharding.TrainLayout``), the
layers are gathered inside their checkpoint regions, and the step computes
what one device computes on the global batch, within round-off (the sums
run in another order): the same loss, grad norm, learning rate and update.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.models import decode as decmod
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.tree import flatten, unflatten

from . import tp as tpmod
from .compression import compress_decompress_grads
from .sharding import TrainLayout


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


def _rank_rows(batch: dict, microbatches: int, dp: int, d: int
               ) -> list[dict]:
    """Data-parallel rank ``d``'s rows of each microbatch: of the global
    batch's microbatch k, its d-th of ``dp`` equal shares.  With one
    microbatch that is rows d B/dp ... (d+1) B/dp (``batch_specs``'
    layout); with more, the union over the ranks of their k-th parts is
    one device's microbatch k, so a masked loss weights the same tokens."""
    return [_split(part, dp)[d] for part in _split(batch, microbatches)]


def make_train_step(cfg: ModelConfig, *, microbatches: int = 1,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, remat: bool = True,
                    grad_compression: Optional[str] = None, mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) with metrics ``loss``, ``grad_norm`` and ``lr``.

    ``batch``: ``tokens`` (B, S+1) [, ``mask`` (B, S), ``positions``
    (B, S+1) or mrope's (3, B, S+1), ``enc_embeds`` (B, T, d)] on the
    params' device.  Gradient accumulation: with ``microbatches`` > 1 the
    batch is split on its batch axis, each part runs one forward and
    backward, the f32 gradients and the losses are summed in order and
    scaled by ``1 / microbatches``.  The learning rate is the cosine
    schedule at the step the optimizer state holds before the update (0
    for the first).

    ``mesh``: a ``runtime/sharding.TrainMesh``; ``params`` and the
    moments are then this rank's shards (``TrainLayout(cfg, mesh).shard``)
    and ``batch`` the global batch, of which the rank takes its rows
    (``_rank_rows``); ``loss`` is the global batch's."""
    if grad_compression not in (None, "int8"):
        raise ValueError(f"grad_compression {grad_compression!r}: None or "
                         "'int8'")
    if mesh is not None:
        return _mesh_train_step(cfg, mesh, microbatches, peak_lr, warmup,
                                total_steps, remat, grad_compression)

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


def _mesh_train_step(cfg, mesh, microbatches, peak_lr, warmup, total_steps,
                     remat, grad_compression):
    """One rank's train step on ``mesh`` (see ``make_train_step``).

    Each microbatch's loss is the rank's share of the global one: its
    tokens' mean (or, with a mask, their masked sum over 1/dp of the
    microbatch's global token count), plus the MoE's aux loss of its
    router means against the whole microbatch's expert counts
    (``models/moe.py``), so the gathers' backward, a mean over dp, gives
    the global microbatch's gradient.  The union of the ranks' k-th parts
    is one device's microbatch k, so the MoE's capacity is that
    microbatch's, as in the reference.  The metric is the mean of the
    ranks' losses over the data group."""
    layout = TrainLayout(cfg, mesh)
    dp = mesh.dp
    amax = layout.amax_total if grad_compression == "int8" else None

    def train_step(params, opt_state, batch):
        parts = _rank_rows(batch, microbatches, dp, mesh.data.rank)
        totals = [None] * microbatches
        if "mask" in batch:
            counts = torch.stack([torch.sum(p["mask"].to(torch.float32))
                                  for p in parts])
            counts = tpmod.all_reduce(counts, mesh.data)
            totals = list(torch.clamp(counts, min=1.0) / dp)
        # the layers' shards, gathered in the forward; the root units
        # gathered once, here
        flat, treedef = flatten({k: v for k, v in params.items()
                                 if isinstance(v, list)})
        roots, rdef = flatten(layout.gather_roots(params))
        n = len(flat)
        # every microbatch runs the same ops (the sums start from zero), so
        # on fake tensors one counts for all (``kernels.repeated``)
        fake = kernels.is_fake(flat[0])
        trips = 1 if fake else microbatches
        # the first microbatch's gradients start the sums, as one
        # device's do (no zeros held through the first backward)
        loss_acc, gacc = None, None
        with tpmod.scope(mesh.model, mesh.data), kernels.repeated(
                microbatches if fake else 1):
            for part, total in zip(parts[:trips], totals[:trips]):
                live = [p.detach().requires_grad_(True)
                        for p in flat + roots]
                view = layout.view(unflatten(treedef, live[:n]),
                                   unflatten(rdef, live[n:]))
                with torch.enable_grad():
                    loss = tf.loss_fn(cfg, view, part, remat=remat,
                                      mask_total=total)
                    grads = torch.autograd.grad(loss, live,
                                                materialize_grads=True)
                g32 = [g.to(torch.float32) for g in grads]
                if gacc is None:
                    loss_acc, gacc = loss.detach(), g32
                else:
                    loss_acc = loss_acc + loss.detach()
                    torch._foreach_add_(gacc, g32)
                del grads, g32
        del roots, live, view
        if microbatches > 1:
            scale = 1.0 / microbatches
            torch._foreach_mul_(gacc, scale)
            loss_acc = loss_acc * scale
        loss = tpmod.all_reduce(loss_acc.reshape(1), mesh.data)[0]
        if dp > 1:
            loss = loss / dp
        grads = unflatten(treedef, gacc[:n])
        # the root units' summed gradients to their shards, once a step
        grads.update((k, g) for (k, _), g in layout.scatter_roots(
            unflatten(rdef, gacc[n:])).items())
        if grad_compression == "int8":
            grads = compress_decompress_grads(grads, amax)
        lr = cosine_schedule(opt_state.step, peak_lr, warmup, total_steps)
        params, opt_state, gnorm = adamw_update(params, grads, opt_state, lr,
                                                sq_total=layout.sq_total)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}

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

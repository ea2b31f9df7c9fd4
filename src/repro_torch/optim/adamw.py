"""AdamW over the port's param trees (port of ``repro/optim/adamw.py``).

The reference's arithmetic, step for step: moments in f32; the global-norm
clip (default 1.0) scales the gradients before they reach the moments;
weight decay on every leaf, norms and embeddings included; bias correction
``1 - b ** step`` from the incremented step, in f32.  ``torch.optim.AdamW``
orders the decay and the bias correction differently and has no clip, so
this is written out with ``torch._foreach_*`` ops instead.

Unlike the reference, which returns new trees, ``adamw_update`` updates
the params and the moments in place (under ``torch.no_grad()``) and returns
the same trees: at full width a second copy of each would cost its GB.
Every value stays on the device; nothing is read back to the host.

Under model-parallel training (``runtime/steps.make_train_step(mesh=)``)
the params, gradients and moments are a rank's ZeRO shards; the update is
elementwise and runs on them as it is, and ``sq_total`` adds the shards'
squared norms up over the ranks that hold each leaf
(``runtime/sharding.TrainLayout.sq_total``), so the clip and ``grad_norm``
are one device's.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import flatten, leaves, tree_map, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32, on the params' device
    mu: Any              # first moment (f32), the params' structure
    nu: Any              # second moment (f32)


def adamw_init(params) -> AdamWState:
    flat = leaves(params)
    dev = flat[0].device if flat else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def clip_by_global_norm(grads, max_norm: float, sq_total=None):
    """(grads scaled so their global norm is at most ``max_norm``, the f32
    norm before scaling); new tensors, the input is left as it was.
    ``sq_total(squared norms per leaf) -> the global squared norm`` (0-d)
    replaces their sum when the leaves are shards of a mesh."""
    flat, treedef = flatten(grads)
    f32 = [g.to(torch.float32) for g in flat]
    norms = torch._foreach_norm(f32)
    if sq_total is None:
        gn = torch.linalg.vector_norm(torch.stack(norms))
    else:
        gn = torch.sqrt(sq_total([n * n for n in norms]))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    scaled = torch._foreach_mul(f32, scale)
    return unflatten(treedef, [s.to(g.dtype) for s, g in zip(scaled, flat)]), gn


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                 sq_total=None):
    """One AdamW step, in place -> (params, new state, grad norm before the
    clip).  ``lr`` is a float or a 0-d tensor on the params' device;
    ``sq_total`` as ``clip_by_global_norm``'s."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm, sq_total)
    step = state.step + 1
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.full_like(stepf, b1).pow(stepf)
    b2c = 1.0 - torch.full_like(stepf, b2).pow(stepf)

    p_flat = leaves(params)
    g = [x.to(torch.float32) for x in leaves(grads)]
    mu, nu = leaves(state.mu), leaves(state.nu)
    if not (len(p_flat) == len(g) == len(mu) == len(nu)):
        raise ValueError("params, grads and moments differ in structure")
    # m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
    gg = torch._foreach_mul(g, 1 - b2)
    torch._foreach_mul_(gg, g)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, gg)
    del g, gg
    # p -= lr (m_hat / (sqrt(v_hat) + eps) + wd p), in f32
    pf = [p if p.dtype == torch.float32 else p.to(torch.float32)
          for p in p_flat]
    upd = torch._foreach_div(mu, b1c)
    den = torch._foreach_div(nu, b2c)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(upd, den)
    del den
    torch._foreach_add_(upd, torch._foreach_mul(pf, weight_decay))
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(pf, upd)
    for p, f in zip(p_flat, pf):
        if f is not p:
            p.copy_(f)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm

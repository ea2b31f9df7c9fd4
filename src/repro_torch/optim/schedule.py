"""Learning-rate schedules (pure functions of the step; port of
``repro/optim/schedule.py``).

``step`` is an int or an integer tensor (the optimizer state's step, on the
device: no value is read back to the host); the result is a 0-d float32
tensor on ``step``'s device, computed in f32 as the reference's ``jnp``
arithmetic is.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step)


def linear_warmup(step, peak_lr: float, warmup: int) -> torch.Tensor:
    step = _step(step)
    return peak_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)


def cosine_schedule(step, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = linear_warmup(step, peak_lr, warmup)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm, peak_lr * cos)

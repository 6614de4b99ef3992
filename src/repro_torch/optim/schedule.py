"""LR schedules: pure functions of the step (Algorithm 1 line 25, "adjust
learning rate with scheduler"), as the JAX package's ``optim.schedule``.

The step is a Python int or a 0-dim tensor; the value is a 0-dim f32
tensor on the step's device (the CPU for an int), computed there, so a
schedule inside the spmd step reads nothing back to the host. The
arithmetic is the JAX package's, in its order.
"""
from __future__ import annotations

import math

import torch

from repro_torch.optim.adamw import f32_pow

F32 = torch.float32


def _step_f32(step) -> torch.Tensor:
    if torch.is_tensor(step):
        return step.to(F32)
    return torch.tensor(step, dtype=F32)


def constant(lr):
    return lambda step: torch.full((), lr, dtype=F32,
                                   device=_step_f32(step).device)


def cosine(lr, warmup_steps, total_steps, final_frac=0.1):
    def fn(step):
        step = _step_f32(step)
        warm = lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = (final_frac * lr + (1 - final_frac) * lr * 0.5
               * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def step_decay(lr, decay_every, gamma=0.5):
    def fn(step):
        k = torch.div(_step_f32(step), decay_every, rounding_mode="floor")
        return torch.full((), lr, dtype=F32, device=k.device) \
            * f32_pow(gamma, k)
    return fn

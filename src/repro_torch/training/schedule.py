"""Learning-rate schedules as ``step -> lr`` callables, the port of
`repro/training/schedule.py`.

Each returns a 0-d float32 tensor computed in float32, as the
reference's ``jnp`` arithmetic is, so the port's ``adamw`` reads the
same learning rate as the reference's at every step.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def linear_warmup_cosine(peak_lr: float, warmup_steps: int,
                         total_steps: int, final_frac: float = 0.1):
    """``peak_lr * step / warmup`` during the warm-up, then a cosine from
    ``peak_lr`` down to ``final_frac * peak_lr`` at ``total_steps``."""
    def fn(step):
        s = _f32(step)
        warm = peak_lr * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, peak_lr * cos)
    return fn


def linear_decay(peak_lr: float, total_steps: int):
    def fn(step):
        s = _f32(step)
        return peak_lr * torch.clamp(1.0 - s / max(total_steps, 1), 0.0, 1.0)
    return fn

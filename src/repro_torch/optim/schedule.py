"""Learning-rate schedules (twin of ``repro.optim.schedule``): functions
of the step (a 0-d tensor or an int) returning a float32 0-d tensor on
the step's device, never read on the host."""
from __future__ import annotations

import math

import torch


def _step(step):
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule(value: float = 1.0):
    return lambda step: torch.full_like(_step(step), value)


def cosine_schedule(total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_step(step), max=total_steps) / total_steps
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return final_frac + (1 - final_frac) * cos
    return fn


def linear_warmup_cosine(warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    """0 at step 0, rising linearly to 1 at ``warmup``, then the cosine
    decay to ``final_frac`` over the remaining steps."""
    cos = cosine_schedule(max(total_steps - warmup, 1), final_frac)

    def fn(step):
        s = _step(step)
        w = torch.clamp(s / max(warmup, 1), max=1.0)
        return w * cos(torch.clamp(s - warmup, min=0))
    return fn

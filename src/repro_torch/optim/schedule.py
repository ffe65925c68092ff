"""Learning-rate schedules (port of `repro/optim/schedule.py`)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 200, total: int = 10000,
                  min_ratio: float = 0.1):
    """Scale factor in [min_ratio, 1]: linear warmup then cosine decay.

    step: an int or an integer tensor (the optimizer state's step).
    Returns a float32 scalar tensor on step's device, computed op for op
    as the reference: every Python constant rounded to float32 where it
    meets the step, as jax's weak types round it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos

"""LR schedules (pure functions of the step counter): the port of
``src/repro/optim/schedule.py``, in float32 as the reference computes
them."""

from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    """Linear warmup then cosine decay to ``min_ratio * base_lr``. The
    returned function takes the step (an int or a tensor) and returns a
    0-d float32 tensor on the step's device."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup_steps, 1)
        frac = ((step - warmup_steps)
                / max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, base_lr * cos)

    return lr

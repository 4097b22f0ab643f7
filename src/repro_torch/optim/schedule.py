"""LR schedules (pure functions of the step): the port of
``repro/optim/schedule.py``, in float32."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1
                    ) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to ``min_ratio``
    of it at ``total_steps``: a float32 scalar on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1.0 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)

"""The learning-rate schedules of ``repro.optim.schedule`` (linear warmup,
and warmup then cosine decay), of a step (an int32 tensor), returning a
float32 tensor."""
from __future__ import annotations

import math

import torch


def linear_warmup(peak, warmup_steps):
    """``peak * min(1, step / warmup_steps)``."""
    def f(step):
        s = step.to(torch.float32)
        return peak * torch.clamp(s / max(1, warmup_steps), max=1.0)

    return f


def cosine_schedule(peak, warmup_steps, total_steps, final_frac=0.1):
    """Linear warmup to ``peak``, then a cosine decay to
    ``final_frac * peak`` at ``total_steps``."""
    def f(step):
        s = step.to(torch.float32)
        warm = peak * torch.clamp(s / max(1, warmup_steps), max=1.0)
        t = torch.clamp((s - warmup_steps)
                        / max(1, total_steps - warmup_steps), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                                   * t))
        return torch.where(s < warmup_steps, warm, peak * cos)

    return f

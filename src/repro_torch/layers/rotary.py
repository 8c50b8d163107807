"""Rotary position embeddings (half-split layout of ``repro/layers/rotary.py``)."""
from __future__ import annotations

import torch


def rope_freqs(dim: int, base: float, device=None):
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (base ** exps)


def apply_rope(x, positions, base: float = 10000.0):
    """x: (..., S, D_even); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    inv = rope_freqs(d, base, x.device)
    ang = positions[..., None].to(torch.float32) * inv       # (..., S, d/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

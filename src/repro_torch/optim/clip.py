"""Gradient clipping by the global norm, as ``repro.optim.clip``."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by ``min(1, max_norm / norm)``, the float32 norm)."""
    leaves = tree_leaves(grads)
    sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        sq = sq + torch.sum(g.to(torch.float32) ** 2)
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm

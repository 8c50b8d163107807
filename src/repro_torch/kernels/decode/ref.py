"""The plain PyTorch oracle of the decode kernels (the port of
``repro/kernels/decode/ref.py``): for each sequence and KV head, the
``group`` query heads are the rows of ``flash2_blocked_ref`` and the
cache length masks the keys. No kernel replaces it."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash.ref import flash2_blocked_ref


def decode_attention_ref(q, k_cache, v_cache, lengths, *, scale=None,
                         variant="exact", block_k=128):
    """q (B, H, D) one token a sequence, caches (B, Hkv, S, D), lengths
    (B,) valid rows -> (B, H, D) in q's dtype."""
    B, H, D = q.shape
    Hkv = k_cache.shape[1]
    group = H // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    lengths = [int(n) for n in lengths]
    return torch.stack([
        torch.cat([flash2_blocked_ref(
            q[b, h * group:(h + 1) * group], k_cache[b, h], v_cache[b, h],
            causal=False, scale=scale, variant=variant, block_q=group,
            block_k=block_k, kv_len=lengths[b]) for h in range(Hkv)])
        for b in range(B)])

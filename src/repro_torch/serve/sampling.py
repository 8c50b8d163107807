"""Token sampling: greedy and temperature.

``sample_token`` is ``repro``'s one-key batch sampler, a greedy-equal
twin: at temperature 0 it is the argmax, as ``repro``'s; above 0 it draws
the whole batch from one ``torch.Generator``, whose numbers are not
``jax.random``'s. ``sample_tokens`` is what the engine uses: row i is drawn with its own ``torch.Generator``, seeded from
(base seed, admission order, tokens generated so far) alone, so a
request's temp>0 stream does not depend on which other requests share the
batch or on when preemptions happen. The draws are not ``repro``'s:
``jax.random`` and torch generators give different numbers.
"""
from __future__ import annotations

import torch

_MIX = 0x9E3779B97F4A7C15   # 64-bit golden-ratio multiplier
_MASK = (1 << 63) - 1


def row_seed(seed: int, admit_order: int, n_out: int) -> int:
    """A generator seed that is a function of the three counters only."""
    h = seed & _MASK
    for v in (admit_order, n_out):
        h = ((h ^ (v & _MASK)) * _MIX + 1) & _MASK
    return h


def sample_token(generator, logits, *, temperature: float = 0.0,
                 top_k: int = 0):
    """logits (B, V) -> (B,) int32; one ``torch.Generator`` drives the
    whole batch (unused at temperature 0, the argmax). Above 0 the logits
    are divided by ``temperature`` and, with ``top_k``, those below the
    k-th largest of their row set to -1e30 before the draw. The draws are
    not ``jax.random``'s, so only the argmax equals ``repro``'s."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.to(torch.float32) / temperature
    if top_k:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff,
                             torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def sample_tokens(seeds, logits, *, temperature: float = 0.0):
    """logits (B, V) -> (B,) int64 tokens. ``seeds`` is one generator seed
    per row (``row_seed``), unused at temperature 0 (argmax)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    out = torch.empty(logits.shape[0], dtype=torch.int64,
                      device=logits.device)
    for i, seed in enumerate(seeds):
        gen = torch.Generator(device=logits.device).manual_seed(seed)
        out[i] = torch.multinomial(probs[i], 1, generator=gen)[0]
    return out

"""Batch construction for a model's forward (the port of
``repro/models/inputs.py``'s ``token_count`` and ``make_batch``).

A decoder-only config with a frontend (llava-next-34b) counts its
frontend tokens in ``seq_len``: the text is ``seq_len - frontend_tokens``
tokens and the frontend's embeddings are a model input. An
encoder-decoder's encoder takes ``frontend_tokens`` stub frames and its
decoder ``seq_len`` text tokens. A decode batch is one token a sequence
and its length. ``input_specs`` gives the same batch as ``meta`` tensors
of the reference's shapes and dtypes, the stand-ins its dry run lowers
(``launch/dryrun.py``): nothing is allocated.
"""
from __future__ import annotations

import torch

from repro_torch.models.api import resolve_device


def token_count(cfg, seq_len: int) -> int:
    """The text tokens of a ``seq_len``-token sequence."""
    if cfg.frontend and not cfg.encoder_layers:
        return seq_len - cfg.frontend_tokens
    return seq_len


def input_specs(cfg, *, seq_len: int, global_batch: int,
                kind: str = "train"):
    """``meta`` tensors of one step's batch: for "train" or "prefill",
    ``tokens`` (B, token_count) int32 and, with a frontend,
    ``frontend_embeds`` (B, frontend_tokens, frontend_dim) in ``cfg.dtype``;
    for "decode", ``tokens1`` and ``lengths`` (B,) int32."""
    B = global_batch

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind in ("train", "prefill"):
        batch = {"tokens": spec((B, token_count(cfg, seq_len)), torch.int32)}
        if cfg.frontend:
            batch["frontend_embeds"] = spec(
                (B, cfg.frontend_tokens, cfg.frontend_dim),
                getattr(torch, cfg.dtype))
        return batch
    if kind == "decode":
        return {"tokens1": spec((B,), torch.int32),
                "lengths": spec((B,), torch.int32)}
    raise ValueError(f"unknown batch kind {kind!r}")


def make_batch(generator: torch.Generator, cfg, *, seq_len: int,
               global_batch: int, kind: str = "train", device="cuda"):
    """A random batch drawn from ``generator`` (on ``device``): for
    ``kind`` "train" or "prefill", ``tokens`` (B, token_count) int32 in
    [0, vocab) and, with a frontend, ``frontend_embeds`` (B,
    frontend_tokens, frontend_dim) N(0, 1) in ``cfg.dtype``; for "decode",
    ``tokens1`` (B,) and ``lengths`` (B,) in [0, seq_len)."""
    device = resolve_device(device)
    B = global_batch

    def ints(shape, hi):
        return torch.randint(0, hi, shape, generator=generator,
                             dtype=torch.int32, device=device)

    if kind == "decode":
        return {"tokens1": ints((B,), cfg.vocab_size),
                "lengths": ints((B,), seq_len)}
    if kind not in ("train", "prefill"):
        raise ValueError(f"unknown batch kind {kind!r}")
    batch = {"tokens": ints((B, token_count(cfg, seq_len)), cfg.vocab_size)}
    if cfg.frontend:
        batch["frontend_embeds"] = torch.randn(
            (B, cfg.frontend_tokens, cfg.frontend_dim), generator=generator,
            dtype=torch.float32, device=device).to(getattr(torch, cfg.dtype))
    return batch

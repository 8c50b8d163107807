"""Token embeddings and the tied output head."""
from __future__ import annotations

import math

import torch

from repro_torch.layers.common import dense_init


def embed_init(cfg, dtype, generator, device):
    if not cfg.tie_embeddings:
        raise NotImplementedError("the port serves tied embeddings only")
    return {"table": dense_init((cfg.vocab_size, cfg.d_model), dtype,
                                generator, device, scale=0.02)}


def embed_apply(params, tokens, cfg):
    """The table's rows of ``tokens``; with ``cfg.scale_embeddings`` times
    sqrt(d_model) as a float32 product (``repro`` multiplies by a numpy
    float32 scalar, which promotes a bfloat16 row to float32; the caller
    casts to the compute dtype)."""
    x = params["table"][tokens.to(torch.int64)]
    if cfg.scale_embeddings:
        x = x.to(torch.float32) * torch.tensor(math.sqrt(cfg.d_model),
                                               dtype=torch.float32)
    return x


def logits_apply(params, x):
    """Tied head: ``x @ table^T`` in the model's compute dtype."""
    return torch.matmul(x, params["table"].transpose(0, 1))

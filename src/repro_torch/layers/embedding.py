"""Token embeddings and the tied output head."""
from __future__ import annotations

import torch

from repro_torch.layers.common import dense_init


def embed_init(cfg, dtype, generator, device):
    if not cfg.tie_embeddings:
        raise NotImplementedError("the port serves tied embeddings only")
    return {"table": dense_init((cfg.vocab_size, cfg.d_model), dtype,
                                generator, device, scale=0.02)}


def embed_apply(params, tokens):
    return params["table"][tokens.to(torch.int64)]


def logits_apply(params, x):
    """Tied head: ``x @ table^T`` in the model's compute dtype."""
    return torch.matmul(x, params["table"].transpose(0, 1))

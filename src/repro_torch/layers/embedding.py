"""Token embeddings and the output head: tied (``x @ table^T``) or, for a
config with ``tie_embeddings=False`` (arctic-480b, kimi-k2-1t-a32b), its
own ``out`` weight (d, V); with ``cfg.logits_softcap`` (recurrentgemma-2b)
the logits are capped softly at +-c."""
from __future__ import annotations

import math

import torch

from repro_torch.layers.common import dense_init
from repro_torch.sharding.regions import vocab_lookup


def embed_init(cfg, dtype, generator, device):
    """The table (std 0.02) and, untied, the head ``out`` (fan-in std),
    drawn from ``generator`` in that order."""
    p = {"table": dense_init((cfg.vocab_size, cfg.d_model), dtype,
                             generator, device, scale=0.02)}
    if not cfg.tie_embeddings:
        p["out"] = dense_init((cfg.d_model, cfg.vocab_size), dtype,
                              generator, device)
    return p


def embed_apply(params, tokens, cfg):
    """The table's rows of ``tokens``; with ``cfg.scale_embeddings`` times
    sqrt(d_model) as a float32 product (``repro`` multiplies by a numpy
    float32 scalar, which promotes a bfloat16 row to float32; the caller
    casts to the compute dtype). On a mesh (a DTensor table) each rank
    looks its vocab shard up (``sharding/regions.py:vocab_lookup``; the
    index-put gradient of ``table[tokens]`` on DTensors fails in torch
    2.11)."""
    x = vocab_lookup(params["table"], tokens)
    if cfg.scale_embeddings:
        x = x.to(torch.float32) * torch.tensor(math.sqrt(cfg.d_model),
                                               dtype=torch.float32)
    return x


def logits_apply(params, x, cfg):
    """The head in the model's compute dtype: ``x @ table^T`` tied,
    ``x @ out`` untied; a softcap c maps them to ``tanh(logits / c) * c``
    in float32, cast back to their dtype."""
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["table"].transpose(0, 1))
    else:
        logits = torch.matmul(x, params["out"])
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = (torch.tanh(logits.to(torch.float32) / c) * c).to(
            logits.dtype)
    return logits

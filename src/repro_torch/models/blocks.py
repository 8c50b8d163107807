"""Residual blocks of the ``attn`` kind: norm -> attention -> residual,
norm -> SwiGLU -> residual, over the full sequence (training) or over
per-slot (contiguous) caches or a paged KV pool (serving)."""
from __future__ import annotations

import torch

from repro_torch.layers.attention_layer import (
    attn_apply,
    attn_decode_step,
    attn_init,
    attn_init_cache,
    attn_paged_decode_step,
    attn_paged_prefill_step,
    attn_prefill_step,
)
from repro_torch.layers.common import rmsnorm, rmsnorm_init
from repro_torch.layers.mlp import mlp_apply, mlp_init


def block_init(cfg, dtype, generator, device):
    return {
        "norm_mix": rmsnorm_init(cfg.d_model, dtype, device),
        "mix": attn_init(cfg, dtype, generator, device),
        "norm_ffn": rmsnorm_init(cfg.d_model, dtype, device),
        "ffn": mlp_init(cfg.d_model, cfg.d_ff, cfg.activation, dtype,
                        generator, device),
    }


def _ffn(params, x):
    return x + mlp_apply(params["ffn"], rmsnorm(params["norm_ffn"], x))


def block_apply(params, x, cfg):
    """One causal block over the full sequence x (B, S, d)."""
    h = rmsnorm(params["norm_mix"], x)
    h = attn_apply(params["mix"], h, cfg, window=cfg.window or None)
    return _ffn(params, x + h)


def block_init_cache(cfg, batch, max_len, dtype, device):
    """Per-slot caches; a windowed layer keeps only a rolling buffer of
    ``min(max_len, window)`` slots."""
    span = min(max_len, cfg.window) if cfg.window else max_len
    return attn_init_cache(cfg, batch, span, dtype, device)


def block_prefill(params, cache, x, cfg, lengths, n_valid, plan):
    """Chunked prefill through one block; ``plan`` is the tick's
    ``chunk_plan`` of the cache writes."""
    h = rmsnorm(params["norm_mix"], x)
    cache, h = attn_prefill_step(params["mix"], cache, h, cfg, lengths,
                                 n_valid, plan, window=cfg.window)
    return cache, _ffn(params, x + h)


def block_decode_step(params, cache, x1, cfg, lengths):
    """One decode token through one block; a windowed layer's rolling
    buffer takes the token at slot ``lengths % span`` and attends to its
    last ``min(lengths + 1, span)`` slots."""
    h = rmsnorm(params["norm_mix"], x1)
    if cfg.window:
        span = cache["k"].shape[2]
        cache, h = attn_decode_step(
            params["mix"], cache, h, cfg, lengths,
            write_pos=torch.remainder(lengths, span),
            attn_len=torch.clamp(lengths + 1, max=span))
    else:
        cache, h = attn_decode_step(params["mix"], cache, h, cfg, lengths)
    return cache, _ffn(params, x1 + h)


def block_paged_prefill(params, cache, x, cfg, lengths, n_valid, chunk_rows,
                        chunk_plan, block_tables, page_size):
    h = rmsnorm(params["norm_mix"], x)
    cache, h = attn_paged_prefill_step(
        params["mix"], cache, h, cfg, lengths, n_valid, chunk_rows,
        chunk_plan, window=cfg.window, block_tables=block_tables,
        page_size=page_size)
    return cache, _ffn(params, x + h)


def block_paged_decode_step(params, cache, x1, cfg, lengths, write_row,
                            write_plan, block_tables, page_size):
    h = rmsnorm(params["norm_mix"], x1)
    cache, h = attn_paged_decode_step(
        params["mix"], cache, h, cfg, lengths, write_row, write_plan,
        window=cfg.window, block_tables=block_tables, page_size=page_size)
    return cache, _ffn(params, x1 + h)

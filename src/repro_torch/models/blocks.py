"""Residual blocks of the ``attn`` kind: norm -> attention -> residual,
norm -> SwiGLU -> residual, over a paged KV pool."""
from __future__ import annotations

from repro_torch.layers.attention_layer import (
    attn_init,
    attn_paged_decode_step,
    attn_paged_prefill_step,
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

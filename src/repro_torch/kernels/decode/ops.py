"""Public wrappers of the flash-decode kernels (the port of
``repro/kernels/decode/ops.py``): fold q to (B*Hkv, group, D), view
per-slot caches as (B*Hkv, S, D) and flat pools as pages; no copy is
made."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.decode.decode import (
    decode_fwd,
    decode_fwd_plain,
    paged_decode_fwd,
    paged_decode_fwd_plain,
)


def _run_contiguous(q, k_cache, v_cache, k_scale, v_scale, lengths, *, scale,
                    variant, plain):
    B, H, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    Dv = v_cache.shape[-1]
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)

    def fold(t, *tail):  # (B, Hkv, S, ...) -> (B*Hkv, S, ...)
        return None if t is None else t.reshape((B * Hkv, S) + tail)

    fn = decode_fwd_plain if plain else decode_fwd
    o3 = fn(q.reshape(B * Hkv, H // Hkv, D), fold(k_cache, D),
            fold(v_cache, Dv), lengths.to(torch.int32), fold(k_scale),
            fold(v_scale), scale=scale, variant=variant, num_kv_heads=Hkv)
    return o3.reshape(B, H, Dv)


def decode_attention(q, k_cache, v_cache, lengths, *, scale=None,
                     variant="exact", plain=False):
    """q (B, H, D) against per-slot caches (B, Hkv, S, D) of values;
    ``lengths`` (B,) <= S counts the tokens to attend, the current one
    included. ``plain`` runs the plain version on any device."""
    return _run_contiguous(q, k_cache, v_cache, None, None, lengths,
                           scale=scale, variant=variant, plain=plain)


def quant_decode_attention(q, k_codes, v_codes, k_scale, v_scale, lengths, *,
                           scale=None, variant="exact", plain=False):
    """As ``decode_attention`` over int8/fp8 code caches and their float32
    scale rows (B, Hkv, S), dequantized in the tile."""
    f32 = torch.float32
    return _run_contiguous(q, k_codes, v_codes, k_scale.to(f32),
                           v_scale.to(f32), lengths, scale=scale,
                           variant=variant, plain=plain)


def _run(q, k_pool, v_pool, ks_pool, vs_pool, block_tables, lengths, *,
         page_size, scale, variant, window, plain):
    B, H, D = q.shape
    pool_tokens, Hkv, _ = k_pool.shape
    Dv = v_pool.shape[-1]
    if pool_tokens % page_size:
        raise ValueError(f"pool of {pool_tokens} rows is not a whole number "
                         f"of {page_size}-token pages")
    nblk = pool_tokens // page_size
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    q3 = q.reshape(B * Hkv, H // Hkv, D)
    fn = paged_decode_fwd_plain if plain else paged_decode_fwd
    o3 = fn(block_tables.to(torch.int32), lengths.to(torch.int32), q3,
            k_pool.reshape(nblk, page_size, Hkv, D),
            v_pool.reshape(nblk, page_size, Hkv, Dv),
            None if ks_pool is None else ks_pool.reshape(nblk, page_size, Hkv),
            None if vs_pool is None else vs_pool.reshape(nblk, page_size, Hkv),
            scale=scale, variant=variant, page_size=page_size, window=window,
            num_kv_heads=Hkv)
    return o3.reshape(B, H, Dv)


def fused_paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                                 page_size, scale=None, variant="exact",
                                 window=None, plain=False):
    """q (B, H, D) against value pools (pool_tokens, Hkv, D); lengths count
    the current token. ``plain`` runs the plain version on any device."""
    return _run(q, k_pool, v_pool, None, None, block_tables, lengths,
                page_size=page_size, scale=scale, variant=variant,
                window=window, plain=plain)


def quant_fused_paged_decode_attention(q, k_code_pool, v_code_pool,
                                       k_scale_pool, v_scale_pool,
                                       block_tables, lengths, *, page_size,
                                       scale=None, variant="exact",
                                       window=None, plain=False):
    """As ``fused_paged_decode_attention`` over int8/fp8 code pools and
    their float32 scale pools (pool_tokens, Hkv), dequantized in the tile."""
    return _run(q, k_code_pool, v_code_pool, k_scale_pool.to(torch.float32),
                v_scale_pool.to(torch.float32), block_tables, lengths,
                page_size=page_size, scale=scale, variant=variant,
                window=window, plain=plain)

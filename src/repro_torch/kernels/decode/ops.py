"""Public wrappers of the paged flash-decode kernel (the port of
``repro/kernels/decode/ops.py``'s fused paged forms): fold q to
(B*Hkv, group, D) and view the flat pools as pages; no copy is made."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.decode.decode import (
    paged_decode_fwd,
    paged_decode_fwd_plain,
)


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

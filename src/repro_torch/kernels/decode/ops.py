"""Public wrappers of the flash-decode kernels (the port of
``repro/kernels/decode/ops.py``): fold q to (B*Hkv, group, D), view
per-slot caches as (B*Hkv, S, D) and flat pools as pages; no copy is
made, except by ``paged_decode_attention``, the gather-then-kernel form
(the ``gather_pallas`` route), which copies the paged history into
logical order and runs the contiguous kernel on the copy. On a mesh
(DTensor operands) the contiguous decode runs per shard
(``sharding/regions.py:sharded_decode``)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode.decode import (
    BLOCK_K,
    decode_fwd,
    decode_fwd_plain,
    paged_decode_fwd,
    paged_decode_fwd_plain,
)
from repro_torch.kernels.paged import gather_history
from repro_torch.sharding.regions import sharded_decode


def _run_contiguous(q, k_cache, v_cache, k_scale, v_scale, lengths, *, scale,
                    variant, plain, block_k):
    B, H, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    Dv = v_cache.shape[-1]
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if build.DISPATCH_SINK is not None:
        build.DISPATCH_SINK("decode", impl="plain" if plain else "kernel",
                            variant=variant,
                            kv_dtype=build.kv_label(k_cache, k_scale),
                            batch=B, heads=H, heads_kv=Hkv, d_qk=D, d_v=Dv,
                            kv_tokens=S, q_tokens=1)

    def fold(t, *tail):  # (B, Hkv, S, ...) -> (B*Hkv, S, ...)
        return None if t is None else t.reshape((B * Hkv, S) + tail)

    fn = decode_fwd_plain if plain else decode_fwd
    o3 = fn(q.reshape(B * Hkv, H // Hkv, D), fold(k_cache, D),
            fold(v_cache, Dv), lengths.to(torch.int32), fold(k_scale),
            fold(v_scale), scale=scale, variant=variant, num_kv_heads=Hkv,
            block_k=block_k)
    return o3.reshape(B, H, Dv)


def decode_attention(q, k_cache, v_cache, lengths, *, scale=None,
                     variant="exact", plain=False, block_k=BLOCK_K):
    """q (B, H, D) against per-slot caches K (B, Hkv, S, D) and V
    (B, Hkv, S, Dv) of values;
    ``lengths`` (B,) <= S counts the tokens to attend, the current one
    included. ``plain`` runs the plain version on any device. The tiles
    are ``min(block_k, S)`` columns wide."""
    return sharded_decode(q, (k_cache, v_cache), lengths, lambda q, k, v, n: (
        _run_contiguous(q, k, v, None, None, n, scale=scale, variant=variant,
                        plain=plain, block_k=block_k)))


def quant_decode_attention(q, k_codes, v_codes, k_scale, v_scale, lengths, *,
                           scale=None, variant="exact", plain=False,
                           block_k=BLOCK_K):
    """As ``decode_attention`` over int8/fp8 code caches and their float32
    scale rows (B, Hkv, S), dequantized in the tile."""
    f32 = torch.float32
    return sharded_decode(
        q, (k_codes, v_codes, k_scale, v_scale), lengths,
        lambda q, kc, vc, ks, vs, n: _run_contiguous(
            q, kc, vc, ks.to(f32), vs.to(f32), n, scale=scale,
            variant=variant, plain=plain, block_k=block_k))


def paged_decode_attention(q, k_pool, v_pool, rows, lengths, *, scale=None,
                           variant="exact", block_k=BLOCK_K, plain=False,
                           kv_dtype="fp32"):
    """Gather-then-kernel paged decode (the ``gather_pallas`` route and its
    ``_q`` twin, the twins of ``repro``'s ``paged_decode_attention_pallas``
    and ``gather_pallas_q``): the history of pools (pool_tokens, Hkv, .) is
    copied through ``rows`` (B, L) into logical order
    (``kernels.paged.gather_history``: a ``QuantKV`` pool is dequantized to
    float32 at ``kv_dtype``; sentinel rows read zero and lie at or past
    ``lengths``, where the kernel masks), then the contiguous decode runs
    on the copy in tiles of ``min(block_k, L)`` columns (the fused paged
    kernel's at ``block_k = page_size``)."""
    return decode_attention(
        q, gather_history(k_pool, rows, kv_dtype).contiguous(),
        gather_history(v_pool, rows, kv_dtype).contiguous(), lengths,
        scale=scale, variant=variant, plain=plain, block_k=block_k)


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
    if build.DISPATCH_SINK is not None:
        build.DISPATCH_SINK("paged_decode",
                            impl="plain" if plain else "kernel",
                            variant=variant,
                            kv_dtype=build.kv_label(k_pool, ks_pool),
                            batch=B, heads=H, heads_kv=Hkv, d_qk=D, d_v=Dv,
                            kv_tokens=block_tables.shape[1] * page_size,
                            q_tokens=1, page_size=page_size)
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

"""Public wrappers of the full-sequence forward and the chunked-prefill
kernels (the port of ``repro/kernels/flash/ops.py``): fold the head axes,
pad the full-sequence forward's key axis to whole tiles, view
per-slot caches as (B*Hkv, S, D) and flat pools as pages; no copy of a
cache is made, except by ``paged_prefill_attention``, the gather-then-
kernel form (the ``gather_pallas`` route), which copies the paged history
into logical order and runs the contiguous kernel on the copy.

``block_q`` is the plain versions' query block (``cfg.attention_block_q``;
the CUDA kernels keep their own, and neither changes a number);
``block_k`` is the contiguous prefill's KV tile width, part of an ExpMul
result."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.flash.flash import flash_fwd, flash_fwd_plain
from repro_torch.kernels.flash.prefill import (
    BLOCK_K,
    BLOCK_Q,
    paged_prefill_fwd,
    paged_prefill_fwd_plain,
    prefill_fwd,
    prefill_fwd_plain,
)
from repro_torch.kernels.paged import gather_history
from repro_torch.numerics.quant import kv_values


def flash_attention_fwd(q, k, v, *, causal=True, scale=None, window=None,
                        variant="exact", block_k=128, plain=False,
                        q_offset=0, block_q=BLOCK_Q):
    """Full-sequence attention forward: q (B, H, Sq, D), k and v
    (B, Hkv, Sk, D) -> (B, H, Sq, D) in q's dtype, as
    ``repro.kernels.flash.ops.flash_attention_fwd``: the key axis is
    zero-padded to a multiple of ``min(block_k, Sk)``, the padded keys
    masked by ``kv_len = Sk``. The reference's query padding to whole
    ``block_q`` blocks changes no number and is not done. ``plain`` runs
    the plain version on any device. ``q_offset``: the global row of q's
    first row, for the causal and window masks (``flash.py``)."""
    B, H, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if v.shape[-1] != D:
        raise ValueError("the flash kernel requires Dq == Dv")
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    bk = min(block_k, Sk)
    if build.DISPATCH_SINK is not None:
        build.DISPATCH_SINK("full", impl="plain" if plain else "kernel",
                            variant=variant, kv_dtype="fp32", batch=B,
                            heads=H, heads_kv=Hkv, d_qk=D, d_v=D,
                            kv_tokens=Sk, q_tokens=Sq)

    def fold(t, n, pad):
        if pad:
            t = F.pad(t, (0, 0, 0, pad))
        return t.reshape(t.shape[0] * t.shape[1], n + pad, D).contiguous()

    fn = flash_fwd_plain if plain else flash_fwd
    o3 = fn(fold(q, Sq, 0), fold(k, Sk, -Sk % bk), fold(v, Sk, -Sk % bk),
            causal=causal, scale=scale, window=window, variant=variant,
            block_k=bk, num_q_heads=H, num_kv_heads=Hkv, kv_len=Sk,
            q_offset=q_offset, block_q=block_q)
    return o3.reshape(B, H, Sq, D)


def _run_contiguous(q, kc, vc, ksc, vsc, kn, vn, ksn, vsn, lengths, n_valid,
                    *, scale, variant, window, rolling, plain, block_q,
                    block_k):
    B, H, C, D = q.shape
    Hkv = kc.shape[1]
    Dv = vc.shape[-1]
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if build.DISPATCH_SINK is not None:
        build.DISPATCH_SINK("prefill", impl="plain" if plain else "kernel",
                            variant=variant, kv_dtype=build.kv_label(kc, ksc),
                            batch=B, heads=H, heads_kv=Hkv, d_qk=D, d_v=Dv,
                            kv_tokens=kc.shape[2], q_tokens=C)

    def fold(t):  # (B, Hkv, L, ...) -> (B*Hkv, L, ...)
        return None if t is None else t.reshape((B * Hkv,) + t.shape[2:])

    fn = prefill_fwd_plain if plain else prefill_fwd
    o3 = fn(q.reshape(B * H, C, D), fold(kc), fold(vc), fold(kn), fold(vn),
            lengths.to(torch.int32), n_valid.to(torch.int32), fold(ksc),
            fold(vsc), fold(ksn), fold(vsn), scale=scale, variant=variant,
            window=window, rolling=rolling, num_q_heads=H, num_kv_heads=Hkv,
            block_q=block_q, block_k=block_k)
    return o3.reshape(B, H, C, Dv)


def prefill_attention(q, k_cache, v_cache, k_chunk, v_chunk, lengths,
                      n_valid, *, scale=None, variant="exact", window=None,
                      rolling=False, plain=False, block_q=BLOCK_Q,
                      block_k=BLOCK_K):
    """q (B, H, C, D) and the chunk's KV (B, Hkv, C, D / Dv) against
    per-slot caches K (B, Hkv, S, D) and V (B, Hkv, S, Dv) of values holding
    ``lengths`` (B,) tokens;
    ``n_valid`` (B,) chunk tokens are valid. ``rolling`` reads the cache as
    a rolling buffer of span S. ``plain`` runs the plain version on any
    device. The KV tiles are ``min(block_k, max(S, C, 1))`` wide."""
    return _run_contiguous(q, k_cache, v_cache, None, None, k_chunk, v_chunk,
                           None, None, lengths, n_valid, scale=scale,
                           variant=variant, window=window, rolling=rolling,
                           plain=plain, block_q=block_q, block_k=block_k)


def quant_prefill_attention(q, kc_codes, vc_codes, kc_scale, vc_scale,
                            kn_codes, vn_codes, kn_scale, vn_scale, lengths,
                            n_valid, *, scale=None, variant="exact",
                            window=None, rolling=False, plain=False,
                            block_q=BLOCK_Q, block_k=BLOCK_K):
    """As ``prefill_attention`` over int8/fp8 codes with float32 scale rows:
    the cache (B, Hkv, S, ...) and the chunk, already quantized
    (B, Hkv, C, ...)."""
    f32 = torch.float32
    return _run_contiguous(q, kc_codes, vc_codes, kc_scale.to(f32),
                           vc_scale.to(f32), kn_codes, vn_codes,
                           kn_scale.to(f32), vn_scale.to(f32), lengths,
                           n_valid, scale=scale, variant=variant,
                           window=window, rolling=rolling, plain=plain,
                           block_q=block_q, block_k=block_k)


def paged_prefill_attention(q, k_chunk, v_chunk, k_pool, v_pool, rows,
                            lengths, n_valid, *, scale=None, variant="exact",
                            window=None, block_q=BLOCK_Q, block_k=BLOCK_K,
                            plain=False, kv_dtype="fp32"):
    """Gather-then-kernel paged prefill (the ``gather_pallas`` route and its
    ``_q`` twin, the twins of ``repro``'s ``paged_prefill_attention_pallas``
    and ``gather_pallas_q``): the history of pools (pool_tokens, Hkv, .) is
    copied through ``rows`` (B, L) into logical order
    (``kernels.paged.gather_history``: ``QuantKV`` pools and chunk are
    dequantized to float32 at ``kv_dtype``; sentinel rows read zero and lie
    at or past ``lengths``, where the kernel masks), then the contiguous
    prefill runs on the copy with absolute positions, in ``block_k``-wide
    tiles (the fused paged kernel's at ``block_k = page_size``). The chunk
    is taken in the copy's dtype."""
    k_cache = gather_history(k_pool, rows, kv_dtype).contiguous()
    v_cache = gather_history(v_pool, rows, kv_dtype).contiguous()
    return prefill_attention(
        q, k_cache, v_cache, kv_values(k_chunk, kv_dtype).to(k_cache.dtype),
        kv_values(v_chunk, kv_dtype).to(v_cache.dtype), lengths, n_valid,
        scale=scale, variant=variant, window=window, rolling=False,
        plain=plain, block_q=block_q, block_k=block_k)


def _run(q, kn, vn, ksn, vsn, k_pool, v_pool, ks_pool, vs_pool, block_tables,
         lengths, n_valid, *, page_size, scale, variant, window, plain,
         block_q):
    B, H, C, D = q.shape
    pool_tokens, Hkv, _ = k_pool.shape
    Dv = v_pool.shape[-1]
    if pool_tokens % page_size:
        raise ValueError(f"pool of {pool_tokens} rows is not a whole number "
                         f"of {page_size}-token pages")
    nblk = pool_tokens // page_size
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if build.DISPATCH_SINK is not None:
        build.DISPATCH_SINK("paged_prefill",
                            impl="plain" if plain else "kernel",
                            variant=variant,
                            kv_dtype=build.kv_label(k_pool, ks_pool),
                            batch=B, heads=H, heads_kv=Hkv, d_qk=D, d_v=Dv,
                            kv_tokens=block_tables.shape[1] * page_size,
                            q_tokens=C, page_size=page_size)

    def pages(t, *tail):
        return None if t is None else t.reshape((nblk, page_size, Hkv) + tail)

    def fold(t):  # (B, Hkv, C, ...) -> (B*Hkv, C, ...)
        return None if t is None else t.reshape((B * Hkv,) + t.shape[2:])

    fn = paged_prefill_fwd_plain if plain else paged_prefill_fwd
    o3 = fn(block_tables.to(torch.int32), lengths.to(torch.int32),
            n_valid.to(torch.int32), q.reshape(B * H, C, D),
            pages(k_pool, D), pages(v_pool, Dv), fold(kn), fold(vn),
            pages(ks_pool), pages(vs_pool), fold(ksn), fold(vsn),
            scale=scale, variant=variant, window=window, page_size=page_size,
            num_q_heads=H, num_kv_heads=Hkv, block_q=block_q)
    return o3.reshape(B, H, C, Dv)


def fused_paged_prefill_attention(q, k_chunk, v_chunk, k_pool, v_pool,
                                  block_tables, lengths, n_valid, *,
                                  page_size, scale=None, variant="exact",
                                  window=None, plain=False, block_q=BLOCK_Q):
    """q (B, H, C, D) and the chunk's KV (B, Hkv, C, D) against value pools
    (pool_tokens, Hkv, D). ``plain`` runs the plain version on any
    device."""
    return _run(q, k_chunk, v_chunk, None, None, k_pool, v_pool, None, None,
                block_tables, lengths, n_valid, page_size=page_size,
                scale=scale, variant=variant, window=window, plain=plain,
                block_q=block_q)


def quant_fused_paged_prefill_attention(q, kn_codes, vn_codes, kn_scale,
                                        vn_scale, k_code_pool, v_code_pool,
                                        k_scale_pool, v_scale_pool,
                                        block_tables, lengths, n_valid, *,
                                        page_size, scale=None,
                                        variant="exact", window=None,
                                        plain=False, block_q=BLOCK_Q):
    """As ``fused_paged_prefill_attention`` with the chunk already
    quantized (codes (B, Hkv, C, D), scales (B, Hkv, C)) and int8/fp8 code
    pools with float32 scale pools (pool_tokens, Hkv)."""
    f32 = torch.float32
    return _run(q, kn_codes, vn_codes, kn_scale.to(f32), vn_scale.to(f32),
                k_code_pool, v_code_pool, k_scale_pool.to(f32),
                v_scale_pool.to(f32), block_tables, lengths, n_valid,
                page_size=page_size, scale=scale, variant=variant,
                window=window, plain=plain, block_q=block_q)

"""GQA attention layer with RoPE and QKV bias over a paged KV pool.

The paged serving half of ``repro/layers/attention_layer.py``, with its
order of operations: decode quantizes and scatters the new token's K/V
into the pool, then attends; chunked prefill quantizes the chunk once,
attends over [pool ++ chunk codes], then scatters the chunk. With
``cfg.kv_dtype`` "int8"/"fp8" the pools hold codes plus per-(token, head)
float32 scale pools. The pools are updated in place.

``cfg.attention_impl`` "kernel" runs the CUDA kernels (their plain
versions for CPU tensors); "plain" runs the plain versions on any device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode.ops import (
    fused_paged_decode_attention,
    quant_fused_paged_decode_attention,
)
from repro_torch.kernels.flash.ops import (
    fused_paged_prefill_attention,
    quant_fused_paged_prefill_attention,
)
from repro_torch.kernels.paged import scatter_rows
from repro_torch.layers.common import dense_init
from repro_torch.layers.rotary import apply_rope
from repro_torch.numerics.quant import (
    QUANT_KV_DTYPES,
    kv_code_dtype,
    quantize_kv,
)


def kv_quantized(cfg) -> bool:
    return cfg.kv_dtype in QUANT_KV_DTYPES


def _kernel_kw(cfg, window, page_size):
    return dict(page_size=page_size, variant=cfg.attention_variant,
                window=window, plain=cfg.attention_impl == "plain")


def attn_init(cfg, dtype, generator, device):
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init((d, H, hd), dtype, generator, device),
        "wk": dense_init((d, Hkv, hd), dtype, generator, device),
        "wv": dense_init((d, Hkv, hd), dtype, generator, device),
        "wo": dense_init((H, hd, d), dtype, generator, device),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", H), ("bk", Hkv), ("bv", Hkv)):
            p[name] = torch.zeros((heads, hd), dtype=dtype, device=device)
    return p


def _project_qkv(params, x, cfg, positions):
    """x (B, S, d), positions (B, S) -> q (B, H, S, hd), k/v (B, Hkv, S, hd)."""
    q = torch.einsum("bsd,dhk->bhsk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bhsk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bhsk", x, params["wv"])
    if "bq" in params:
        q = q + params["bq"][None, :, None, :]
        k = k + params["bk"][None, :, None, :]
        v = v + params["bv"][None, :, None, :]
    q = apply_rope(q, positions[:, None, :], cfg.rope_base)
    k = apply_rope(k, positions[:, None, :], cfg.rope_base)
    return q, k, v


def attn_init_paged_cache(cfg, pool_tokens, dtype, device):
    """Flat pools of one row per pooled token (no batch axis)."""
    hd, Hkv = cfg.resolved_head_dim(), cfg.num_kv_heads
    if kv_quantized(cfg):
        cd = kv_code_dtype(cfg.kv_dtype)
        return {
            "k": torch.zeros((pool_tokens, Hkv, hd), dtype=cd, device=device),
            "v": torch.zeros((pool_tokens, Hkv, hd), dtype=cd, device=device),
            "k_scale": torch.zeros((pool_tokens, Hkv), dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros((pool_tokens, Hkv), dtype=torch.float32,
                                   device=device),
        }
    return {
        "k": torch.zeros((pool_tokens, Hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((pool_tokens, Hkv, hd), dtype=dtype, device=device),
    }


def attn_paged_decode_step(params, pool, x1, cfg, lengths, write_row,
                           write_plan=None, *, window=None, block_tables,
                           page_size):
    """x1 (B, d) one token at absolute position ``lengths``; write_row (B,)
    its physical row (``token_rows``), ``write_plan`` the precomputed
    ``scatter_plan`` of those rows. Idle slots carry sentinel rows, so
    their writes drop and their scores are fully masked."""
    q = torch.einsum("bd,dhk->bhk", x1, params["wq"])
    k = torch.einsum("bd,dhk->bhk", x1, params["wk"])
    v = torch.einsum("bd,dhk->bhk", x1, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    pos = lengths[:, None, None]
    q = apply_rope(q[:, :, None, :], pos, cfg.rope_base)[:, :, 0]
    k = apply_rope(k[:, :, None, :], pos, cfg.rope_base)[:, :, 0]
    kw = _kernel_kw(cfg, window, page_size)
    if kv_quantized(cfg):
        kq = quantize_kv(k, cfg.kv_dtype)
        vq = quantize_kv(v, cfg.kv_dtype)
        for name, val in (("k", kq.codes), ("v", vq.codes),
                          ("k_scale", kq.scale), ("v_scale", vq.scale)):
            scatter_rows(pool[name], write_row, val, plan=write_plan)
        o = quant_fused_paged_decode_attention(
            q, pool["k"], pool["v"], pool["k_scale"], pool["v_scale"],
            block_tables, lengths + 1, **kw)
    else:
        scatter_rows(pool["k"], write_row, k, plan=write_plan)
        scatter_rows(pool["v"], write_row, v, plan=write_plan)
        o = fused_paged_decode_attention(q, pool["k"], pool["v"],
                                         block_tables, lengths + 1, **kw)
    return pool, torch.einsum("bhk,hkd->bd", o, params["wo"])


def attn_paged_prefill_step(params, pool, x, cfg, lengths, n_valid,
                            chunk_rows, chunk_plan=None, *, window=None,
                            block_tables, page_size):
    """x (B, C, d) a chunk at absolute positions ``lengths + [0, C)``;
    chunk_rows (B, C) its physical rows, ``chunk_plan`` the precomputed
    ``scatter_plan`` of its valid rows. The chunk attends to
    [paged history ++ chunk], then its valid tokens are scattered."""
    B, C, _ = x.shape
    idx = torch.arange(C, device=x.device)[None, :]
    positions = lengths[:, None] + idx
    q, k, v = _project_qkv(params, x, cfg, positions)
    valid = (idx < n_valid[:, None]).reshape(-1)
    rows = chunk_rows.reshape(-1)
    kw = _kernel_kw(cfg, window, page_size)

    def flat(t):  # (B, Hkv, C, ...) -> (B*C, Hkv, ...) token-major
        return t.transpose(1, 2).reshape((B * C, t.shape[1]) + t.shape[3:])

    if kv_quantized(cfg):
        kq = quantize_kv(k, cfg.kv_dtype)
        vq = quantize_kv(v, cfg.kv_dtype)
        o = quant_fused_paged_prefill_attention(
            q, kq.codes, vq.codes, kq.scale, vq.scale, pool["k"], pool["v"],
            pool["k_scale"], pool["v_scale"], block_tables, lengths, n_valid,
            **kw)
        new = {"k": kq.codes, "v": vq.codes, "k_scale": kq.scale,
               "v_scale": vq.scale}
    else:
        k, v = k.to(pool["k"].dtype), v.to(pool["v"].dtype)
        o = fused_paged_prefill_attention(
            q, k, v, pool["k"], pool["v"], block_tables, lengths, n_valid,
            **kw)
        new = {"k": k, "v": v}
    for name, val in new.items():
        scatter_rows(pool[name], rows, flat(val), valid, plan=chunk_plan)
    return pool, torch.einsum("bhsk,hkd->bsd", o, params["wo"])

"""GQA attention layer with RoPE and QKV bias: the full-sequence path of
training (``attn_apply``) and the serving paths over per-slot or paged KV
caches.

``repro/layers/attention_layer.py`` without cross-attention, with its order
of operations. ``attn_apply`` attends over the sequence's own K/V through
``core.attention.attention`` (the flash kernel forward and the reference's
recompute backward); it runs unquantized (``kv_dtype="fp32"``) and raises
on a quantized ``cfg.kv_dtype``. On the serving paths, decode quantizes
and writes the new token's K/V, then attends; chunked prefill quantizes
the chunk once, attends over [cache ++ chunk codes], then writes the
chunk. The per-slot (contiguous) cache of a windowed layer is a rolling
buffer of ``span = min(max_len, window)`` slots: RoPE uses absolute
positions while the slot wraps modulo the span, and prefill reads the
buffer with the rolling mask, before the chunk overwrites slots its own
earlier queries still read. With ``cfg.kv_dtype`` "int8"/"fp8" the caches
hold codes plus per-(token, head) float32 scale rows. The caches are
updated in place.

``cfg.attention_impl`` "kernel" runs the CUDA kernels (their plain
versions for CPU tensors); "plain" runs the plain versions on any device.
"""
from __future__ import annotations

import torch

from repro_torch.core.attention import attention
from repro_torch.kernels.decode.ops import (
    decode_attention,
    fused_paged_decode_attention,
    quant_decode_attention,
    quant_fused_paged_decode_attention,
)
from repro_torch.kernels.flash.ops import (
    fused_paged_prefill_attention,
    prefill_attention,
    quant_fused_paged_prefill_attention,
    quant_prefill_attention,
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


def attn_apply(params, x, cfg, *, positions=None, causal=True, window=None):
    """x (B, S, d) -> (B, S, d): full-sequence attention of the training
    path, RoPE at ``positions`` (default ``arange(S)`` per row)."""
    if kv_quantized(cfg):
        raise NotImplementedError(
            f"full-sequence attention at kv_dtype={cfg.kv_dtype!r} (the "
            f"reference's fake-quant training impls) is not ported; train at "
            f"kv_dtype='fp32'")
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q, k, v = _project_qkv(params, x, cfg, positions)
    o = attention(q, k, v, cfg, causal=causal, window=window)
    return torch.einsum("bhsk,hkd->bsd", o, params["wo"])


def _init_kv(shape, cfg, dtype, device):
    """KV buffers of ``shape + (head_dim,)``: values in ``dtype``, or codes
    plus float32 scale rows of ``shape`` for a quantized ``cfg.kv_dtype``."""
    full = shape + (cfg.resolved_head_dim(),)
    if kv_quantized(cfg):
        cd = kv_code_dtype(cfg.kv_dtype)
        return {
            "k": torch.zeros(full, dtype=cd, device=device),
            "v": torch.zeros(full, dtype=cd, device=device),
            "k_scale": torch.zeros(shape, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape, dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(full, dtype=dtype, device=device),
            "v": torch.zeros(full, dtype=dtype, device=device)}


def attn_init_cache(cfg, batch, max_len, dtype, device):
    """Per-slot caches (batch, Hkv, max_len, hd), the contiguous layout."""
    return _init_kv((batch, cfg.num_kv_heads, max_len), cfg, dtype, device)


def _project_token(params, x1, cfg, lengths):
    """x1 (B, d) at positions ``lengths`` -> q (B, H, hd), k/v (B, Hkv, hd)."""
    q = torch.einsum("bd,dhk->bhk", x1, params["wq"])
    k = torch.einsum("bd,dhk->bhk", x1, params["wk"])
    v = torch.einsum("bd,dhk->bhk", x1, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    pos = lengths[:, None, None]
    q = apply_rope(q[:, :, None, :], pos, cfg.rope_base)[:, :, 0]
    k = apply_rope(k[:, :, None, :], pos, cfg.rope_base)[:, :, 0]
    return q, k, v


def _quantized(cfg, k, v):
    """The K/V to store: {"k", "v"[, "k_scale", "v_scale"]}."""
    if kv_quantized(cfg):
        kq = quantize_kv(k, cfg.kv_dtype)
        vq = quantize_kv(v, cfg.kv_dtype)
        return {"k": kq.codes, "v": vq.codes, "k_scale": kq.scale,
                "v_scale": vq.scale}
    return {"k": k, "v": v}


def attn_decode_step(params, cache, x1, cfg, lengths, *, write_pos=None,
                     attn_len=None):
    """x1 (B, d) one token at absolute position ``lengths`` (B,).

    The token's K/V land in slot ``write_pos`` (default ``lengths``; a
    rolling buffer passes ``lengths % span``), then it attends to the first
    ``attn_len`` slots (default ``lengths + 1``). A slot index past the
    cache is clamped to its last slot, as JAX's dynamic_update_slice does.
    """
    B = x1.shape[0]
    S = cache["k"].shape[2]
    write_pos = lengths if write_pos is None else write_pos
    attn_len = lengths + 1 if attn_len is None else attn_len
    q, k, v = _project_token(params, x1, cfg, lengths)
    new = _quantized(cfg, k, v)
    b = torch.arange(B, device=x1.device)
    slot = torch.clamp(write_pos.to(torch.int64), 0, S - 1)
    for name, val in new.items():
        cache[name][b, :, slot] = val.to(cache[name].dtype)
    kw = dict(variant=cfg.attention_variant,
              plain=cfg.attention_impl == "plain")
    if kv_quantized(cfg):
        o = quant_decode_attention(q, cache["k"], cache["v"],
                                   cache["k_scale"], cache["v_scale"],
                                   attn_len, **kw)
    else:
        o = decode_attention(q, cache["k"], cache["v"], attn_len, **kw)
    return cache, torch.einsum("bhk,hkd->bd", o, params["wo"])


def chunk_plan(positions, gate, span):
    """The (row, chunk index, slot) triples a chunk write keeps: gated-on
    tokens whose slot ``positions`` lies in ``[0, span)``.

    Finding them syncs with the device once; every layer of a tick writes
    the same slots, so the model computes the plan once per tick.
    """
    keep = gate & (positions >= 0) & (positions < span)
    b, c = torch.nonzero(keep, as_tuple=True)
    return b, c, positions[b, c].to(torch.int64)


def chunk_write(buf, new, plan):
    """Write a chunk of C tokens into a per-slot buffer **in place**.

    buf (B, Hkv, span, ...), new (B, Hkv, C, ...); ``plan`` is the
    ``chunk_plan`` of the write. The kept slots of a row are distinct (the
    gate keeps only the last ``span`` tokens of a rolling buffer), so the
    write is deterministic. Returns buf.
    """
    b, c, slot = plan
    buf[b, :, slot] = new[b, :, c].to(buf.dtype)
    return buf


def chunk_gate(lengths, n_valid, C, span, rolling):
    """(positions, gate) of a chunk write: the slots of the chunk's tokens
    (absolute positions, modulo the span for a rolling buffer) and which
    tokens are written. A chunk longer than a rolling span writes only its
    last ``span`` valid tokens, so no two of a row share a slot."""
    idx = torch.arange(C, device=lengths.device)[None, :]
    positions = lengths[:, None].to(torch.int64) + idx
    nv = n_valid[:, None].to(torch.int64)
    gate = (idx < nv) & (idx >= nv - span)
    return (torch.remainder(positions, span) if rolling else positions), gate


def attn_prefill_step(params, cache, x, cfg, lengths, n_valid, plan, *,
                      window=None):
    """x (B, C, d) a chunk at absolute positions ``lengths + [0, C)``;
    ``n_valid`` (B,) valid chunk tokens (0 for idle slots, which write
    nothing). The chunk attends to [cache ++ chunk] (the cache read as a
    rolling buffer when ``window`` is set), then its valid tokens are
    written as the tick's ``chunk_plan`` of ``chunk_gate`` says."""
    C = x.shape[1]
    positions = lengths[:, None] + torch.arange(C, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)
    kw = dict(variant=cfg.attention_variant, window=window,
              rolling=window is not None,
              plain=cfg.attention_impl == "plain")
    new = _quantized(cfg, k, v)
    if kv_quantized(cfg):
        o = quant_prefill_attention(
            q, cache["k"], cache["v"], cache["k_scale"], cache["v_scale"],
            new["k"], new["v"], new["k_scale"], new["v_scale"], lengths,
            n_valid, **kw)
    else:
        new = {name: t.to(cache[name].dtype) for name, t in new.items()}
        o = prefill_attention(q, cache["k"], cache["v"], new["k"], new["v"],
                              lengths, n_valid, **kw)
    for name, val in new.items():
        chunk_write(cache[name], val, plan)
    return cache, torch.einsum("bhsk,hkd->bsd", o, params["wo"])


def attn_init_paged_cache(cfg, pool_tokens, dtype, device):
    """Flat pools of one row per pooled token (no batch axis)."""
    return _init_kv((pool_tokens, cfg.num_kv_heads), cfg, dtype, device)


def attn_paged_decode_step(params, pool, x1, cfg, lengths, write_row,
                           write_plan=None, *, window=None, block_tables,
                           page_size):
    """x1 (B, d) one token at absolute position ``lengths``; write_row (B,)
    its physical row (``token_rows``), ``write_plan`` the precomputed
    ``scatter_plan`` of those rows. Idle slots carry sentinel rows, so
    their writes drop and their scores are fully masked."""
    q, k, v = _project_token(params, x1, cfg, lengths)
    kw = _kernel_kw(cfg, window, page_size)
    for name, val in _quantized(cfg, k, v).items():
        scatter_rows(pool[name], write_row, val, plan=write_plan)
    if kv_quantized(cfg):
        o = quant_fused_paged_decode_attention(
            q, pool["k"], pool["v"], pool["k_scale"], pool["v_scale"],
            block_tables, lengths + 1, **kw)
    else:
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

    new = _quantized(cfg, k, v)
    if kv_quantized(cfg):
        o = quant_fused_paged_prefill_attention(
            q, new["k"], new["v"], new["k_scale"], new["v_scale"], pool["k"],
            pool["v"], pool["k_scale"], pool["v_scale"], block_tables,
            lengths, n_valid, **kw)
    else:
        new = {name: t.to(pool[name].dtype) for name, t in new.items()}
        o = fused_paged_prefill_attention(
            q, new["k"], new["v"], pool["k"], pool["v"], block_tables,
            lengths, n_valid, **kw)
    for name, val in new.items():
        scatter_rows(pool[name], rows, flat(val), valid, plan=chunk_plan)
    return pool, torch.einsum("bhsk,hkd->bsd", o, params["wo"])

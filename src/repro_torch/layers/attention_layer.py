"""GQA attention layer with RoPE and QKV bias: the full-sequence path of
training (``attn_apply``) and the serving paths over per-slot or paged KV
caches.

``repro/layers/attention_layer.py`` with its order of operations. Every
attention call goes through the backend registry
(``kernels/registry.py``): ``AttentionSpec.from_config(cfg, window=...)``
and one ``dispatch_*`` call, so ``cfg.attention_impl`` and the serving
tables' ``attention_{decode,prefill,paged}_impl`` pick the route.
``attn_apply`` attends over the sequence's own K/V through the
full-sequence table; at a quantized ``cfg.kv_dtype`` its ``_q`` entry
fake-quantizes K (after RoPE) and V with the cache's codec and attends
over those at full precision, so that ``forward`` matches a round trip
through a quantized cache. On the
serving paths, decode quantizes and writes the new token's K/V, then
attends; chunked prefill quantizes
the chunk once, attends over [cache ++ chunk codes], then writes the
chunk. The per-slot (contiguous) cache of a windowed layer is a rolling
buffer of ``span = min(max_len, window)`` slots: RoPE uses absolute
positions while the slot wraps modulo the span, and prefill reads the
buffer with the rolling mask, before the chunk overwrites slots its own
earlier queries still read. With ``cfg.kv_dtype`` "int8"/"fp8" the caches
hold codes plus per-(token, head) float32 scale rows. The caches are
updated in place, at a fixed shape and with no sync, so a serving tick can
be captured in a CUDA graph: every cache's storage holds one token's row
of scratch past its end (``kernels.paged.zeros_with_scratch``), where the
writes a tick drops land.

The paged steps pass the block tables and the page size and no
``rows``: the fused kernels read the tables, a gather route computes the
rows from them on the device.

Cross-attention of an encoder-decoder's decoder has no RoPE and float
K/V from the encoder output: ``cross_attn_apply`` runs the full-sequence
``attention`` non-causally, ``cross_attn_decode`` the decode table's
one-pass "xla" route (``core.attention.decode_one_pass``) whatever the
config names, as ``repro`` forces it: its ExpMul weights differ from a
tiled kernel's.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.attention import attention
from repro_torch.kernels.paged import (
    rows_with_scratch,
    scatter_fixed,
    zeros_with_scratch,
)
from repro_torch.kernels.registry import (
    AttentionSpec,
    dispatch_attention,
    dispatch_decode,
    dispatch_paged_decode,
    dispatch_paged_prefill,
    dispatch_prefill,
)
from repro_torch.layers.common import dense_init
from repro_torch.layers.rotary import apply_rope
from repro_torch.sharding.regions import write_slot
from repro_torch.numerics.quant import (
    QUANT_KV_DTYPES,
    QuantKV,
    kv_code_dtype,
    quantize_kv,
)


def kv_quantized(cfg) -> bool:
    return cfg.kv_dtype in QUANT_KV_DTYPES


def _kv(cfg, store):
    """The (K, V) operands of a cache, pool or chunk ``store``: its values,
    or ``QuantKV`` codes and scales."""
    if kv_quantized(cfg):
        return (QuantKV(store["k"], store["k_scale"]),
                QuantKV(store["v"], store["v_scale"]))
    return store["k"], store["v"]


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
    path, RoPE at ``positions`` (default ``arange(S)`` per row); K and V
    fake-quantized at a quantized ``cfg.kv_dtype``."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q, k, v = _project_qkv(params, x, cfg, positions)
    o = dispatch_attention(AttentionSpec.from_config(cfg, window=window),
                           q, k, v, causal=causal)
    return torch.einsum("bhsk,hkd->bsd", o, params["wo"])


def cross_attn_init(cfg, dtype, generator, device):
    """Encoder-decoder cross-attention: no bias, no RoPE."""
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": dense_init((d, H, hd), dtype, generator, device),
        "wk": dense_init((d, Hkv, hd), dtype, generator, device),
        "wv": dense_init((d, Hkv, hd), dtype, generator, device),
        "wo": dense_init((H, hd, d), dtype, generator, device),
    }


def cross_attn_kv(params, enc_out):
    """enc_out (B, Se, d) -> k, v (B, Hkv, Se, hd)."""
    k = torch.einsum("bsd,dhk->bhsk", enc_out, params["wk"])
    v = torch.einsum("bsd,dhk->bhsk", enc_out, params["wv"])
    return k, v


def cross_attn_apply(params, x, enc_out, cfg):
    """x (B, S, d) attends to every row of enc_out (B, Se, d): non-causal
    full-sequence attention (the flash kernel). The encoder's K/V are
    activations, not a cache, so they are never quantized."""
    q = torch.einsum("bsd,dhk->bhsk", x, params["wq"])
    k, v = cross_attn_kv(params, enc_out)
    o = attention(q, k, v, cfg, causal=False)
    return torch.einsum("bhsk,hkd->bsd", o, params["wo"])


def cross_attn_decode(params, x1, kv, enc_len, cfg):
    """x1 (B, d) one token against the encoder's ``kv`` (k, v
    (B, Hkv, Se, hd)), the first ``enc_len`` (B,) rows of each valid: the
    reference's one-pass "xla" decode (``decode_one_pass``) on every
    device, as ``repro`` forces it for cross K/V."""
    q = torch.einsum("bd,dhk->bhk", x1, params["wq"])
    k, v = kv
    spec = AttentionSpec.from_config(cfg, kv_dtype="fp32").replace(
        decode_impl="xla")
    o = dispatch_decode(spec, q, k, v, enc_len)
    return torch.einsum("bhk,hkd->bd", o, params["wo"])


def _init_kv(shape, cfg, dtype, device):
    """KV buffers of ``shape + (head_dim,)``: values in ``dtype``, or codes
    plus float32 scale rows of ``shape`` for a quantized ``cfg.kv_dtype``;
    each with one token's row of scratch (Hkv rows of its last axis)."""
    hd, Hkv = cfg.resolved_head_dim(), cfg.num_kv_heads
    full = shape + (hd,)

    def zeros(shp, dt):
        return zeros_with_scratch(shp, Hkv * math.prod(shp[len(shape):]),
                                  dt, device)

    if kv_quantized(cfg):
        cd = kv_code_dtype(cfg.kv_dtype)
        return {
            "k": zeros(full, cd),
            "v": zeros(full, cd),
            "k_scale": zeros(shape, torch.float32),
            "v_scale": zeros(shape, torch.float32),
        }
    return {"k": zeros(full, dtype), "v": zeros(full, dtype)}


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
    S = cache["k"].shape[2]
    write_pos = lengths if write_pos is None else write_pos
    attn_len = lengths + 1 if attn_len is None else attn_len
    q, k, v = _project_token(params, x1, cfg, lengths)
    new = _quantized(cfg, k, v)
    slot = torch.clamp(write_pos.to(torch.int64), 0, S - 1)
    for name, val in new.items():
        write_slot(cache[name], val, slot, seq_dim=2)
    o = dispatch_decode(AttentionSpec.from_config(cfg), q, *_kv(cfg, cache),
                        attn_len)
    return cache, torch.einsum("bhk,hkd->bd", o, params["wo"])


def chunk_index(positions, gate, span, heads):
    """The destination of every (row, chunk token, KV head) of a chunk
    write, (B*C*Hkv,) int64 in that order, into a per-slot buffer
    (B, Hkv, span, ...) seen as its B*Hkv*span rows of the last axes:
    gated-on tokens whose slot ``positions`` lies in ``[0, span)`` at their
    row, every other at the scratch row of its head, B*Hkv*span + h. Every
    layer of a tick writes the same slots, so the model computes it once
    per tick, on the device, with no sync."""
    B, C = positions.shape
    keep = gate & (positions >= 0) & (positions < span)
    h = torch.arange(heads, device=positions.device)
    b = torch.arange(B, device=positions.device)
    row = (b[:, None, None] * heads + h) * span + positions[:, :, None]
    return torch.where(keep[:, :, None], row,
                       B * heads * span + h).reshape(-1)


def chunk_write(buf, new, index):
    """Write a chunk of C tokens into a per-slot buffer **in place**.

    buf (B, Hkv, span, ...), new (B, Hkv, C, ...); ``index`` is the
    ``chunk_index`` of the write. The kept slots of a row are distinct (the
    gate keeps only the last ``span`` tokens of a rolling buffer) and only
    scratch rows take two writes, so the write is deterministic. Returns
    buf.
    """
    tail = buf.shape[3:]
    vals = new.transpose(1, 2).reshape((-1,) + tail)     # (b, c, h) order
    rows_with_scratch(buf, tail, buf.shape[1]).index_copy_(
        0, index, vals.to(buf.dtype))
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


def attn_prefill_step(params, cache, x, cfg, lengths, n_valid, index, *,
                      window=None):
    """x (B, C, d) a chunk at absolute positions ``lengths + [0, C)``;
    ``n_valid`` (B,) valid chunk tokens (0 for idle slots, which write
    nothing). The chunk attends to [cache ++ chunk] (the cache read as a
    rolling buffer when ``window`` is set), then its valid tokens are
    written as the tick's ``chunk_index`` of ``chunk_gate`` says."""
    C = x.shape[1]
    positions = lengths[:, None] + torch.arange(C, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)
    new = _quantized(cfg, k, v)
    if not kv_quantized(cfg):
        new = {name: t.to(cache[name].dtype) for name, t in new.items()}
    o = dispatch_prefill(AttentionSpec.from_config(cfg, window=window), q,
                         *_kv(cfg, cache), *_kv(cfg, new), lengths=lengths,
                         n_valid=n_valid, rolling=window is not None)
    for name, val in new.items():
        chunk_write(cache[name], val, index)
    return cache, torch.einsum("bhsk,hkd->bsd", o, params["wo"])


def attn_init_paged_cache(cfg, pool_tokens, dtype, device):
    """Flat pools of one row per pooled token (no batch axis)."""
    return _init_kv((pool_tokens, cfg.num_kv_heads), cfg, dtype, device)


def attn_paged_decode_step(params, pool, x1, cfg, lengths, write_index, *,
                           window=None, block_tables, page_size):
    """x1 (B, d) one token at absolute position ``lengths``; write_index
    (B,) the ``kernels.paged.scatter_index`` of its physical row
    (``token_rows``). Idle slots carry sentinel rows, so their writes go
    to the scratch row and their scores are fully masked."""
    q, k, v = _project_token(params, x1, cfg, lengths)
    for name, val in _quantized(cfg, k, v).items():
        scatter_fixed(pool[name], write_index, val)
    o = dispatch_paged_decode(AttentionSpec.from_config(cfg, window=window),
                              q, *_kv(cfg, pool), None, lengths + 1,
                              block_tables=block_tables, page_size=page_size)
    return pool, torch.einsum("bhk,hkd->bd", o, params["wo"])


def attn_paged_prefill_step(params, pool, x, cfg, lengths, n_valid,
                            write_index, *, window=None, block_tables,
                            page_size):
    """x (B, C, d) a chunk at absolute positions ``lengths + [0, C)``;
    write_index (B*C,) the ``kernels.paged.scatter_index`` of its physical
    rows, the invalid ones at the scratch row. The chunk attends to
    [paged history ++ chunk], then its valid tokens are scattered."""
    B, C, _ = x.shape
    positions = lengths[:, None] + torch.arange(C, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)

    def flat(t):  # (B, Hkv, C, ...) -> (B*C, Hkv, ...) token-major
        return t.transpose(1, 2).reshape((B * C, t.shape[1]) + t.shape[3:])

    new = _quantized(cfg, k, v)
    if not kv_quantized(cfg):
        new = {name: t.to(pool[name].dtype) for name, t in new.items()}
    o = dispatch_paged_prefill(
        AttentionSpec.from_config(cfg, window=window), q, *_kv(cfg, new),
        *_kv(cfg, pool), None, lengths=lengths, n_valid=n_valid,
        block_tables=block_tables, page_size=page_size)
    for name, val in new.items():
        scatter_fixed(pool[name], write_index, flat(val))
    return pool, torch.einsum("bhsk,hkd->bsd", o, params["wo"])

"""Multi-head latent attention (MiniCPM3 / DeepSeek-V2 family): the port of
``repro/layers/mla.py``.

Queries and keys/values come through low-rank latents, and the caches
store only the KV latent and the shared RoPE key (``kv_lora_rank +
qk_rope_dim`` features a token instead of ``2 * H * hd``). Each serving
tick expands the history's latents to full K (``qk_nope_dim +
qk_rope_dim``) and V (``v_head_dim``) for every head (``_expand_latents``)
and hands them to the registry's **contiguous** decode and prefill
tables (``cfg.attention_impl`` "kernel": the contiguous kernels at Dq !=
Dv) on either layout, at ``kv_dtype="fp32"``, as the reference's MLA
dispatches: the paged pool holds the latents, which a tick gathers
through its block tables, so an MLA layer never launches a paged kernel
and ``attention_paged_impl`` does not reach it. The absorbed-matmul
decode is not part of ``repro`` and not ported.

With a quantized ``cfg.kv_dtype`` the latents are what is quantized: codes
plus one float32 scale per token for each of ``kv_lat`` and ``k_rope``,
dequantized right before the expansion, whose product with a bfloat16
``w_ukv`` is then float32 (JAX's type promotion, kept). The expanded K/V
are never quantized themselves.

The caches are written in place at a fixed shape, with no sync, as
``attention_layer.py``'s are (``kernels.paged.scatter_fixed`` into the
storage's scratch row), so a serving tick can be captured in a CUDA graph.
Windowed MLA is refused on the serving paths, as ``repro`` refuses it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.attention import attention
from repro_torch.kernels.paged import (
    gather_dequant_rows,
    gather_rows,
    quant_scatter_fixed,
    scatter_fixed,
    zeros_with_scratch,
)
from repro_torch.kernels.registry import (
    KERNEL_FAMILY,
    AttentionSpec,
    dispatch_decode,
    dispatch_prefill,
)
from repro_torch.layers.common import dense_init, rmsnorm, rmsnorm_init
from repro_torch.layers.rotary import apply_rope
from repro_torch.sharding.regions import pad, write_slot
from repro_torch.numerics.quant import (
    QUANT_KV_DTYPES,
    dequantize_kv,
    fake_quant_kv,
    kv_code_dtype,
)


def _quantized(cfg) -> bool:
    return cfg.kv_dtype in QUANT_KV_DTYPES


def _scale(cfg) -> float:
    m = cfg.mla
    return 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)


def _spec(cfg):
    """The serving spec: the contiguous decode and prefill tables on both
    layouts, over expanded K/V that are never quantized themselves."""
    return AttentionSpec.from_config(cfg, kv_dtype="fp32")


def mla_init(cfg, dtype, generator, device):
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk_head = m.qk_nope_dim + m.qk_rope_dim
    return {
        "w_dq": dense_init((d, m.q_lora_rank), dtype, generator, device),
        "q_norm": rmsnorm_init(m.q_lora_rank, dtype, device),
        "w_uq": dense_init((m.q_lora_rank, H, qk_head), dtype, generator,
                           device),
        "w_dkv": dense_init((d, m.kv_lora_rank + m.qk_rope_dim), dtype,
                            generator, device),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, dtype, device),
        "w_ukv": dense_init((m.kv_lora_rank, H, m.qk_nope_dim + m.v_head_dim),
                            dtype, generator, device),
        "wo": dense_init((H, m.v_head_dim, d), dtype, generator, device),
    }


def _mla_q(params, x, cfg, positions):
    """x (B, S, d) -> q (B, H, S, qk_nope + qk_rope), RoPE on its tail."""
    m = cfg.mla
    q_lat = rmsnorm(params["q_norm"], x @ params["w_dq"])
    q = torch.einsum("bsr,rhk->bhsk", q_lat, params["w_uq"])
    q_rope = apply_rope(q[..., m.qk_nope_dim:], positions[:, None, :],
                        cfg.rope_base)
    return torch.cat([q[..., :m.qk_nope_dim], q_rope], dim=-1)


def _mla_latents(params, x, cfg, positions):
    """x (B, S, d) -> the normed KV latent (B, S, rank) and the shared key
    (B, S, rope), roped at ``positions`` (B, S)."""
    m = cfg.mla
    dkv = x @ params["w_dkv"]
    kv_lat = rmsnorm(params["kv_norm"], dkv[..., :m.kv_lora_rank])
    k_rope = apply_rope(dkv[:, None, :, m.kv_lora_rank:],
                        positions[:, None, :], cfg.rope_base)[:, 0]
    return kv_lat, k_rope


def _expand_latents(params, kv_lat, k_rope, cfg):
    """(B, S, rank) + (B, S, rope) latents -> K (B, H, S, qk_nope + qk_rope)
    and V (B, H, S, v), each contiguous. A float32 (dequantized) latent
    takes the weights in float32, as JAX promotes."""
    m = cfg.mla
    B, S, _ = kv_lat.shape
    w = params["w_ukv"].to(torch.promote_types(kv_lat.dtype,
                                               params["w_ukv"].dtype))
    ukv = torch.einsum("bsr,rhk->bhsk", kv_lat.to(w.dtype), w)
    k_rope = k_rope.to(ukv.dtype)[:, None].expand(B, cfg.num_heads, S,
                                                  m.qk_rope_dim)
    k = torch.cat([ukv[..., :m.qk_nope_dim], k_rope], dim=-1)
    return k, ukv[..., m.qk_nope_dim:].contiguous()


def mla_apply(params, x, cfg, *, positions=None, causal=True, window=None):
    """x (B, S, d) -> (B, S, d): full-sequence MLA of the training path,
    over the expanded latents. At a quantized ``cfg.kv_dtype`` the latents
    (what a quantized cache stores) are fake-quantized before the
    expansion, as ``repro`` does, so ``forward`` matches a round trip
    through a latent cache. The flash routes (``KERNEL_FAMILY``) take
    Dv == Dq only, as the reference's Pallas kernel does: V is zero-padded
    to the qk width (96 for minicpm3-4b), or q and K to the v width where
    it is the wider, and the padding's output columns dropped. Each output
    column is its own value chain over the same weights, and zero features
    appended to a score's fmaf chain leave it bit for bit, so no number
    changes; the scale stays the qk width's. Every other route takes K and
    V as they are, as ``repro``'s ``flash_jnp`` does."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q = _mla_q(params, x, cfg, positions)
    kv_lat, k_rope = _mla_latents(params, x, cfg, positions)
    if _quantized(cfg):
        kv_lat = fake_quant_kv(kv_lat, cfg.kv_dtype)
        k_rope = fake_quant_kv(k_rope, cfg.kv_dtype)
    k, v = _expand_latents(params, kv_lat, k_rope, cfg)
    Dv, D = v.shape[-1], k.shape[-1]
    if cfg.attention_impl in KERNEL_FAMILY and Dv != D:
        W = max(D, Dv)

        def widen(t):
            return pad(t, (0, W - t.shape[-1])) if t.shape[-1] < W else t

        o = attention(widen(q), widen(k), widen(v), cfg, causal=causal,
                      window=window, scale=_scale(cfg))[..., :Dv]
    else:
        o = attention(q, k, v, cfg, causal=causal, window=window,
                      scale=_scale(cfg))
    return torch.einsum("bhsk,hkd->bsd", o, params["wo"])


def _init_latents(shape, cfg, dtype, device):
    """Latent buffers of ``shape + (features,)``: ``kv_lat`` and ``k_rope``
    in ``dtype``, or codes plus float32 scales of ``shape`` for a quantized
    ``cfg.kv_dtype``; each with one token's row of scratch past its end."""
    m = cfg.mla

    def zeros(feats, dt):
        full = shape + ((feats,) if feats else ())
        return zeros_with_scratch(full, feats or 1, dt, device)

    if _quantized(cfg):
        cd = kv_code_dtype(cfg.kv_dtype)
        return {"kv_lat": zeros(m.kv_lora_rank, cd),
                "k_rope": zeros(m.qk_rope_dim, cd),
                "kv_lat_scale": zeros(0, torch.float32),
                "k_rope_scale": zeros(0, torch.float32)}
    return {"kv_lat": zeros(m.kv_lora_rank, dtype),
            "k_rope": zeros(m.qk_rope_dim, dtype)}


def mla_init_cache(cfg, batch, max_len, dtype, device):
    """Per-slot latent caches (batch, max_len, features)."""
    return _init_latents((batch, max_len), cfg, dtype, device)


def mla_init_paged_cache(cfg, pool_tokens, dtype, device):
    """Flat latent pools of one row per pooled token (DESIGN.md §7): paging
    and latent compression compose."""
    return _init_latents((pool_tokens,), cfg, dtype, device)


def _rows(t):
    """A per-slot buffer (B, S, ...) as its B*S rows (a view)."""
    return t.view((-1,) + tuple(t.shape[2:]))


def _write(cache, index, kv_lat, k_rope, cfg, flat=lambda t: t):
    """Write the latents (quantized to codes and scales when the cache
    holds codes) to rows ``index`` (``scatter_index`` or ``chunk_index``
    order) of each buffer seen through ``flat``, in place. Returns the
    values attention reads back for them: the dequantized latents, or
    these."""
    out = []
    for name, val in (("kv_lat", kv_lat), ("k_rope", k_rope)):
        rows = val.reshape((-1, val.shape[-1]))
        if _quantized(cfg):
            q = quant_scatter_fixed(flat(cache[name]),
                                    flat(cache[f"{name}_scale"]), index,
                                    rows, cfg.kv_dtype)
            val = dequantize_kv(q.codes, q.scale,
                                cfg.kv_dtype).reshape(val.shape)
        else:
            scatter_fixed(flat(cache[name]), index, rows)
        out.append(val)
    return tuple(out)


def _read(cache, cfg, read=lambda t: t):
    """The history's latents through ``read`` (a gather, or the buffers
    themselves), dequantized when the cache holds codes."""
    if _quantized(cfg):
        return tuple(dequantize_kv(read(cache[name]),
                                   read(cache[f"{name}_scale"]), cfg.kv_dtype)
                     for name in ("kv_lat", "k_rope"))
    return read(cache["kv_lat"]), read(cache["k_rope"])


def _decode(params, x1, cfg, lengths, k, v):
    q = _mla_q(params, x1[:, None, :], cfg, lengths[:, None])[:, :, 0]
    o = dispatch_decode(_spec(cfg), q, k, v, lengths + 1, scale=_scale(cfg))
    return torch.einsum("bhk,hkd->bd", o, params["wo"])


def mla_decode_step(params, cache, x1, cfg, lengths, index):
    """x1 (B, d) one token at position ``lengths`` (B,) against per-slot
    latent caches: its latents land in slot ``lengths`` (clamped to the
    last slot, as JAX's dynamic_update_slice does), ``index`` being that
    slot's row of ``_rows`` (``b * S + slot``); then the whole cache is
    expanded and the first ``lengths + 1`` slots attended."""
    kv_lat, k_rope = _mla_latents(params, x1[:, None, :], cfg,
                                  lengths[:, None])
    if _quantized(cfg):
        _write(cache, index, kv_lat, k_rope, cfg, flat=_rows)
    else:      # slot ``lengths`` of each row (``index``'s rows)
        slot = torch.clamp(lengths.to(torch.int64), 0,
                           cache["kv_lat"].shape[1] - 1)
        for name, val in (("kv_lat", kv_lat), ("k_rope", k_rope)):
            write_slot(cache[name], val[:, 0], slot, seq_dim=1)
    k, v = _expand_latents(params, *_read(cache, cfg), cfg)
    return cache, _decode(params, x1, cfg, lengths, k, v)


def _refuse_window(cfg):
    if cfg.window:
        raise NotImplementedError("windowed MLA chunked prefill")


def _prefill(params, x, cfg, lengths, n_valid, history, write):
    """The chunk's queries against [expanded history ++ expanded chunk];
    ``history`` gives the resident latents (read before the chunk's
    write), ``write`` stores the chunk's and returns what attention reads
    back for them."""
    C = x.shape[1]
    positions = (lengths[:, None].to(torch.int64)
                 + torch.arange(C, device=x.device)[None, :])
    q = _mla_q(params, x, cfg, positions)
    kv_lat, k_rope = _mla_latents(params, x, cfg, positions)
    k_cache, v_cache = _expand_latents(params, *history, cfg)
    k_chunk, v_chunk = _expand_latents(params, *write(kv_lat, k_rope), cfg)
    o = dispatch_prefill(_spec(cfg), q, k_cache, v_cache, k_chunk, v_chunk,
                         lengths=lengths, n_valid=n_valid, scale=_scale(cfg))
    return torch.einsum("bhsk,hkd->bsd", o, params["wo"])


def mla_prefill_step(params, cache, x, cfg, lengths, n_valid, index):
    """x (B, C, d) a chunk at positions ``lengths + [0, C)`` against
    per-slot latent caches; ``index`` (B*C,) the ``chunk_index`` of its
    writes into ``_rows`` (the tokens past ``n_valid`` or the cache at the
    scratch row). The pre-chunk cache is expanded whole, then the chunk's
    valid latents are written."""
    _refuse_window(cfg)
    history = _read(cache, cfg)
    out = _prefill(params, x, cfg, lengths, n_valid, history,
                   lambda lat, rope: _write(cache, index, lat, rope, cfg,
                                            flat=_rows))
    return cache, out


def mla_paged_decode_step(params, pool, x1, cfg, lengths, write_index, rows):
    """x1 (B, d) one token at position ``lengths`` against latent pools:
    its latents are scattered at ``write_index`` (``scatter_index`` of its
    physical row), then the history is gathered through ``rows`` (B, L)
    (``slot_rows`` of the block tables, logical order; sentinel rows read
    0), expanded and attended as on the contiguous layout."""
    kv_lat, k_rope = _mla_latents(params, x1[:, None, :], cfg,
                                  lengths[:, None])
    _write(pool, write_index, kv_lat, k_rope, cfg)
    k, v = _expand_latents(params, *_gather(pool, rows, cfg), cfg)
    return pool, _decode(params, x1, cfg, lengths, k, v)


def _gather(pool, rows, cfg):
    if _quantized(cfg):
        return tuple(gather_dequant_rows(pool[name], pool[f"{name}_scale"],
                                         rows, cfg.kv_dtype)
                     for name in ("kv_lat", "k_rope"))
    return gather_rows(pool["kv_lat"], rows), gather_rows(pool["k_rope"], rows)


def mla_paged_prefill_step(params, pool, x, cfg, lengths, n_valid,
                           write_index, rows):
    """x (B, C, d) a chunk against latent pools: the resident history is
    gathered through ``rows`` and expanded once, the chunk attends to
    [history ++ chunk], and its valid latents are scattered at
    ``write_index`` (B*C,)."""
    _refuse_window(cfg)
    history = _gather(pool, rows, cfg)
    out = _prefill(params, x, cfg, lengths, n_valid, history,
                   lambda lat, rope: _write(pool, write_index, lat, rope,
                                            cfg))
    return pool, out

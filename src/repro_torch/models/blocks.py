"""Residual blocks, dispatched on their kind (``attn``, ``rglru``,
``mlstm`` or ``slstm``): norm -> mix -> residual, then for ``attn`` and
``rglru`` (when ``d_ff`` or ``moe`` gives one) norm -> MLP (SwiGLU, GeGLU
or plain GELU), or for a config with ``cfg.moe`` the mixture of experts
(``layers/moe.py``) -> residual, over the full sequence (training) or
over per-slot (contiguous) caches or a paged KV pool (serving). The
``attn`` mix is GQA (``layers/attention_layer.py``) or, for a config with
``cfg.mla``, multi-head latent attention (``layers/mla.py``), whose caches
and pools hold latents; the ``rglru`` mix is the RG-LRU temporal block
(``layers/rglru.py``); ``mlstm`` and ``slstm`` are the xLSTM blocks
(``layers/xlstm.py``), which carry their own projections and no FFN. A
recurrent kind's O(1) per-slot state (``h``, ``conv``; ``C``, ``n``,
``m``; ``c``, ``n``, ``h``, ``m``) stays per slot on the paged layout
too: no pool, no quantization. The norms are ``cfg.norm``'s (RMSNorm, or
LayerNorm with a bias)."""
from __future__ import annotations

from typing import Callable, NamedTuple

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
from repro_torch.layers.common import make_norm
from repro_torch.layers.mla import (
    mla_apply,
    mla_decode_step,
    mla_init,
    mla_init_cache,
    mla_paged_decode_step,
    mla_paged_prefill_step,
    mla_prefill_step,
)
from repro_torch.layers.mlp import mlp_apply, mlp_init
from repro_torch.layers.moe import moe_apply, moe_init
from repro_torch.layers.rglru import (
    rglru_apply,
    rglru_decode_step,
    rglru_init,
    rglru_init_cache,
    rglru_prefill_step,
)
from repro_torch.layers.xlstm import (
    mlstm_apply,
    mlstm_decode_step,
    mlstm_init,
    mlstm_init_cache,
    mlstm_prefill_step,
    slstm_apply,
    slstm_decode_step,
    slstm_init,
    slstm_init_cache,
    slstm_prefill_step,
)
from repro_torch.sharding.constraints import gather_fsdp

KINDS = ("attn", "rglru", "mlstm", "slstm")


class _Forms(NamedTuple):
    """A recurrent kind's functions: its init, the full-sequence forward,
    the per-slot cache, the decode step and the chunked prefill step."""
    init: Callable
    apply: Callable
    init_cache: Callable
    decode: Callable
    prefill: Callable


_RECURRENT = {
    "rglru": _Forms(rglru_init, rglru_apply, rglru_init_cache,
                    rglru_decode_step, rglru_prefill_step),
    "mlstm": _Forms(mlstm_init, mlstm_apply, mlstm_init_cache,
                    mlstm_decode_step, mlstm_prefill_step),
    "slstm": _Forms(slstm_init, slstm_apply, slstm_init_cache,
                    slstm_decode_step, slstm_prefill_step),
}


def _check_kind(kind):
    if kind not in KINDS:
        raise ValueError(f"block kind {kind!r} is not ported; ported: "
                         f"{KINDS}")


def _has_ffn(cfg, kind):
    """``repro``'s rule: attention and RG-LRU blocks have an FFN when the
    config gives one; xLSTM blocks never do."""
    return kind in ("attn", "rglru") and (cfg.d_ff > 0 or cfg.moe is not None)


def norm_fn(cfg):
    """The apply function of ``cfg.norm``."""
    return make_norm(cfg.norm)[1]


def block_init(cfg, kind, dtype, generator, device):
    _check_kind(kind)
    norm_init = make_norm(cfg.norm)[0]
    mix = (_RECURRENT[kind].init if kind in _RECURRENT else
           mla_init if cfg.mla else attn_init)
    p = {"norm_mix": norm_init(cfg.d_model, dtype, device),
         "mix": mix(cfg, dtype, generator, device)}
    if _has_ffn(cfg, kind):
        p["norm_ffn"] = norm_init(cfg.d_model, dtype, device)
        p["ffn"] = (moe_init(cfg, dtype, generator, device) if cfg.moe else
                    mlp_init(cfg.d_model, cfg.d_ff, cfg.activation, dtype,
                             generator, device))
    return p


def gather_block(params, cfg):
    """A block's weights gathered over the DP axes on a mesh
    (``gather_fsdp``), but for an MoE FFN's, which ``moe_apply`` gathers
    itself."""
    if not (cfg.moe and "ffn" in params):
        return gather_fsdp(params)
    rest = gather_fsdp({k: v for k, v in params.items() if k != "ffn"})
    return {**rest, "ffn": params["ffn"]}


def ffn(params, x, cfg, moe_impl="scatter"):
    """x + FFN(norm(x)) over x (B, C, d), or over x (B, d) of a decode
    tick: there the MoE sees the slots as its tokens, (B, 1, d) as
    ``repro`` hands it ``h[:, None, :]``. A block without an FFN returns
    x."""
    if "ffn" not in params:
        return x
    h = norm_fn(cfg)(params["norm_ffn"], x)
    if not cfg.moe:
        return x + mlp_apply(params["ffn"], h, cfg.activation)
    if h.dim() == 2:
        return x + moe_apply(params["ffn"], h[:, None, :], cfg,
                             impl=moe_impl)[:, 0]
    return x + moe_apply(params["ffn"], h, cfg, impl=moe_impl)


def block_apply(params, x, cfg, kind, moe_impl="scatter", *, positions=None,
                causal=True):
    """One block over the full sequence x (B, S, d); an attention layer at
    RoPE ``positions`` (default ``arange(S)`` a row), causal or not (an
    encoder's)."""
    h = norm_fn(cfg)(params["norm_mix"], x)
    if kind in _RECURRENT:
        h = _RECURRENT[kind].apply(params["mix"], h, cfg)
    else:
        h = (mla_apply if cfg.mla else attn_apply)(
            params["mix"], h, cfg, positions=positions, causal=causal,
            window=cfg.window or None)
    return ffn(params, x + h, cfg, moe_impl)


def block_init_cache(cfg, kind, batch, max_len, dtype, device):
    """Per-slot caches; a windowed layer keeps only a rolling buffer of
    ``min(max_len, window)`` slots. MLA latent caches keep ``max_len``; a
    recurrent layer keeps its state of one token a slot."""
    _check_kind(kind)
    if kind in _RECURRENT:
        return _RECURRENT[kind].init_cache(cfg, batch, dtype, device)
    if cfg.mla:
        return mla_init_cache(cfg, batch, max_len, dtype, device)
    span = min(max_len, cfg.window) if cfg.window else max_len
    return attn_init_cache(cfg, batch, span, dtype, device)


def block_prefill(params, cache, x, cfg, kind, lengths, n_valid, index):
    """Chunked prefill through one block; ``index`` is the tick's
    ``chunk_index`` of the cache writes (attention layers only)."""
    h = norm_fn(cfg)(params["norm_mix"], x)
    if kind in _RECURRENT:
        cache, h = _RECURRENT[kind].prefill(params["mix"], cache, h, cfg,
                                            n_valid)
    elif cfg.mla:
        cache, h = mla_prefill_step(params["mix"], cache, h, cfg, lengths,
                                    n_valid, index)
    else:
        cache, h = attn_prefill_step(params["mix"], cache, h, cfg, lengths,
                                     n_valid, index, window=cfg.window)
    return cache, ffn(params, x + h, cfg)


def block_decode_step(params, cache, x1, cfg, kind, lengths, index=None):
    """One decode token through one block; a windowed layer's rolling
    buffer takes the token at slot ``lengths % span`` and attends to its
    last ``min(lengths + 1, span)`` slots. An MLA layer writes its latents
    at ``index``, the tick's rows of slots ``lengths``."""
    h = norm_fn(cfg)(params["norm_mix"], x1)
    if kind in _RECURRENT:
        cache, h = _RECURRENT[kind].decode(params["mix"], cache, h, cfg)
    elif cfg.mla:
        cache, h = mla_decode_step(params["mix"], cache, h, cfg, lengths,
                                   index)
    elif cfg.window:
        span = cache["k"].shape[2]
        cache, h = attn_decode_step(
            params["mix"], cache, h, cfg, lengths,
            write_pos=torch.remainder(lengths, span),
            attn_len=torch.clamp(lengths + 1, max=span))
    else:
        cache, h = attn_decode_step(params["mix"], cache, h, cfg, lengths)
    return cache, ffn(params, x1 + h, cfg)


def block_paged_prefill(params, cache, x, cfg, kind, lengths, n_valid,
                        write_index, block_tables, page_size, rows=None):
    """Chunked prefill through one block over a paged pool; an MLA layer
    gathers its latent history through ``rows`` (``slot_rows``). A
    recurrent layer takes its per-slot path."""
    if kind != "attn":
        return block_prefill(params, cache, x, cfg, kind, lengths, n_valid,
                             None)
    h = norm_fn(cfg)(params["norm_mix"], x)
    if cfg.mla:
        cache, h = mla_paged_prefill_step(params["mix"], cache, h, cfg,
                                          lengths, n_valid, write_index, rows)
    else:
        cache, h = attn_paged_prefill_step(
            params["mix"], cache, h, cfg, lengths, n_valid, write_index,
            window=cfg.window, block_tables=block_tables,
            page_size=page_size)
    return cache, ffn(params, x + h, cfg)


def block_paged_decode_step(params, cache, x1, cfg, kind, lengths,
                            write_index, block_tables, page_size, rows=None):
    if kind != "attn":
        return block_decode_step(params, cache, x1, cfg, kind, lengths)
    h = norm_fn(cfg)(params["norm_mix"], x1)
    if cfg.mla:
        cache, h = mla_paged_decode_step(params["mix"], cache, h, cfg,
                                         lengths, write_index, rows)
    else:
        cache, h = attn_paged_decode_step(
            params["mix"], cache, h, cfg, lengths, write_index,
            window=cfg.window, block_tables=block_tables,
            page_size=page_size)
    return cache, ffn(params, x1 + h, cfg)

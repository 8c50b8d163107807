"""Model assembly: init, the full-sequence forward and loss of training,
and for serving the decode state, chunked prefill and single-token decode
over per-slot (contiguous) caches or paged pools; for an encoder-decoder
the encoder pass and the decode step with cross-attention (the port of
``repro/models/api.py``).

Parameters are a dict of tensors with ``repro``'s layouts
(``wq (d, H, hd)``, ``wo (H, hd, d)``, ...; an MLA config's ``w_dq``,
``w_uq``, ``w_dkv``, ``w_ukv``, ``wo`` and its two norms; an MoE config's
``ffn`` holds ``router``, the expert stacks ``w_up``, ``w_gate``,
``w_down`` (E, ., .) and its ``dense`` residual; an untied head is
``embed.out``), one entry of ``"layers"`` per layer in true layer order,
layer ``l`` of kind ``cfg.pattern_for()[l]`` (``attn``, ``rglru``,
``mlstm`` or ``slstm``); the layer loop is a Python loop. A config with
a frontend has ``frontend_proj`` (frontend_dim, d). An encoder-decoder
(``cfg.encoder_layers``) has ``enc_layers`` (of kinds
``cfg.pattern_for(encoder_layers)``), ``enc_final_norm`` and
``dec_layers`` in place of ``layers``: each decoder layer an attention
block with ``norm_cross`` and ``cross`` (``layers/attention_layer.py``)
between its self-attention and its FFN. Norms are ``cfg.norm``'s. An MLA
config's caches and pools hold latents (``layers/mla.py``). The state is
one dict of caches per layer: an attention layer's KV cache or pool, or a
recurrent layer's per-slot state (RG-LRU's ``h`` and ``conv``, mLSTM's
``C``, ``n``, ``m``, sLSTM's ``c``, ``n``, ``h``, ``m``; the stabilizers
``m`` start at -1e30), on the paged layout too. A pattern with no
attention layer (xlstm-1.3b) has no KV: its ticks build no cache index.
The state is updated in place: ``prefill``, ``decode_step``
and their paged twins return it for symmetry with ``repro``. Those four
read no tensor's value on the host and allocate at fixed shapes, so a
tick of them can be captured in a CUDA graph (``serve/graphs.py``); on
the kernel path, that is, since the plain versions read the longest
length. An MoE layer routes every row of a tick, idle and padding rows
too, as ``repro`` does (``layers/moe.py``), without a host read.

An encoder-decoder serves through ``init_decode_state(enc_len=)``,
``encode_for_decode`` and ``decode_step``, the one serving path
``repro`` has for it: its state holds per decoder layer a self-attention
cache, the encoder's cross K/V and each row's ``enc_len``. Paged state,
chunked prefill and the paged ticks refuse it, as ``repro``'s do.

Entry points take ``device="cuda"`` by default and raise without a card
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.paged import scatter_index, slot_rows, token_rows
from repro_torch.layers.attention_layer import (
    attn_apply,
    attn_decode_step,
    attn_init_paged_cache,
    chunk_gate,
    chunk_index,
    cross_attn_apply,
    cross_attn_decode,
    cross_attn_init,
    cross_attn_kv,
)
from repro_torch.layers.common import dense_init, make_norm
from repro_torch.layers.embedding import embed_apply, embed_init, logits_apply
from repro_torch.layers.mla import mla_init_paged_cache
from repro_torch.models.blocks import (
    block_apply,
    block_decode_step,
    block_init,
    block_init_cache,
    block_paged_decode_step,
    block_paged_prefill,
    block_prefill,
    ffn,
    norm_fn,
)
from repro_torch.sharding.constraints import (
    constrain,
    gather_fsdp,
    model_axis_size,
)
from repro_torch.sharding.regions import gather_last


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the kernels' plain "
            "PyTorch versions")
    return device


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def init_model(cfg, generator: torch.Generator | None = None, *,
               device="cuda"):
    """Random parameters drawn from ``generator`` (a fresh generator seeded
    with 0 on ``device`` when None), in ``cfg.param_dtype``. On the
    ``meta`` device the full tree is built with nothing drawn (every leaf
    ``torch.empty`` of its shape and dtype, no generator): the dry run's
    shape-only model."""
    device = resolve_device(device)
    if device.type == "meta":
        generator = None
    elif generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    pd = _dtype(cfg.param_dtype)
    norm_init = make_norm(cfg.norm)[0]
    params = {"embed": embed_init(cfg, pd, generator, device),
              "final_norm": norm_init(cfg.d_model, pd, device)}
    if cfg.frontend:
        params["frontend_proj"] = dense_init(
            (cfg.frontend_dim, cfg.d_model), pd, generator, device)
    if not cfg.encoder_layers:
        params["layers"] = [block_init(cfg, kind, pd, generator, device)
                            for kind in cfg.pattern_for()]
        return params
    params["enc_layers"] = [block_init(cfg, kind, pd, generator, device)
                            for kind in cfg.pattern_for(cfg.encoder_layers)]
    params["enc_final_norm"] = norm_init(cfg.d_model, pd, device)
    params["dec_layers"] = []
    for _ in range(cfg.decoder_layers):
        p = block_init(cfg, "attn", pd, generator, device)
        p["norm_cross"] = norm_init(cfg.d_model, pd, device)
        p["cross"] = cross_attn_init(cfg, pd, generator, device)
        params["dec_layers"].append(p)
    return params


def _run(fn, cfg, *args, **kw):
    """``fn(*args, **kw)``, under a non-reentrant checkpoint with
    ``cfg.remat``."""
    if cfg.remat:
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return fn(*args, **kw)


def _boundary(x, cfg):
    """The block-boundary layout of the activations x (B, S, d) on a mesh,
    as ``repro``'s ``_run_stack`` pins it: the batch over the DP axes and,
    when the attention heads cannot use the 'model' axis, the sequence
    over it (the stack runs sequence-parallel; never for MoE). Off a mesh
    and on plain tensors ``constrain`` returns x itself."""
    msize = model_axis_size()
    seq_par = (msize > 0 and cfg.num_heads % msize != 0
               and x.shape[1] % msize == 0 and cfg.moe is None)
    return constrain(x, "batch", "model" if seq_par else None, None)


def _gathered(fn):
    """``fn(p, ...)`` on the layer's weights gathered over the DP axes
    (``gather_fsdp``; the weights themselves off a mesh)."""
    return lambda p, *args, **kw: fn(gather_fsdp(p), *args, **kw)


_block_apply = _gathered(block_apply)


def _run_stack(layers, kinds, x, cfg, moe_impl, causal=True):
    """The blocks of ``layers`` (of ``kinds``) over x, each between two
    block-boundary constraints."""
    for p, kind in zip(layers, kinds):
        x = _boundary(x, cfg)
        x = _run(_block_apply, cfg, p, x, cfg, kind, moe_impl, causal=causal)
        x = _boundary(x, cfg)
    return x


def encode(params, frontend_embeds, cfg, moe_impl="scatter"):
    """The encoder over the projected frames, every frame (padding too, as
    ``repro`` runs it), non-causal, then its final norm: (B, Se, d)."""
    x = frontend_embeds.to(_dtype(cfg.dtype)) @ params["frontend_proj"]
    x = _run_stack(params["enc_layers"], cfg.pattern_for(cfg.encoder_layers),
                   x, cfg, moe_impl, causal=False)
    return norm_fn(cfg)(params["enc_final_norm"], x)


def _dec_block_apply(p, x, enc_out, cfg, moe_impl="scatter"):
    """A decoder layer: causal self-attention, cross-attention to
    ``enc_out``, then the FFN, each pre-normed with a residual."""
    norm = norm_fn(cfg)
    x = x + attn_apply(p["mix"], norm(p["norm_mix"], x), cfg, causal=True)
    x = x + cross_attn_apply(p["cross"], norm(p["norm_cross"], x), enc_out,
                             cfg)
    return ffn(p, x, cfg, moe_impl)


def forward(params, batch, cfg, *, moe_impl="scatter"):
    """batch["tokens"] (B, S) [+ ``frontend_embeds`` (B, T, frontend_dim)]
    -> logits (B, S_total, V) in ``cfg.dtype``; an MoE config's FFN
    dispatches by ``moe_impl`` (``layers/moe.py``). A decoder-only config
    with a frontend prepends the projected ``frontend_embeds``, when
    given, to the text (S_total = T + S, positions counting the patches);
    an encoder-decoder encodes them and its decoder attends to them. With
    ``cfg.remat`` each layer runs under a non-reentrant
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
    layer): its activations are recomputed in the backward, which runs its
    attention forward a second time."""
    x = embed_apply(params["embed"], batch["tokens"], cfg).to(
        _dtype(cfg.dtype))
    if cfg.encoder_layers:
        enc_out = encode(params, batch["frontend_embeds"], cfg, moe_impl)
        for p in params["dec_layers"]:
            x = _run(_gathered(_dec_block_apply), cfg, p, x, enc_out, cfg,
                     moe_impl)
    else:
        if cfg.frontend and "frontend_embeds" in batch:
            fe = (batch["frontend_embeds"].to(_dtype(cfg.dtype))
                  @ params["frontend_proj"])
            x = torch.cat([fe, x], dim=1)
        x = _run_stack(params["layers"], cfg.pattern_for(), x, cfg,
                       moe_impl)
    x = norm_fn(cfg)(params["final_norm"], x)
    return logits_apply(params["embed"], x, cfg)


def loss_fn(params, batch, cfg, *, moe_impl="scatter"):
    """Next-token cross entropy over the text positions (a prepended
    frontend's are dropped) of ``forward(..., moe_impl=moe_impl)``, masked
    by ``batch["loss_mask"]`` when given,
    in the reference's order: the max of the logits, a float32 log-sum-exp
    of the shifted logits, a gather of the targets, then a masked mean.
    ``torch.amax`` splits the gradient among tied maxima evenly, as JAX's
    max does."""
    logits = forward(params, batch, cfg, moe_impl=moe_impl)
    n_front = logits.shape[1] - batch["tokens"].shape[1]
    logits = logits[:, n_front:-1]
    targets = batch["tokens"][:, 1:].to(torch.int64)
    mask = batch.get("loss_mask")
    mask = (torch.ones(targets.shape, dtype=torch.float32,
                       device=targets.device)
            if mask is None else mask[:, 1:])
    m = torch.amax(logits, dim=-1, keepdim=True)
    lse = m[..., 0].to(torch.float32) + torch.log(
        torch.sum(torch.exp((logits - m).to(torch.float32)), dim=-1))
    tgt = gather_last(logits, targets[..., None])[..., 0]
    nll = lse - tgt.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def init_decode_state(cfg, batch, max_len, *, enc_len=None, device="cuda"):
    """Per-slot KV state: per layer, caches of ``max_len`` slots (a rolling
    buffer of ``min(max_len, window)`` for a windowed config) for each of
    ``batch`` sequences; codes plus float32 scale rows for a quantized
    ``cfg.kv_dtype``. A recurrent layer's state is one token's a slot. An
    encoder-decoder's state also holds, per decoder layer, cross K/V of
    ``enc_len`` encoder rows (written by ``encode_for_decode``) and each
    row's valid ``enc_len``; it refuses a quantized ``kv_dtype``, as
    ``repro`` does."""
    device = resolve_device(device)
    dt = _dtype(cfg.dtype)
    if not cfg.encoder_layers:
        return {"caches": [block_init_cache(cfg, kind, batch, max_len, dt,
                                            device)
                           for kind in cfg.pattern_for()]}
    if cfg.kv_dtype != "fp32":
        raise NotImplementedError(
            "quantized KV serving targets decoder-only configs; encoder "
            "cross-attention K/V are recomputed activations, not a cache")
    if enc_len is None:
        raise TypeError("an encoder-decoder's decode state needs enc_len, "
                        "the number of encoder frames")
    shape = (batch, cfg.num_kv_heads, enc_len, cfg.resolved_head_dim())

    def zeros():
        return torch.zeros(shape, dtype=dt, device=device)

    return {"caches": [block_init_cache(cfg, "attn", batch, max_len, dt,
                                        device)
                       for _ in range(cfg.decoder_layers)],
            "cross_kv": [(zeros(), zeros())
                         for _ in range(cfg.decoder_layers)],
            "enc_len": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}


def encode_for_decode(params, state, frontend_embeds, enc_lengths, cfg):
    """Run the encoder once over ``frontend_embeds`` (B, Se, frontend_dim)
    and put each decoder layer's cross K/V of its output, and
    ``enc_lengths`` (B,), into the state; returns the state."""
    enc_out = encode(params, frontend_embeds, cfg)
    state["cross_kv"] = [cross_attn_kv(p["cross"], enc_out)
                         for p in params["dec_layers"]]
    state["enc_len"] = enc_lengths
    return state


def _attn_cache(state, cfg):
    """The cache of the first attention layer, whose geometry (span, pool
    rows) every attention layer shares; None without an attention
    layer."""
    kinds = cfg.pattern_for()
    return state["caches"][kinds.index("attn")] if "attn" in kinds else None


def _last_logits(params, x, n_valid, cfg):
    """Logits of each row's last valid chunk token."""
    B, C, _ = x.shape
    x = norm_fn(cfg)(params["final_norm"], x)
    last = torch.clamp(n_valid.to(torch.int64) - 1, 0, C - 1)
    return logits_apply(params["embed"], x[torch.arange(B, device=x.device),
                                           last], cfg)


def prefill(params, state, tokens, lengths, n_valid, cfg):
    """Chunked prefill against per-slot caches.

    tokens (B, C); lengths (B,) tokens already resident; n_valid (B,) valid
    chunk tokens (0 = idle slot, a no-op). Every layer attends over its
    cache and the chunk, then writes the chunk's valid tokens. Returns
    (logits (B, V) of each row's last valid token, state). An
    encoder-decoder is refused.
    """
    if cfg.encoder_layers:
        raise NotImplementedError("chunked prefill targets decoder-only "
                                  "configs; encoder-decoder serving uses "
                                  "encode_for_decode + decode_step")
    C = tokens.shape[1]
    x = embed_apply(params["embed"], tokens, cfg).to(_dtype(cfg.dtype))
    attn = _attn_cache(state, cfg)
    if attn is None:
        index = None
    elif cfg.mla:   # latent caches (B, max_len, ...): one row a token
        span = attn["kv_lat"].shape[1]
        idx = torch.arange(C, device=tokens.device)[None, :]
        index = chunk_index(lengths[:, None].to(torch.int64) + idx,
                            idx < n_valid[:, None], span, 1)
    else:
        span = attn["k"].shape[2]
        index = chunk_index(*chunk_gate(lengths, n_valid, C, span,
                                        rolling=bool(cfg.window)), span,
                            cfg.num_kv_heads)
    for p, cache, kind in zip(params["layers"], state["caches"],
                              cfg.pattern_for()):
        _, x = block_prefill(p, cache, x, cfg, kind, lengths, n_valid, index)
    return _last_logits(params, x, n_valid, cfg), state


def _decode_step_encdec(params, state, x, lengths, cfg):
    """The decoder layers of one token: self-attention over its per-slot
    cache (the contiguous decode kernel), cross-attention over the
    encoder's K/V (``cross_attn_decode``), then the FFN."""
    norm = norm_fn(cfg)
    for p, cache, kv in zip(params["dec_layers"], state["caches"],
                            state["cross_kv"]):
        p = gather_fsdp(p)
        _, h = attn_decode_step(p["mix"], cache, norm(p["norm_mix"], x), cfg,
                                lengths)
        x = x + h
        x = x + cross_attn_decode(p["cross"], norm(p["norm_cross"], x), kv,
                                  state["enc_len"], cfg)
        x = ffn(p, x, cfg)
    return x


def decode_step(params, state, tokens1, lengths, cfg):
    """One decode tick against per-slot caches: tokens1 (B,) at positions
    ``lengths`` -> (logits (B, V), state)."""
    x = embed_apply(params["embed"], tokens1, cfg).to(_dtype(cfg.dtype))
    if cfg.encoder_layers:
        x = _decode_step_encdec(params, state, x, lengths, cfg)
        x = norm_fn(cfg)(params["final_norm"], x)
        return logits_apply(params["embed"], x, cfg), state
    index = None
    if cfg.mla:   # slot lengths of each row (clamped to the last), as rows
        S = _attn_cache(state, cfg)["kv_lat"].shape[1]
        b = torch.arange(tokens1.shape[0], device=tokens1.device)
        index = b * S + torch.clamp(lengths.to(torch.int64), 0, S - 1)
    for p, cache, kind in zip(params["layers"], state["caches"],
                              cfg.pattern_for()):
        _, x = block_decode_step(gather_fsdp(p), cache, x, cfg, kind,
                                 lengths, index)
    x = norm_fn(cfg)(params["final_norm"], x)
    return logits_apply(params["embed"], x, cfg), state


def init_paged_state(cfg, slots, pool_blocks, page_size, *, device="cuda"):
    """Paged KV state: per attention layer, flat pools of ``pool_blocks *
    page_size`` rows shared by all ``slots`` sequences through their block
    tables; per recurrent layer, the per-slot state of
    ``init_decode_state`` (not paged, not quantized). An
    encoder-decoder is refused."""
    if cfg.encoder_layers:
        raise NotImplementedError("paged serving targets decoder-only "
                                  "configs; encoder-decoder serving uses "
                                  "the contiguous layout")
    device = resolve_device(device)
    dt = _dtype(cfg.dtype)
    init = mla_init_paged_cache if cfg.mla else attn_init_paged_cache
    return {"caches": [
        init(cfg, pool_blocks * page_size, dt, device) if kind == "attn"
        else block_init_cache(cfg, kind, slots, 0, dt, device)
        for kind in cfg.pattern_for()]}


def _pool_rows(state, cfg) -> int:
    return next(iter(_attn_cache(state, cfg).values())).shape[0]


def _paged_index(state, cfg, block_tables, positions, page_size,
                 valid=None):
    """The pool-row scatter index of a tick's writes at token
    ``positions`` (flattened; None without an attention layer, which
    writes no KV)."""
    if _attn_cache(state, cfg) is None:
        return None
    rows = token_rows(block_tables, positions, page_size).reshape(-1)
    return scatter_index(rows, _pool_rows(state, cfg),
                         None if valid is None else valid.reshape(-1))


def prefill_paged(params, state, tokens, lengths, n_valid, block_tables, cfg,
                  *, page_size):
    """Chunked prefill against the paged pools.

    tokens (B, C); lengths (B,) tokens already resident; n_valid (B,) valid
    chunk tokens (0 = idle slot, a no-op); block_tables (B, max_blocks).
    Returns (logits (B, V) of each row's last valid token, state).
    """
    if cfg.encoder_layers:
        raise NotImplementedError("paged prefill targets decoder-only "
                                  "configs")
    C = tokens.shape[1]
    x = embed_apply(params["embed"], tokens, cfg).to(_dtype(cfg.dtype))
    idx = torch.arange(C, device=tokens.device)[None, :]
    index = _paged_index(state, cfg, block_tables, lengths[:, None] + idx,
                         page_size, idx < n_valid[:, None])
    rows = slot_rows(block_tables, page_size) if cfg.mla else None
    for p, cache, kind in zip(params["layers"], state["caches"],
                              cfg.pattern_for()):
        _, x = block_paged_prefill(p, cache, x, cfg, kind, lengths, n_valid,
                                   index, block_tables, page_size, rows)
    return _last_logits(params, x, n_valid, cfg), state


def _pools(state, cfg):
    """The attention layers' pools (a recurrent layer's state is per
    slot)."""
    return [cache for cache, kind in zip(state["caches"], cfg.pattern_for())
            if kind == "attn"]


def copy_paged_block(state, cfg, src, dst, *, page_size):
    """Copy physical page ``src`` to page ``dst`` in every leaf of every
    attention layer's pool (K/V values or MLA latents, or codes and their
    float32 scale rows), in place, and return the state: the device half of
    a copy-on-write for the shared-prefix cache. A pool's token rows are
    its axis 0, so a page is ``page_size`` consecutive rows; ``src`` and
    ``dst`` are host ints, so the copy needs no sync. Per-slot recurrent
    state is untouched."""
    s, d = int(src) * page_size, int(dst) * page_size
    for cache in _pools(state, cfg):
        for leaf in cache.values():
            leaf[d:d + page_size].copy_(leaf[s:s + page_size])
    return state


def poison_paged_block(state, cfg, block, *, page_size, value=None):
    """Overwrite physical page ``block`` of every attention layer's pool
    with non-finite garbage, in place, and return the state: the device
    half of the ``kv_corrupt`` chaos point (DESIGN.md §13). Float leaves
    (K/V values, MLA latents, the scale rows of codes) get NaN, integer code
    leaves their most negative code (the NaN scales alone make every
    dequantized row non-finite). Attention over the page then gives
    non-finite logits to exactly the sequences whose block tables reference
    it.

    ``value`` fills every leaf instead: ``value=0`` is the quarantine
    *scrub* of a page going back to the free list, since a masked NaN row
    still reaches the output (weight 0 times NaN is NaN in the value
    product). ``block`` is a host int, so the write needs no sync. Per-slot
    recurrent state is untouched."""
    b = int(block) * page_size
    for cache in _pools(state, cfg):
        for leaf in cache.values():
            if value is not None:
                fill = value
            elif leaf.is_floating_point():
                fill = float("nan")
            else:
                fill = torch.iinfo(leaf.dtype).min
            leaf[b:b + page_size].fill_(fill)
    return state


def decode_step_paged(params, state, tokens1, lengths, block_tables, cfg, *,
                      page_size):
    """One decode tick: tokens1 (B,) at positions ``lengths`` ->
    (logits (B, V), state)."""
    if cfg.encoder_layers:
        raise NotImplementedError("paged decode targets decoder-only "
                                  "configs")
    x = embed_apply(params["embed"], tokens1, cfg).to(_dtype(cfg.dtype))
    index = _paged_index(state, cfg, block_tables, lengths, page_size)
    rows = slot_rows(block_tables, page_size) if cfg.mla else None
    for p, cache, kind in zip(params["layers"], state["caches"],
                              cfg.pattern_for()):
        _, x = block_paged_decode_step(p, cache, x, cfg, kind, lengths, index,
                                       block_tables, page_size, rows)
    x = norm_fn(cfg)(params["final_norm"], x)
    return logits_apply(params["embed"], x, cfg), state

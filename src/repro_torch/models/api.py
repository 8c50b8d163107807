"""Model assembly: init, the full-sequence forward and loss of training,
and for serving the decode state, chunked prefill and single-token decode
over per-slot (contiguous) caches or paged pools (the decoder-only half of
``repro/models/api.py``).

Parameters are a dict of tensors with ``repro``'s layouts
(``wq (d, H, hd)``, ``wo (H, hd, d)``, ...), one entry of ``"layers"`` per
layer; the layer loop is a Python loop. The state is one dict of caches
per layer and is updated in place: ``prefill``, ``decode_step`` and their
paged twins return it for symmetry with ``repro``.

Entry points take ``device="cuda"`` by default and raise without a card
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.paged import scatter_plan, token_rows
from repro_torch.layers.attention_layer import (
    attn_init_paged_cache,
    chunk_gate,
    chunk_plan,
)
from repro_torch.layers.common import rmsnorm, rmsnorm_init
from repro_torch.layers.embedding import embed_apply, embed_init, logits_apply
from repro_torch.models.blocks import (
    block_apply,
    block_decode_step,
    block_init,
    block_init_cache,
    block_paged_decode_step,
    block_paged_prefill,
    block_prefill,
)


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
    with 0 on ``device`` when None), in ``cfg.param_dtype``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    pd = _dtype(cfg.param_dtype)
    return {
        "embed": embed_init(cfg, pd, generator, device),
        "final_norm": rmsnorm_init(cfg.d_model, pd, device),
        "layers": [block_init(cfg, pd, generator, device)
                   for _ in range(cfg.num_layers)],
    }


def forward(params, batch, cfg):
    """batch["tokens"] (B, S) -> logits (B, S, V) in ``cfg.dtype``. With
    ``cfg.remat`` each layer runs under a non-reentrant
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
    layer): its activations are recomputed in the backward, which runs its
    attention forward a second time."""
    x = embed_apply(params["embed"], batch["tokens"]).to(_dtype(cfg.dtype))
    for p in params["layers"]:
        if cfg.remat:
            x = checkpoint(block_apply, p, x, cfg, use_reentrant=False)
        else:
            x = block_apply(p, x, cfg)
    x = rmsnorm(params["final_norm"], x)
    return logits_apply(params["embed"], x)


def loss_fn(params, batch, cfg):
    """Next-token cross entropy, masked by ``batch["loss_mask"]`` when
    given, in the reference's order: the max of the logits, a float32
    log-sum-exp of the shifted logits, a gather of the targets, then a
    masked mean. ``torch.amax`` splits the gradient among tied maxima
    evenly, as JAX's max does."""
    logits = forward(params, batch, cfg)[:, :-1]
    targets = batch["tokens"][:, 1:].to(torch.int64)
    mask = batch.get("loss_mask")
    mask = (torch.ones(targets.shape, dtype=torch.float32,
                       device=targets.device)
            if mask is None else mask[:, 1:])
    m = torch.amax(logits, dim=-1, keepdim=True)
    lse = m[..., 0].to(torch.float32) + torch.log(
        torch.sum(torch.exp((logits - m).to(torch.float32)), dim=-1))
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = lse - tgt.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def init_decode_state(cfg, batch, max_len, *, device="cuda"):
    """Per-slot KV state: per layer, caches of ``max_len`` slots (a rolling
    buffer of ``min(max_len, window)`` for a windowed config) for each of
    ``batch`` sequences; codes plus float32 scale rows for a quantized
    ``cfg.kv_dtype``."""
    device = resolve_device(device)
    dt = _dtype(cfg.dtype)
    return {"caches": [block_init_cache(cfg, batch, max_len, dt, device)
                       for _ in range(cfg.num_layers)]}


def _last_logits(params, x, n_valid):
    """Logits of each row's last valid chunk token."""
    B, C, _ = x.shape
    x = rmsnorm(params["final_norm"], x)
    last = torch.clamp(n_valid.to(torch.int64) - 1, 0, C - 1)
    return logits_apply(params["embed"], x[torch.arange(B, device=x.device),
                                           last])


def prefill(params, state, tokens, lengths, n_valid, cfg):
    """Chunked prefill against per-slot caches.

    tokens (B, C); lengths (B,) tokens already resident; n_valid (B,) valid
    chunk tokens (0 = idle slot, a no-op). Every layer attends over its
    cache and the chunk, then writes the chunk's valid tokens. Returns
    (logits (B, V) of each row's last valid token, state).
    """
    C = tokens.shape[1]
    x = embed_apply(params["embed"], tokens).to(_dtype(cfg.dtype))
    span = state["caches"][0]["k"].shape[2]
    plan = chunk_plan(*chunk_gate(lengths, n_valid, C, span,
                                  rolling=bool(cfg.window)), span)
    for p, cache in zip(params["layers"], state["caches"]):
        _, x = block_prefill(p, cache, x, cfg, lengths, n_valid, plan)
    return _last_logits(params, x, n_valid), state


def decode_step(params, state, tokens1, lengths, cfg):
    """One decode tick against per-slot caches: tokens1 (B,) at positions
    ``lengths`` -> (logits (B, V), state)."""
    x = embed_apply(params["embed"], tokens1).to(_dtype(cfg.dtype))
    for p, cache in zip(params["layers"], state["caches"]):
        _, x = block_decode_step(p, cache, x, cfg, lengths)
    x = rmsnorm(params["final_norm"], x)
    return logits_apply(params["embed"], x), state


def init_paged_state(cfg, slots, pool_blocks, page_size, *, device="cuda"):
    """Paged KV state: per layer, flat pools of ``pool_blocks * page_size``
    rows shared by all ``slots`` sequences through their block tables."""
    del slots  # attention-only: no per-slot state
    device = resolve_device(device)
    dt = _dtype(cfg.dtype)
    return {"caches": [attn_init_paged_cache(cfg, pool_blocks * page_size,
                                             dt, device)
                       for _ in range(cfg.num_layers)]}


def _pool_rows(state) -> int:
    return state["caches"][0]["k"].shape[0]


def prefill_paged(params, state, tokens, lengths, n_valid, block_tables, cfg,
                  *, page_size):
    """Chunked prefill against the paged pools.

    tokens (B, C); lengths (B,) tokens already resident; n_valid (B,) valid
    chunk tokens (0 = idle slot, a no-op); block_tables (B, max_blocks).
    Returns (logits (B, V) of each row's last valid token, state).
    """
    C = tokens.shape[1]
    x = embed_apply(params["embed"], tokens).to(_dtype(cfg.dtype))
    idx = torch.arange(C, device=tokens.device)[None, :]
    chunk_rows = token_rows(block_tables, lengths[:, None] + idx, page_size)
    plan = scatter_plan(chunk_rows.reshape(-1), _pool_rows(state),
                        (idx < n_valid[:, None]).reshape(-1))
    for p, cache in zip(params["layers"], state["caches"]):
        _, x = block_paged_prefill(p, cache, x, cfg, lengths, n_valid,
                                   chunk_rows, plan, block_tables, page_size)
    return _last_logits(params, x, n_valid), state


def decode_step_paged(params, state, tokens1, lengths, block_tables, cfg, *,
                      page_size):
    """One decode tick: tokens1 (B,) at positions ``lengths`` ->
    (logits (B, V), state)."""
    x = embed_apply(params["embed"], tokens1).to(_dtype(cfg.dtype))
    write_row = token_rows(block_tables, lengths, page_size)
    plan = scatter_plan(write_row, _pool_rows(state))
    for p, cache in zip(params["layers"], state["caches"]):
        _, x = block_paged_decode_step(p, cache, x, cfg, lengths, write_row,
                                       plan, block_tables, page_size)
    x = rmsnorm(params["final_norm"], x)
    return logits_apply(params["embed"], x), state

"""Core attention of the port (``repro/core/attention.py``): the
full-sequence path with the reference's recompute-and-STE backward
(``attention_ref``, ``flash_ref`` = ``flash_jnp``, ``FlashAttention`` =
``_pallas_attn_vjp``), the one-pass serving math of the reference's XLA
routes (``prefill_attention``, ``prefill_positions``, ``decode_one_pass``),
and the built-in entries of the backend registry
(``kernels/registry.py``), which register on import:

  full sequence   ref, flash_jnp, kernel (pallas), plain
  prefill         masked_xla, kernel (pallas), plain
  decode          xla, kernel (pallas), plain
  paged prefill   gather_xla, gather_pallas, kernel (pallas), plain
  paged decode    gather_xla, gather_pallas, kernel (pallas), plain

The quantized ``_q`` twins are in ``kernels/kvquant.py``; the XLA and
gather entries serve both, dequantizing a ``QuantKV`` operand themselves.

``kernel`` runs the forward on the hand-written flash kernel
(``kernels/flash/flash.py``; its plain version for CPU tensors), and
``plain`` on the plain version on any device. Both go through
``FlashAttention``, a ``torch.autograd.Function`` that keeps only q, k and
v for the backward and there recomputes the output with ``flash_ref`` in
differentiable PyTorch ops: exact arithmetic for the exact variant, and
for ExpMul the quantized weights of ``qexp_ste`` whose gradient is that of
the exact ``e^x`` (the paper's operator is forward-only). The backward
walks the KV tiles of ``flash_ref``, the largest divisor of Sk not above
``block_k``, which differ from the forward's padded tiles when
``block_k`` does not divide Sk, as in the reference. ``flash_jnp`` is
``flash_ref`` itself, differentiated by autograd, with the spec's
``use_ste`` and ``q_chunks``; ``ref`` the full softmax.

On a mesh (DTensor operands, ``launch/dryrun.py``) the kernel call runs
per shard (``sharding/regions.py:sharded_attention``), and ``flash_ref``
pins its queries and online-softmax carries as the reference's
``flash_jnp`` does (``sharding/constraints.py``; off a mesh those are the
identity). On ``meta`` operands the forward is the kernel wrapper's meta
route and the backward is priced, not run: it records the reference's
recompute, the forward's products once more plus the four of the
gradient (dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q), 3x the
forward's analytic FLOPs, and it reads q, k and v twice and dO once and
writes dQ, dK and dV (``_price_backward``); the tile loop of ``flash_ref``
never runs there.

The serving kernels' entries call the wrappers of ``kernels/flash/ops.py``
and ``kernels/decode/ops.py``: the fused paged kernels given the block
tables, the gather-then-kernel form (``gather_pallas``: the paged history
copied into logical order, then the contiguous kernel) given only
``rows``, as the reference's ``pallas`` entries do. ``gather_pallas``
decode with a window runs ``gather_xla``: the contiguous decode kernel
masks by length only. The XLA routes are plain PyTorch ops on any device
(``repro`` reaches no ``pallas_call`` for them), and none reads a value
back to the host, so a serving tick on them is capturable.
"""
from __future__ import annotations

import contextvars
import math

import torch

from repro_torch.kernels import costs
from repro_torch.kernels.decode.ops import (
    decode_attention,
    fused_paged_decode_attention,
    paged_decode_attention,
)
from repro_torch.kernels.flash.flash import BLOCK_Q
from repro_torch.kernels.flash.ops import (
    flash_attention_fwd,
    fused_paged_prefill_attention,
    paged_prefill_attention,
    prefill_attention as _prefill_kernel,
)
from repro_torch.kernels.paged import gather_history, slot_rows
from repro_torch.kernels.registry import (
    AttentionSpec,
    dispatch_attention,
    register_kernel_family,
    register_attention,
    register_decode,
    register_paged_decode,
    register_paged_prefill,
    register_prefill,
)
from repro_torch.numerics.log2exp import log2exp_lhat, pow2_neg, qexp_ste
from repro_torch.numerics.quant import kv_values
from repro_torch.sharding.constraints import constrain, model_axis_size
from repro_torch.sharding.regions import sharded_attention

MASK_VALUE = -1e30


def _qexp(x, use_ste):
    """Quantized e^x as an exact power of two (the paper's Log2Exp)."""
    return qexp_ste(x) if use_ste else pow2_neg(log2exp_lhat(x))


def _scores(qf, kt, scale):
    """(B, Hkv, G, Sq, D) x (B, Hkv, T, D) -> (B, Hkv, G, Sq, T) float32."""
    return torch.matmul(qf.to(torch.float32),
                        kt.to(torch.float32).transpose(-1, -2)[:, :, None]
                        ) * scale


def attention_ref(q, k, v, *, causal=True, scale=None, window=None,
                  variant="exact", use_ste=False):
    """Full-softmax reference: q (B, H, Sq, D), k and v (B, Hkv, Sk, D)."""
    B, H, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    s = _scores(q.reshape(B, Hkv, H // Hkv, Sq, D), k, scale)
    rows = torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (rows >= cols)
    if window is not None:
        mask = mask & (rows - cols < window)
    s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
    zero = torch.zeros_like(s)
    if variant == "expmul":
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.where(mask, _qexp(s - m, use_ste), zero)
        l = torch.sum(p, dim=-1, keepdim=True)
        p = p / torch.where(l == 0.0, torch.ones_like(l), l)
    else:
        p = torch.where(mask, torch.softmax(s, dim=-1), zero)
    o = torch.matmul(p, v.to(torch.float32)[:, :, None])
    return o.reshape(B, H, Sq, v.shape[-1]).to(q.dtype)


def flash_ref(q, k, v, *, causal=True, scale=None, window=None,
              variant="exact", use_ste=False, block_k=512,
              causal_q_chunks=4, q_offset=0):
    """FlashAttention-2 over KV blocks in differentiable PyTorch ops, the
    port of ``flash_jnp``: the block width is the largest divisor of Sk not
    above ``block_k``; a causal self-attention splits the queries into up
    to ``causal_q_chunks`` chunks that each walk only the blocks up to
    their diagonal, and blocks wholly below a chunk's diagonal skip the
    mask, as the reference does (both change no number: a block past the
    diagonal is wholly masked and leaves (m, l, acc) as they were).

    ``q_offset``: q holds rows ``q_offset:q_offset + Sq`` of a sequence
    whose keys are k and v (a rank's share of a query-split call), and the
    masks take those global rows. Such a call runs the pieces of the whole
    call's chunks that its rows cover, each as the whole call runs it."""
    B, H, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    Dv = v.shape[-1]
    group = H // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    bk = min(block_k, Sk)
    if Sk % bk:  # the largest divisor <= block_k
        bk = next(b for b in range(bk, 0, -1) if Sk % b == 0)
    nk = Sk // bk
    whole = q_offset + Sq if q_offset else Sq   # the whole call's rows
    n_chunks = 1
    if causal and window is None and causal_q_chunks > 1 and (
            whole == Sk or (q_offset and whole <= Sk)):
        whole = Sk
        for c in range(min(causal_q_chunks, nk), 0, -1):
            if Sk % c == 0 and (Sk // c) % bk == 0:
                n_chunks = c
                break
    Sq_c = whole // n_chunks
    dev = q.device
    # the 'model' dim of the activations on a mesh: kv-heads if they divide
    # the axis, else the head group, else the (chunked) queries
    msize = model_axis_size()
    tp = [None, None, None]
    for i, dim in enumerate((Hkv, group, Sq_c)):
        if msize and dim % msize == 0:
            tp[i] = "model"
            break
    dims5 = ("batch", tp[0], tp[1], tp[2], None)

    def run_chunk(q_chunk, row0, nk_c):
        n = q_chunk.shape[2]
        qf = constrain(q_chunk.reshape(B, Hkv, group, n, D), *dims5)
        rows = row0 + torch.arange(n, device=dev)[:, None]
        m = torch.full((B, Hkv, group, n, 1), MASK_VALUE,
                       dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, group, n, Dv), dtype=torch.float32,
                          device=dev)
        if causal and window is None:
            n_interior = max(0, row0 // bk)
        elif not causal and window is None:
            n_interior = nk_c
        else:
            n_interior = 0
        for ci in range(nk_c):
            m, l, acc = (constrain(t, *dims5) for t in (m, l, acc))
            sl = slice(ci * bk, (ci + 1) * bk)
            s = _scores(qf, k[:, :, sl], scale)
            mask = None
            if ci >= n_interior:
                cols = ci * bk + torch.arange(bk, device=dev)[None, :]
                mask = torch.ones((n, bk), dtype=torch.bool, device=dev)
                if causal:
                    mask = mask & (rows >= cols)
                if window is not None:
                    mask = mask & (rows - cols < window)
                s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
            m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
            if variant == "expmul":
                alpha = _qexp(m - m_new, use_ste)
                p = _qexp(s - m_new, use_ste)
            else:
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
            if mask is not None:
                p = torch.where(mask, p, torch.zeros_like(p))
            l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
            pv = p.to(v.dtype).to(torch.float32)
            acc = acc * alpha + torch.matmul(
                pv, v[:, :, sl].to(torch.float32)[:, :, None])
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        return (acc / l).reshape(B, H, n, Dv)

    if n_chunks == 1:
        return run_chunk(q, q_offset, nk).to(q.dtype)
    outs = []
    for ci in range(n_chunks):   # the pieces of q's rows in each chunk
        lo = max(ci * Sq_c, q_offset)
        hi = min((ci + 1) * Sq_c, q_offset + Sq)
        if lo < hi:
            outs.append(run_chunk(q[:, :, lo - q_offset:hi - q_offset], lo,
                                  ((ci + 1) * Sq_c) // bk))
    return torch.cat(outs, dim=2).to(q.dtype)


# the plain flash walk's query block (``spec.block_q``; it changes no
# number), bound by the full-sequence entry around its call
_PLAIN_BLOCK_Q = contextvars.ContextVar("plain_block_q", default=BLOCK_Q)


class FlashAttention(torch.autograd.Function):
    """The flash forward (CUDA kernel or plain version) with the
    reference's recompute backward: ``flash_ref`` in exact arithmetic, or
    through ``qexp_ste`` for ExpMul, over ``block_k``-wide blocks; both at
    the query offset ``q_offset``. The plain version walks query blocks of
    the bound ``_PLAIN_BLOCK_Q``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, variant, block_k,
                plain, q_offset=0):
        ctx.save_for_backward(q, k, v)
        ctx.spec = (causal, scale, window, variant, block_k, q_offset)
        return flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                   window=window, variant=variant,
                                   block_k=block_k, plain=plain,
                                   q_offset=q_offset,
                                   block_q=_PLAIN_BLOCK_Q.get())

    @staticmethod
    def backward(ctx, g):
        causal, scale, window, variant, block_k, q_offset = ctx.spec
        if g.device.type == "meta":
            return _price_backward(*ctx.saved_tensors, g) + (None,) * 7
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(True)
                       for t in ctx.saved_tensors)
            o = flash_ref(q, k, v, causal=causal, scale=scale, window=window,
                          variant=variant, use_ste=variant == "expmul",
                          block_k=block_k, q_offset=q_offset)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None, None, None, None, None, None, None


def _price_backward(q, k, v, g):
    """The backward on ``meta`` operands: empty gradients, and the
    recompute's cost reported to the op counters (see the module
    docstring)."""
    if costs.counting():
        B, H, Sq, D = q.shape
        flops, _ = costs.attention_call_cost(
            g, (), batch=B * H, heads=1, q_tokens=Sq, kv_tokens=k.shape[2],
            d_qk=D, d_v=v.shape[-1])
        nbytes = costs.tensor_bytes(q, k, v) * 3 + costs.tensor_bytes(g)
        costs.record_call("flash_backward", flops=3 * flops, bytes=nbytes)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def attention(q, k, v, cfg, *, causal=True, window=None, scale=None):
    """q (B, H, Sq, D), k and v (B, Hkv, Sk, D) -> (B, H, Sq, D) through
    the registry's full-sequence table at ``cfg.attention_impl`` ("kernel"
    by default: the flash kernel, its plain version for CPU tensors),
    ``cfg.attention_variant`` and KV tiles of
    ``min(cfg.attention_block_k, Sk)`` columns. K and V are taken as given
    (``kv_dtype="fp32"``): a layer that stores quantized K/V dispatches
    with its own spec, whose ``_q`` entry fake-quantizes them."""
    spec = AttentionSpec.from_config(cfg, window=window, kv_dtype="fp32")
    return dispatch_attention(spec, q, k, v, causal=causal, scale=scale)


def _masked_decode(q, k, v, mask, *, variant, scale):
    """The one-pass decode core: q (B, H, D), k (B, Hkv, S, D), v
    (B, Hkv, S, Dv), mask (B, S) bool over cache rows -> (B, H, Dv) in q's
    dtype (the reference's ``_masked_decode_xla``)."""
    B, H, D = q.shape
    Hkv = k.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qf = q.to(torch.float32).reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k.to(torch.float32)) * scale
    mask = mask[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = (pow2_neg(log2exp_lhat(s - m)) if variant == "expmul"
         else torch.exp(s - m))
    p = torch.where(mask, p, torch.zeros_like(p))
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhgk,bhkd->bhgd",
                     p / torch.where(l == 0.0, torch.ones_like(l), l),
                     v.to(torch.float32))
    return o.reshape(B, H, v.shape[-1]).to(q.dtype)


def decode_one_pass(q, k, v, lengths, *, variant="exact", scale=None):
    """One query a row over a cache: q (B, H, D), k (B, Hkv, S, D) and v
    (B, Hkv, S, Dv), the first ``lengths`` (B,) rows valid -> (B, H, Dv)
    in q's dtype. One masked softmax over all S columns, in float32, as
    the reference's "xla" decode route computes it: the ExpMul weights are
    ``pow2_neg(log2exp_lhat(s - m))`` with m the whole row's max, so they
    differ from a tiled walk's, whose m is a running max. A row of length
    0 gives zeros."""
    return _masked_decode(q, k, v, decode_mask(lengths, k.shape[2], None,
                                               q.device),
                          variant=variant, scale=scale)


def prefill_attention(q, k, v, *, q_positions, kv_positions, kv_valid,
                      scale=None, window=None, variant="exact", use_ste=False):
    """Masked one-pass attention of a prompt chunk against gathered KV
    (the reference's ``prefill_attention``): q (B, H, C, D), k and v
    (B, Hkv, T, .), typically [cache ++ chunk]. Query i sees KV j iff
    ``kv_valid[b, j]`` and ``kv_positions[b, j] <= q_positions[b, i]``
    (and inside ``window``), which is exact for fresh caches, rolling
    caches and partly filled chunks alike."""
    B, H, C, D = q.shape
    Hkv = k.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    s = _scores(q.reshape(B, Hkv, H // Hkv, C, D), k, scale)
    delta = q_positions[:, :, None] - kv_positions[:, None, :]   # (B, C, T)
    mask = kv_valid[:, None, :] & (delta >= 0)
    if window is not None:
        mask = mask & (delta < window)
    mask = mask[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = _qexp(s - m, use_ste) if variant == "expmul" else torch.exp(s - m)
    p = torch.where(mask, p, torch.zeros_like(p))
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.matmul(p / torch.where(l == 0.0, torch.ones_like(l), l),
                     v.to(torch.float32)[:, :, None])
    return o.reshape(B, H, C, v.shape[-1]).to(q.dtype)


def prefill_positions(lengths, n_valid, span, C, *, rolling):
    """The positional tensors implied by the prefill convention: lengths
    and n_valid (B,), ``span`` cache slots, a chunk of C. Returns
    (q_positions (B, C), kv_positions (B, span + C), kv_valid
    (B, span + C)) in [cache ++ chunk] order; ``rolling`` gives slot j the
    newest written position congruent to j modulo the span."""
    dev = lengths.device
    lengths = lengths.to(torch.int64)
    idx = torch.arange(C, device=dev)[None, :]
    q_positions = lengths[:, None] + idx
    chunk_valid = idx < n_valid.to(dev)[:, None]
    slot = torch.arange(span, device=dev)[None, :]
    if rolling:
        last = lengths[:, None] - 1
        cache_pos = last - torch.remainder(last - slot, span)
    else:
        cache_pos = slot.expand(lengths.shape[0], span)
    cache_valid = (cache_pos >= 0) & (cache_pos < lengths[:, None])
    return (q_positions, torch.cat([cache_pos, q_positions], dim=1),
            torch.cat([cache_valid, chunk_valid], dim=1))


def _f32(*ts):
    return tuple(t.to(torch.float32) for t in ts)


# ---------------------------------------------------------------------------
# the registry's built-in entries
# ---------------------------------------------------------------------------
@register_attention("ref")
def _attention_ref_impl(q, k, v, *, spec, causal, scale):
    return attention_ref(q, k, v, causal=causal, scale=scale,
                         window=spec.window, variant=spec.variant,
                         use_ste=spec.use_ste)


@register_attention("flash_jnp")
def _flash_jnp_impl(q, k, v, *, spec, causal, scale):
    return flash_ref(q, k, v, causal=causal, scale=scale, window=spec.window,
                     variant=spec.variant, use_ste=spec.use_ste,
                     block_k=spec.block_k, causal_q_chunks=spec.q_chunks)


def _flash_entry(plain):
    def entry(q, k, v, *, spec, causal, scale):
        scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
        bk = min(spec.block_k, k.shape[2])

        def run(q, k, v, q_offset=0):
            return FlashAttention.apply(q, k, v, causal, float(scale),
                                        spec.window, spec.variant, bk, plain,
                                        q_offset)

        bound = _PLAIN_BLOCK_Q.set(spec.block_q)
        try:
            return sharded_attention(q, k, v, run)
        finally:
            _PLAIN_BLOCK_Q.reset(bound)
    return entry


register_kernel_family(register_attention, _flash_entry)


@register_prefill("masked_xla")
def _prefill_masked_xla(q, k_cache, v_cache, k_chunk, v_chunk, *, spec,
                        scale, lengths, n_valid, rolling):
    """[cache ++ chunk], its positional tensors rebuilt, one masked
    softmax: the reference's XLA prefill. At a quantized ``spec.kv_dtype``
    (``masked_xla_q``: cache and chunk quantized on write, so the chunk's
    queries see the values decode reads later) both are dequantized
    first."""
    k_cache, v_cache, k_chunk, v_chunk = (
        kv_values(t, spec.kv_dtype) for t in (k_cache, v_cache, k_chunk,
                                              v_chunk))
    q_positions, kv_positions, kv_valid = prefill_positions(
        lengths, n_valid, k_cache.shape[2], q.shape[2], rolling=rolling)
    return prefill_attention(
        q, torch.cat(_f32(k_cache, k_chunk), dim=2),
        torch.cat(_f32(v_cache, v_chunk), dim=2), q_positions=q_positions,
        kv_positions=kv_positions, kv_valid=kv_valid, scale=scale,
        window=spec.window, variant=spec.variant, use_ste=spec.use_ste)


def _prefill_entry(plain):
    def entry(q, k_cache, v_cache, k_chunk, v_chunk, *, spec, scale, lengths,
              n_valid, rolling):
        return _prefill_kernel(q, k_cache, v_cache, k_chunk, v_chunk,
                               lengths, n_valid, scale=scale,
                               variant=spec.variant, window=spec.window,
                               rolling=rolling, plain=plain,
                               block_q=spec.block_q, block_k=spec.block_k)
    return entry


register_kernel_family(register_prefill, _prefill_entry)


@register_decode("xla")
def _decode_xla(q, k_cache, v_cache, lengths, *, spec, scale):
    """``decode_one_pass``; at a quantized ``spec.kv_dtype`` (``xla_q``)
    over the dequantized caches."""
    return decode_one_pass(q, kv_values(k_cache, spec.kv_dtype),
                           kv_values(v_cache, spec.kv_dtype), lengths,
                           variant=spec.variant, scale=scale)


def _decode_entry(plain):
    def entry(q, k_cache, v_cache, lengths, *, spec, scale):
        return decode_attention(q, k_cache, v_cache, lengths, scale=scale,
                                variant=spec.variant, plain=plain,
                                block_k=spec.decode_block_k)
    return entry


register_kernel_family(register_decode, _decode_entry)


# ---------------------------------------------------------------------------
# paged entries
# ---------------------------------------------------------------------------
def paged_rows(rows, block_tables, page_size):
    """``rows`` (B, L), or the block tables' ``slot_rows``: on the device,
    no host read."""
    return rows if rows is not None else slot_rows(block_tables, page_size)


def chunk_operands(q, lengths, q_positions, chunk_valid, n_valid):
    """The paged prefill's (q_positions, chunk_valid, n_valid), each
    derived from the others where it was not given."""
    C = q.shape[2]
    idx = torch.arange(C, device=q.device)[None, :]
    if n_valid is None:
        n_valid = torch.sum(chunk_valid.to(torch.int32), dim=1)
    if chunk_valid is None:
        chunk_valid = idx < n_valid.to(q.device)[:, None]
    if q_positions is None:
        q_positions = lengths.to(torch.int64)[:, None] + idx
    return q_positions, chunk_valid, n_valid


def paged_prefill_xla(q, k_hist, v_hist, k_chunk, v_chunk, *, spec, scale,
                      q_positions, chunk_valid, lengths):
    """[gathered history ++ chunk] with history position j at j: the
    masking of a fresh contiguous cache, for every variant and window."""
    B, L = k_hist.shape[0], k_hist.shape[2]
    hist_pos = torch.arange(L, device=q.device)[None, :].expand(B, L)
    kv_positions = torch.cat([hist_pos, q_positions.to(torch.int64)], dim=1)
    kv_valid = torch.cat(
        [hist_pos < lengths.to(q.device)[:, None], chunk_valid], dim=1)
    return prefill_attention(
        q, torch.cat(_f32(k_hist, k_chunk), dim=2),
        torch.cat(_f32(v_hist, v_chunk), dim=2), q_positions=q_positions,
        kv_positions=kv_positions, kv_valid=kv_valid, scale=scale,
        window=spec.window, variant=spec.variant, use_ste=spec.use_ste)


def decode_mask(lengths, L, window, device):
    """(B, L) bool: positions below ``lengths`` and, with a window, at or
    above ``lengths - window`` (absolute positions, as the paged pool keeps
    them)."""
    pos = torch.arange(L, device=device)[None, :]
    lengths = lengths.to(device)[:, None]
    mask = pos < lengths
    if window is not None:
        mask = mask & (pos >= lengths - window)
    return mask


@register_paged_prefill("gather_xla")
def _paged_prefill_gather_xla(q, k_chunk, v_chunk, k_pool, v_pool, rows, *,
                              spec, scale, q_positions, chunk_valid, lengths,
                              n_valid=None, block_tables=None, page_size=0):
    """[gathered history ++ chunk], one masked softmax; at a quantized
    ``spec.kv_dtype`` (``gather_xla_q``) the history and the chunk are
    dequantized first."""
    rows = paged_rows(rows, block_tables, page_size)
    q_positions, chunk_valid, _ = chunk_operands(
        q, lengths, q_positions, chunk_valid, n_valid)
    kv = spec.kv_dtype
    return paged_prefill_xla(
        q, gather_history(k_pool, rows, kv), gather_history(v_pool, rows, kv),
        kv_values(k_chunk, kv), kv_values(v_chunk, kv), spec=spec,
        scale=scale, q_positions=q_positions, chunk_valid=chunk_valid,
        lengths=lengths)


@register_paged_prefill("gather_pallas")
def _paged_prefill_gather_pallas(q, k_chunk, v_chunk, k_pool, v_pool, rows,
                                 *, spec, scale, q_positions=None,
                                 chunk_valid=None, lengths, n_valid=None,
                                 block_tables=None, page_size=0, plain=False):
    """Gather-then-kernel paged prefill: the history copied into logical
    order, then the contiguous prefill kernel (``plain``: its plain
    version) at ``block_k = page_size`` (``spec.block_k`` without a page
    size): the fused kernel's tiles, so the same-tile ExpMul oracle of the
    fused paged prefill. At a quantized ``spec.kv_dtype``
    (``gather_pallas_q``) the copy and the chunk are dequantized to
    float32 first."""
    rows = paged_rows(rows, block_tables, page_size)
    _, _, n_valid = chunk_operands(q, lengths, q_positions, chunk_valid,
                                   n_valid)
    return paged_prefill_attention(
        q, k_chunk, v_chunk, k_pool, v_pool, rows, lengths, n_valid,
        scale=scale, variant=spec.variant, window=spec.window,
        block_q=spec.block_q,
        block_k=page_size if page_size else spec.block_k, plain=plain,
        kv_dtype=spec.kv_dtype)


def _paged_prefill_entry(plain):
    def entry(q, k_chunk, v_chunk, k_pool, v_pool, rows, *, spec, scale,
              q_positions=None, chunk_valid=None, lengths, n_valid=None,
              block_tables=None, page_size=0):
        """The fused paged prefill, the block tables read in the kernel;
        a call with ``rows`` only takes the gather-then-kernel form."""
        if block_tables is None:
            return _paged_prefill_gather_pallas(
                q, k_chunk, v_chunk, k_pool, v_pool, rows, spec=spec,
                scale=scale, q_positions=q_positions,
                chunk_valid=chunk_valid, lengths=lengths, n_valid=n_valid,
                plain=plain)
        _, _, n_valid = chunk_operands(q, lengths, q_positions, chunk_valid,
                                       n_valid)
        return fused_paged_prefill_attention(
            q, k_chunk, v_chunk, k_pool, v_pool, block_tables, lengths,
            n_valid, page_size=page_size, scale=scale, variant=spec.variant,
            window=spec.window, plain=plain, block_q=spec.block_q)
    return entry


register_kernel_family(register_paged_prefill, _paged_prefill_entry)


@register_paged_decode("gather_xla")
def _paged_decode_gather_xla(q, k_pool, v_pool, rows, lengths, *, spec,
                             scale, block_tables=None, page_size=0):
    """The gathered history (current token included; dequantized at a
    quantized ``spec.kv_dtype``, ``gather_xla_q``), one masked softmax; a
    window masks positions below ``lengths - window``."""
    rows = paged_rows(rows, block_tables, page_size)
    return _masked_decode(
        q, gather_history(k_pool, rows, spec.kv_dtype),
        gather_history(v_pool, rows, spec.kv_dtype),
        decode_mask(lengths, rows.shape[1], spec.window, q.device),
        variant=spec.variant, scale=scale)


@register_paged_decode("gather_pallas")
def _paged_decode_gather_pallas(q, k_pool, v_pool, rows, lengths, *, spec,
                                scale, block_tables=None, page_size=0,
                                plain=False):
    """Gather-then-kernel paged decode in ``spec.decode_block_k``-wide
    tiles (``plain``: the kernel's plain version) over the copy, dequantized
    to float32 at a quantized ``spec.kv_dtype`` (``gather_pallas_q``); with
    a window, ``gather_xla`` (the contiguous decode kernel masks by length
    only)."""
    if spec.window is not None:
        return _paged_decode_gather_xla(
            q, k_pool, v_pool, rows, lengths, spec=spec, scale=scale,
            block_tables=block_tables, page_size=page_size)
    return paged_decode_attention(
        q, k_pool, v_pool, paged_rows(rows, block_tables, page_size),
        lengths, scale=scale, variant=spec.variant,
        block_k=spec.decode_block_k, plain=plain, kv_dtype=spec.kv_dtype)


def _paged_decode_entry(plain):
    def entry(q, k_pool, v_pool, rows, lengths, *, spec, scale,
              block_tables=None, page_size=0):
        """The fused paged decode, the block tables read in the kernel; a
        call with ``rows`` only takes the gather-then-kernel form."""
        if block_tables is None:
            return _paged_decode_gather_pallas(
                q, k_pool, v_pool, rows, lengths, spec=spec, scale=scale,
                plain=plain)
        return fused_paged_decode_attention(
            q, k_pool, v_pool, block_tables, lengths, page_size=page_size,
            scale=scale, variant=spec.variant, window=spec.window,
            plain=plain)
    return entry


register_kernel_family(register_paged_decode, _paged_decode_entry)

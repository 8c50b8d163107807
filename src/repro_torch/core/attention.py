"""Full-sequence attention of the training path, with the reference's
recompute-and-STE backward (the port of ``repro/core/attention.py``'s
``attention_ref``, ``flash_jnp`` and ``_pallas_attn_vjp``).

``attention`` runs the forward on the hand-written flash kernel
(``kernels/flash/flash.py``; its plain version for CPU tensors) when
``cfg.attention_impl`` is "kernel", or on the plain version on any device
when it is "plain". Both go through ``FlashAttention``, a
``torch.autograd.Function`` that keeps only q, k and v for the backward
and there recomputes the output with ``flash_ref`` in differentiable
PyTorch ops: exact arithmetic for the exact variant, and for ExpMul the
quantized weights of ``qexp_ste`` whose gradient is that of the exact
``e^x`` (the paper's operator is forward-only). The backward walks the
KV tiles of ``flash_ref``, the largest divisor of Sk not above
``block_k``, which differ from the forward's padded tiles when
``block_k`` does not divide Sk, as in the reference.

On a mesh (DTensor operands, ``launch/dryrun.py``) the call runs per
shard (``sharding/regions.py:sharded_attention``), and ``flash_ref`` pins
its queries and online-softmax carries as the reference's ``flash_jnp``
does (``sharding/constraints.py``; off a mesh those are the identity). On
``meta`` operands the forward is the kernel wrapper's meta route and the
backward is priced, not run: it records the reference's recompute, the
forward's products once more plus the four of the gradient (dV = P^T dO,
dP = dO V^T, dQ = dS K, dK = dS^T Q), 3x the forward's analytic FLOPs,
and it reads q, k and v twice and dO once and writes dQ, dK and dV
(``_price_backward``); the tile loop of ``flash_ref`` never runs there.

``decode_one_pass`` is the reference's "xla" decode route
(``_decode_xla`` and ``_masked_decode_xla``), which its cross-attention
decode takes: plain PyTorch ops on any device, the reference's own route
there (``repro`` reaches no ``pallas_call`` for it).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import costs
from repro_torch.kernels.flash.ops import flash_attention_fwd
from repro_torch.numerics.log2exp import log2exp_lhat, pow2_neg, qexp_ste
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


class FlashAttention(torch.autograd.Function):
    """The flash forward (CUDA kernel or plain version) with the
    reference's recompute backward: ``flash_ref`` in exact arithmetic, or
    through ``qexp_ste`` for ExpMul, over ``block_k``-wide blocks; both at
    the query offset ``q_offset``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, variant, block_k,
                plain, q_offset=0):
        ctx.save_for_backward(q, k, v)
        ctx.spec = (causal, scale, window, variant, block_k, q_offset)
        return flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                   window=window, variant=variant,
                                   block_k=block_k, plain=plain,
                                   q_offset=q_offset)

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
    """q (B, H, Sq, D), k and v (B, Hkv, Sk, D) -> (B, H, Sq, D), the
    twin of the reference's "pallas" backend: ``cfg.attention_variant``
    and KV tiles of ``min(cfg.attention_block_k, Sk)`` columns;
    ``cfg.attention_impl`` "kernel" (the CUDA kernel; its plain version for
    CPU tensors) or "plain" (the plain version on any device)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])

    def run(q, k, v, q_offset=0):
        return FlashAttention.apply(
            q, k, v, causal, float(scale), window, cfg.attention_variant,
            min(cfg.attention_block_k, k.shape[2]),
            cfg.attention_impl == "plain", q_offset)

    return sharded_attention(q, k, v, run)


def decode_one_pass(q, k, v, lengths, *, variant="exact", scale=None):
    """One query a row over a cache: q (B, H, D), k (B, Hkv, S, D) and v
    (B, Hkv, S, Dv), the first ``lengths`` (B,) rows valid -> (B, H, Dv)
    in q's dtype. One masked softmax over all S columns, in float32, as
    the reference's "xla" decode route computes it: the ExpMul weights are
    ``pow2_neg(log2exp_lhat(s - m))`` with m the whole row's max, so they
    differ from a tiled walk's, whose m is a running max. A row of length
    0 gives zeros."""
    B, H, D = q.shape
    _, Hkv, S, _ = k.shape
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qf = q.to(torch.float32).reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k.to(torch.float32)) * scale
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])[:, None, None, :]
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

"""The shared online-softmax tile step, in plain PyTorch.

One KV tile of the FlashAttention-2 recurrence in exact or ExpMul
arithmetic, with optional dequantization of K/V codes — the arithmetic of
``repro/kernels/flash/tile.py`` (``online_softmax_tile`` and
``finalize_tiles``) operation for operation. The plain versions of the
paged decode and prefill kernels call it on each tile in the kernels'
tile order; the CUDA kernels run the same step in ``csrc/tile.cuh`` and
``csrc/tile_sm90.cuh``. ``decode_fold`` is the contiguous decode
kernel's parallel form of the walk, for the tests.

Shapes carry any leading batch axes: q (..., rows, D), k (..., bk, D),
v (..., bk, Dv), k_scale / v_scale (..., bk) or None, mask
(..., rows, bk); the state is m, l (..., rows, 1) and acc (..., rows, Dv),
all float32.
"""
from __future__ import annotations

import torch

from repro_torch.numerics.log2exp import apply_pow2_scale, log2exp_lhat, pow2_neg

MASK_VALUE = -1e30


def init_state(rows_shape, dv: int, device):
    """(m, l, acc) before the first tile: m = MASK_VALUE, l = acc = 0."""
    m = torch.full(tuple(rows_shape) + (1,), MASK_VALUE, dtype=torch.float32,
                   device=device)
    return m, torch.zeros_like(m), torch.zeros(tuple(rows_shape) + (dv,),
                                               dtype=torch.float32,
                                               device=device)


def online_softmax_tile(q, k, v, k_scale, v_scale, mask, state, *, scale,
                        variant):
    """One KV tile; returns the new (m, l, acc).

    The score is ``(q @ k^T) * scale`` times ``k_scale`` per column when k
    holds codes; masked scores become ``MASK_VALUE`` and masked weights 0;
    ``v_scale`` is folded into the weights before ``p @ v``, so ExpMul's
    power-of-two weights multiply the value codes.
    """
    m_prev, l_prev, acc_prev = state
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if k_scale is not None:
        s = s * k_scale[..., None, :]
    s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
    m_new = torch.maximum(m_prev, torch.amax(s, dim=-1, keepdim=True))
    zero = torch.zeros_like(s)
    if variant == "exact":
        alpha = torch.exp(m_prev - m_new)
        p = torch.where(mask, torch.exp(s - m_new), zero)
        l_new = l_prev * alpha + torch.sum(p, dim=-1, keepdim=True)
        pv = p if v_scale is None else p * v_scale[..., None, :]
        acc = acc_prev * alpha + torch.matmul(pv, v)
    elif variant == "expmul":
        lr = log2exp_lhat(m_prev - m_new)
        p = torch.where(mask, pow2_neg(log2exp_lhat(s - m_new)), zero)
        l_new = apply_pow2_scale(l_prev, lr) + torch.sum(p, dim=-1,
                                                         keepdim=True)
        pv = p if v_scale is None else p * v_scale[..., None, :]
        acc = (apply_pow2_scale(acc_prev, lr.expand(acc_prev.shape))
               + torch.matmul(pv, v))
    else:
        raise ValueError(f"unknown attention variant {variant!r}")
    return m_new, l_new, acc


def finalize_tiles(state, dtype):
    """acc / l in ``dtype``; a row that saw no valid column (l == 0) gives
    0, never NaN."""
    _, l, acc = state
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l).to(dtype)


def select_state(run, new, old):
    """Per-row ``run ? new : old`` over (m, l, acc): a tile the kernel
    skips leaves that row's state untouched. ``run`` has the rows' shape."""
    r = run[..., None]
    return tuple(torch.where(r, n, o) for n, o in zip(new, old))


def decode_fold(q3, k3, v3, lengths, ks2=None, vs2=None, *, scale, variant,
                num_kv_heads, block_k=256):
    """The contiguous decode kernel's algorithm (``csrc/decode.cu``) in
    plain PyTorch, for the tests: every tile's scores and maximum first,
    then each tile's weights, weight sum and value product from the prefix
    maximum m_t = max(m_{t-1}, max_j s_tj) alone, then the fold of those
    partials in tile order. The same float operations as
    ``decode_fwd_plain``'s sequential walk, so the same bits; the main path
    does not call it. Shapes as ``decode_fwd_plain``'s."""
    BHkv, group, _ = q3.shape
    S, Dv = k3.shape[1], v3.shape[-1]
    dev = q3.device
    quant = ks2 is not None
    bk = min(block_k, S)
    pad = -S % bk
    length = lengths.to(torch.int64)[torch.arange(BHkv, device=dev)
                                     // num_kv_heads]
    k = torch.nn.functional.pad(k3.to(torch.float32), (0, 0, 0, pad))
    v = torch.nn.functional.pad(v3.to(torch.float32), (0, 0, 0, pad))
    ks = torch.nn.functional.pad(ks2, (0, pad)) if quant else None
    vs = torch.nn.functional.pad(vs2, (0, pad)) if quant else None
    q = q3.to(torch.float32)
    cols = torch.arange(bk, device=dev)
    top = min(int(lengths.max()), S) if lengths.numel() else 0
    # 1. each tile's scores and row maxima
    tiles = []
    for c0 in range(0, top, bk):
        sl = slice(c0, c0 + bk)
        mask = ((c0 + cols)[None, :] < length[:, None])[:, None, :].expand(
            BHkv, group, bk)
        s = torch.matmul(q, k[:, sl].transpose(-1, -2)) * scale
        if quant:
            s = s * ks[:, sl][..., None, :]
        s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
        tiles.append((sl, mask, s, torch.amax(s, dim=-1, keepdim=True),
                      (c0 < length)[:, None].expand(BHkv, group)))
    # 2. per tile, from the prefix maximum alone: psum_t and dsum_t
    m, l, acc = init_state((BHkv, group), Dv, dev)
    m_prev = m
    parts = []
    for sl, mask, s, tmax, run in tiles:
        m_new = torch.maximum(m_prev, tmax)
        zero = torch.zeros_like(s)
        if variant == "exact":
            p = torch.where(mask, torch.exp(s - m_new), zero)
        elif variant == "expmul":
            p = torch.where(mask, pow2_neg(log2exp_lhat(s - m_new)), zero)
        else:
            raise ValueError(f"unknown attention variant {variant!r}")
        pv = p if not quant else p * vs[:, sl][..., None, :]
        parts.append((m_prev, m_new, torch.sum(p, dim=-1, keepdim=True),
                      torch.matmul(pv, v[:, sl]), run))
        m_prev = m_new
    # 3. the fold, in tile order
    for m_old, m_new, psum, dsum, run in parts:
        if variant == "exact":
            alpha = torch.exp(m_old - m_new)
            new = (m_new, l * alpha + psum, acc * alpha + dsum)
        else:
            lr = log2exp_lhat(m_old - m_new)
            new = (m_new, apply_pow2_scale(l, lr) + psum,
                   apply_pow2_scale(acc, lr.expand(acc.shape)) + dsum)
        m, l, acc = select_state(run, new, (m, l, acc))
    return finalize_tiles((m, l, acc), q3.dtype)

"""The shared online-softmax tile step, in plain PyTorch.

One KV tile of the FlashAttention-2 recurrence in exact or ExpMul
arithmetic, with optional dequantization of K/V codes — the arithmetic of
``repro/kernels/flash/tile.py`` (``online_softmax_tile`` and
``finalize_tiles``) operation for operation. The plain versions of the
paged decode and prefill kernels call it on each tile in the kernels'
tile order; the CUDA kernels run the same step per query row in
``csrc/tile.cuh``.

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

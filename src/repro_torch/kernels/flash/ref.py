"""Plain PyTorch oracles of FlashAttention-2 (the port of
``repro/kernels/flash/ref.py``), on single-head 2-D operands: q (Sq, D),
k and v (Sk, D).

* ``attention_ref``: the textbook softmax attention (ground truth).
* ``flash2_blocked_ref``: FlashAttention-2 over the tile schedule of
  ``block_q`` x ``block_k`` blocks, in exact or ExpMul arithmetic, the
  operands padded to whole blocks.
* ``flash2_alg4_ref``: the paper's per-key recurrence (Alg. 2, and Alg. 4
  in the merged [l, o] form of Eq. 3-5): one key and value a step, as the
  operator's datapath runs it.

No kernel replaces them (``repro`` reaches no ``pallas_call`` for them);
the kernels' own plain versions are in ``flash.py`` and ``prefill.py``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.numerics.log2exp import (
    apply_pow2_scale,
    log2exp_lhat,
    pow2_neg,
)

MASK_VALUE = -1e30


def _build_mask(rows, cols, *, causal, window, kv_len):
    mask = cols < kv_len
    if causal:
        mask = mask & (rows >= cols)
    if window is not None:
        mask = mask & (rows - cols < window)
    return mask


def attention_ref(q, k, v, *, causal=False, scale=None, window=None):
    """Softmax attention over the full score matrix, in float32."""
    Sq, D = q.shape
    Sk = k.shape[0]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).T) * scale
    rows = torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Sk, device=q.device)[None, :]
    mask = _build_mask(rows, cols, causal=causal, window=window, kv_len=Sk)
    s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
    p = torch.where(mask, torch.softmax(s, dim=-1), torch.zeros_like(s))
    return torch.matmul(p, v.to(torch.float32)).to(q.dtype)


def flash2_blocked_ref(q, k, v, *, causal=False, scale=None, window=None,
                       variant="exact", block_q=128, block_k=128,
                       kv_len=None):
    """FlashAttention-2 in tiles of ``min(block_q, Sq)`` query rows by
    ``min(block_k, Sk)`` keys, the keys past ``kv_len`` masked."""
    Sq, D = q.shape
    Sk = k.shape[0]
    kv_len = Sk if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    qp = F.pad(q, (0, 0, 0, -Sq % bq))
    kp = F.pad(k, (0, 0, 0, -Sk % bk))
    vp = F.pad(v, (0, 0, 0, -Sk % bk))
    dev = q.device
    out = torch.zeros((qp.shape[0], v.shape[-1]), dtype=torch.float32,
                      device=dev)
    for q0 in range(0, qp.shape[0], bq):
        qt = qp[q0:q0 + bq].to(torch.float32)
        m = torch.full((bq, 1), MASK_VALUE, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((bq, v.shape[-1]), dtype=torch.float32, device=dev)
        rows = q0 + torch.arange(bq, device=dev)[:, None]
        for k0 in range(0, kp.shape[0], bk):
            kt = kp[k0:k0 + bk].to(torch.float32)
            vt = vp[k0:k0 + bk].to(torch.float32)
            s = torch.matmul(qt, kt.T) * scale
            cols = k0 + torch.arange(bk, device=dev)[None, :]
            mask = _build_mask(rows, cols, causal=causal, window=window,
                               kv_len=kv_len)
            s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
            m_new = torch.maximum(m, torch.amax(s, dim=1, keepdim=True))
            if variant == "exact":
                alpha = torch.exp(m - m_new)
                p = torch.where(mask, torch.exp(s - m_new),
                                torch.zeros_like(s))
                l = l * alpha + torch.sum(p, dim=1, keepdim=True)
                acc = acc * alpha + torch.matmul(p, vt)
            elif variant == "expmul":
                lr = log2exp_lhat(m - m_new)
                p = torch.where(mask, pow2_neg(log2exp_lhat(s - m_new)),
                                torch.zeros_like(s))
                l = apply_pow2_scale(l, lr) + torch.sum(p, dim=1,
                                                        keepdim=True)
                acc = (apply_pow2_scale(acc, lr.expand(acc.shape))
                       + torch.matmul(p, vt))
            else:
                raise ValueError(f"unknown attention variant {variant!r}")
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out[q0:q0 + bq] = acc / l
    return out[:Sq].to(q.dtype)


def flash2_alg4_ref(q, k, v, *, causal=False, scale=None, variant="expmul"):
    """The paper's per-key recurrence over v* = [1, v] and o* = [l, o]:
    each step rescales o* by the quantized e^(m_prev - m_new) and adds
    v* by the quantized e^(s_i - m_new), both exact power-of-two scalings
    (``apply_pow2_scale``) under ExpMul; ``variant="exact"`` is Alg. 2
    with ``torch.exp``. A masked key (score at ``MASK_VALUE``) adds 0."""
    Sq, D = q.shape
    Sk = k.shape[0]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    dev = q.device
    s_all = torch.matmul(q.to(torch.float32), k.to(torch.float32).T) * scale
    if causal:
        rows = torch.arange(Sq, device=dev)[:, None]
        cols = torch.arange(Sk, device=dev)[None, :]
        s_all = torch.where(rows >= cols, s_all,
                            torch.full_like(s_all, MASK_VALUE))
    v_star = torch.cat([torch.ones((Sk, 1), dtype=torch.float32, device=dev),
                        v.to(torch.float32)], dim=1)
    m = torch.full((Sq, 1), MASK_VALUE, dtype=torch.float32, device=dev)
    o_star = torch.zeros((Sq, v.shape[-1] + 1), dtype=torch.float32,
                         device=dev)
    for i in range(Sk):
        s_i = s_all[:, i:i + 1]
        m_new = torch.maximum(m, s_i)
        vi = v_star[i][None, :].expand(o_star.shape)
        if variant == "expmul":
            shape = o_star.shape
            a = apply_pow2_scale(o_star, log2exp_lhat(m - m_new).expand(shape))
            b = apply_pow2_scale(vi, log2exp_lhat(s_i - m_new).expand(shape))
        else:
            a = o_star * torch.exp(m - m_new)
            b = vi * torch.exp(s_i - m_new)
        b = torch.where(s_i <= MASK_VALUE, torch.zeros_like(b), b)
        m, o_star = m_new, a + b
    l = o_star[:, :1]
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o_star[:, 1:] / l).to(q.dtype)

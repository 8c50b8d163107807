"""The shared online-softmax tile step, in plain PyTorch.

One KV tile of the FlashAttention-2 recurrence in exact or ExpMul
arithmetic, with optional dequantization of K/V codes — the arithmetic of
``repro/kernels/flash/tile.py`` (``online_softmax_tile`` and
``finalize_tiles``) operation for operation. The plain versions of the
paged decode and prefill kernels call it on each tile in the kernels'
tile order; the CUDA kernels run the same step in ``csrc/tile.cuh`` and
``csrc/tile_sm90.cuh``. Both products are ``fma_chain``s, summed in the
kernels' order on every device and shape. ``decode_fold`` and
``paged_decode_fold`` are the decode kernels' parallel forms of the walk,
for the tests.

Shapes carry any leading batch axes: q (..., rows, D), k (..., bk, D),
v (..., bk, Dv), k_scale / v_scale (..., bk) or None, mask
(..., rows, bk); the state is m, l (..., rows, 1) and acc (..., rows, Dv),
all float32.
"""
from __future__ import annotations

import torch

from repro_torch.numerics.log2exp import apply_pow2_scale, log2exp_lhat, pow2_neg

MASK_VALUE = -1e30


def fma_chain(a, b):
    """``a @ b`` as the kernels sum it: each output is one chain
    ``acc = fmaf(a_k, b_k, acc)`` over k = 0, 1, ..., K - 1 from acc = 0,
    each step rounded once to float32, so the result depends on no
    library's choice of order. a (..., M, K) and b (..., K, N) hold
    float32 values (any float dtype that float32 holds exactly); returns
    float32 (..., M, N).

    A step is ``torch.addcmul`` in float32, which rounds a * b + c once (a
    fused multiply-add) on the card and on the host:
    ``tools/fma_witness.py`` holds this chain bit for bit against a raw
    ``fmaf`` kernel on inputs where fused and unfused rounding differ, and
    ``tests/test_torch_paged_fold.py`` pins it against exact arithmetic."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    shape = (torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
             + (a.shape[-2], b.shape[-1]))
    acc = torch.zeros(shape, dtype=torch.float32, device=a.device)
    for k in range(a.shape[-1]):
        acc.addcmul_(a32[..., :, k, None], b32[..., k, None, :])
    return acc


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
    s = fma_chain(q, k.transpose(-1, -2)) * scale
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
        acc = acc_prev * alpha + fma_chain(pv, v)
    elif variant == "expmul":
        lr = log2exp_lhat(m_prev - m_new)
        p = torch.where(mask, pow2_neg(log2exp_lhat(s - m_new)), zero)
        l_new = apply_pow2_scale(l_prev, lr) + torch.sum(p, dim=-1,
                                                         keepdim=True)
        pv = p if v_scale is None else p * v_scale[..., None, :]
        acc = (apply_pow2_scale(acc_prev, lr.expand(acc_prev.shape))
               + fma_chain(pv, v))
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
        s = fma_chain(q, k[:, sl].transpose(-1, -2)) * scale
        if quant:
            s = s * ks[:, sl][..., None, :]
        s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
        tiles.append((sl, mask, s, torch.amax(s, dim=-1, keepdim=True),
                      (c0 < length)[:, None].expand(BHkv, group)))
    prefix, m = [], init_state((BHkv, group), Dv, dev)[0]
    for tile in tiles:
        m = torch.maximum(m, tile[3])
        prefix.append(m)
    return _fold_tiles([(mask, s, v[:, sl], vs[:, sl] if quant else None, run)
                        for sl, mask, s, _, run in tiles], prefix,
                       init_state((BHkv, group), Dv, dev), variant=variant,
                       dtype=q3.dtype)


def _fold_tiles(tiles, prefix, state, *, variant, dtype):
    """Steps 2 and 3 of the decode kernels' algorithm: each tile's weights,
    weight sum and value product (v_scale folded into the weights) from its
    prefix maximum m_t alone, then the fold of those partials in tile
    order, l_t = rescale(l_{t-1}, m_{t-1} -> m_t) + psum_t (acc alike).
    ``tiles`` holds (mask, s, v, v_scale or None, run) per tile, the
    scores masked; a tile that does not run leaves a row's state as it
    was. ``state`` is the (m, l, acc) before the first tile."""
    m, l, acc = state
    m_prev = m
    parts = []
    for (mask, s, v, vs, run), m_new in zip(tiles, prefix):
        zero = torch.zeros_like(s)
        if variant == "exact":
            p = torch.where(mask, torch.exp(s - m_new), zero)
        elif variant == "expmul":
            p = torch.where(mask, pow2_neg(log2exp_lhat(s - m_new)), zero)
        else:
            raise ValueError(f"unknown attention variant {variant!r}")
        pv = p if vs is None else p * vs[..., None, :]
        parts.append((m_prev, m_new, torch.sum(p, dim=-1, keepdim=True),
                      fma_chain(pv, v), run))
        m_prev = m_new
    # the fold, in tile order
    for m_old, m_new, psum, dsum, run in parts:
        if variant == "exact":
            alpha = torch.exp(m_old - m_new)
            new = (m_new, l * alpha + psum, acc * alpha + dsum)
        else:
            lr = log2exp_lhat(m_old - m_new)
            new = (m_new, apply_pow2_scale(l, lr) + psum,
                   apply_pow2_scale(acc, lr.expand(acc.shape)) + dsum)
        m, l, acc = select_state(run, new, (m, l, acc))
    return finalize_tiles((m, l, acc), dtype)


def paged_decode_fold(bt, len1, q3, k4, v4, ks3=None, vs3=None, *, scale,
                      variant, page_size, window, num_kv_heads,
                      pages_per_rank=4, cluster=8):
    """The paged decode kernel's algorithm (``csrc/paged_decode.cu``) in
    plain PyTorch, for the tests. Each page is a tile. Rank r of a cluster
    of ``cluster`` ranks takes chunk k * cluster + r in round k, a chunk
    being ``pages_per_rank`` pages in table order. First every page's
    scores and row maxima; then each page's prefix maximum from the
    maxima of the earlier rounds (carried), of the lower ranks' chunks
    in this round and of the rank's own earlier pages; then each page's
    weights, weight sum and value product from that maximum alone, and
    their fold in page order. The same float operations as
    ``paged_decode_fwd_plain``'s sequential walk, so the same bits; the
    main path does not call it. (The kernel counts chunks from the
    window's lowest page, here from page 0: that changes only the order in
    which maxima are taken, which is exact.) Shapes as
    ``paged_decode_fwd_plain``'s."""
    BHkv, group, _ = q3.shape
    nblk, ps = k4.shape[0], page_size
    dev = q3.device
    quant = ks3 is not None
    b_idx = torch.arange(BHkv, device=dev) // num_kv_heads
    h_idx = torch.arange(BHkv, device=dev) % num_kv_heads
    length = len1.to(torch.int64)[b_idx]
    q = q3.to(torch.float32)
    cols = torch.arange(ps, device=dev)
    n_pages = min(-(-int(len1.max()) // ps), bt.shape[1]) \
        if len1.numel() else 0
    # 1. every page's masked scores and row maxima
    tiles, tmax = [], []
    for t in range(n_pages):
        c0 = t * ps
        run = c0 < length
        if window is not None:
            run = run & (c0 + ps > length - window)
        blk = torch.clamp(bt[b_idx, t].to(torch.int64), max=nblk - 1)
        c = c0 + cols[None, :]
        mask = c < length[:, None]
        if window is not None:
            mask = mask & (c >= (length - window)[:, None])
        mask = mask[:, None, :].expand(BHkv, group, ps)
        s = fma_chain(q, k4[blk, :, h_idx].to(torch.float32).transpose(-1, -2))
        s = s * scale
        if quant:
            s = s * ks3[blk, :, h_idx][..., None, :]
        s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
        tiles.append((mask, s, v4[blk, :, h_idx].to(torch.float32),
                      vs3[blk, :, h_idx] if quant else None,
                      run[:, None].expand(BHkv, group)))
        tmax.append(torch.amax(s, dim=-1, keepdim=True))
    # 2. the prefix maxima from the chunks' maxima, round by round
    state = init_state((BHkv, group), v4.shape[-1], dev)
    n_chunks = -(-n_pages // pages_per_rank)
    chunk_max = [torch.amax(torch.stack(tmax[c * pages_per_rank:
                                             (c + 1) * pages_per_rank]), 0)
                 for c in range(n_chunks)]
    prefix, carry = [], state[0]
    for k0 in range(0, n_chunks, cluster):
        for c in range(k0, min(k0 + cluster, n_chunks)):
            m = carry
            for lower in chunk_max[k0:c]:
                m = torch.maximum(m, lower)
            for t in range(c * pages_per_rank,
                           min((c + 1) * pages_per_rank, n_pages)):
                m = torch.maximum(m, tmax[t])
                prefix.append(m)
        for cm in chunk_max[k0:k0 + cluster]:
            carry = torch.maximum(carry, cm)
    # 3. the partials from the prefix maxima, folded in page order
    return _fold_tiles(tiles, prefix, state, variant=variant, dtype=q3.dtype)

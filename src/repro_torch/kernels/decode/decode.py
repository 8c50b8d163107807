"""Flash-decode: one query token per sequence against a KV cache, as
hand-written Hopper kernels and their plain PyTorch versions, for two
layouts:

* **paged** (``csrc/paged_decode.cu``, the port of
  ``repro/kernels/decode/decode.py:paged_decode_fwd_pallas``): q
  (B*Hkv, group, D), pools (pool_blocks, page_size, Hkv, D) of values or
  int8/fp8 codes, scale pools (pool_blocks, page_size, Hkv) float32 for
  codes, block tables (B, max_blocks) int32 (sentinel = pool_blocks) and
  lengths (B,) int32 counting the current token. The tiles are pages
  0, 1, ... of the block table, masked ``col < length`` (and the window).
* **contiguous** (``csrc/decode.cu``, the port of ``decode_fwd_pallas``):
  q (B*Hkv, group, D), per-slot caches (B*Hkv, S, D) of values or codes,
  scale rows (B*Hkv, S) float32 for codes, lengths (B,) int32 with
  ``length <= S``. The tiles are ``bk = min(BLOCK_K, S)`` columns wide,
  the reference's width (ExpMul results depend on it), masked
  ``col < length``; rows past the length (a previous occupant's) are
  masked, and the kernel never reads them.

``*_fwd`` launches the CUDA kernel for CUDA tensors and runs the plain
version only for CPU tensors. ``*_fwd_plain`` walks the same tiles in the
same order on any device, through the shared tile step.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.flash.tile import (
    finalize_tiles,
    init_state,
    online_softmax_tile,
    select_state,
)

NAME = "paged_decode"
CONTIGUOUS = "decode"
BLOCK_K = 256      # the reference's decode tile (spec.decode_block_k)
HEAD_DIMS = (16, 64)
ACT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float8_e4m3fn: 3}
CODE_DTYPES = (torch.int8, torch.float8_e4m3fn)
MAX_PAGE = 32

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURE = {NAME: (ctypes.c_int, [_P] * 8 + [_I] * 8 + [_F] + [_I] * 3
                     + [_P])}
_CONTIGUOUS_SIGNATURE = {"contiguous_decode": (
    ctypes.c_int, [_P] * 7 + [_I] * 6 + [_F] + [_I] * 3 + [_P])}


def paged_decode_fwd_plain(bt, len1, q3, k4, v4, ks3=None, vs3=None, *,
                           scale, variant, page_size, window, num_kv_heads):
    """The plain PyTorch version: the kernel's tile walk, vectorized over
    (sequence, KV head). Returns (B*Hkv, group, Dv) in q's dtype."""
    build.COUNTS[f"{NAME}_plain"] += 1
    BHkv, group, _ = q3.shape
    nblk = k4.shape[0]
    Dv = v4.shape[-1]
    dev = q3.device
    quant = ks3 is not None
    b_idx = torch.arange(BHkv, device=dev) // num_kv_heads
    h_idx = torch.arange(BHkv, device=dev) % num_kv_heads
    length = len1.to(torch.int64)[b_idx]                       # (BHkv,)
    q = q3.to(torch.float32)
    state = init_state((BHkv, group), Dv, dev)
    cols = torch.arange(page_size, device=dev)
    n_pages = min(-(-int(len1.max()) // page_size), bt.shape[1]) \
        if len1.numel() else 0
    for ki in range(n_pages):
        c0 = ki * page_size
        run = c0 < length
        if window is not None:
            run = run & (c0 + page_size > length - window)
        blk = torch.clamp(bt[b_idx, ki].to(torch.int64), max=nblk - 1)
        k = k4[blk, :, h_idx].to(torch.float32)                # (BHkv, ps, D)
        v = v4[blk, :, h_idx].to(torch.float32)
        ks = ks3[blk, :, h_idx] if quant else None
        vs = vs3[blk, :, h_idx] if quant else None
        c = c0 + cols[None, :]
        mask = c < length[:, None]
        if window is not None:
            mask = mask & (c >= (length - window)[:, None])
        mask = mask[:, None, :].expand(BHkv, group, page_size)
        new = online_softmax_tile(q, k, v, ks, vs, mask, state, scale=scale,
                                  variant=variant)
        state = select_state(run[:, None].expand(BHkv, group), new, state)
    return finalize_tiles(state, q3.dtype)


def _check(bt, len1, q3, k4, v4, ks3, vs3, page_size, num_kv_heads):
    dev = q3.device
    tensors = [bt, len1, q3, k4, v4] + ([ks3, vs3] if ks3 is not None else [])
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{NAME}: all operands must be on {dev}, got "
                             f"one on {t.device}")
    if q3.dtype not in ACT_DTYPES:
        raise ValueError(f"{NAME}: q must be float32/bfloat16, got {q3.dtype}")
    if k4.dtype not in KV_DTYPES or v4.dtype != k4.dtype:
        raise ValueError(f"{NAME}: unsupported pool dtypes {k4.dtype}/{v4.dtype}")
    if (ks3 is not None) != (k4.dtype in CODE_DTYPES):
        raise ValueError(f"{NAME}: scale pools go with int8/fp8 code pools "
                         f"and only with them")
    BHkv, group, D = q3.shape
    if D not in HEAD_DIMS or k4.shape[-1] != D or v4.shape[-1] != D:
        raise ValueError(f"{NAME}: the kernel is built for head dims "
                         f"{HEAD_DIMS} with Dv == D, got q {tuple(q3.shape)}, "
                         f"v {tuple(v4.shape)}")
    if not 0 < page_size <= MAX_PAGE or k4.shape[1] != page_size:
        raise ValueError(f"{NAME}: page_size must be in [1, {MAX_PAGE}] and "
                         f"match the pool's, got {page_size}, {tuple(k4.shape)}")
    if not 0 < group <= 32 or k4.shape[2] != num_kv_heads:
        raise ValueError(f"{NAME}: group {group} / Hkv {num_kv_heads} not "
                         f"supported by the kernel")
    if bt.dtype != torch.int32 or len1.dtype != torch.int32:
        raise ValueError(f"{NAME}: block tables and lengths must be int32")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: operands must be contiguous")
    if BHkv != bt.shape[0] * num_kv_heads or len1.shape != (bt.shape[0],):
        raise ValueError(f"{NAME}: q rows {BHkv} do not match B x Hkv "
                         f"({bt.shape[0]} x {num_kv_heads})")


def paged_decode_fwd(bt, len1, q3, k4, v4, ks3=None, vs3=None, *, scale,
                     variant, page_size, window, num_kv_heads):
    """Paged decode on the CUDA kernel (CUDA tensors) or its plain version
    (CPU tensors). Returns (B*Hkv, group, D) in q's dtype."""
    if q3.device.type == "cpu":
        return paged_decode_fwd_plain(
            bt, len1, q3, k4, v4, ks3, vs3, scale=scale, variant=variant,
            page_size=page_size, window=window, num_kv_heads=num_kv_heads)
    if q3.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {q3.device}")
    if variant not in ("exact", "expmul"):
        raise ValueError(f"unknown attention variant {variant!r}")
    _check(bt, len1, q3, k4, v4, ks3, vs3, page_size, num_kv_heads)
    BHkv, group, D = q3.shape
    out = torch.empty_like(q3)
    if BHkv == 0:
        return out
    lib = build.load(NAME, _SIGNATURE)
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    err = lib.paged_decode(
        q3.data_ptr(), k4.data_ptr(), v4.data_ptr(),
        ks3.data_ptr() if ks3 is not None else None,
        vs3.data_ptr() if vs3 is not None else None,
        bt.data_ptr(), len1.data_ptr(), out.data_ptr(),
        bt.shape[0], num_kv_heads, group, D, k4.shape[0], page_size,
        bt.shape[1], window or 0, float(scale), int(variant == "expmul"),
        ACT_DTYPES[q3.dtype], KV_DTYPES[k4.dtype], stream)
    build.check(err, NAME)
    build.COUNTS[NAME] += 1
    return out


# ---------------------------------------------------------------------------
# contiguous caches
# ---------------------------------------------------------------------------
def decode_fwd_plain(q3, k3, v3, lengths, ks2=None, vs2=None, *, scale,
                     variant, num_kv_heads, block_k=BLOCK_K):
    """The plain PyTorch version: tiles of ``min(block_k, S)`` columns,
    vectorized over (sequence, KV head); the cache is padded to a whole
    number of tiles here only. Returns (B*Hkv, group, Dv) in q's dtype."""
    build.COUNTS[f"{CONTIGUOUS}_plain"] += 1
    BHkv, group, _ = q3.shape
    S, Dv = k3.shape[1], v3.shape[-1]
    dev = q3.device
    quant = ks2 is not None
    bk = min(block_k, S)
    pad = -S % bk
    length = lengths.to(torch.int64)[torch.arange(BHkv, device=dev)
                                     // num_kv_heads]          # (BHkv,)
    k = F.pad(k3.to(torch.float32), (0, 0, 0, pad))
    v = F.pad(v3.to(torch.float32), (0, 0, 0, pad))
    ks = F.pad(ks2, (0, pad)) if quant else None
    vs = F.pad(vs2, (0, pad)) if quant else None
    q = q3.to(torch.float32)
    state = init_state((BHkv, group), Dv, dev)
    cols = torch.arange(bk, device=dev)
    top = min(int(lengths.max()), S) if lengths.numel() else 0
    for c0 in range(0, top, bk):
        sl = slice(c0, c0 + bk)
        mask = ((c0 + cols)[None, :] < length[:, None])[:, None, :]
        new = online_softmax_tile(
            q, k[:, sl], v[:, sl], ks[:, sl] if quant else None,
            vs[:, sl] if quant else None, mask.expand(BHkv, group, bk),
            state, scale=scale, variant=variant)
        run = (c0 < length)[:, None].expand(BHkv, group)
        state = select_state(run, new, state)
    return finalize_tiles(state, q3.dtype)


def _check_contiguous(q3, k3, v3, lengths, ks2, vs2, num_kv_heads):
    name = CONTIGUOUS
    quant = ks2 is not None
    tensors = [q3, k3, v3, lengths] + ([ks2, vs2] if quant else [])
    for t in tensors:
        if t.device != q3.device:
            raise ValueError(f"{name}: all operands must be on {q3.device}, "
                             f"got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if q3.dtype not in ACT_DTYPES:
        raise ValueError(f"{name}: q must be float32/bfloat16, got {q3.dtype}")
    if k3.dtype not in KV_DTYPES or v3.dtype != k3.dtype:
        raise ValueError(f"{name}: unsupported cache dtypes "
                         f"{k3.dtype}/{v3.dtype}")
    if quant != (k3.dtype in CODE_DTYPES) or (quant and vs2 is None):
        raise ValueError(f"{name}: scale rows go with int8/fp8 codes and "
                         f"only with them")
    BHkv, group, D = q3.shape
    B, S = lengths.shape[0], k3.shape[1]
    if D not in HEAD_DIMS or k3.shape[-1] != D or v3.shape[-1] != D:
        raise ValueError(f"{name}: the kernel is built for head dims "
                         f"{HEAD_DIMS} with Dv == D, got q {tuple(q3.shape)}, "
                         f"v {tuple(v3.shape)}")
    if not 0 < group <= 32 or BHkv != B * num_kv_heads or S == 0:
        raise ValueError(f"{name}: q {tuple(q3.shape)} with {B} lengths and "
                         f"Hkv={num_kv_heads} over {S} slots is not supported")
    if (tuple(k3.shape[:2]) != (BHkv, S) or tuple(v3.shape[:2]) != (BHkv, S)
            or (quant and {tuple(ks2.shape), tuple(vs2.shape)}
                != {(BHkv, S)})):
        raise ValueError(f"{name}: cache shapes {tuple(k3.shape)} / "
                         f"{tuple(v3.shape)} do not match q {tuple(q3.shape)}")
    if lengths.dtype != torch.int32:
        raise ValueError(f"{name}: lengths must be int32")


def decode_fwd(q3, k3, v3, lengths, ks2=None, vs2=None, *, scale, variant,
               num_kv_heads):
    """Contiguous decode on the CUDA kernel (CUDA tensors) or its plain
    version (CPU tensors). Returns (B*Hkv, group, D) in q's dtype."""
    if q3.device.type == "cpu":
        return decode_fwd_plain(q3, k3, v3, lengths, ks2, vs2, scale=scale,
                                variant=variant, num_kv_heads=num_kv_heads)
    if q3.device.type != "cuda":
        raise ValueError(f"{CONTIGUOUS}: no kernel for device {q3.device}")
    if variant not in ("exact", "expmul"):
        raise ValueError(f"unknown attention variant {variant!r}")
    _check_contiguous(q3, k3, v3, lengths, ks2, vs2, num_kv_heads)
    BHkv, group, D = q3.shape
    S = k3.shape[1]
    out = torch.empty_like(q3)
    if BHkv == 0:
        return out
    lib = build.load(CONTIGUOUS, _CONTIGUOUS_SIGNATURE)
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    err = lib.contiguous_decode(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
        ks2.data_ptr() if ks2 is not None else None,
        vs2.data_ptr() if vs2 is not None else None,
        lengths.data_ptr(), out.data_ptr(), lengths.shape[0], num_kv_heads,
        group, D, S, min(BLOCK_K, S), float(scale), int(variant == "expmul"),
        ACT_DTYPES[q3.dtype], KV_DTYPES[k3.dtype], stream)
    build.check(err, CONTIGUOUS)
    build.COUNTS[CONTIGUOUS] += 1
    return out

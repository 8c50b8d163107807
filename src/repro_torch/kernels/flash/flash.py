"""Full-sequence FlashAttention-2 forward, exact and ExpMul variants, as a
hand-written Hopper kernel (``csrc/flash.cu``, the port of
``repro/kernels/flash/flash.py:flash_fwd_pallas``) and its plain PyTorch
version.

Layout, the reference's folded one: q3 (B*H, Sq, D), k3 and v3
(B*Hkv, Sk_pad, D), float32 or bfloat16, one dtype for all three; the
output is (B*H, Sq, D) in that dtype. The KV tiles are ``block_k``
columns wide, counted from column 0 of the padded K (ExpMul results depend
on the width), and each row's mask is ``col < kv_len``, ``row >= col``
when ``causal`` and ``row - col < window`` when a window is set, where
``row`` is the query's index plus ``q_offset``: a call on rows
``q_offset:`` of a sequence (a rank's share of a query-split call, the
keys the whole sequence's) masks as the whole call does those rows, so
its output is theirs. Query head h reads KV head ``h // (H / Hkv)``.

``flash_fwd_plain`` walks those tiles vectorized over every row and
reproduces the Pallas kernel's ``min(block_q, Sq)``-row query blocks
(``BLOCK_Q``, Pallas' default) and the tiles each block skips, so it equals
the Pallas kernel tile for tile. It sums both products as ``fma_chain``s,
the scores in depth order and the values in column order.

The CUDA kernel runs the contiguous prefill's register-tiled CUDA-core
layout (``csrc/tile_sm90.cuh``): a block of 128 threads per (batch x head,
32 query rows), causal blocks launched heaviest first; each tile's K and V
staged in 64-row sub-tiles converted to float32 in shared memory, its scores
in 4 x 4 register blocks, its row max, weights, weight sum and rescale once
per tile, and its value product from a fresh chain, all in the plain
version's order. A block skips the tiles wholly masked for all of its rows
and reads no column at or past ``kv_len`` or, when causal, past its last
row. The row blocking changes no number (a wholly masked tile leaves a
row's (m, l, acc) as it was), so neither version needs Sq padded. Its shared
memory grows with the head dim and the tile width (``flash_smem``: 100,352
bytes at D 64 and 512-wide tiles, two blocks an SM; 174,080 at D 256); the
wrapper checks it against the card's limit before the launch. At head dims
96 and 112 the kernel stages V at 128 features, the padding zero, and
stores the first D (``csrc/tile_sm90.cuh:value_width``); each stored
feature keeps the plain version's chain.

``flash_fwd`` launches the CUDA kernel for CUDA tensors and runs the plain
version only for CPU tensors. A ``meta`` operand (the dry run's) has
nothing to launch: it gets ``torch.empty`` of the output's shape and
dtype, and the plain tile loop never runs. A launch and a ``meta`` call
each report their analytic cost to the active op counters
(``kernels/costs.py:report_call``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, costs
from repro_torch.kernels.decode.decode import ACT_DTYPES, card_smem_limit
from repro_torch.kernels.flash.tile import (
    finalize_tiles,
    init_state,
    online_softmax_tile,
    select_state,
)

NAME = "flash"
HEAD_DIMS = (16, 32, 64, 96, 112, 128, 256)
MAX_BLOCK_K = 512  # the widest KV tile the kernel stages (tile.cuh kMaxTile)
BLOCK_Q = 128      # the reference's query block (cfg.attention_block_q)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURE = {"flash_forward": (ctypes.c_int, [_P] * 4 + [_I] * 11 + [_F]
                                + [_I] * 2 + [_P]),
              "flash_smem": (ctypes.c_longlong, [_I] * 2)}


@functools.lru_cache(maxsize=None)
def smem_bytes(D, block_k) -> int:
    """The shared memory, in bytes, the kernel gives a block at head dim
    ``D`` and tile width ``block_k`` (``csrc/flash.cu:flash_smem``; the
    launch asks the card for exactly this much)."""
    return int(build.load(NAME, _SIGNATURE).flash_smem(D, block_k))


def _check(q3, k3, v3, *, block_k, num_q_heads, num_kv_heads, kv_len,
           q_offset=0):
    """Raise on operands neither version takes."""
    BH, Sq, D = q3.shape
    BHkv, Sk, _ = k3.shape
    H, Hkv = num_q_heads, num_kv_heads
    if q3.dtype not in ACT_DTYPES or {k3.dtype, v3.dtype} != {q3.dtype}:
        raise ValueError(f"{NAME}: q, k and v must share float32 or "
                         f"bfloat16, got {q3.dtype}/{k3.dtype}/{v3.dtype}")
    if {k3.device, v3.device} != {q3.device}:
        raise ValueError(f"{NAME}: all operands must be on {q3.device}")
    if v3.shape != k3.shape or k3.shape[-1] != D:
        raise ValueError(f"{NAME}: k {tuple(k3.shape)} and v "
                         f"{tuple(v3.shape)} must share (B*Hkv, Sk, D) with "
                         f"q's D={D} (Dq == Dv)")
    if H <= 0 or Hkv <= 0 or H % Hkv or BH % H or BH // H * Hkv != BHkv:
        raise ValueError(f"{NAME}: q {tuple(q3.shape)} and k "
                         f"{tuple(k3.shape)} do not fold H={H} over Hkv={Hkv}")
    if not 0 < block_k <= MAX_BLOCK_K or Sk % block_k:
        raise ValueError(f"{NAME}: block_k must be in [1, {MAX_BLOCK_K}] and "
                         f"divide the padded Sk={Sk}, got {block_k}")
    if not 0 <= kv_len <= Sk:
        raise ValueError(f"{NAME}: kv_len {kv_len} outside [0, {Sk}]")
    if q_offset < 0:
        raise ValueError(f"{NAME}: q_offset {q_offset} is negative")


def flash_fwd_plain(q3, k3, v3, *, causal, scale, window, variant, block_k,
                    num_q_heads, num_kv_heads, kv_len, q_offset=0,
                    block_q=BLOCK_Q):
    """The plain PyTorch version on any device: the Pallas kernel's tile
    walk, vectorized over (batch x head, row). ``block_q`` is the Pallas
    kernel's query block, whose wholly masked tiles it skips (blocks of
    global rows, counted from row 0 of the sequence). Returns
    (B*H, Sq, D) in q's dtype."""
    _check(q3, k3, v3, block_k=block_k, num_q_heads=num_q_heads,
           num_kv_heads=num_kv_heads, kv_len=kv_len, q_offset=q_offset)
    build.COUNTS[f"{NAME}_plain"] += 1
    BH, Sq, _ = q3.shape
    H, Hkv = num_q_heads, num_kv_heads
    dev = q3.device
    bh = torch.arange(BH, device=dev)
    kvh = bh // H * Hkv + (bh % H) // (H // Hkv)
    rows = q_offset + torch.arange(Sq, device=dev)[:, None]    # (Sq, 1)
    bq = min(block_q, q_offset + Sq)
    r0 = rows // bq * bq                                       # block start
    cols = torch.arange(block_k, device=dev)[None, :]
    q = q3.to(torch.float32)
    state = init_state((BH, Sq), v3.shape[-1], dev)
    for c0 in range(0, min(kv_len, k3.shape[1]), block_k):
        run = torch.ones_like(rows, dtype=torch.bool)
        if causal:
            run = run & (c0 < r0 + bq)
        if window is not None:
            run = run & (c0 + block_k > r0 - window)
        c = c0 + cols
        mask = c < kv_len
        if causal:
            mask = mask & (rows >= c)
        if window is not None:
            mask = mask & (rows - c < window)
        sl = slice(c0, c0 + block_k)
        new = online_softmax_tile(
            q, k3[kvh, sl].to(torch.float32), v3[kvh, sl].to(torch.float32),
            None, None, mask.expand(BH, Sq, block_k), state, scale=scale,
            variant=variant)
        state = select_state(run[:, 0].expand(BH, Sq), new, state)
    return finalize_tiles(state, q3.dtype)


def flash_fwd(q3, k3, v3, *, causal, scale, window, variant, block_k,
              num_q_heads, num_kv_heads, kv_len, q_offset=0):
    """The forward on the CUDA kernel (CUDA tensors) or its plain version
    (CPU tensors). Returns (B*H, Sq, D) in q's dtype. A ``meta`` call's
    price ignores the mask, so ``q_offset`` too."""
    kw = dict(causal=causal, scale=scale, window=window, variant=variant,
              block_k=block_k, num_q_heads=num_q_heads,
              num_kv_heads=num_kv_heads, kv_len=kv_len, q_offset=q_offset)
    if q3.device.type == "cpu":
        return flash_fwd_plain(q3, k3, v3, **kw)
    if q3.device.type == "meta":
        _check(q3, k3, v3, block_k=block_k, num_q_heads=num_q_heads,
               num_kv_heads=num_kv_heads, kv_len=kv_len, q_offset=q_offset)
        return _report(torch.empty_like(q3), q3, k3, v3, kv_len)
    if q3.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {q3.device}")
    if variant not in ("exact", "expmul"):
        raise ValueError(f"unknown attention variant {variant!r}")
    _check(q3, k3, v3, block_k=block_k, num_q_heads=num_q_heads,
           num_kv_heads=num_kv_heads, kv_len=kv_len, q_offset=q_offset)
    if not all(t.is_contiguous() for t in (q3, k3, v3)):
        raise ValueError(f"{NAME}: operands must be contiguous")
    BH, Sq, D = q3.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{NAME}: the kernel is built for head dims "
                         f"{HEAD_DIMS}, got {D}")
    need, limit = smem_bytes(D, block_k), card_smem_limit(q3.device)
    if need > limit:
        raise ValueError(f"{NAME}: head dim {D} at block_k {block_k} needs "
                         f"{need} B of shared memory a block, the card "
                         f"allows {limit}")
    out = torch.empty_like(q3)
    if BH == 0 or Sq == 0:
        return out
    lib = build.load(NAME, _SIGNATURE)
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    err = lib.flash_forward(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(), BH,
        num_q_heads, num_kv_heads, Sq, k3.shape[1], D, block_k, kv_len,
        int(q_offset), int(bool(causal)), window or 0, float(scale),
        int(variant == "expmul"), ACT_DTYPES[q3.dtype], stream)
    build.check(err, NAME)
    build.COUNTS[NAME] += 1
    return _report(out, q3, k3, v3, kv_len)


def _report(out, q3, k3, v3, kv_len):
    """Report the call to the op counters (``kernels/costs.py``)."""
    if not costs.counting():
        return out
    BH, Sq, D = q3.shape
    return costs.report_call(NAME, out, (q3, k3, v3), batch=BH, heads=1,
                             q_tokens=Sq, kv_tokens=kv_len, d_qk=D, d_v=D)

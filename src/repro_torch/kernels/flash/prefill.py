"""Chunked prefill: a chunk of C fresh queries per sequence against
[KV history ++ the chunk's own KV], as hand-written Hopper kernels and
their plain PyTorch versions, for two layouts. Neither builds the
concatenation.

* **paged** (``csrc/paged_prefill.cu``, the port of
  ``repro/kernels/flash/prefill.py:paged_prefill_fwd_pallas``): q
  (B*H, C, D); pools K (pool_blocks, page_size, Hkv, D) and V (...,
  Dv) of values or int8/fp8 codes with (pool_blocks, page_size, Hkv)
  float32 scale pools; the chunk's K (B*Hkv, C, D) and V (B*Hkv, C, Dv)
  in the pool's dtype with (B*Hkv, C) float32 scales for codes; block tables (B, max_blocks) int32; lengths
  (tokens already resident) and n_valid (valid chunk tokens), each (B,)
  int32. The KV tiles are one page wide: history pages 0, 1, ... up to
  ``length`` (masked ``col < length`` and the window), then chunk tiles
  [0, ps), [ps, 2ps), ... from the chunk start (masked ``j < n_valid``,
  ``row >= j`` and the window).
* **contiguous** (``csrc/prefill.cu``, the port of
  ``prefill_fwd_pallas``): per-slot caches K (B*Hkv, S, D) and V
  (B*Hkv, S, Dv) with (B*Hkv, S) scale rows for codes, the chunk as above
  (its V rows Dv wide). The KV tiles are
  ``bk = min(block_k, max(S, C, 1))`` columns wide, ``block_k`` the
  reference's width (``BLOCK_K``; the ``gather_pallas`` route passes the
  page size; ExpMul results depend on it): cache tiles [0, bk), ... below
  ``min(length, S)``, then chunk tiles from the chunk start. With
  ``rolling=False`` slot j holds position j (``length <= S``); with
  ``rolling=True`` the cache is a rolling buffer of span S and slot j
  holds position ``last - ((last - j) % S)``, ``last = length - 1``,
  masked where that is negative (Python's ``%``: ``torch.remainder``,
  never ``torch.fmod``) and by the window.

The plain versions also reproduce the Pallas kernels' query blocks of
``min(block_q, C)`` rows (``BLOCK_Q``, or ``cfg.attention_block_q``) and the tiles they skip per block, so they equal
the Pallas kernels tile for tile; the CUDA kernels use smaller query
blocks, which changes only which fully masked tiles they skip.

``*_fwd`` launches the CUDA kernel for CUDA tensors and runs the plain
version only for CPU tensors. A ``meta`` operand (the dry run's) gets
``torch.empty`` of the output's shape and dtype after the shape checks,
and no tile loop runs. A launch and a ``meta`` call each report their
analytic cost to the active op counters (``kernels/costs.py:report_call``).

Both kernels take their Pallas kernels' inputs: any head dims D, Dv up to
256 (codes too), any GQA group, pages of up to 256 tokens
(``decode.check_head_dims``, ``decode.check_page``); a call runs the
narrowest built width that holds (D, Dv), its numbers the plain
version's at the call's dims. The paged kernel takes a whole-row walk or
the general one, as the paged decode does (``kernels/decode/decode.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, costs
from repro_torch.kernels.decode.decode import (
    ACT_DTYPES,
    CODE_DTYPES,
    KV_DTYPES,
    check_head_dims,
    check_page,
    check_smem,
)
from repro_torch.kernels.flash.tile import (
    finalize_tiles,
    init_state,
    online_softmax_tile,
    select_state,
)

NAME = "paged_prefill"
CONTIGUOUS = "prefill"
BLOCK_Q = 128      # the reference's query block (cfg.attention_block_q)
BLOCK_K = 512      # the reference's contiguous KV tile (cfg.attention_block_k)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURE = {NAME: (ctypes.c_int, [_P] * 13 + [_I] * 10 + [_F] + [_I] * 4
                     + [ctypes.POINTER(_I), _P]),
              "paged_prefill_smem": (ctypes.c_longlong, [_I] * 3)}
_CONTIGUOUS_SIGNATURE = {
    "contiguous_prefill": (ctypes.c_int, [_P] * 12 + [_I] * 10 + [_F]
                           + [_I] * 3 + [_P]),
    "contiguous_prefill_smem": (ctypes.c_longlong, [_I] * 4)}


@functools.lru_cache(maxsize=None)
def paged_prefill_smem(D, page_size=16, Dv=None) -> int:
    """The shared memory, in bytes, the paged prefill gives a block at head
    dims D, Dv (default D) and page size ``page_size``
    (``csrc/paged_prefill.cu:paged_prefill_smem``; the same at any length;
    it grows with pages over 64 tokens, whose scores it holds whole)."""
    return int(build.load(NAME, _SIGNATURE).paged_prefill_smem(
        D, D if Dv is None else Dv, page_size))


@functools.lru_cache(maxsize=None)
def contiguous_prefill_smem(D, block_k, Dv=None, kv_dtype=torch.float32) -> int:
    """The shared memory, in bytes, the contiguous prefill gives a block at
    tile width ``block_k``, head dims D, Dv (default D) and KV dtype
    ``kv_dtype`` (``csrc/prefill.cu:contiguous_prefill_smem``: float KV at
    64 < D <= 96, Dv <= 64 runs the (96, 64) build)."""
    return int(build.load(CONTIGUOUS, _CONTIGUOUS_SIGNATURE)
               .contiguous_prefill_smem(D, D if Dv is None else Dv, block_k,
                                        KV_DTYPES[kv_dtype]))


def paged_prefill_fwd_plain(bt, lengths, n_valid, q3, k4, v4, kn3, vn3,
                            ks3=None, vs3=None, ksn2=None, vsn2=None, *,
                            scale, variant, window, page_size, num_q_heads,
                            num_kv_heads, block_q=BLOCK_Q):
    """The plain PyTorch version, vectorized over (sequence, head, row).
    ``block_q`` is the Pallas kernel's query block, whose fully masked
    tiles it skips. Returns (B*H, C, Dv) in q's dtype."""
    build.COUNTS[f"{NAME}_plain"] += 1
    BH, C, _ = q3.shape
    H, Hkv, ps = num_q_heads, num_kv_heads, page_size
    nblk = k4.shape[0]
    Dv = v4.shape[-1]
    dev = q3.device
    quant = ks3 is not None
    bq = min(block_q, C)
    b_idx = torch.arange(BH, device=dev) // H
    h_idx = (torch.arange(BH, device=dev) % H) // (H // Hkv)
    kvh = b_idx * Hkv + h_idx
    length = lengths.to(torch.int64)[b_idx][:, None]           # (BH, 1)
    nv = n_valid.to(torch.int64)[b_idx][:, None]
    rows = torch.arange(C, device=dev)[None, :]                # (1, C)
    r0 = rows // bq * bq                                       # block start
    cols = torch.arange(ps, device=dev)
    q = q3.to(torch.float32)
    state = init_state((BH, C), Dv, dev)

    def step(state, k, v, ks, vs, mask, run):
        new = online_softmax_tile(q, k, v, ks, vs, mask, state, scale=scale,
                                  variant=variant)
        return select_state(run, new, state)

    n_hist = min(-(-int(lengths.max()) // ps), bt.shape[1]) \
        if lengths.numel() else 0
    for ki in range(n_hist):
        c0 = ki * ps
        run = (c0 < length).expand(BH, C)
        if window is not None:
            run = run & (c0 + ps > length + r0 - window)
        blk = torch.clamp(bt[b_idx, ki].to(torch.int64), max=nblk - 1)
        c = (c0 + cols)[None, None, :]
        mask = (c < length[:, :, None]).expand(BH, C, ps)
        if window is not None:
            mask = mask & ((length + rows)[:, :, None] - c < window)
        state = step(state, k4[blk, :, h_idx].to(torch.float32),
                     v4[blk, :, h_idx].to(torch.float32),
                     ks3[blk, :, h_idx] if quant else None,
                     vs3[blk, :, h_idx] if quant else None, mask, run)

    pad = -C % ps
    kn = F.pad(kn3.to(torch.float32), (0, 0, 0, pad))[kvh]     # (BH, Ck, D)
    vn = F.pad(vn3.to(torch.float32), (0, 0, 0, pad))[kvh]
    ksn = F.pad(ksn2, (0, pad))[kvh] if quant else None
    vsn = F.pad(vsn2, (0, pad))[kvh] if quant else None
    for j0 in range(0, C + pad, ps):
        run = (j0 < nv) & (j0 < r0 + bq)
        if window is not None:
            run = run & (j0 + ps > r0 - window)
        c = (j0 + cols)[None, None, :]
        r = rows[:, :, None]
        mask = (c < nv[:, :, None]) & (r >= c)
        if window is not None:
            mask = mask & (r - c < window)
        sl = slice(j0, j0 + ps)
        state = step(state, kn[:, sl], vn[:, sl],
                     ksn[:, sl] if quant else None,
                     vsn[:, sl] if quant else None,
                     mask.expand(BH, C, ps), run.expand(BH, C))
    return finalize_tiles(state, q3.dtype)


def _check(bt, lengths, n_valid, q3, k4, v4, kn3, vn3, ks3, vs3, ksn2, vsn2,
           page_size, num_q_heads, num_kv_heads):
    dev = q3.device
    quant = ks3 is not None
    tensors = [bt, lengths, n_valid, q3, k4, v4, kn3, vn3]
    if quant:
        tensors += [ks3, vs3, ksn2, vsn2]
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{NAME}: all operands must be on {dev}, got "
                             f"one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: operands must be contiguous")
    if q3.dtype not in ACT_DTYPES:
        raise ValueError(f"{NAME}: q must be float32/bfloat16, got {q3.dtype}")
    if (k4.dtype not in KV_DTYPES
            or {v4.dtype, kn3.dtype, vn3.dtype} != {k4.dtype}):
        raise ValueError(f"{NAME}: pool and chunk must share one supported "
                         f"dtype, got {k4.dtype}/{v4.dtype}/{kn3.dtype}")
    if quant != (k4.dtype in CODE_DTYPES) or (quant and ksn2 is None):
        raise ValueError(f"{NAME}: scale operands go with int8/fp8 codes "
                         f"and only with them")
    BH, C, D = q3.shape
    B = bt.shape[0]
    Dv = v4.shape[-1]
    if ({k4.shape[-1], kn3.shape[-1]} != {D} or vn3.shape[-1] != Dv
            or v4.shape[:3] != k4.shape[:3]):
        raise ValueError(f"{NAME}: K rows must be q's D={D} wide and V rows "
                         f"one width, got pools {tuple(k4.shape)} / "
                         f"{tuple(v4.shape)}, chunk {tuple(kn3.shape)} / "
                         f"{tuple(vn3.shape)}")
    check_head_dims(NAME, D, Dv)
    check_page(NAME, page_size, k4.shape)
    if (num_q_heads % num_kv_heads or BH != B * num_q_heads
            or k4.shape[2] != num_kv_heads
            or tuple(kn3.shape[:2]) != (B * num_kv_heads, C)
            or tuple(vn3.shape[:2]) != (B * num_kv_heads, C)):
        raise ValueError(f"{NAME}: shapes q {tuple(q3.shape)}, chunk "
                         f"{tuple(kn3.shape)} do not match B={B}, "
                         f"H={num_q_heads}, Hkv={num_kv_heads}")
    if {bt.dtype, lengths.dtype, n_valid.dtype} != {torch.int32}:
        raise ValueError(f"{NAME}: block tables, lengths and n_valid must "
                         f"be int32")


def paged_prefill_fwd(bt, lengths, n_valid, q3, k4, v4, kn3, vn3, ks3=None,
                      vs3=None, ksn2=None, vsn2=None, *, scale, variant,
                      window, page_size, num_q_heads, num_kv_heads,
                      block_q=BLOCK_Q):
    """Paged prefill on the CUDA kernel (CUDA tensors) or its plain version
    (CPU tensors, in query blocks of ``block_q``). Returns (B*H, C, Dv) in
    q's dtype."""
    if q3.device.type == "cpu":
        return paged_prefill_fwd_plain(
            bt, lengths, n_valid, q3, k4, v4, kn3, vn3, ks3, vs3, ksn2, vsn2,
            scale=scale, variant=variant, window=window, page_size=page_size,
            num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
            block_q=block_q)
    if q3.device.type == "meta":
        _check(bt, lengths, n_valid, q3, k4, v4, kn3, vn3, ks3, vs3, ksn2,
               vsn2, page_size, num_q_heads, num_kv_heads)
        return _report_paged(q3.new_empty(q3.shape[:2] + v4.shape[-1:]), bt,
                             lengths, n_valid, q3, k4, v4, kn3, vn3, ks3,
                             ksn2, vsn2, page_size)
    if q3.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {q3.device}")
    if variant not in ("exact", "expmul"):
        raise ValueError(f"unknown attention variant {variant!r}")
    _check(bt, lengths, n_valid, q3, k4, v4, kn3, vn3, ks3, vs3, ksn2, vsn2,
           page_size, num_q_heads, num_kv_heads)
    BH, C, D = q3.shape
    Dv = v4.shape[-1]
    check_smem(NAME, paged_prefill_smem(D, page_size, Dv), q3.device,
               f"head dims {D}/{Dv} in pages of {page_size}")
    out = q3.new_empty((BH, C, Dv))
    if BH == 0 or C == 0:
        return out
    lib = build.load(NAME, _SIGNATURE)
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    ptr = (lambda t: None if t is None else t.data_ptr())
    taken = ctypes.c_int(-1)
    err = lib.paged_prefill(
        q3.data_ptr(), k4.data_ptr(), v4.data_ptr(), ptr(ks3), ptr(vs3),
        kn3.data_ptr(), vn3.data_ptr(), ptr(ksn2), ptr(vsn2), bt.data_ptr(),
        lengths.data_ptr(), n_valid.data_ptr(), out.data_ptr(),
        bt.shape[0], num_q_heads, num_kv_heads, C, D, Dv, k4.shape[0],
        page_size,
        bt.shape[1], window or 0, float(scale), int(variant == "expmul"),
        ACT_DTYPES[q3.dtype], KV_DTYPES[k4.dtype], build.walk_code(),
        ctypes.byref(taken), stream)
    build.check(err, NAME)
    build.COUNTS[NAME] += 1
    if taken.value == build.WALKS["whole"]:
        build.COUNTS[NAME + build.WHOLE] += 1
    return _report_paged(out, bt, lengths, n_valid, q3, k4, v4, kn3, vn3, ks3,
                         ksn2, vsn2, page_size)


def _report_paged(out, bt, lengths, n_valid, q3, k4, v4, kn3, vn3, ks3, ksn2,
                  vsn2, page_size):
    """Report the call to the op counters: the chunk's operands and the
    pages of the tables' span (every row's, at the table's width) read
    once."""
    if not costs.counting():
        return out
    BH, C, D = q3.shape
    span = bt.shape[1] * page_size
    kv = bt.shape[0] * span * k4.shape[2] * (
        k4.shape[-1] * k4.element_size() + v4.shape[-1] * v4.element_size()
        + (8 if ks3 is not None else 0))
    return costs.report_call(
        NAME, out, (q3, kn3, vn3, ksn2, vsn2, bt, lengths, n_valid),
        batch=BH, heads=1, q_tokens=C, kv_tokens=span + C, d_qk=D,
        d_v=v4.shape[-1], kv_bytes=kv)


# ---------------------------------------------------------------------------
# contiguous caches
# ---------------------------------------------------------------------------
def prefill_blocks(S, C, block_q=BLOCK_Q, block_k=BLOCK_K):
    """(bq, bk): the query block and the KV tile width of a chunk of C
    queries over S cache slots, as the reference chooses them."""
    return min(block_q, C), min(block_k, max(S, C, 1))


def prefill_fwd_plain(q3, kc3, vc3, kn3, vn3, lengths, n_valid, ksc2=None,
                      vsc2=None, ksn2=None, vsn2=None, *, scale, variant,
                      window, rolling, num_q_heads, num_kv_heads,
                      block_q=BLOCK_Q, block_k=BLOCK_K):
    """The plain PyTorch version, vectorized over (sequence, head, row);
    the cache and the chunk are padded to whole tiles here only. Returns
    (B*H, C, Dv) in q's dtype."""
    build.COUNTS[f"{CONTIGUOUS}_plain"] += 1
    BH, C, _ = q3.shape
    H, Hkv = num_q_heads, num_kv_heads
    S, Dv = kc3.shape[1], vc3.shape[-1]
    dev = q3.device
    quant = ksc2 is not None
    bq, bk = prefill_blocks(S, C, block_q, block_k)
    bh = torch.arange(BH, device=dev)
    b_idx = bh // H
    kvh = b_idx * Hkv + (bh % H) // (H // Hkv)
    length = lengths.to(torch.int64)[b_idx][:, None]           # (BH, 1)
    nv = n_valid.to(torch.int64)[b_idx][:, None]
    rows = torch.arange(C, device=dev)[None, :]                # (1, C)
    r0 = rows // bq * bq                                       # block start
    cols = torch.arange(bk, device=dev)
    q = q3.to(torch.float32)
    state = init_state((BH, C), Dv, dev)

    def tiles(t, n):   # pad the sequence axis to whole tiles, per query head
        t = t.to(torch.float32) if t.dim() == 3 else t
        pad = (0, 0, 0, -n % bk) if t.dim() == 3 else (0, -n % bk)
        return F.pad(t, pad)[kvh]

    def step(state, k, v, ks, vs, mask, run):
        new = online_softmax_tile(q, k, v, ks, vs, mask, state, scale=scale,
                                  variant=variant)
        return select_state(run, new, state)

    top = min(int(lengths.max()), S) if lengths.numel() and S else 0
    if top:
        kc, vc = tiles(kc3, S), tiles(vc3, S)
        ksc = tiles(ksc2, S) if quant else None
        vsc = tiles(vsc2, S) if quant else None
    for c0 in range(0, top, bk):
        run = (c0 < torch.clamp(length, max=S)).expand(BH, C)
        if window is not None and not rolling:
            run = run & (c0 + bk > length + r0 - window)
        c = (c0 + cols)[None, None, :]                         # (1, 1, bk)
        if rolling:
            last = (length - 1)[:, :, None]
            pos = last - torch.remainder(last - c, S)
            mask = (pos >= 0) & (c < S)
        else:
            pos = c
            mask = c < length[:, :, None]
        if window is not None:
            mask = mask & ((length + rows)[:, :, None] - pos < window)
        sl = slice(c0, c0 + bk)
        state = step(state, kc[:, sl], vc[:, sl],
                     ksc[:, sl] if quant else None,
                     vsc[:, sl] if quant else None,
                     mask.expand(BH, C, bk), run)

    top = min(int(n_valid.max()), C) if n_valid.numel() else 0
    if top:
        kn, vn = tiles(kn3, C), tiles(vn3, C)
        ksn = tiles(ksn2, C) if quant else None
        vsn = tiles(vsn2, C) if quant else None
    for j0 in range(0, top, bk):
        run = (j0 < nv) & (j0 < r0 + bq)
        if window is not None:
            run = run & (j0 + bk > r0 - window)
        c = (j0 + cols)[None, None, :]
        r = rows[:, :, None]
        mask = (c < nv[:, :, None]) & (r >= c)
        if window is not None:
            mask = mask & (r - c < window)
        sl = slice(j0, j0 + bk)
        state = step(state, kn[:, sl], vn[:, sl],
                     ksn[:, sl] if quant else None,
                     vsn[:, sl] if quant else None,
                     mask.expand(BH, C, bk), run.expand(BH, C))
    return finalize_tiles(state, q3.dtype)


def _check_contiguous(q3, kc3, vc3, kn3, vn3, lengths, n_valid, ksc2, vsc2,
                      ksn2, vsn2, num_q_heads, num_kv_heads):
    name = CONTIGUOUS
    quant = ksc2 is not None
    scales = [ksc2, vsc2, ksn2, vsn2]
    tensors = [q3, kc3, vc3, kn3, vn3, lengths, n_valid]
    if quant:
        tensors += scales
    for t in tensors:
        if t is None:
            raise ValueError(f"{name}: scale operands go with int8/fp8 "
                             f"codes, all four of them")
        if t.device != q3.device:
            raise ValueError(f"{name}: all operands must be on {q3.device}, "
                             f"got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if q3.dtype not in ACT_DTYPES:
        raise ValueError(f"{name}: q must be float32/bfloat16, got {q3.dtype}")
    if (kc3.dtype not in KV_DTYPES
            or {vc3.dtype, kn3.dtype, vn3.dtype} != {kc3.dtype}):
        raise ValueError(f"{name}: cache and chunk must share one supported "
                         f"dtype, got {kc3.dtype}/{vc3.dtype}/{kn3.dtype}")
    if quant != (kc3.dtype in CODE_DTYPES):
        raise ValueError(f"{name}: scale operands go with int8/fp8 codes "
                         f"and only with them")
    BH, C, D = q3.shape
    B, S = lengths.shape[0], kc3.shape[1]
    H, Hkv = num_q_heads, num_kv_heads
    Dv = vc3.shape[-1]
    if {kc3.shape[-1], kn3.shape[-1]} != {D} or vn3.shape[-1] != Dv:
        raise ValueError(f"{name}: K rows must be q's D={D} wide and V rows "
                         f"one width, got cache {tuple(kc3.shape)} / "
                         f"{tuple(vc3.shape)}, chunk {tuple(kn3.shape)} / "
                         f"{tuple(vn3.shape)}")
    check_head_dims(name, D, Dv)
    if (H % Hkv or BH != B * H or n_valid.shape != (B,)
            or {tuple(kc3.shape[:2]), tuple(vc3.shape[:2])} != {(B * Hkv, S)}
            or {tuple(kn3.shape[:2]), tuple(vn3.shape[:2])}
            != {(B * Hkv, C)}):
        raise ValueError(f"{name}: shapes q {tuple(q3.shape)}, cache "
                         f"{tuple(kc3.shape)}, chunk {tuple(kn3.shape)} do "
                         f"not match B={B}, H={H}, Hkv={Hkv}")
    if quant and ({tuple(ksc2.shape), tuple(vsc2.shape)} != {(B * Hkv, S)}
                  or {tuple(ksn2.shape), tuple(vsn2.shape)}
                  != {(B * Hkv, C)}):
        raise ValueError(f"{name}: scale rows do not match the codes")
    if {lengths.dtype, n_valid.dtype} != {torch.int32}:
        raise ValueError(f"{name}: lengths and n_valid must be int32")


def prefill_fwd(q3, kc3, vc3, kn3, vn3, lengths, n_valid, ksc2=None,
                vsc2=None, ksn2=None, vsn2=None, *, scale, variant, window,
                rolling, num_q_heads, num_kv_heads, block_q=BLOCK_Q,
                block_k=BLOCK_K):
    """Contiguous prefill on the CUDA kernel (CUDA tensors) or its plain
    version (CPU tensors), in KV tiles of ``prefill_blocks``' width at
    ``block_k`` (the plain version's query blocks of ``block_q`` change no
    number). Returns (B*H, C, Dv) in q's dtype."""
    if q3.device.type == "cpu":
        return prefill_fwd_plain(
            q3, kc3, vc3, kn3, vn3, lengths, n_valid, ksc2, vsc2, ksn2, vsn2,
            scale=scale, variant=variant, window=window, rolling=rolling,
            num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
            block_q=block_q, block_k=block_k)
    if q3.device.type == "meta":
        _check_contiguous(q3, kc3, vc3, kn3, vn3, lengths, n_valid, ksc2,
                          vsc2, ksn2, vsn2, num_q_heads, num_kv_heads)
        return _report_contiguous(
            q3.new_empty(q3.shape[:2] + vc3.shape[-1:]), q3, kc3, vc3, kn3,
            vn3, lengths, n_valid, ksc2, vsc2, ksn2, vsn2)
    if q3.device.type != "cuda":
        raise ValueError(f"{CONTIGUOUS}: no kernel for device {q3.device}")
    if variant not in ("exact", "expmul"):
        raise ValueError(f"unknown attention variant {variant!r}")
    _check_contiguous(q3, kc3, vc3, kn3, vn3, lengths, n_valid, ksc2, vsc2,
                      ksn2, vsn2, num_q_heads, num_kv_heads)
    BH, C, D = q3.shape
    S, Dv = kc3.shape[1], vc3.shape[-1]
    bk = prefill_blocks(S, C, block_q, block_k)[1]
    check_smem(CONTIGUOUS, contiguous_prefill_smem(D, bk, Dv, kc3.dtype),
               q3.device, f"head dims {D}/{Dv} in {bk}-wide tiles")
    out = q3.new_empty((BH, C, Dv))
    if BH == 0 or C == 0:
        return out
    lib = build.load(CONTIGUOUS, _CONTIGUOUS_SIGNATURE)
    stream = torch.cuda.current_stream(q3.device).cuda_stream
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = lib.contiguous_prefill(
        q3.data_ptr(), kc3.data_ptr(), vc3.data_ptr(), ptr(ksc2), ptr(vsc2),
        kn3.data_ptr(), vn3.data_ptr(), ptr(ksn2), ptr(vsn2),
        lengths.data_ptr(), n_valid.data_ptr(), out.data_ptr(),
        lengths.shape[0], num_q_heads, num_kv_heads, C, D, Dv, S, bk,
        window or 0, int(bool(rolling)),
        float(scale), int(variant == "expmul"), ACT_DTYPES[q3.dtype],
        KV_DTYPES[kc3.dtype], stream)
    build.check(err, CONTIGUOUS)
    build.COUNTS[CONTIGUOUS] += 1
    return _report_contiguous(out, q3, kc3, vc3, kn3, vn3, lengths, n_valid,
                              ksc2, vsc2, ksn2, vsn2)


def _report_contiguous(out, q3, kc3, *operands):
    """Report the call to the op counters (the whole cache read once)."""
    if not costs.counting():
        return out
    BH, C, D = q3.shape
    return costs.report_call(CONTIGUOUS, out, (q3, kc3) + operands,
                             batch=BH, heads=1, q_tokens=C,
                             kv_tokens=kc3.shape[1] + C, d_qk=D,
                             d_v=operands[0].shape[-1])

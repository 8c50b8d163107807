"""Operands for holding the attention kernels against their plain versions
on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).

``paged_case`` builds one paged-attention input: shuffled, fragmented
block tables with sentinel entries, ragged lengths, and pool blocks that
no table references filled with NaN (in value pools and scale pools), so
a kernel that reads an unallocated page shows it in its output.
``contiguous_case`` builds one input over per-slot caches: the slots a
sequence has not written hold a previous occupant's rows, large but
finite (``STALE``, or the largest code with a large scale), since the
reference multiplies their zero weights into them and NaN would poison
it too.
``poison_paged`` and ``poison_contiguous`` write the ``kv_corrupt`` fault's
NaN into pages or rows a sequence reads, and ``rows_rel_err`` holds a
kernel to its plain version's non-finite output rows.
``head_dim_cases`` builds one input of each serving kernel at gemma-7b's
head count (16 query heads, or any other) and a given head dim (112 for
kimi-k2-1t-a32b), over any KV kind;
``mla_cases`` one input of each contiguous kernel at minicpm3-4b's head
dims (``MLA_DIMS``: K rows of 96, V rows of 64); ``windowed_cases`` one
input of each serving kernel at recurrentgemma-2b's local attention (MQA,
10 query heads over 1 KV head of 256, a 2,048-token window, the
contiguous cache a rolling buffer of span 2,048 that wraps).
``flash_case`` builds one full-sequence input (q, k, v of one dtype) for
the training path's flash forward, ``flash_edge_cases`` the edges of
its kernel's layout, and ``flash_cross_cases`` its non-causal Sq != Sk
shapes of an encoder-decoder's cross-attention. ``one_pass_case`` builds
an input of the cross-attention decode (``core.attention.decode_one_pass``,
plain PyTorch on every device), to hold its card result against the
CPU's.
``expmul_case`` builds one input of the standalone ExpMul operator, with
the contract's edge values, and ``same_bits`` compares two of its
results as raw bits.
``dyadic=True`` draws q in multiples of 2^-3 with |q| <= 2, values in
multiples of 2^-3, integer codes (|c| <= 15 for fp8, exact in e4m3) and
power-of-two scales: with a power-of-two softmax scale every score is
then exact in any summation order, so no ExpMul L_hat can flip between
two implementations.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.decode.ops import (
    decode_attention,
    fused_paged_decode_attention,
    quant_decode_attention,
    quant_fused_paged_decode_attention,
)
from repro_torch.kernels.expmul.expmul import expmul_fwd, expmul_fwd_plain
from repro_torch.kernels.expmul.ref import expmul_ref
from repro_torch.kernels.flash.flash import flash_fwd, flash_fwd_plain
from repro_torch.kernels.flash.ops import (
    flash_attention_fwd,
    fused_paged_prefill_attention,
    prefill_attention,
    quant_fused_paged_prefill_attention,
    quant_prefill_attention,
)

KV_KINDS = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
            "fp8": torch.float8_e4m3fn}
STALE = 1e4        # a previous occupant's rows in a contiguous cache
MLA_DIMS = (96, 64)  # minicpm3-4b's expanded K and V widths
# x: past the clip, -inf, 0 and -0 (L_hat 22, 22, 0, 0)
EXPMUL_X_EDGES = (-1e6, -float("inf"), 0.0, -0.0)
# v: +-0; float32 and bfloat16 denormals; the smallest normals; finite
# values near the top of the exponent range
EXPMUL_V_EDGES = (0.0, -0.0, 1e-40, -1e-45, 2.0 ** -130, -(2.0 ** -133),
                  2.0 ** -126, -(2.0 ** -126), 1.5 * 2.0 ** -126,
                  2.0 ** -125, 2.0 ** 127, -1.5 * 2.0 ** 127, 3.3e38,
                  -3e38)


def _act(rng, shape, dyadic):
    if dyadic:
        return rng.integers(-16, 17, shape).astype(np.float32) / 8.0
    return rng.standard_normal(shape).astype(np.float32)


def _kv_operand(rng, shape, kv, dyadic, device):
    """(values or codes, float32 scale rows or None) on ``device``."""
    if kv in ("int8", "fp8"):
        # fp8 codes: integers up to 15 are exact in e4m3
        hi = 15 if kv == "fp8" else 127
        codes = torch.from_numpy(
            rng.integers(-hi, hi + 1, shape).astype(np.float32))
        scale = (2.0 ** rng.integers(-7, -3, shape[:-1]) if dyadic else
                 rng.uniform(0.004, 0.03, shape[:-1])).astype(np.float32)
        return (codes.to(KV_KINDS[kv]).to(device),
                torch.from_numpy(scale).to(device))
    vals = torch.from_numpy(_act(rng, shape, dyadic)).to(KV_KINDS[kv])
    return vals.to(device), None


def paged_case(rng, *, B, H, Hkv, D, page_size, max_blocks, lengths,
               n_valid=None, chunk=0, kv="int8", q_dtype=torch.float32,
               dyadic=True, window=None, Dv=None, device="cuda"):
    """Decode operands (``chunk == 0``) or prefill operands (``n_valid``
    valid tokens of a ``chunk``-token chunk after ``lengths`` resident); K
    rows D wide, V rows ``Dv`` (default D)."""
    ps = page_size
    Dv = D if Dv is None else Dv
    n_valid = [0] * B if n_valid is None else list(n_valid)
    need = [-(-(n + m) // ps) for n, m in zip(lengths, n_valid)]
    nblk = sum(need) + 3                  # spare blocks stay unreferenced
    perm = list(rng.permutation(nblk))
    bt = np.full((B, max_blocks), nblk, np.int32)
    for b, n in enumerate(need):
        for i in range(n):
            bt[b, i] = perm.pop()
    unused = np.array(perm, np.int64)
    quant = kv in ("int8", "fp8")

    def kv_operand(shape, rows_axis_blocks):
        vals, scale = _kv_operand(rng, shape, kv, dyadic, "cpu")
        if rows_axis_blocks:    # NaN in the blocks no table references
            if quant:
                scale.view(nblk, ps, Hkv)[unused] = float("nan")
            else:
                vals.view(nblk, ps, Hkv, shape[-1])[unused] = float("nan")
        return vals.to(device), None if scale is None else scale.to(device)

    k, ks = kv_operand((nblk * ps, Hkv, D), True)
    v, vs = kv_operand((nblk * ps, Hkv, Dv), True)
    case = dict(k_pool=k, v_pool=v, ks_pool=ks, vs_pool=vs,
                block_tables=torch.from_numpy(bt).to(device),
                lengths=torch.tensor(lengths, dtype=torch.int32,
                                     device=device),
                page_size=ps, window=window, quant=quant)
    if chunk:
        case["q"] = torch.from_numpy(_act(rng, (B, H, chunk, D), dyadic)).to(
            q_dtype).to(device)
        case["kn"], case["ksn"] = kv_operand((B, Hkv, chunk, D), False)
        case["vn"], case["vsn"] = kv_operand((B, Hkv, chunk, Dv), False)
        case["n_valid"] = torch.tensor(n_valid, dtype=torch.int32,
                                       device=device)
    else:
        case["q"] = torch.from_numpy(_act(rng, (B, H, D), dyadic)).to(
            q_dtype).to(device)
    return case


def sentinel_within(case, row, page):
    """Put the sentinel (the pool's block count) at entry ``page`` of
    ``row``'s block table, inside its length: both versions clamp it to the
    last pool block, which then takes the replaced block's rows, so the
    row attends to the same keys as before (a row that holds that last
    block attends to the new rows)."""
    bt, ps = case["block_tables"], case["page_size"]
    nblk = case["k_pool"].shape[0] // ps
    blk = int(bt[row, page])
    for name in ("k_pool", "v_pool", "ks_pool", "vs_pool"):
        if case[name] is not None:
            pool = case[name].view((nblk, ps) + tuple(case[name].shape[1:]))
            pool[nblk - 1] = pool[blk].clone()
    bt[row, page] = nblk


def run_decode(case, variant, plain=False):
    kw = dict(page_size=case["page_size"], window=case["window"],
              variant=variant, plain=plain)
    if case["quant"]:
        return quant_fused_paged_decode_attention(
            case["q"], case["k_pool"], case["v_pool"], case["ks_pool"],
            case["vs_pool"], case["block_tables"], case["lengths"], **kw)
    return fused_paged_decode_attention(
        case["q"], case["k_pool"], case["v_pool"], case["block_tables"],
        case["lengths"], **kw)


def run_prefill(case, variant, plain=False):
    kw = dict(page_size=case["page_size"], window=case["window"],
              variant=variant, plain=plain)
    if case["quant"]:
        return quant_fused_paged_prefill_attention(
            case["q"], case["kn"], case["vn"], case["ksn"], case["vsn"],
            case["k_pool"], case["v_pool"], case["ks_pool"], case["vs_pool"],
            case["block_tables"], case["lengths"], case["n_valid"], **kw)
    return fused_paged_prefill_attention(
        case["q"], case["kn"], case["vn"], case["k_pool"], case["v_pool"],
        case["block_tables"], case["lengths"], case["n_valid"], **kw)


def contiguous_case(rng, *, B, H, Hkv, D, S, lengths, n_valid=None, chunk=0,
                    kv="int8", q_dtype=torch.float32, dyadic=True,
                    window=None, rolling=False, Dv=None, device="cuda"):
    """Decode operands (``chunk == 0``; ``lengths <= S`` count the tokens
    to attend) or prefill operands (``n_valid`` valid tokens of a
    ``chunk``-token chunk after ``lengths`` resident; ``rolling`` reads the
    cache as a rolling buffer of span S) over per-slot caches, K
    (B, Hkv, S, D) and V (B, Hkv, S, Dv) (``Dv`` default D), whose slots
    at or past ``min(length, S)`` are stale."""
    quant = kv in ("int8", "fp8")
    Dv = D if Dv is None else Dv
    k, ks = _kv_operand(rng, (B, Hkv, S, D), kv, dyadic, "cpu")
    v, vs = _kv_operand(rng, (B, Hkv, S, Dv), kv, dyadic, "cpu")
    for b, n in enumerate(lengths):
        n = min(int(n), S)
        for codes, scale in ((k, ks), (v, vs)):
            sign = torch.where(torch.arange(codes.shape[-1]) % 2 == 1, 1.0,
                               -1.0)
            if quant:
                big = 127.0 if kv == "int8" else 448.0
                codes[b, :, n:] = (big * sign).to(codes.dtype)
                scale[b, :, n:] = 64.0
            else:
                codes[b, :, n:] = (STALE * sign).to(codes.dtype)
    case = dict(k=k.to(device), v=v.to(device),
                ks=None if ks is None else ks.to(device),
                vs=None if vs is None else vs.to(device),
                lengths=torch.tensor(lengths, dtype=torch.int32,
                                     device=device),
                window=window, rolling=rolling, quant=quant)
    if chunk:
        case["q"] = torch.from_numpy(_act(rng, (B, H, chunk, D), dyadic)).to(
            q_dtype).to(device)
        case["kn"], case["ksn"] = _kv_operand(rng, (B, Hkv, chunk, D), kv,
                                              dyadic, device)
        case["vn"], case["vsn"] = _kv_operand(rng, (B, Hkv, chunk, Dv), kv,
                                              dyadic, device)
        case["n_valid"] = torch.tensor(n_valid, dtype=torch.int32,
                                       device=device)
    else:
        case["q"] = torch.from_numpy(_act(rng, (B, H, D), dyadic)).to(
            q_dtype).to(device)
    return case


def run_contiguous_decode(case, variant, plain=False):
    kw = dict(variant=variant, plain=plain)
    if case["quant"]:
        return quant_decode_attention(case["q"], case["k"], case["v"],
                                      case["ks"], case["vs"],
                                      case["lengths"], **kw)
    return decode_attention(case["q"], case["k"], case["v"], case["lengths"],
                            **kw)


def run_contiguous_prefill(case, variant, plain=False):
    kw = dict(variant=variant, window=case["window"],
              rolling=case["rolling"], plain=plain)
    if case["quant"]:
        return quant_prefill_attention(
            case["q"], case["k"], case["v"], case["ks"], case["vs"],
            case["kn"], case["vn"], case["ksn"], case["vsn"],
            case["lengths"], case["n_valid"], **kw)
    return prefill_attention(case["q"], case["k"], case["v"], case["kn"],
                             case["vn"], case["lengths"], case["n_valid"],
                             **kw)


def flash_case(rng, *, B, H, Hkv, Sq, Sk, D, dtype=torch.float32,
               dyadic=True, causal=True, window=None, block_k=128,
               kv_len=None, device="cuda"):
    """Full-sequence operands: q (B, H, Sq, D), k and v (B, Hkv, Sk, D) in
    ``dtype``, with the mask and the KV tile width to run them at. With
    ``kv_len`` (Sk then a multiple of ``block_k``) the keys at or past it
    are large finite stale rows (``STALE``), and ``run_flash`` hands the
    folded operands to the forward at that ``kv_len``, as the reference's
    padded call does: a kernel that weighs such a row shows it."""
    def draw(shape):
        return torch.from_numpy(_act(rng, shape, dyadic))
    q, k, v = draw((B, H, Sq, D)), draw((B, Hkv, Sk, D)), draw((B, Hkv, Sk, D))
    if kv_len is not None:
        sign = torch.where(torch.arange(D) % 2 == 1, 1.0, -1.0)
        k[:, :, kv_len:] = STALE * sign
        v[:, :, kv_len:] = STALE * sign
    return dict(q=q.to(dtype).to(device), k=k.to(dtype).to(device),
                v=v.to(dtype).to(device), causal=causal, window=window,
                block_k=block_k, kv_len=kv_len)


def flash_edge_cases(rng, *, S, D, group, dtype, dyadic, device="cuda"):
    """The flash kernel's layout edges at Sq = S (2 sequences, 2 KV heads
    of ``group`` query heads each): causal over 128-wide tiles; causal with
    a 40-token window over 64-wide tiles (its lower edge inside a 64-row
    sub-tile; whole tiles skipped at S = 1000); non-causal over one more
    64-wide tile of keys than S needs, kv_len = S; causal over those keys
    at kv_len = S - S // 3. Returns [(label, case)]."""
    padded = S + -S % 64 + 64
    cases = []
    for label, kw in (
            ("causal bk=128", dict(causal=True, block_k=128, Sk=S)),
            ("causal window=40 bk=64", dict(causal=True, window=40,
                                            block_k=64, Sk=S)),
            (f"cross kv_len={S} of {padded} bk=64",
             dict(causal=False, block_k=64, Sk=padded, kv_len=S)),
            (f"causal kv_len={S - S // 3} of {padded} bk=64",
             dict(causal=True, block_k=64, Sk=padded, kv_len=S - S // 3))):
        cases.append((label, flash_case(rng, B=2, H=2 * group, Hkv=2, Sq=S,
                                        D=D, dtype=dtype, dyadic=dyadic,
                                        device=device, **kw)))
    return cases


# cross-attention query lengths (under, at one past and past the flash
# kernel's 32-row query block) and encoder lengths (under one tile, and
# two 512-wide tiles of seamless-m4t-medium's 1,024 frames)
CROSS_SQ, CROSS_SK = (1, 7, 33), (16, 1024)


def flash_cross_cases(rng, *, D, group, dtype, dyadic, device="cuda"):
    """Non-causal flash at Sq != Sk, over the tiles cross-attention's
    ``attention`` call walks (``min(512, Sk)`` wide): every Sq of
    ``CROSS_SQ`` against every Sk of ``CROSS_SK``, 2 sequences, 2 KV heads
    of ``group`` query heads each. Returns [(label, case)]."""
    return [(f"Sq {sq} Sk {sk}",
             flash_case(rng, B=2, H=2 * group, Hkv=2, Sq=sq, Sk=sk, D=D,
                        dtype=dtype, dyadic=dyadic, causal=False,
                        block_k=min(512, sk), device=device))
            for sq in CROSS_SQ for sk in CROSS_SK]


def one_pass_case(rng, *, B=8, H=16, Hkv=16, S=1024, D=64,
                  dtype=torch.bfloat16):
    """CPU operands of ``decode_one_pass`` at seamless-m4t-medium's cross
    K/V (16 / 16 heads of 64, 1,024 frames), dyadic (exact scores), with
    lengths 0, 1, S and ragged ones between: q (B, H, D), k and v
    (B, Hkv, S, D) in ``dtype``, lengths (B,) int32."""
    lengths = np.concatenate([[0, 1, S], rng.integers(2, S, B - 3)])
    return dict(q=torch.from_numpy(_act(rng, (B, H, D), True)).to(dtype),
                k=torch.from_numpy(_act(rng, (B, Hkv, S, D), True)).to(dtype),
                v=torch.from_numpy(_act(rng, (B, Hkv, S, D), True)).to(dtype),
                lengths=torch.from_numpy(lengths.astype(np.int32)))


def run_flash(case, variant, plain=False):
    if case.get("kv_len") is None:
        return flash_attention_fwd(case["q"], case["k"], case["v"],
                                   causal=case["causal"],
                                   window=case["window"], variant=variant,
                                   block_k=case["block_k"], plain=plain)
    q, k, v = case["q"], case["k"], case["v"]
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    fn = flash_fwd_plain if plain else flash_fwd
    out = fn(q.reshape(B * H, Sq, D), k.reshape(B * Hkv, Sk, D),
             v.reshape(B * Hkv, Sk, D), causal=case["causal"],
             scale=1.0 / math.sqrt(D), window=case["window"], variant=variant,
             block_k=case["block_k"], num_q_heads=H, num_kv_heads=Hkv,
             kv_len=case["kv_len"])
    return out.reshape(B, H, Sq, D)


def kernel_tol(variant, out_dtype) -> float:
    """The limit of ``rel_err`` between a kernel and its plain version.
    Both walk the same tiles in the same order, so in float32 they agree
    to ~2e-7 for the exact variant (``expf`` against ``torch.exp``) and
    bit for bit under ExpMul (measured on the card): 1e-5. A bfloat16
    output of the exact variant may also round one step apart, at most
    one bf16 ulp, 2^-7 of the output's magnitude."""
    if out_dtype == torch.bfloat16 and variant == "exact":
        return 2.0 ** -7
    return 1e-5


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref| (both finite), in float64."""
    got = got.to(torch.float64)
    ref = ref.to(torch.float64)
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        return float("inf")
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def rows_rel_err(got, ref) -> float:
    """``rel_err`` over the output rows (vectors along the last axis) that
    hold only finite values; inf when the two differ in which rows hold a
    non-finite value. A poisoned KV page must leave the kernel's non-finite
    rows exactly the plain version's, and its finite rows within
    ``kernel_tol``."""
    bad = ~torch.isfinite(ref).all(-1)
    if not torch.equal(~torch.isfinite(got).all(-1), bad):
        return float("inf")
    if bool(bad.all()):
        return 0.0
    return rel_err(got[~bad], ref[~bad])


def _poison(t, index, code):
    """NaN into ``t[index]``, or ``code`` where ``t`` holds integer codes."""
    if t is not None:
        t[index] = code if not t.is_floating_point() else float("nan")


def poison_paged(case, row, page, *, tail=False):
    """Poison page ``page`` of ``row``'s block table, a page the row reads,
    as ``models.api.poison_paged_block`` does: NaN values, or int8 codes of
    -128 with NaN scale rows. With ``tail`` only the page's rows at or past
    the row's length (a recycled page that was never scrubbed)."""
    ps = case["page_size"]
    blk = int(case["block_tables"][row, page])
    lo = int(case["lengths"][row]) - page * ps if tail else 0
    rows = slice(blk * ps + max(lo, 0), (blk + 1) * ps)
    for name in ("k_pool", "v_pool", "ks_pool", "vs_pool"):
        _poison(case[name], rows, -128)


def poison_contiguous(case, row, lo, hi):
    """Poison the cache rows [lo, hi) of sequence ``row`` (every KV head),
    as ``poison_paged`` does a page."""
    for name in ("k", "v", "ks", "vs"):
        if case[name] is not None:
            _poison(case[name], (row, slice(None), slice(lo, hi)), -128)


def head_dim_cases(rng, D, *, kv, q_dtype=torch.float32, group=1, H=16,
                   dyadic=False, device="cuda"):
    """One input of each serving kernel at ``H`` query heads (``H`` /
    ``group`` KV heads; gemma-7b's 16 by default) of head dim ``D``
    (gemma's 256, or 32 in its smoke config; arctic-480b's 128;
    kimi-k2-1t-a32b's 112), over KV
    kind ``kv`` (``KV_KINDS``): 4 sequences whose lengths
    cross the decode's 256-wide tiles and the contiguous prefill's 512-wide
    ones (300, 0, 600, 17 resident for decode; 530, 0, 17, 600 before a
    70-token chunk of which 70, 0, 33 and 0 tokens are valid), pages of 16,
    640 contiguous slots. Returns [(kernel, run, case, idle rows, label)]:
    row 1 attends to nothing."""
    kw = dict(B=4, H=H, Hkv=H // group, D=D, kv=kv, q_dtype=q_dtype,
              dyadic=dyadic, device=device)
    dec, pf, nv, C, S = [300, 0, 600, 17], [530, 0, 17, 600], [70, 0, 33, 0], \
        70, 640
    mb = -(-(max(pf) + C) // 16) + 1
    label = f"D={D} group={group} {kv} {'dyadic' if dyadic else 'random'}"
    return [
        ("paged_decode", run_decode,
         paged_case(rng, page_size=16, max_blocks=mb, lengths=dec, **kw),
         [1], label),
        ("paged_prefill", run_prefill,
         paged_case(rng, page_size=16, max_blocks=mb, lengths=pf,
                    n_valid=nv, chunk=C, **kw), [1], label),
        ("decode", run_contiguous_decode,
         contiguous_case(rng, S=S, lengths=dec, **kw), [1], label),
        ("prefill", run_contiguous_prefill,
         contiguous_case(rng, S=S, lengths=pf, n_valid=nv, chunk=C, **kw),
         [1], label),
    ]


def mla_cases(rng, *, kv, q_dtype=torch.float32, dyadic=False, S=640,
              device="cuda"):
    """One input of each contiguous kernel at MLA's head dims
    (``MLA_DIMS``), 4 / 4 heads (MLA's group of 1), over float KV kind
    ``kv``: 4 sequences over ``S`` slots holding 300, 0, S and 1 tokens
    for decode (a length crossing the 256-wide tiles, none, the whole
    cache, one), and 530, 0, S and 1 before a 70-token chunk of which 70,
    0, 33 and 70 tokens are valid (a partial chunk); every slot past a
    length stale. Returns [(kernel, run, case, idle rows, label)]: row 1
    attends to nothing."""
    D, Dv = MLA_DIMS
    kw = dict(B=4, H=4, Hkv=4, D=D, Dv=Dv, S=S, kv=kv, q_dtype=q_dtype,
              dyadic=dyadic, device=device)
    label = f"D={D} Dv={Dv} {kv} {'dyadic' if dyadic else 'random'}"
    return [
        ("decode", run_contiguous_decode,
         contiguous_case(rng, lengths=[300, 0, S, 1], **kw), [1], label),
        ("prefill", run_contiguous_prefill,
         contiguous_case(rng, lengths=[530, 0, S, 1], n_valid=[70, 0, 33, 70],
                         chunk=70, **kw), [1], label),
    ]


def windowed_cases(rng, *, kv, q_dtype=torch.float32, H=10, Hkv=1, D=256,
                   window=2048, chunk=256, dyadic=False, device="cuda"):
    """One input of each serving kernel at recurrentgemma-2b's local
    attention: ``H`` / ``Hkv`` heads of ``D``, a ``window``-token window,
    over KV kind ``kv``. Six sequences: histories of 1,024, 2,048, 2,049
    (the window's floor at 1, inside the first page and tile), 3,584 and
    3,000 (the floor at 952 for decode, inside a page of 16 and a 256-wide
    tile; whole pages below it skipped), and an idle row. Prefill: a
    ``chunk``-token chunk of which 256 (all), 200, 1, 256, 77 and 0 tokens
    are valid, after those histories, paged and on a rolling buffer of
    span ``window`` (every history past it wrapped). Contiguous decode
    attends to ``min(length + 1, span)`` slots of the rolling buffer:
    1,024, 2,048 (a wrapped buffer, every slot), 2,047, 1 and 1,537.
    Returns [(kernel, run, case, idle rows, label)]: row 5 attends to
    nothing."""
    hist = [1024, 2048, 2049, 3584, 3000, 0]
    nv = [chunk, 200, 1, chunk, 77, 0]
    kw = dict(B=len(hist), H=H, Hkv=Hkv, D=D, kv=kv, q_dtype=q_dtype,
              dyadic=dyadic, window=window, device=device)
    label = (f"D={D} group={H // Hkv} window={window} {kv} "
             f"{'dyadic' if dyadic else 'random'}")
    mb = -(-(max(hist) + chunk) // 16) + 1
    return [
        ("paged_decode", run_decode,
         paged_case(rng, page_size=16, max_blocks=mb, lengths=hist, **kw),
         [5], label),
        ("paged_prefill", run_prefill,
         paged_case(rng, page_size=16, max_blocks=mb, lengths=hist,
                    n_valid=nv, chunk=chunk, **kw), [5], label),
        ("decode", run_contiguous_decode,
         contiguous_case(rng, S=window, lengths=[1024, window, window - 1, 1,
                                                 1537, 0], **kw),
         [5], label),
        ("prefill", run_contiguous_prefill,
         contiguous_case(rng, S=window, lengths=hist, n_valid=nv,
                         chunk=chunk, rolling=True, **kw), [5], label),
    ]


POISON_SPOTS = ("first", "middle", "last", "tail")
SERVING_KERNELS = ("paged_decode", "paged_prefill", "decode", "prefill")


def poisoned_case(rng, kernel, spot, *, kv="int8", length=1000, chunk=100,
                  D=64, H=14, Hkv=2, page_size=16, Dv=None, device="cuda"):
    """One input of a serving ``kernel`` (``SERVING_KERNELS``) with a fault
    in what sequence 0 (``length`` tokens; 37 and a third row beside it)
    reads: its first, a middle or its last page (contiguous: 16 rows
    there, the last 5 rows below the length), or ``"tail"``, its rows past
    the length (paged: in its last page; contiguous: to the end of the
    cache, ``length * 3 // 2`` slots). ``Dv`` (contiguous kernels only)
    sets the V rows' width. Returns (case, run)."""
    ps = page_size
    kw = dict(B=3, H=H, Hkv=Hkv, D=D, kv=kv, device="cpu")
    lengths = [length, 37, length // 2 + 5]
    if kernel.startswith("paged_"):
        max_blocks = -(-(length + chunk) // ps) + 1
        if kernel == "paged_decode":
            case, run = paged_case(rng, page_size=ps, max_blocks=max_blocks,
                                   lengths=lengths, **kw), run_decode
        else:
            lengths[1] = 0
            case, run = paged_case(
                rng, page_size=ps, max_blocks=max_blocks, lengths=lengths,
                n_valid=[chunk, chunk // 2, 15], chunk=chunk,
                **kw), run_prefill
        last = (length - 1) // ps
        poison_paged(case, 0, {"first": 0, "middle": last // 2, "last": last,
                               "tail": last}[spot], tail=spot == "tail")
    else:
        S = length * 3 // 2
        kw["Dv"] = Dv
        if kernel == "decode":
            case, run = contiguous_case(rng, S=S, lengths=lengths,
                                        **kw), run_contiguous_decode
        else:
            lengths[1] = 0
            case, run = contiguous_case(
                rng, S=S, lengths=lengths, n_valid=[chunk, chunk // 2, 15],
                chunk=chunk, **kw), run_contiguous_prefill
        lo, hi = {"first": (0, 16), "middle": (length // 2, length // 2 + 16),
                  "last": (length - 5, length), "tail": (length, S)}[spot]
        poison_contiguous(case, 0, lo, hi)
    return {k: v.to(device) if torch.is_tensor(v) else v
            for k, v in case.items()}, run


PAGED_KERNELS = ("paged_decode", "paged_prefill")
# The serving kernels' contract past the widths they are built for, as
# their Pallas kernels take it: (D, Dv, KV kinds, GQA group, page sizes,
# kernels). Head dim 80 (phi-2) over every KV dtype; DeepSeek-style MLA
# widths (192, 128) and a narrow pair (48, 32) over codes; groups past a
# block's 32 rows (MQA's) and past what shared memory allows at 256; pages
# of 64 to 256 tokens (256 over int8 and 64-200 over float32 rows at 256 are
# wider than a decode rank stages at once); pages that the staging rows do
# not divide: 48 (two pages of a rank's 128 int8 rows, one of the prefill's
# 64-row sub-tiles) and 200 over float32 at 256 (seven pieces of a rank's 32
# rows and four sub-tiles, the last of each partial); rows of 40 bytes
# (D 20 in bfloat16, D 40 in int8) off a 16-byte boundary.
CONTRACT_SHAPES = (
    (80, 80, ("f32", "bf16", "int8", "fp8"), 2, (16,), SERVING_KERNELS),
    (192, 128, ("int8", "fp8"), 2, (16,), SERVING_KERNELS),
    (48, 32, ("int8", "fp8"), 2, (16,), SERVING_KERNELS),
    (64, 64, ("int8",), 40, (16,), SERVING_KERNELS),
    (256, 256, ("f32",), 20, (16,), SERVING_KERNELS),
    (64, 64, ("int8",), 2, (64, 128, 256, 48), PAGED_KERNELS),
    (256, 256, ("f32",), 2, (64, 128, 200), PAGED_KERNELS),
    (20, 20, ("bf16",), 2, (16,), SERVING_KERNELS),
    (40, 40, ("int8",), 2, (16,), SERVING_KERNELS),
)
# flash's (Dv == D): head dims off its built widths, a row off 16 bytes
CONTRACT_FLASH_DIMS = (80, 20)


def contract_case(rng, kernel, *, D, Dv=None, kv, group=2, Hkv=2,
                  page_size=16, q_dtype=torch.bfloat16, dyadic=False,
                  device="cuda"):
    """One input of a serving ``kernel`` at head dims (D, Dv), GQA
    ``group`` over ``Hkv`` KV heads and pages of ``page_size``: 4
    sequences, decode lengths 300, 0, 77 and 17 (two 256-wide tiles), or
    130, 0, 17 and 64 resident before a 40-token chunk of which 40, 0, 33
    and 0 are valid. Returns (run, case, idle rows): row 1 attends to
    nothing."""
    kw = dict(B=4, H=group * Hkv, Hkv=Hkv, D=D, Dv=Dv, kv=kv,
              q_dtype=q_dtype, dyadic=dyadic, device=device)
    dec, pf, nv, C = [300, 0, 77, 17], [130, 0, 17, 64], [40, 0, 33, 0], 40
    if kernel == "paged_decode":
        mb = -(-max(dec) // page_size) + 1
        return run_decode, paged_case(rng, page_size=page_size,
                                      max_blocks=mb, lengths=dec, **kw), [1]
    if kernel == "paged_prefill":
        mb = -(-(max(pf) + C) // page_size) + 1
        return run_prefill, paged_case(
            rng, page_size=page_size, max_blocks=mb, lengths=pf, n_valid=nv,
            chunk=C, **kw), [1]
    if kernel == "decode":
        return run_contiguous_decode, contiguous_case(
            rng, S=320, lengths=dec, **kw), [1]
    return run_contiguous_prefill, contiguous_case(
        rng, S=192, lengths=pf, n_valid=nv, chunk=C, **kw), [1]


def expmul_case(rng, rows, d, dtype=torch.float32, device="cuda"):
    """ExpMul operands inside the contract (finite inputs): x (rows,)
    float32 from [-20, 0] (the clip zone included) with ``EXPMUL_X_EDGES``
    in its first rows; v (rows, d) in ``dtype`` of N(0, 10^2) with
    ``EXPMUL_V_EDGES`` in its first elements and at ~5% of the others."""
    x = -rng.uniform(0.0, 20.0, rows).astype(np.float32)
    n = min(rows, len(EXPMUL_X_EDGES))
    x[:n] = EXPMUL_X_EDGES[:n]
    v = (rng.standard_normal(rows * d) * 10.0).astype(np.float32)
    edges = np.array(EXPMUL_V_EDGES, np.float32)
    pick = rng.random(v.size) < 0.05
    v[pick] = rng.choice(edges, int(pick.sum()))
    n = min(v.size, edges.size)
    v[:n] = edges[:n]
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(v.reshape(rows, d)).to(dtype).to(device))


def same_bits(a, b) -> bool:
    """Whether two float32 or bfloat16 tensors are equal bit for bit."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    w = torch.int32 if a.dtype == torch.float32 else torch.int16
    return bool(torch.equal(a.contiguous().view(w), b.contiguous().view(w)))


def run_expmul(x, v):
    """(kernel, plain version, oracle) results of ExpMul on one input."""
    return expmul_fwd(x, v), expmul_fwd_plain(x, v), expmul_ref(x[:, None], v)

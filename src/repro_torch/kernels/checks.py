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
``flash_case`` builds one full-sequence input (q, k, v of one dtype) for
the training path's flash forward, and ``flash_edge_cases`` the edges of
its kernel's layout.
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
               dyadic=True, window=None, device="cuda"):
    """Decode operands (``chunk == 0``) or prefill operands (``n_valid``
    valid tokens of a ``chunk``-token chunk after ``lengths`` resident)."""
    ps = page_size
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
                vals.view(nblk, ps, Hkv, D)[unused] = float("nan")
        return vals.to(device), None if scale is None else scale.to(device)

    pool = (nblk * ps, Hkv, D)
    k, ks = kv_operand(pool, True)
    v, vs = kv_operand(pool, True)
    case = dict(k_pool=k, v_pool=v, ks_pool=ks, vs_pool=vs,
                block_tables=torch.from_numpy(bt).to(device),
                lengths=torch.tensor(lengths, dtype=torch.int32,
                                     device=device),
                page_size=ps, window=window, quant=quant)
    if chunk:
        case["q"] = torch.from_numpy(_act(rng, (B, H, chunk, D), dyadic)).to(
            q_dtype).to(device)
        case["kn"], case["ksn"] = kv_operand((B, Hkv, chunk, D), False)
        case["vn"], case["vsn"] = kv_operand((B, Hkv, chunk, D), False)
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
                    window=None, rolling=False, device="cuda"):
    """Decode operands (``chunk == 0``; ``lengths <= S`` count the tokens
    to attend) or prefill operands (``n_valid`` valid tokens of a
    ``chunk``-token chunk after ``lengths`` resident; ``rolling`` reads the
    cache as a rolling buffer of span S) over per-slot (B, Hkv, S, D)
    caches whose slots at or past ``min(length, S)`` are stale."""
    quant = kv in ("int8", "fp8")
    k, ks = _kv_operand(rng, (B, Hkv, S, D), kv, dyadic, "cpu")
    v, vs = _kv_operand(rng, (B, Hkv, S, D), kv, dyadic, "cpu")
    sign = torch.where(torch.arange(D) % 2 == 1, 1.0, -1.0)
    for b, n in enumerate(lengths):
        n = min(int(n), S)
        for codes, scale in ((k, ks), (v, vs)):
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
        case["vn"], case["vsn"] = _kv_operand(rng, (B, Hkv, chunk, D), kv,
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

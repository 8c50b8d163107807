"""Operands for holding the paged kernels against their plain versions on
the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).

``paged_case`` builds one paged-attention input: shuffled, fragmented
block tables with sentinel entries, ragged lengths, and pool blocks that
no table references filled with NaN (in value pools and scale pools), so
a kernel that reads an unallocated page shows it in its output.
``dyadic=True`` draws q in multiples of 2^-3 with |q| <= 2, values in
multiples of 2^-3, integer codes (|c| <= 15 for fp8, exact in e4m3) and
power-of-two scales: with a power-of-two softmax scale every score is
then exact in any summation order, so no ExpMul L_hat can flip between
two implementations.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.decode.ops import (
    fused_paged_decode_attention,
    quant_fused_paged_decode_attention,
)
from repro_torch.kernels.flash.ops import (
    fused_paged_prefill_attention,
    quant_fused_paged_prefill_attention,
)

KV_KINDS = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
            "fp8": torch.float8_e4m3fn}


def _act(rng, shape, dyadic):
    if dyadic:
        return rng.integers(-16, 17, shape).astype(np.float32) / 8.0
    return rng.standard_normal(shape).astype(np.float32)


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
    dt = KV_KINDS[kv]

    def kv_operand(shape, rows_axis_blocks):
        if quant:
            # fp8 codes: integers up to 15 are exact in e4m3
            hi = 15 if kv == "fp8" else 127
            codes = rng.integers(-hi, hi + 1, shape).astype(np.float32)
            scale = (2.0 ** rng.integers(-7, -3, shape[:-1]) if dyadic else
                     rng.uniform(0.004, 0.03, shape[:-1])).astype(np.float32)
            c = torch.from_numpy(codes)
            c = c.to(dt) if kv == "fp8" else c.to(torch.int8)
            s = torch.from_numpy(scale)
            if rows_axis_blocks:
                s.view(nblk, ps, Hkv)[unused] = float("nan")
            return c.to(device), s.to(device)
        vals = torch.from_numpy(_act(rng, shape, dyadic)).to(dt)
        if rows_axis_blocks:
            vals.view(nblk, ps, Hkv, D)[unused] = float("nan")
        return vals.to(device), None

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

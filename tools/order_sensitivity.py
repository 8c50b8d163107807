#!/usr/bin/env python3
"""How sensitive the contiguous prefill's output is to the summation order
of its two products, on the CPU.

    PYTHONPATH=src python tools/order_sensitivity.py

Runs the plain prefill (``prefill_fwd_plain``) at the serving shapes of
``chip_smoke.py`` phase 5 (8 sequences x 1024 resident int8 tokens, a
256-token chunk, 14 / 2 heads of 64, bf16 q, ExpMul), then again with one
product summed in float64 and rounded once to float32, another summation
order (as a tensor-core product's would be). It prints how many bfloat16
outputs differ and the relative error the kernel checks would see against
their limit of 1e-5 (``kernels/checks.py:kernel_tol``):

* the value product in another order moves outputs by float ulps, and a
  few of them cross a bfloat16 rounding edge;
* the scores in another order leave the ExpMul weights (and so the
  output) unchanged where q and the codes are exact in bf16.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.kernels import checks  # noqa: E402
from repro_torch.kernels.flash import prefill, tile  # noqa: E402


def tile_step(q, k, v, k_scale, v_scale, mask, state, *, scale, variant,
              f64):
    """``tile.online_softmax_tile`` (ExpMul) with the products named in
    ``f64`` ("scores", "values") summed in float64 and rounded once."""
    assert variant == "expmul"
    m_prev, l_prev, acc_prev = state
    if "scores" in f64:
        s = torch.matmul(q.double(), k.double().transpose(-1, -2)).float()
    else:
        s = tile.fma_chain(q, k.transpose(-1, -2))
    s = s * scale
    if k_scale is not None:
        s = s * k_scale[..., None, :]
    s = torch.where(mask, s, torch.full_like(s, tile.MASK_VALUE))
    m_new = torch.maximum(m_prev, torch.amax(s, dim=-1, keepdim=True))
    lr = tile.log2exp_lhat(m_prev - m_new)
    p = torch.where(mask, tile.pow2_neg(tile.log2exp_lhat(s - m_new)),
                    torch.zeros_like(s))
    l_new = tile.apply_pow2_scale(l_prev, lr) + torch.sum(p, dim=-1,
                                                          keepdim=True)
    pv = p if v_scale is None else p * v_scale[..., None, :]
    if "values" in f64:
        dsum = torch.matmul(pv.double(), v.double()).float()
    else:
        dsum = tile.fma_chain(pv, v)
    return m_new, l_new, (tile.apply_pow2_scale(
        acc_prev, lr.expand(acc_prev.shape)) + dsum)


def main() -> int:
    rng = np.random.default_rng(4)
    case = checks.contiguous_case(
        rng, B=8, H=14, Hkv=2, D=64, S=2048, lengths=[1024] * 8,
        n_valid=[256] * 8, chunk=256, kv="int8", q_dtype=torch.bfloat16,
        dyadic=False, device="cpu")
    ref = checks.run_contiguous_prefill(case, "expmul", plain=True)
    step = prefill.online_softmax_tile
    for f64 in ("values", "scores"):
        prefill.online_softmax_tile = (
            lambda *a, f64=f64, **kw: tile_step(*a, f64=(f64,), **kw))
        try:
            got = checks.run_contiguous_prefill(case, "expmul", plain=True)
        finally:
            prefill.online_softmax_tile = step
        n = int((got.float() != ref.float()).sum())
        print(f"{f64} summed in float64: {n} of {ref.numel()} bf16 outputs "
              f"differ; rel err {checks.rel_err(got, ref):.3e} (limit 1e-5)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

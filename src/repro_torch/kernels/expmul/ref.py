"""The "textbook" oracle of the ExpMul operator (paper Alg. 3), the port of
``repro/kernels/expmul/ref.py``: floor division for the arithmetic shifts
and frexp/ldexp for the exponent arithmetic, rather than bit manipulation,
so it cross-checks the kernel (``csrc/expmul.cu``) and the bit path
(``numerics/log2exp.py``) structurally.

Contract: finite inputs; denormal V flushes to zero (matching the hardware,
whose biased-exponent field of a denormal is 0 and always underflows).

``torch.ldexp`` multiplies by ``2.0 ** e``, and ``2.0 ** 128`` overflows
a float32 (frexp gives exponent 128 for |v| >= 2^127), so the ldexp runs
in float64, exponent included; the result, of magnitude at most |v| and
flushed below the smallest normal, is exact in float32.
"""
from __future__ import annotations

import torch

from repro_torch.numerics.log2exp import (
    CLIP_HI,
    CLIP_LO,
    FRAC_BITS,
    FRAC_SCALE,
    ROUND_HALF,
)

_MIN_NORMAL = 2.0 ** -126  # f32 and bf16 share the 8-bit exponent / bias 127


def _lhat_ref(x: torch.Tensor) -> torch.Tensor:
    """L_hat via floor-division arithmetic (== arithmetic shifts)."""
    xc = torch.clamp(x.to(torch.float32), CLIP_LO, CLIP_HI)
    xfix = torch.round(xc * FRAC_SCALE).to(torch.int32)
    acc = (xfix + torch.floor_divide(xfix, 2)
           - torch.floor_divide(xfix, 16))
    return torch.floor_divide(-acc + ROUND_HALF, 1 << FRAC_BITS).to(torch.int32)


def expmul_ref(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Oracle for ExpMul(x, V) = e^x V under the paper's log2 quantization
    (``x`` broadcasts against ``v``)."""
    lhat = _lhat_ref(x)
    vf = v.to(torch.float32)
    mant, expo = torch.frexp(vf)
    # biased f32/bf16 exponent field of a normal v = expo + 126
    new_biased = expo + 126 - lhat
    out = torch.ldexp(mant.to(torch.float64),
                      (expo - lhat).to(torch.float64)).to(torch.float32)
    flush = (new_biased <= 0) | (vf.abs() < _MIN_NORMAL)
    out = torch.where(flush, torch.zeros_like(out), out)
    return out.to(v.dtype)


def expmul_exact_ref(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The unfused baseline the paper compares against: separate exp and
    mul, in float32."""
    return (torch.exp(x.to(torch.float32)) * v.to(torch.float32)).to(v.dtype)

"""Fixed-point Log2Exp quantization and the ExpMul primitive (paper §IV-B),
with the straight-through autograd forms used in training.

The bit-level contract is ``repro/numerics/log2exp.py``; this module
reproduces it bit for bit on PyTorch tensors:

* ``x`` is clipped to [-15, 0] and rounded into 10-fraction-bit fixed point
  with ``torch.round`` (half to even, like ``jnp.round`` and CUDA ``rintf``);
* ``x·log2(e) ≈ x + x>>1 - x>>4`` uses arithmetic shifts on int32;
* ``L_hat = (-acc + 512) >> 10`` (round half up);
* ``apply_pow2_scale`` subtracts ``L_hat`` from the exponent field; a biased
  exponent that reaches <= 0 flushes to +0, so denormals and -0 come out as
  +0 even at ``L_hat = 0``;
* ``pow2_neg`` assembles ``2^-L_hat`` from bits (0.0 when the exponent
  underflows);
* ``qexp_ste`` and ``expmul_ste`` run the quantized forward bit for bit and
  take the gradient of the exact ``e^x`` (``e^x * v``) at the clipped input,
  as ``repro``'s custom VJPs do.

The CUDA kernels carry the same arithmetic in ``csrc/tile.cuh``.
"""
from __future__ import annotations

import torch

FRAC_BITS = 10
FRAC_SCALE = 1 << FRAC_BITS           # 1024
ROUND_HALF = 1 << (FRAC_BITS - 1)     # 512, for round-half-up of -acc
CLIP_LO = -15.0
CLIP_HI = 0.0

# dtype -> (signed bit container of the same width, mantissa bits)
_LAYOUT = {
    torch.float32: (torch.int32, 23),
    torch.bfloat16: (torch.int16, 7),
}
_EXP_MASK = 0xFF


def _layout(dtype):
    if dtype not in _LAYOUT:
        raise ValueError(f"ExpMul supports float32/bfloat16, got {dtype}")
    return _LAYOUT[dtype]


def log2exp_lhat(x: torch.Tensor) -> torch.Tensor:
    """Integer L_hat >= 0 (int32) such that e^x ~= 2^{-L_hat} (x <= 0).
    A NaN x gives 0, as the reference's clip-then-cast does; the NaN is
    replaced before the clamp, so no platform's NaN-to-int cast is met."""
    xf = torch.nan_to_num(x.to(torch.float32), nan=0.0, posinf=float("inf"),
                          neginf=float("-inf"))
    xc = torch.clamp(xf, CLIP_LO, CLIP_HI)
    xfix = torch.round(xc * FRAC_SCALE).to(torch.int32)
    acc = xfix + (xfix >> 1) - (xfix >> 4)   # arithmetic shifts: floor
    return (ROUND_HALF - acc) >> FRAC_BITS


def apply_pow2_scale(v: torch.Tensor, lhat: torch.Tensor) -> torch.Tensor:
    """``v * 2^{-lhat}`` by integer subtraction on the exponent field.

    ``lhat`` is a non-negative int32 tensor broadcastable to ``v``. The
    sign and mantissa fields are untouched; an exponent that reaches <= 0
    flushes the element to +0.
    """
    container, mant_bits = _layout(v.dtype)
    width = 32 if container == torch.int32 else 16
    wide = v.view(container).to(torch.int32)
    if width == 16:
        wide = wide & 0xFFFF                 # the uint16 container of repro
    exp_field = (wide >> mant_bits) & _EXP_MASK
    new_exp = exp_field - lhat
    rest = wide & ~(_EXP_MASK << mant_bits)
    out = rest | (torch.clamp(new_exp, min=0) << mant_bits)
    out = torch.where(new_exp <= 0, torch.zeros_like(out), out)
    if width == 16:
        out = torch.where(out >= 1 << 15, out - (1 << 16), out)
    return out.to(container).view(v.dtype)


def pow2_neg(lhat: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The float ``2^{-lhat}`` assembled from bits (no transcendental)."""
    container, mant_bits = _layout(dtype)
    new_exp = 127 - lhat.to(torch.int32)
    bits = torch.where(new_exp <= 0, torch.zeros_like(new_exp),
                       new_exp << mant_bits)
    return bits.to(container).view(dtype)


def expmul(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """ExpMul(x, V) = e^x * V under log2 quantization (paper Eq. 8-9)."""
    lhat = log2exp_lhat(x)
    return apply_pow2_scale(v, lhat.expand(torch.broadcast_shapes(
        lhat.shape, v.shape)))


class _QExpSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return pow2_neg(log2exp_lhat(x))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        e = torch.exp(torch.clamp(x.to(torch.float32), CLIP_LO, CLIP_HI))
        return (e * g).to(x.dtype)


def qexp_ste(x: torch.Tensor) -> torch.Tensor:
    """Quantized ``e^x`` as the float32 power of two ``2^-L_hat``, with the
    straight-through gradient ``exp(clip(x, -15, 0)) * g``."""
    return _QExpSTE.apply(x)


def _unbroadcast(t: torch.Tensor, shape) -> torch.Tensor:
    """Sum ``t`` over the axes that broadcasting added to ``shape``."""
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        return t
    ndiff = t.dim() - len(shape)
    if ndiff:
        t = torch.sum(t, dim=tuple(range(ndiff)))
    axes = tuple(i for i, (a, b) in enumerate(zip(t.shape, shape))
                 if b == 1 and a != 1)
    if axes:
        t = torch.sum(t, dim=axes, keepdim=True)
    return t.reshape(shape)


class _ExpMulSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, v):
        ctx.save_for_backward(x, v)
        return expmul(x, v)

    @staticmethod
    def backward(ctx, g):
        x, v = ctx.saved_tensors
        e = torch.exp(torch.clamp(x.to(torch.float32), CLIP_LO, CLIP_HI))
        e = e.expand(g.shape)
        gf = g.to(torch.float32)
        dv = _unbroadcast(e * gf, v.shape).to(v.dtype)
        dx = _unbroadcast(e * v.to(torch.float32) * gf, x.shape).to(x.dtype)
        return dx, dv


def expmul_ste(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """ExpMul with a straight-through estimator: the quantized forward of
    ``expmul``, the gradients of the exact ``e^x * v`` (``x`` clipped to
    [-15, 0]), with broadcast axes summed."""
    return _ExpMulSTE.apply(x, v)


def exact_expmul(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The exact ``e^x * v`` the hardware baseline computes (for
    comparison): ``exp`` in float32, cast to ``v``'s dtype, then a
    broadcast multiply."""
    return torch.exp(x.to(torch.float32)).to(v.dtype) * v

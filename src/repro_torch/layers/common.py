"""Shared layer utilities: initializer, RMSNorm, activation."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(shape, dtype, generator, device, scale=None):
    """Truncated-normal (-2, 2 std) fan-in init, as ``repro``'s dense_init:
    fan-in is the product of every axis but the last. A weight of rank 3
    (an expert stack (E, d, f), attention's (d, H, hd)) is drawn and scaled
    one slab of its leading axis at a time, straight into ``dtype``, so
    the float32 temporaries are one slab's, not the whole weight's (an
    arctic-480b expert stack is 17.8 GB in float32)."""
    fan_in = math.prod(shape[:-1]) if len(shape) >= 2 else (shape[0] if shape
                                                            else 1)
    std = scale if scale is not None else 1.0 / math.sqrt(max(1, fan_in))

    def draw(slab_shape):
        w = torch.empty(slab_shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return w.mul_(std)

    if len(shape) != 3:
        return draw(shape).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i].copy_(draw(shape[1:]))
    return out


def rmsnorm_init(dim, dtype, device):
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps=1e-6):
    """RMSNorm with the ``(1 + scale)`` gain of ``repro/layers/common.py``."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].to(torch.float32))).to(x.dtype)


def activation_fn(name: str):
    """The gate's activation of a gated MLP, as ``repro/layers/common.py``
    has it: SiLU, or GELU in its tanh form (``jax.nn.gelu(approximate=True)``)."""
    if name in ("swiglu", "silu"):
        return F.silu
    if name in ("geglu", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")

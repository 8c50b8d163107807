"""Shared layer utilities: initializer, RMSNorm, activation."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(shape, dtype, generator, device, scale=None):
    """Truncated-normal (-2, 2 std) fan-in init, as ``repro``'s dense_init:
    fan-in is the product of every axis but the last."""
    fan_in = math.prod(shape[:-1]) if len(shape) >= 2 else (shape[0] if shape
                                                            else 1)
    std = scale if scale is not None else 1.0 / math.sqrt(max(1, fan_in))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(dtype)


def rmsnorm_init(dim, dtype, device):
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps=1e-6):
    """RMSNorm with the ``(1 + scale)`` gain of ``repro/layers/common.py``."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].to(torch.float32))).to(x.dtype)


def silu(x):
    return F.silu(x)

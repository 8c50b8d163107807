"""Shared layer utilities: initializer, RMSNorm and LayerNorm, activation."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# the float32 elements ``dense_init`` draws at once for a rank-3 weight
# (256 MB)
DRAW_ELEMENTS = 1 << 26


def dense_init(shape, dtype, generator, device, scale=None):
    """Truncated-normal (-2, 2 std) fan-in init, as ``repro``'s dense_init:
    fan-in is the product of every axis but the last. A weight of rank 3
    (an expert stack (E, d, f), attention's (d, H, hd)) is drawn and scaled
    in blocks of slabs of its leading axis, each block at most
    ``DRAW_ELEMENTS`` float32 elements (one slab if a slab is larger),
    straight into ``dtype``, so the float32 temporaries stay bounded (an
    arctic-480b expert stack is 17.8 GB in float32) and a weight of many
    small slabs takes a few draws, not one a slab. On the ``meta`` device
    nothing is drawn: the weight is ``torch.empty`` of its shape and dtype
    (a shape-only model, ``init_model(cfg, device="meta")``), and
    ``generator`` may be None."""
    fan_in = math.prod(shape[:-1]) if len(shape) >= 2 else (shape[0] if shape
                                                            else 1)
    std = scale if scale is not None else 1.0 / math.sqrt(max(1, fan_in))
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)

    def draw(block_shape):
        w = torch.empty(block_shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return w.mul_(std)

    if len(shape) != 3:
        return draw(shape).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    step = max(1, DRAW_ELEMENTS // math.prod(shape[1:]))
    for i in range(0, shape[0], step):
        block = out[i:i + step]
        block.copy_(draw(block.shape))
    return out


def rmsnorm_init(dim, dtype, device):
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps=1e-6):
    """RMSNorm with the ``(1 + scale)`` gain of ``repro/layers/common.py``."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].to(torch.float32))).to(x.dtype)


def layernorm_init(dim, dtype, device):
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x, eps=1e-6):
    """LayerNorm with ``repro``'s ``(1 + scale)`` gain and a bias, over a
    float32 body."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].to(torch.float32))
            + params["bias"].to(torch.float32)).to(x.dtype)


def make_norm(kind: str):
    """(init, apply) of ``cfg.norm``: "rmsnorm" or "layernorm"."""
    if kind == "rmsnorm":
        return rmsnorm_init, rmsnorm
    if kind == "layernorm":
        return layernorm_init, layernorm
    raise ValueError(f"unknown norm {kind!r}")


def activation_fn(name: str):
    """The activation of an MLP, as ``repro/layers/common.py`` has it:
    SiLU, or GELU in its tanh form (``jax.nn.gelu(approximate=True)``),
    gated (``swiglu``, ``geglu``) or not (``gelu``)."""
    if name in ("swiglu", "silu"):
        return F.silu
    if name in ("geglu", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")

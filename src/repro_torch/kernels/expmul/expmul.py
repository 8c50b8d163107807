"""The standalone ExpMul operator, ``out[r, c] = e^{x[r]} * v[r, c]`` for
x <= 0 under the paper's log2 quantization, as a hand-written Hopper
kernel (``csrc/expmul.cu``, the port of
``repro/kernels/expmul/expmul.py:expmul_pallas``) and its plain PyTorch
version.

x is (rows,) of any float dtype and is cast to float32, as the reference
does; v is (rows, d), float32 or bfloat16; the output has v's shape and
dtype. The numerics are the contract of ``numerics/log2exp.py`` bit for
bit: L_hat per row by fixed-point shift-add, then an integer subtraction
on each element's exponent field, flushing to +0 where it underflows.

``expmul_fwd`` launches the CUDA kernel for CUDA tensors and runs the
plain version only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode.decode import ACT_DTYPES
from repro_torch.numerics.log2exp import expmul

NAME = "expmul"

_P, _L, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURE = {"expmul_forward": (ctypes.c_int, [_P] * 3 + [_L] * 2
                                 + [_I, _P])}


def _operands(x, v):
    """(x as contiguous float32, v contiguous); raises on operands neither
    version takes."""
    if x.dim() != 1 or v.dim() != 2 or x.shape[0] != v.shape[0]:
        raise ValueError(f"{NAME}: x must be (rows,) and v (rows, d), got "
                         f"{tuple(x.shape)} and {tuple(v.shape)}")
    if not x.is_floating_point():
        raise ValueError(f"{NAME}: x must be a float tensor, got {x.dtype}")
    if v.dtype not in ACT_DTYPES:
        raise ValueError(f"{NAME}: v must be float32 or bfloat16, got "
                         f"{v.dtype}")
    if x.device != v.device:
        raise ValueError(f"{NAME}: x on {x.device} and v on {v.device}")
    return x.to(torch.float32).contiguous(), v.contiguous()


def expmul_fwd_plain(x, v):
    """The plain PyTorch version on any device: the bit path of
    ``numerics.log2exp.expmul`` on x as (rows, 1) against v (rows, d)."""
    x, v = _operands(x, v)
    build.COUNTS[f"{NAME}_plain"] += 1
    return expmul(x[:, None], v)


def expmul_fwd(x, v):
    """ExpMul on the CUDA kernel (CUDA tensors) or its plain version (CPU
    tensors). Returns v's shape and dtype."""
    if x.device.type == "cpu" and v.device.type == "cpu":
        return expmul_fwd_plain(x, v)
    if v.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {v.device}")
    x, v = _operands(x, v)
    out = torch.empty_like(v)
    if out.numel() == 0:
        return out
    lib = build.load(NAME, _SIGNATURE)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = lib.expmul_forward(x.data_ptr(), v.data_ptr(), out.data_ptr(),
                             v.shape[0], v.shape[1], ACT_DTYPES[v.dtype],
                             stream)
    build.check(err, NAME)
    build.COUNTS[NAME] += 1
    return out

"""KV-cache quantization codecs: symmetric per-row int8 and e4m3 fp8.

The contract is ``repro/numerics/quant.py``: one float32 scale per row of
the last axis, ``scale = amax / Q`` (Q = 127 for int8, 448 for fp8) or 1
for an all-zero row; int8 codes are ``clip(round(x / scale), -127, 127)``
with round half to even, fp8 codes are ``clip(x / scale, -448, 448)``
cast to ``float8_e4m3fn``; dequantization is ``codes.float() * scale``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

KV_DTYPES = ("fp32", "int8", "fp8")
QUANT_KV_DTYPES = ("int8", "fp8")

INT8_QMAX = 127.0
FP8_QMAX = 448.0    # e4m3fn max normal


class QuantKV(NamedTuple):
    """Codes plus per-row float32 scales: ``codes.shape == scale.shape + (D,)``."""

    codes: torch.Tensor
    scale: torch.Tensor


def kv_code_dtype(kv_dtype: str):
    """Storage dtype of the code array for a quantized kv_dtype."""
    if kv_dtype == "int8":
        return torch.int8
    if kv_dtype == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"kv_dtype {kv_dtype!r} has no code dtype "
                     f"(quantized dtypes: {QUANT_KV_DTYPES})")


def kv_code_bytes(kv_dtype: str) -> int:
    """Bytes per stored element (1 for both int8 and fp8)."""
    return kv_code_dtype(kv_dtype).itemsize


def _row_scale(x, qmax):
    amax = torch.amax(torch.abs(x), dim=-1)
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax))


def quantize_kv(x: torch.Tensor, kv_dtype: str) -> QuantKV:
    """Encode ``x`` along its last axis into codes + float32 scales."""
    x = x.to(torch.float32)
    if kv_dtype == "int8":
        scale = _row_scale(x, INT8_QMAX)
        y = x / scale[..., None]
        codes = torch.clamp(torch.round(y), -INT8_QMAX, INT8_QMAX)
        return QuantKV(codes.to(torch.int8), scale)
    if kv_dtype == "fp8":
        scale = _row_scale(x, FP8_QMAX)
        y = torch.clamp(x / scale[..., None], -FP8_QMAX, FP8_QMAX)
        return QuantKV(y.to(torch.float8_e4m3fn), scale)
    raise ValueError(f"cannot quantize to kv_dtype {kv_dtype!r}")


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  kv_dtype: str = "int8") -> torch.Tensor:
    """Decode codes + scales back to float32."""
    if kv_dtype not in QUANT_KV_DTYPES:
        raise ValueError(f"cannot dequantize kv_dtype {kv_dtype!r}")
    return codes.to(torch.float32) * scale[..., None].to(torch.float32)


def kv_values(kv, kv_dtype: str) -> torch.Tensor:
    """A ``QuantKV`` dequantized to float32 at ``kv_dtype``; a tensor of
    values as it is."""
    if isinstance(kv, QuantKV):
        return dequantize_kv(kv.codes, kv.scale, kv_dtype)
    return kv


def fake_quant_kv(x: torch.Tensor, kv_dtype: str) -> torch.Tensor:
    """Quantize then dequantize ``x`` (the full-sequence attention's K and V
    at a quantized ``kv_dtype``), in ``x``'s dtype: bit for bit a round trip
    through a quantized cache. Its gradient is autograd's through
    ``quantize_kv``, as ``jax.grad``'s is in ``repro``: none through int8
    codes (an integer cast), the e4m3 cast's through fp8 codes, and the row
    scale's through its ``amax``."""
    q = quantize_kv(x, kv_dtype)
    return dequantize_kv(q.codes, q.scale, kv_dtype).to(x.dtype)

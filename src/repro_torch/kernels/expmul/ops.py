"""Public wrappers of the ExpMul operator (the port of
``repro/kernels/expmul/ops.py``).

``expmul_rows`` is the shape-agnostic entry point: it flattens x to
(rows,) and V to (rows, d) and calls ``expmul_fwd``, which launches the
kernel for CUDA tensors and runs its plain version for CPU tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.expmul.expmul import expmul_fwd


def expmul_rows(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """ExpMul over rows: out[r, ...] = e^{x[r]} * v[r, ...].

    x: (rows,) or any leading shape of v that broadcasts to it, v: (rows,
    ...). Returns v's shape and dtype; raises where x would broadcast v to
    a larger shape.
    """
    lead = v.shape[:x.dim()]
    if x.dim() > v.dim() or any(a not in (1, b)
                                for a, b in zip(x.shape, lead)):
        raise ValueError(f"expmul_rows: x {tuple(x.shape)} does not "
                         f"broadcast to the leading axes of v "
                         f"{tuple(v.shape)}")
    rows = x.expand(lead).reshape(-1)
    flat = v.reshape(rows.shape[0], math.prod(v.shape[x.dim():]))
    return expmul_fwd(rows, flat).reshape(v.shape)


def merged_output_update(o_star, v_star, m_prev, m_cur, s) -> torch.Tensor:
    """Paper Eq. (5): one step of the merged [l, o] recurrence.

    o*_i = ExpMul(m_{i-1} - m_i, o*_{i-1}) + ExpMul(s_i - m_i, v*_i)
    Shapes: o_star/v_star (rows, d+1); m_prev/m_cur/s (rows,).
    """
    return (expmul_rows(m_prev - m_cur, o_star)
            + expmul_rows(s - m_cur, v_star))

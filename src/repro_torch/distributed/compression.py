"""Gradient compression with error feedback, operation for operation as
``repro.distributed.compression``: absmax int8 quantization of each leaf
(one float32 scale a leaf), or top-k magnitude sparsification, with the
compression's residual carried to the next step.

``error_feedback_int8`` is the train step's ``grad_transform`` of the
training launcher's ``--compress-grads``: each leaf plus its residual is
quantized and dequantized, and the difference is the next residual. On one
device there is no reduction to shrink; the numbers are those a
data-parallel run would reduce. ``torch.round`` and ``jnp.round`` both
round half to even.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


def int8_compress(x):
    """-> (q int8, scale float32): absmax quantization of the whole leaf."""
    xf = x.to(torch.float32)
    scale = torch.clamp(torch.amax(torch.abs(xf)) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q, scale):
    return q.to(torch.float32) * scale


def _feedback(grads, residuals, one):
    """(compressed grads, new residuals) of ``one(g, r)`` over matching
    leaves."""
    outs = [one(g, r) for g, r in zip(tree_leaves(grads),
                                      tree_leaves(residuals))]
    return (tree_unflatten_like(grads, [o[0] for o in outs]),
            tree_unflatten_like(grads, [o[1] for o in outs]))


def error_feedback_int8(grads, residuals):
    """-> (compressed_grads, new_residuals); the residual tree matches
    ``grads`` and is float32."""
    def one(g, r):
        gf = g.to(torch.float32) + r
        deq = int8_decompress(*int8_compress(gf))
        return deq.to(g.dtype), gf - deq

    return _feedback(grads, residuals, one)


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def topk_compress(x, frac: float = 0.01):
    """Keep the ``k = max(1, int(size * frac))`` entries of largest
    magnitude (flat layout), zero the rest. Among entries of equal
    magnitude the lower flat index is kept first, as ``jax.lax.top_k``
    keeps it: a stable descending sort of |x|."""
    xf = x.to(torch.float32).reshape(-1)
    k = max(1, int(xf.numel() * frac))
    idx = torch.sort(torch.abs(xf), descending=True, stable=True).indices[:k]
    out = torch.zeros_like(xf)
    out[idx] = xf[idx]
    return out.reshape(x.shape)


def error_feedback_topk(grads, residuals, frac: float = 0.01):
    def one(g, r):
        gf = g.to(torch.float32) + r
        sparse = topk_compress(gf, frac)
        return sparse.to(g.dtype), gf - sparse

    return _feedback(grads, residuals, one)

"""RG-LRU recurrent block (RecurrentGemma / Griffin), the port of
``repro/layers/rglru.py``.

Recurrence: h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) with
a_t = exp(-c * softplus(Lambda) * r_t), r and i input-gated. The temporal
block: in-projection to two branches, (causal conv1d of width 4 -> RG-LRU)
on one, tanh-GELU on the other, their product, out-projection. The
products run in the model dtype, the gates and the recurrence in float32,
with the reference's casts.

Three forms of the recurrence:

* ``rglru_apply`` (the full-sequence forward of training) scans the whole
  sequence with a log-depth inclusive scan of its own; ``repro`` runs
  ``jax.lax.associative_scan``, which pairs the products in another order,
  so the two agree within rounding, not bit for bit.
* ``rglru_decode_step`` advances one token: ``h = a * h + b``, as the
  reference does.
* ``rglru_prefill_step`` advances a chunk: the work that does not depend on
  the previous token (both projections, the conv over the conv state and
  the chunk, the gates, the GELU branch and the out-projection) runs over
  the whole chunk at once, and only the float32 recurrence loops over the
  tokens, in the decode step's order and arithmetic. A row's tokens at or
  past its ``n_valid`` take the identity step (a = 1, b = -0), which
  leaves ``h`` bit for bit unchanged, so an idle row's state does not
  move. The first of those tokens gives what the reference's gated scan
  gives it, one ungated step from the last valid state (an idle row's
  logits read it), computed after the loop over the whole chunk; the
  tokens after it are not defined.

The serving forms update the cache in place (``copy_`` into ``h`` and
``conv``), at fixed shapes and with no host read, so a tick of them can
be captured in a CUDA graph. There is no softmax here, so the paper's
ExpMul operator does not apply to this block; recurrentgemma's local
attention layers use it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.layers.common import dense_init
from repro_torch.sharding import regions
from repro_torch.sharding.constraints import constrain

_C = 8.0
_CONV_W = 4


def rglru_init(cfg, dtype, generator, device):
    """The reference's seven draws in its shapes; ``lam`` uniform on
    [2, 5) in float32, then cast (so that a^c lies in ~(0.9, 0.999))."""
    d = cfg.d_model
    w = cfg.lru_width or d
    p = {
        "w_in_rec": dense_init((d, w), dtype, generator, device),
        "w_in_gate": dense_init((d, w), dtype, generator, device),
        "conv": dense_init((_CONV_W, w), dtype, generator, device, scale=0.5),
        "w_a": dense_init((w, w), dtype, generator, device),
        "b_a": torch.zeros((w,), dtype=dtype, device=device),
        "w_x": dense_init((w, w), dtype, generator, device),
        "b_x": torch.zeros((w,), dtype=dtype, device=device),
    }
    lam = torch.empty((w,), dtype=torch.float32, device=device)
    p["lam"] = lam.uniform_(2.0, 5.0, generator=generator).to(dtype)
    p["w_out"] = dense_init((w, d), dtype, generator, device)
    return p


_SQRT_2_OVER_PI = float(torch.tensor(math.sqrt(2.0 / math.pi),
                                     dtype=torch.float32))


def _gelu(x):
    """``jax.nn.gelu(x, approximate=True)`` on float32 x, in its order of
    operations."""
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                  * (x + 0.044715 * (x * x * x))))
    return x * cdf


def _gates(params, u):
    """(a, b) of the recurrence in float32 for conv outputs u (..., W)."""
    f32 = torch.float32
    r = torch.sigmoid((u @ params["w_a"]).to(f32) + params["b_a"].to(f32))
    i = torch.sigmoid((u @ params["w_x"]).to(f32) + params["b_x"].to(f32))
    lam = params["lam"].to(f32)
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))  # jax.nn.softplus
    a = torch.exp(-_C * softplus * r)
    gated = i * u.to(f32)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * gated


def _conv(params, u, state=None):
    """Causal depthwise conv of width 4 over u (B, S, W), after ``state``
    (B, 3, W) or zeros: (output in u's dtype, the float32 padded input)."""
    w = params["conv"].to(torch.float32)
    if state is None:
        pad = regions.pad(u.to(torch.float32), (0, 0, _CONV_W - 1, 0))
    else:
        pad = torch.cat([state.to(torch.float32), u.to(torch.float32)], 1)
    S = u.shape[1]
    out = sum(pad[:, i:i + S] * w[i] for i in range(_CONV_W))
    return out.to(u.dtype), pad


def _scan(a, b):
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t (h_{-1} = 0) along axis
    1, in log2(S) doubling steps."""
    S, off = a.shape[1], 1
    while off < S:
        a_prev = regions.pad(a[:, :S - off], (0, 0, off, 0), value=1.0)
        b_prev = regions.pad(b[:, :S - off], (0, 0, off, 0))
        a, b = a * a_prev, a * b_prev + b
        off *= 2
    return b


def rglru_apply(params, x, cfg):
    """x (B, S, d) -> (B, S, d) over the full sequence."""
    del cfg
    # on a mesh the recurrence gathers its sequence once (per shard below)
    u = constrain(x @ params["w_in_rec"], "batch", None, "model")
    g = _gelu((x @ params["w_in_gate"]).to(torch.float32))
    u, _ = _conv(params, u)
    a, b = _gates(params, u)
    y = (_scan(a, b) * g).to(x.dtype)
    return y @ params["w_out"]


def rglru_init_cache(cfg, batch, dtype, device):
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, _CONV_W - 1, w), dtype=dtype,
                                device=device)}


def rglru_decode_step(params, cache, x1, cfg):
    """x1 (B, d) -> (B, d): one token of every row; the cache's ``h`` and
    ``conv`` are advanced in place."""
    del cfg
    u = x1 @ params["w_in_rec"]
    g = _gelu((x1 @ params["w_in_gate"]).to(torch.float32))
    u2, pad = _conv(params, u[:, None, :], cache["conv"])
    a, b = _gates(params, u2[:, 0])
    h = a * cache["h"] + b
    cache["h"].copy_(h)
    cache["conv"].copy_(pad[:, 1:])
    y = (h * g).to(x1.dtype)
    return cache, y @ params["w_out"]


def rglru_prefill_step(params, cache, x, cfg, n_valid):
    """x (B, C, d) -> (B, C, d): the first ``n_valid`` (B,) tokens of each
    row's chunk, in order, and the token after them as ``repro``'s gated
    scan gives it (one step from the last valid state); the rest are not
    defined. The cache is
    advanced in place by exactly the valid tokens: ``h`` by their
    recurrence, ``conv`` to the last three inputs, rows ``n_valid + [0, 1,
    2]`` of [conv state ++ chunk] (the old state at ``n_valid = 0``)."""
    del cfg
    B, C, _ = x.shape
    u = x @ params["w_in_rec"]
    g = _gelu((x @ params["w_in_gate"]).to(torch.float32))
    u2, pad = _conv(params, u, cache["conv"])
    a, b = _gates(params, u2)
    valid = (torch.arange(C, device=x.device)[None, :]
             < n_valid.to(torch.int64)[:, None])[..., None]
    a_t = torch.where(valid, a, 1.0)
    b_t = torch.where(valid, b, -0.0)
    hs = torch.empty_like(b)
    h = cache["h"]
    for t in range(C):    # sequential, as the reference orders it
        torch.mul(a_t[:, t], h, out=hs[:, t])
        hs[:, t].add_(b_t[:, t])
        h = hs[:, t]
    cache["h"].copy_(h)
    hs = torch.where(valid, hs, a * hs + b)
    rows = n_valid.to(torch.int64)[:, None] + torch.arange(
        _CONV_W - 1, device=x.device)[None, :]
    cache["conv"].copy_(torch.gather(
        pad, 1, rows[..., None].expand(B, _CONV_W - 1, pad.shape[-1])))
    y = (hs * g).to(x.dtype)
    return cache, y @ params["w_out"]

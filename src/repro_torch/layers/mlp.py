"""Gated MLP (SwiGLU / GeGLU) and the plain MLP (GELU)."""
from __future__ import annotations

from repro_torch.layers.common import activation_fn, dense_init

GATED = ("swiglu", "geglu")


def mlp_init(d_model, d_ff, activation, dtype, generator, device):
    """``w_up`` and ``w_down``, and ``w_gate`` for a gated activation."""
    p = {
        "w_up": dense_init((d_model, d_ff), dtype, generator, device),
        "w_down": dense_init((d_ff, d_model), dtype, generator, device),
    }
    if activation in GATED:
        p["w_gate"] = dense_init((d_model, d_ff), dtype, generator, device)
    return p


def mlp_apply(params, x, activation):
    act = activation_fn(activation)
    up = x @ params["w_up"]
    if "w_gate" in params:
        up = act(x @ params["w_gate"]) * up
    else:
        up = act(up)
    return up @ params["w_down"]

"""Gated MLP (SwiGLU / GeGLU)."""
from __future__ import annotations

from repro_torch.layers.common import activation_fn, dense_init

GATED = ("swiglu", "geglu")


def mlp_init(d_model, d_ff, activation, dtype, generator, device):
    if activation not in GATED:
        raise NotImplementedError(f"the port has the gated MLPs {GATED} "
                                  f"only, got {activation!r}")
    return {
        "w_up": dense_init((d_model, d_ff), dtype, generator, device),
        "w_down": dense_init((d_ff, d_model), dtype, generator, device),
        "w_gate": dense_init((d_model, d_ff), dtype, generator, device),
    }


def mlp_apply(params, x, activation):
    up = x @ params["w_up"]
    up = activation_fn(activation)(x @ params["w_gate"]) * up
    return up @ params["w_down"]

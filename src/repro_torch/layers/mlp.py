"""Gated SwiGLU MLP."""
from __future__ import annotations

from repro_torch.layers.common import dense_init, silu


def mlp_init(d_model, d_ff, activation, dtype, generator, device):
    if activation != "swiglu":
        raise NotImplementedError(f"the port has the swiglu MLP only, got "
                                  f"{activation!r}")
    return {
        "w_up": dense_init((d_model, d_ff), dtype, generator, device),
        "w_down": dense_init((d_ff, d_model), dtype, generator, device),
        "w_gate": dense_init((d_model, d_ff), dtype, generator, device),
    }


def mlp_apply(params, x):
    up = x @ params["w_up"]
    up = silu(x @ params["w_gate"]) * up
    return up @ params["w_down"]

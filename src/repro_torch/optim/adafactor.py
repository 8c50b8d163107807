"""Adafactor with factored second moments, operation for operation as
``repro.optim.adafactor``: a leaf of two or more axes keeps a row moment
``vr`` (its shape without the last axis) and a column moment ``vc`` (its
shape without the second-to-last), so the v moment of an (a, b) matrix
costs a + b floats instead of a * b; other leaves keep a full ``v``. The
decay is ``1 - (step + 1) ** -decay``, each update is clipped to an RMS of
``clip_threshold``, and the update ``-lr * u``, which the caller adds."""
from __future__ import annotations

import torch

from repro_torch.optim.interface import Optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


def adafactor(lr, *, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0):
    """lr: a float or a schedule ``step (int32 tensor) -> float32 tensor``."""
    def init(params):
        def per(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        device = tree_leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "v": tree_map(per, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr(step) if callable(lr) else lr
        beta = 1.0 - (step.to(torch.float32) + 1.0) ** (-decay)

        def upd(g, v, p):
            gf = g.to(torch.float32)
            g2 = gf * gf + eps
            if p.dim() >= 2:
                vr = beta * v["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * v["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                denom = (vr[..., None] / torch.clamp(
                    torch.mean(vr, dim=-1, keepdim=True), min=eps)[..., None]
                         ) * vc[..., None, :]
                u = gf / torch.sqrt(torch.clamp(denom, min=eps))
                v_new = {"vr": vr, "vc": vc}
            else:
                vv = beta * v["v"] + (1 - beta) * g2
                u = gf / torch.sqrt(torch.clamp(vv, min=eps))
                v_new = {"v": vv}
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return (-lr_t * u).to(p.dtype), v_new

        moments = []    # each leaf's dict of moments, in leaf order
        tree_map(lambda _, v: moments.append(v), grads, state["v"])
        pairs = [upd(g, v, p) for g, v, p in zip(
            tree_leaves(grads), moments, tree_leaves(params))]
        updates = tree_unflatten_like(grads, [u for u, _ in pairs])
        v_new = tree_unflatten_like(grads, [v for _, v in pairs])
        return updates, {"step": step, "v": v_new}

    return Optimizer(init, update)

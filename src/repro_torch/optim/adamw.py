"""AdamW on trees of tensors, operation for operation as
``repro.optim.adamw``: moments kept in ``moment_dtype`` and updated in
float32, bias correction by the step, ``delta = mhat / (sqrt(vhat) +
eps)``, plus ``weight_decay * p`` on parameters of two or more axes only
(no decay on norms and biases), and the update ``-lr * delta``, which the
caller adds. ``torch.optim.AdamW`` decays the parameter before the step
(``p *= 1 - lr * wd``) and so rounds differently; it is not used."""
from __future__ import annotations

import torch

from repro_torch.optim.interface import Optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def adamw(lr, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, moment_dtype: str = "float32"):
    """lr: a float or a schedule ``step (int32 tensor) -> float32 tensor``."""
    mdt = _DTYPES[moment_dtype]

    def init(params):
        device = tree_leaves(params)[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr(step) if callable(lr) else lr
        sf = step.to(torch.float32)

        def upd(g, m, v, p):
            gf = g.to(torch.float32)
            mf = b1 * m.to(torch.float32) + (1 - b1) * gf
            vf = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
            mhat = mf / (1 - b1 ** sf)
            vhat = vf / (1 - b2 ** sf)
            delta = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay and p.dim() >= 2:  # no decay on norms/biases
                delta = delta + weight_decay * p.to(torch.float32)
            return (-lr_t * delta).to(p.dtype), mf.to(mdt), vf.to(mdt)

        outs = [upd(g, m, v, p) for g, m, v, p in zip(
            tree_leaves(grads), tree_leaves(state["m"]),
            tree_leaves(state["v"]), tree_leaves(params))]
        updates = tree_unflatten_like(grads, [o[0] for o in outs])
        m_new = tree_unflatten_like(grads, [o[1] for o in outs])
        v_new = tree_unflatten_like(grads, [o[2] for o in outs])
        return updates, {"step": step, "m": m_new, "v": v_new}

    return Optimizer(init, update)

"""Train-step builder, as ``repro.train.step``: loss -> grads -> clip ->
optimizer, with optional microbatch gradient accumulation and a gradient
transform hook.

The returned step maps ``(state, batch) -> (state, metrics)`` and leaves
its inputs as they were: it returns a new parameter tree (``params +
update``) and a new optimizer state, like the reference's pure function.
"""
from __future__ import annotations

import torch

from repro_torch.models.api import init_model, loss_fn
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


def make_train_state(params, optimizer):
    return {"params": params, "opt": optimizer.init(params)}


def make_train_state_specs(cfg, optimizer):
    """The train state on the ``meta`` device, as ``repro``'s
    ``make_train_state_specs`` gives it through ``jax.eval_shape``: the
    full parameter tree and the optimizer's state (AdamW's moments in its
    ``moment_dtype``, a config's ``opt_state_dtype`` where the caller
    passes it), nothing allocated."""
    return make_train_state(init_model(cfg, device="meta"), optimizer)


def value_and_grad(params, batch, cfg, *, moe_impl="scatter"):
    """(loss, grads): the loss of ``loss_fn`` and its gradient with respect
    to every leaf of ``params``, as a tree of the same structure."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten_like(params, leaves), batch, cfg,
                   moe_impl=moe_impl)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten_like(params, grads)


def build_train_step(cfg, optimizer, *, microbatches: int = 1,
                     clip_norm: float = 1.0, moe_impl: str = "scatter",
                     grad_transform=None):
    """grad_transform: an optional fn(grads) -> grads applied before the
    clip (the launcher's ``--compress-grads``); ``moe_impl``: an MoE
    config's dispatch (``layers/moe.py``). With ``microbatches`` > 1 the
    batch is split along its first axis and the loss and the gradients
    accumulate ``x / microbatches`` in float32, in order."""

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            loss, grads = value_and_grad(params, batch, cfg,
                                         moe_impl=moe_impl)
        else:
            parts = {k: torch.chunk(v, microbatches, dim=0)
                     for k, v in batch.items()}
            if any(len(p) != microbatches or p[0].shape[0] * microbatches
                   != batch[k].shape[0] for k, p in parts.items()):
                raise ValueError(f"a batch of "
                                 f"{batch['tokens'].shape[0]} rows does not "
                                 f"split into {microbatches} microbatches")
            device = batch["tokens"].device
            loss = torch.zeros((), dtype=torch.float32, device=device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
                l_i, g_i = value_and_grad(
                    params, {k: p[i] for k, p in parts.items()}, cfg,
                    moe_impl=moe_impl)
                loss = loss + l_i / microbatches
                grads = tree_map(lambda a, g: a + g / microbatches, grads,
                                 g_i)
        if grad_transform is not None:
            grads = grad_transform(grads)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        updates, opt_state = optimizer.update(grads, state["opt"], params)
        new_params = tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
        return ({"params": new_params, "opt": opt_state},
                {"loss": loss, "grad_norm": gnorm})

    return train_step

"""Mixture-of-Experts FFN with top-k routing (``repro/layers/moe.py``).

Two dispatches, as the reference has them:

* ``scatter``, what serving runs: top-k routing, then each routed copy's
  position within its expert from an exclusive cumulative count in (token,
  choice) order, copies at or past the capacity ``C`` dropped, the kept
  ones scattered into an (E, C, d) buffer, the expert GEMMs over it, then
  the kept outputs gathered back and combined with the routing weights.
* ``balanced``, the reference's dry-run dispatch: copy i goes to slot
  i // E of expert i % E whatever the router says, combined with the
  router's weights. On a mesh its dispatch buffer and outputs are pinned
  as the reference pins them (``sharding/constraints.py``), each rank
  padding its own copies so that each meets the expert it meets off a
  mesh (``sharding/regions.py:pad_rows``), and the expert GEMMs run
  expert-parallel (``_expert_ffn_ep``, the reference's ``shard_map``):
  the (C, E, d) buffer enters with C over the DP axes and E over 'model',
  each rank's experts' weights are gathered over the DP axes inside the
  region, and their gradients leave it as a reduce-scatter.

On a mesh ``moe_apply`` gathers its own weights over the DP axes
(``gather_fsdp``; a block leaves its MoE FFN to it,
``models/blocks.py:gather_block``): the router and the dense residual
before routing, the expert stacks at use, after it (``scatter``) or inside
the expert-parallel region (``balanced``).

``moe_ref`` is the dense oracle: every expert on every token, a masked
combine.

Routing follows ``jax.lax.top_k`` exactly: the top k of a stable
descending sort, so ties and all-NaN rows (a request poisoned by a NaN
page) pick the lowest expert ids, as JAX does; ``torch.topk`` breaks ties
otherwise. The k weights then take an exact float32 softmax. Every row of
a tick routes, idle and padding rows too, and takes expert capacity, as in
``repro``: a stream depends on what shares its tick.

Nothing here reads a tensor's value on the host (no ``.item()``,
``nonzero`` or boolean-mask indexing), so a serving tick through it stays
capturable in a CUDA graph. The expert GEMMs are plain ``torch.bmm``
products, as ``repro`` leaves its einsums to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers.common import activation_fn, dense_init
from repro_torch.layers.mlp import GATED, mlp_apply, mlp_init
from repro_torch.sharding.constraints import constrain, gather_fsdp
from repro_torch.sharding.regions import (
    is_dtensor,
    pad_rows,
    run_local,
    scatter_rows,
    take_rows,
    unpad_rows,
)

IMPLS = ("scatter", "balanced")
STACKS = ("w_up", "w_gate", "w_down")


def moe_init(cfg, dtype, generator, device):
    """The router (d, E), the expert stacks ``w_up``, ``w_gate`` (E, d, f)
    and ``w_down`` (E, f, d), and the ``dense`` residual MLP when the
    config has one, drawn from ``generator`` in that order."""
    m, d = cfg.moe, cfg.d_model
    if cfg.activation not in GATED:
        raise NotImplementedError(f"the port has gated experts {GATED} "
                                  f"only, got {cfg.activation!r}")
    E, f = m.num_experts, m.d_ff
    p = {
        "router": dense_init((d, E), dtype, generator, device),
        "w_up": dense_init((E, d, f), dtype, generator, device),
        "w_down": dense_init((E, f, d), dtype, generator, device),
        "w_gate": dense_init((E, d, f), dtype, generator, device),
    }
    if m.dense_residual:
        p["dense"] = mlp_init(d, m.dense_d_ff, cfg.activation, dtype,
                              generator, device)
    return p


def router_logits(params, x2):
    """(T, d) -> (T, E) float32 router logits."""
    return constrain(x2.to(torch.float32) @ params["router"].to(
        torch.float32), "batch", None)


def top_k(logits, k):
    """``jax.lax.top_k`` over the last axis: (values, ids) of the k largest,
    ties and NaN rows resolved to the lowest ids (a stable descending
    sort)."""
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def route(params, x2, m):
    """(T, d) -> (top_w (T, k) float32, an exact softmax over the k logits;
    top_ids (T, k))."""
    top_w, top_ids = top_k(router_logits(params, x2), m.top_k)
    return torch.softmax(top_w, dim=-1), top_ids


def capacity(T, m) -> int:
    """Copies an expert takes in a dispatch of T tokens, computed in Python
    floats as ``repro`` computes it."""
    return max(1, int(T * m.top_k * m.capacity_factor / m.num_experts))


def dispatch(top_ids, E, C):
    """(pos, keep) of each routed copy, flattened in (token, choice) order:
    its position within its expert (an exclusive cumulative count) and
    whether it is below the capacity ``C``."""
    onehot = F.one_hot(top_ids.reshape(-1), num_classes=E)   # (T*k, E)
    pos = torch.sum((torch.cumsum(onehot, dim=0) - onehot) * onehot, dim=-1)
    return pos, pos < C


def _expert_ffn(params, xe, activation):
    """xe (E, C, d) -> (E, C, d): each expert's gated MLP over its slab."""
    up = torch.bmm(xe, params["w_up"])
    up = activation_fn(activation)(torch.bmm(xe, params["w_gate"])) * up
    return torch.bmm(up, params["w_down"])


def _gather(t, mesh, axes, dim):
    """A rank's local ``t`` gathered over the mesh ``axes`` along ``dim``
    (tiled, major axis first); its gradient a reduce-scatter back."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    sub = mesh[axes]
    d = DTensor.from_local(t, sub, [Shard(dim)] * len(axes),
                           run_check=False)
    return d.redistribute(sub, [Replicate()] * len(axes)).to_local(
        grad_placements=[Partial()] * len(axes))


def _expert_ffn_ep(params, xe, activation):
    """xe (C, E, d) -> (C, E, d), expert-parallel (the reference's
    ``_expert_ffn_ep``): over a DTensor the (C, E, d) buffer enters a
    per-shard region with C over the DP axes and E over 'model', and the
    expert weights with their experts over 'model' and d over the DP axes
    (FSDP), gathered over the DP axes inside the region: the gradient of
    that gather is the reduce-scatter of the weight gradients. Off a mesh
    the plain expert GEMMs."""
    if not is_dtensor(xe):
        return _expert_ffn(params, xe.transpose(0, 1),
                           activation).transpose(0, 1)
    mesh = xe.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]
    C, E, d = xe.shape
    ep = "model" if "model" in sizes and E % sizes["model"] == 0 else None
    cd = dp if dp and C % n_dp == 0 else None
    fs = dp if dp and d % n_dp == 0 else None
    act = activation_fn(activation)

    def local(wu, wg, wd, xl):
        if fs:
            wu, wg = _gather(wu, mesh, fs, 1), _gather(wg, mesh, fs, 1)
            wd = _gather(wd, mesh, fs, 2)
        xt = xl.transpose(0, 1)                    # (E_l, C_l, d)
        up = act(torch.bmm(xt, wg)) * torch.bmm(xt, wu)
        return torch.bmm(up, wd).transpose(0, 1)

    x_spec = (cd, ep, None)
    return run_local(local, (params["w_up"], params["w_gate"],
                             params["w_down"], xe),
                     ((ep, fs, None), (ep, fs, None), (ep, None, fs),
                      x_spec), x_spec, mesh)


def moe_apply(params, x, cfg, *, impl="scatter"):
    """x (B, S, d) -> (B, S, d)."""
    m = cfg.moe
    B, S, D = x.shape
    T, E, k = B * S, m.num_experts, m.top_k
    x2 = x.reshape(T, D)
    # the router and dense weights gathered now, the expert stacks at use
    params = {**gather_fsdp({k: v for k, v in params.items()
                             if k not in STACKS}),
              **{k: params[k] for k in STACKS}}
    top_w, top_ids = route(params, x2, m)
    if impl == "scatter":
        params = gather_fsdp(params)
        C = capacity(T, m)
        flat_ids = top_ids.reshape(-1)
        pos, keep = dispatch(top_ids, E, C)
        tok = torch.arange(T * k, device=x.device) // k   # each copy's token
        # a kept copy's row of the (E * C, d) buffer; a dropped one goes to
        # a scratch row past its end, sliced off (the reference adds a zero
        # to slot (e, C - 1) for it, which leaves that slot as it is)
        slot = torch.where(keep, flat_ids * C + pos, E * C)
        buf = x2.new_zeros((E * C + 1, D))
        buf = scatter_rows(buf, slot, take_rows(x2, tok))
        ye = _expert_ffn(params, buf[:E * C].view(E, C, D), cfg.activation)
        rows = flat_ids * C + torch.where(keep, pos, 0)
        g = take_rows(ye.reshape(E * C, D), rows)
        # where, not a product with the mask: a NaN in an expert's slot
        # must not reach a copy that was dropped from it
        g = torch.where(keep[:, None], g, torch.zeros((), dtype=g.dtype,
                                                      device=g.device))
        y = torch.sum(g.reshape(T, k, D).to(torch.float32) * top_w[..., None],
                      dim=1)
    elif impl == "balanced":
        C = -(-T * k // E)
        C = -(-C // 512) * 512
        xr = x2[:, None, :].expand(T, k, D).reshape(T * k, D)
        xr = pad_rows(xr, E * C, E)   # on a mesh each rank its own rows
        xe = constrain(xr.reshape(C, E, D), "batch", "model", None)
        ye = _expert_ffn_ep(params, xe, cfg.activation)
        ye = constrain(ye, "batch", "model", None)
        yr = unpad_rows(constrain(ye.reshape(C * E, D), "batch", None),
                        T * k, E)
        yr = constrain(yr, "batch", None).reshape(T, k, D)
        # combined into the model dtype with the weights in it, as the
        # reference's einsum does (float32 sums, one rounding)
        w = top_w.to(x2.dtype).to(torch.float32)
        y = torch.sum(yr.to(torch.float32) * w[..., None], dim=1).to(x2.dtype)
    else:
        raise ValueError(f"moe impl {impl!r} is not one of {IMPLS}")
    if m.dense_residual:
        y = y + mlp_apply(params["dense"], x2, cfg.activation).to(y.dtype)
    return y.reshape(B, S, D).to(x.dtype)


def moe_ref(params, x, cfg):
    """Dense oracle: every expert on every token, masked combine (small
    configs)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    x2 = x.reshape(T, D)
    top_w, top_ids = route(params, x2, m)
    ye = _expert_ffn(params, x2.expand(m.num_experts, T, D), cfg.activation)
    w_full = torch.zeros((T, m.num_experts), dtype=torch.float32,
                         device=x.device).scatter_add_(1, top_ids, top_w)
    y = torch.einsum("etd,te->td", ye.to(torch.float32), w_full)
    if m.dense_residual:
        y = y + mlp_apply(params["dense"], x2, cfg.activation).to(
            torch.float32)
    return y.reshape(B, S, D).to(x.dtype)

"""Logical-axis sharding rules: the port's parameter, train-state, batch and
decode-state paths -> per-dimension mesh axes (the port of
``repro/sharding/rules.py``).

Scheme on the (pod, data, model) production mesh:

  * DP   : batch over ('pod', 'data')
  * TP   : attention heads / ffn hidden / vocab over 'model'
  * FSDP : the d_model-ish axis of large 2D+ params over ('pod', 'data')
  * EP   : MoE expert axis over 'model'
  * SP   : decode KV caches with few kv-heads shard the *sequence* axis of
           the cache over 'model'

Every proposed axis is divisibility-checked against the dim (``_fit``);
on a mismatch the next candidate is tried, or the dim is replicated.

A spec is a tuple with one entry a tensor dim: None (replicated), an axis
name, or a tuple of axis names (the dim split over several mesh axes,
major to minor). ``param_spec`` is a pure function of a leaf's path, its
shape and the mesh's {axis: size}, so it runs without a process group.

The port keeps one entry a layer (``layers/<i>/...``, ``enc_layers``,
``dec_layers``), where ``repro`` stacks the layers of a unit kind on a
leading axis it never shards. The spec of layer i's leaf is the
reference's spec of its stacked leaf with that leading None dropped: the
rank tests that tell the expert stacks and the sLSTM block-diagonal
weights apart are the reference's less one, and the decode-state rules
index the per-layer caches without the layer axis.

``placements(spec, mesh)`` turns a spec into DTensor placements: an axis
tuple on one tensor dim becomes ``Shard(d)`` on each of those mesh dims.
DTensor splits such a dim in the mesh's order, which is the tuple's for
every rule here (('pod', 'data')), so the local shapes are JAX's.
"""
from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import mesh_axes
from repro_torch.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_unflatten_like,
)

_OPT_KEYS = ("m", "v", "params", "mu", "nu", "opt_state", "state")


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def fsdp_axes(mesh):
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def _axis_size(sizes: dict, axes) -> int:
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= sizes[a]
    return n


def _fit(sizes: dict, dim_size, *candidates):
    """First candidate axis (or axis tuple) that divides dim_size; else
    None."""
    for c in candidates:
        if c is None:
            return None
        if dim_size % _axis_size(sizes, c) == 0:
            return c
    return None


def _normalize(spec) -> tuple:
    """A one-axis tuple as its axis name, as JAX's PartitionSpec prints
    it."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def param_spec(path, shape, mesh) -> tuple:
    """The spec of one parameter leaf; ``path`` is its key path in the
    port's tree (layer indices included), ``mesh`` a mesh or its
    {axis: size}."""
    return _normalize(_param_spec(path, shape, mesh))


def _param_spec(path, shape, mesh) -> tuple:
    sizes = mesh_axes(mesh)
    name = path[-1]
    joined = "/".join(str(p) for p in path)
    fs = fsdp_axes(sizes)

    def spec(*dims):
        full = list(dims)[: len(shape)]
        full += [None] * (len(shape) - len(full))
        return tuple(_fit(sizes, d, ax) if ax is not None else None
                     for d, ax in zip(shape, full))

    # ---- embeddings / head: vocab over 'model' only
    if name == "table":
        return (_fit(sizes, shape[0], "model"), None)
    if name in ("out", "frontend_proj"):
        return (None, _fit(sizes, shape[1], "model"))

    # ---- MoE: (E, d, f) / (E, f, d), experts over model, d over fsdp
    if "ffn" in joined and name in ("w_up", "w_gate", "w_down") \
            and len(shape) == 3:
        dims = ["model", None, None]
        dims[1 if name in ("w_up", "w_gate") else 2] = fs
        return spec(*dims)
    if name == "router":
        return spec(fs, None)

    # ---- attention
    if name in ("wq", "wk", "wv"):       # (d, H|Hkv, hd)
        return spec(fs, "model", None)
    if name == "wo":
        return spec("model", None, fs)
    if name in ("bq", "bk", "bv"):
        return spec("model", None)
    # MLA
    if name in ("w_dq", "w_dkv"):
        return spec(fs, None)
    if name in ("w_uq", "w_ukv"):
        return spec(None, "model", None)

    # ---- dense mlp
    if name in ("w_up", "w_gate", "ffn_up", "ffn_gate"):
        return spec(fs, "model")
    if name in ("w_down", "ffn_down"):
        return spec("model", fs)

    # ---- rg-lru
    if name in ("w_in_rec", "w_in_gate"):
        return spec(fs, "model")
    if name in ("w_a", "w_x"):
        return spec(None, "model")
    if name == "w_out":
        return spec("model", fs)
    if name in ("b_a", "b_x", "lam"):
        return spec("model")
    if name == "conv":
        return spec(None, "model")

    # ---- xlstm
    if name in ("wqh", "wkh", "wvh"):    # block-diagonal (nh, dh, dh)
        return spec("model", None, None)
    if name.startswith(("w_z", "w_i", "w_f", "w_o", "r_")):
        if len(shape) == 3:              # sLSTM block-diagonal
            return spec("model", None, None)
        return spec(None, None)          # mLSTM gate projections (small)

    # ---- norms / biases / scalars
    return (None,) * len(shape)


def placements(spec, mesh):
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's shard of a ``shape`` tensor under ``spec``
    (even splits: the rules shard only dims their axes divide)."""
    sizes = mesh_axes(mesh)
    return tuple(d if axes is None else d // _axis_size(sizes, axes)
                 for d, axes in zip(shape, spec))


def local_slices(shape, placements, mesh) -> tuple:
    """This rank's slice of each dim of a ``shape`` tensor laid out by the
    DTensor ``placements`` on ``mesh``: DTensor's even split, a dim split
    over several mesh dims split major first."""
    n, i = [1] * len(shape), [0] * len(shape)
    for m, p in enumerate(placements):
        if p.is_shard():
            size = mesh.size(m)
            n[p.dim] *= size
            i[p.dim] = i[p.dim] * size + mesh.get_local_rank(m)
    out = []
    for d, size in enumerate(shape):
        if size % n[d]:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"evenly over {n[d]} shards")
        k = size // n[d]
        out.append(slice(i[d] * k, (i[d] + 1) * k))
    return tuple(out)


def shard_local(t, spec, mesh):
    """The DTensor of ``t``, a tensor every rank holds whole, laid out by
    ``spec`` on ``mesh``: each rank keeps its slice, nothing is sent."""
    from torch.distributed.tensor import DTensor

    spec = tuple(spec) + (None,) * (t.dim() - len(spec))
    pl = placements(spec, mesh)
    return DTensor.from_local(t[local_slices(t.shape, pl, mesh)].contiguous(),
                              mesh, pl, run_check=False, shape=t.shape,
                              stride=_contiguous_stride(t.shape))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """One leaf's spec, as the ``*_shardings`` trees hold it (a spec is a
    tuple, which the tree helpers would walk into)."""
    spec: tuple


def _map_with_path(fn, tree):
    return tree_unflatten_like(tree, [Sharding(fn(p, leaf)) for p, leaf in
                                      tree_leaves_with_path(tree)])


def param_shardings(params, mesh):
    """A tree of tensors (``meta`` ones too) -> the tree of their
    ``Sharding``s."""
    return _map_with_path(lambda p, l: param_spec(p, tuple(l.shape), mesh),
                          params)


def state_shardings(state, mesh):
    """The train state: params and optimizer moments by the parameter
    rules (the optimizer's wrapper keys stripped from the path), scalars
    and step counters replicated."""
    def one(path, leaf):
        if leaf.dim() == 0 or "count" in str(path) or "step" in str(path):
            return ()
        keys = tuple(k for k in path if k not in _OPT_KEYS)
        return param_spec(keys, tuple(leaf.shape), mesh)

    return _map_with_path(one, state)


def batch_shardings(batch, mesh):
    """An input batch: the leading dim over the DP axes (over 'data' alone
    when the pair does not divide it on a multi-pod mesh)."""
    sizes = mesh_axes(mesh)
    ba = batch_axes(sizes)

    def one(_, leaf):
        if leaf.dim() == 0:
            return ()
        first = _fit(sizes, leaf.shape[0], ba,
                     "data" if "pod" in sizes else None)
        return _normalize((first,) + (None,) * (leaf.dim() - 1))

    return _map_with_path(one, batch)


def decode_state_shardings(state, mesh, cfg=None):
    """The contiguous decode state (``models/api.py:init_decode_state``):
    the batch dim of every per-layer leaf over DP; an attention cache
    ``k``/``v`` (B, Hkv, S, hd) with its kv-heads over 'model' when they
    divide it, else its sequence (SP split-K); MLA latents ``kv_lat`` /
    ``k_rope`` (B, S, r) with the sequence over 'model'; mLSTM's ``C``
    (B, nh, dh, dh) on its second-last dim; the recurrent widths (``h``,
    ``conv``, ``n``, ``c``, ``m``) on the last. An encoder-decoder's cross
    K/V follow the batch; its top-level ``enc_len`` is replicated, as the
    reference's unstacked leaf is."""
    sizes = mesh_axes(mesh)
    ba = batch_axes(sizes)
    msize = sizes["model"]

    def one(path, leaf):
        shape, name = tuple(leaf.shape), str(path[-1])
        dims = [None] * len(shape)
        if len(path) == 1:        # enc_len: no layer axis in the reference
            return tuple(dims)
        if dims:
            dims[0] = _fit(sizes, shape[0], ba)
        if name in ("k", "v") and len(shape) == 4:
            if shape[1] % msize == 0:
                dims[1] = "model"
            elif shape[2] % msize == 0:
                dims[2] = "model"
        elif name in ("kv_lat", "k_rope") and len(shape) == 3:
            if shape[1] % msize == 0:
                dims[1] = "model"
        elif name == "C":
            dims[-2] = _fit(sizes, shape[-2], "model")
        elif name in ("h", "conv", "n", "c", "m"):
            dims[-1] = _fit(sizes, shape[-1], "model")
        return _normalize(dims)

    return _map_with_path(one, state)


def distribute(tree, shardings, mesh):
    """``meta`` leaves -> DTensors on ``mesh`` by the ``Sharding`` tree
    ``shardings``: each rank's local tensor is ``torch.empty`` of its
    shard's shape, so nothing is allocated or drawn."""
    import torch
    from torch.distributed.tensor import DTensor

    def one(leaf, sh):
        spec = tuple(sh.spec) + (None,) * (leaf.dim() - len(sh.spec))
        local = torch.empty(local_shape(tuple(leaf.shape), spec, mesh),
                            dtype=leaf.dtype, device="meta")
        return DTensor.from_local(local, mesh, placements(spec, mesh),
                                  run_check=False, shape=leaf.shape,
                                  stride=_contiguous_stride(leaf.shape))

    return tree_unflatten_like(tree, [one(l, s) for l, s in zip(
        tree_leaves(tree), tree_leaves(shardings))])


def _contiguous_stride(shape):
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))

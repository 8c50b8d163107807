"""Activation sharding constraints (the port of
``repro/sharding/constraints.py``).

The model pins activation layouts at block boundaries, on attention's
queries and carries, and around the MoE dispatch, as the reference does.
``constrain(x, *dims)`` takes one logical name a leading dim:

  * 'batch' -> the ('pod', 'data') axes of the mesh, when they divide it;
  * 'model' -> 'model' when it divides the dim;
  * 'ep'    -> ('model', 'pod'?, 'data') jointly (the expert-parallel rows);
  * 'ept'   -> ('pod'?, 'data', 'model') jointly;
  * None    -> replicated.

On a DTensor under a current mesh (``launch.mesh.set_mesh``) it is
``x.redistribute`` to those placements, whose collective the dry run
counts. On a plain tensor, or with no current mesh, it returns ``x``
itself: every CPU and card path runs as it did, bit for bit.

``gather_fsdp(params)`` is FSDP's all-gather on use (ZeRO-3): a layer's
weights, sharded over the DP axes at rest (``sharding/rules.py``), are
gathered over those axes right before the layer runs, keeping their
'model' split; the gradient of the gather is the reduce-scatter of the
weight gradients. XLA inserts both from the same rules; the model code
asks for them once a layer, inside the layer's checkpoint, so the
backward gathers again.
"""
from __future__ import annotations

from repro_torch.launch.mesh import current_mesh, mesh_axes
from repro_torch.sharding.regions import is_dtensor
from repro_torch.sharding.rules import placements
from repro_torch.tree import tree_map


def logical_spec(shape, dims, mesh) -> tuple:
    """The spec of a ``shape`` tensor under the logical ``dims``."""
    sizes = mesh_axes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    spec = []
    for size, d in zip(shape, dims):
        axes = None
        if d == "batch":
            axes = dp or None
        elif d == "model" and "model" in sizes:
            axes = "model"
        elif d in ("ep", "ept") and "model" in sizes:
            axes = ("model",) + dp if d == "ep" else dp + ("model",)
        n = 1
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            n *= sizes[a] if a else 1
        spec.append(axes if axes and size % n == 0 else None)
    spec += [None] * (len(shape) - len(spec))
    return tuple(spec)


def constrain(x, *dims):
    """``x`` redistributed to the logical ``dims`` (one a leading dim,
    None replicated), or ``x`` itself off a mesh or on a plain tensor."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    want = placements(logical_spec(tuple(x.shape), dims, mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def gather_fsdp(params):
    """``params`` (a layer's tree) with every DTensor leaf's ('pod',
    'data') shards gathered; the tree itself off a mesh."""
    mesh = current_mesh()
    if mesh is None:
        return params
    from torch.distributed.tensor import Replicate

    names = list(mesh.mesh_dim_names)
    dp = [names.index(a) for a in ("pod", "data") if a in names]

    def one(leaf):
        if not is_dtensor(leaf):
            return leaf
        want = tuple(Replicate() if i in dp else p
                     for i, p in enumerate(leaf.placements))
        return leaf if want == tuple(leaf.placements) \
            else leaf.redistribute(mesh, want)

    return tree_map(one, params)


def constrain_tree(tree, *dims):
    return tree_map(lambda leaf: constrain(leaf, *dims), tree)


def model_axis_size() -> int:
    """Size of the 'model' axis of the current mesh (0 if none)."""
    mesh = current_mesh()
    if mesh is None:
        return 0
    return mesh_axes(mesh).get("model", 0)

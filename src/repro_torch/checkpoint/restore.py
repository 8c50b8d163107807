"""Checkpoint restore: the tree of a saved step, rebuilt in the structure
and dtypes of a template tree, on one device or onto any mesh (the port of
``repro/checkpoint/restore.py``'s elastic restore).

On a mesh each rank assembles only its own slice of each leaf, reading
only the saved shards that overlap it (``_read_slice``, memory-mapped),
so a checkpoint written on (4, 2) restores onto (2, 4), (2, 2) or one
device unchanged."""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.checkpoint.manifest import leaf_key, read_manifest
from repro_torch.sharding.regions import is_dtensor
from repro_torch.sharding.rules import local_slices, placements
from repro_torch.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_unflatten_like,
)


def latest_step(base_dir: str):
    if not os.path.isdir(base_dir):
        return None
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(base_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    return steps[-1] if steps else None


def _read_slice(ckpt_dir, meta, index) -> np.ndarray:
    """The global slice ``index`` (one slice a dim) of a leaf, assembled
    from the saved shards that overlap it."""
    starts = [s.start for s in index]
    stops = [s.stop for s in index]
    first = np.load(os.path.join(ckpt_dir, meta["shards"][0]["file"]),
                    mmap_mode="r")
    out = np.empty([b - a for a, b in zip(starts, stops)], first.dtype)
    for sh in meta["shards"]:
        off, sshape = sh["offset"], sh["shape"]
        lo = [max(a, o) for a, o in zip(starts, off)]
        hi = [min(b, o + s) for b, o, s in zip(stops, off, sshape)]
        if any(l >= h for l, h in zip(lo, hi)):
            continue
        data = np.load(os.path.join(ckpt_dir, sh["file"]), mmap_mode="r")
        src = tuple(slice(l - o, h - o) for l, o, h in zip(lo, off, hi))
        dst = tuple(slice(l - a, h - a) for l, a, h in zip(lo, starts, hi))
        out[dst] = data[src]
    return out


def _tensor(arr, meta, dtype, device):
    if meta["dtype"] == "bfloat16":  # two-byte voids: the bit patterns
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def _mesh_device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def restore_checkpoint(target, base_dir: str, step=None, *, shardings=None,
                       mesh=None):
    """(tree, step): the saved step (default the latest) in the structure of
    ``target``, each leaf with its template's dtype. A leaf is a DTensor
    where ``shardings`` (a tree of ``sharding.rules.Sharding``, with
    ``mesh``) gives its spec, or where its template is a DTensor (its
    mesh and placements); each rank then reads only its slice. Any other
    leaf is whole, on its template's device."""
    from torch.distributed.tensor import DTensor

    if (shardings is None) != (mesh is None):
        raise ValueError("restore_checkpoint takes shardings and mesh "
                         "together")
    step = latest_step(base_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {base_dir}")
    ckpt_dir = os.path.join(base_dir, f"step_{step:08d}")
    manifest = read_manifest(ckpt_dir)
    specs = (tree_leaves(shardings) if shardings is not None
             else [None] * len(tree_leaves(target)))
    leaves = []
    for (path, like), sh in zip(tree_leaves_with_path(target), specs):
        key = leaf_key(path)
        meta = manifest["leaves"][key]
        shape = tuple(like.shape)
        if tuple(meta["shape"]) != shape:
            raise ValueError(f"{key}: saved shape {meta['shape']} does not "
                             f"match {shape}")
        if sh is not None:
            m = mesh
            pl = placements(tuple(sh.spec) + (None,) * (len(shape)
                                                        - len(sh.spec)), m)
        elif is_dtensor(like):
            m, pl = like.device_mesh, like.placements
        else:
            whole = tuple(slice(0, n) for n in shape)
            leaves.append(_tensor(_read_slice(ckpt_dir, meta, whole), meta,
                                  like.dtype, like.device))
            continue
        local = _tensor(_read_slice(ckpt_dir, meta,
                                    local_slices(shape, pl, m)),
                        meta, like.dtype, _mesh_device(m))
        leaves.append(DTensor.from_local(
            local, m, pl, run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride()))
    return tree_unflatten_like(target, leaves), manifest["step"]

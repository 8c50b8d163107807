"""Checkpoint restore on one device: the tree of a saved step, rebuilt in
the structure, dtypes and device of a template tree. Restoring onto
another mesh layout waits for the port's distributed slice."""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.checkpoint.manifest import leaf_key, read_manifest
from repro_torch.tree import tree_leaves_with_path, tree_unflatten_like


def latest_step(base_dir: str):
    if not os.path.isdir(base_dir):
        return None
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(base_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    return steps[-1] if steps else None


def _read(ckpt_dir, meta) -> np.ndarray:
    """The whole leaf, assembled from its saved shards by their offsets."""
    first = np.load(os.path.join(ckpt_dir, meta["shards"][0]["file"]),
                    mmap_mode="r")
    out = np.empty(meta["shape"], first.dtype)
    for sh in meta["shards"]:
        data = np.load(os.path.join(ckpt_dir, sh["file"]), mmap_mode="r")
        dst = tuple(slice(o, o + s) for o, s in zip(sh["offset"], sh["shape"]))
        out[dst] = data
    return out


def _tensor(arr, meta, like):
    if meta["dtype"] == "bfloat16":  # two-byte voids: the bit patterns
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def restore_checkpoint(target, base_dir: str, step=None):
    """(tree, step): the saved step (default the latest) in the structure of
    ``target``, each leaf with its template's dtype and device."""
    step = latest_step(base_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {base_dir}")
    ckpt_dir = os.path.join(base_dir, f"step_{step:08d}")
    manifest = read_manifest(ckpt_dir)
    leaves = []
    for path, like in tree_leaves_with_path(target):
        key = leaf_key(path)
        meta = manifest["leaves"][key]
        if tuple(meta["shape"]) != tuple(like.shape):
            raise ValueError(f"{key}: saved shape {meta['shape']} does not "
                             f"match {tuple(like.shape)}")
        leaves.append(_tensor(_read(ckpt_dir, meta), meta, like))
    return tree_unflatten_like(target, leaves), manifest["step"]

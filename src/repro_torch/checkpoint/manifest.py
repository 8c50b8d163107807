"""Checkpoint manifest, the on-disk layout of ``repro.checkpoint``: one
``.npy`` per leaf (per shard, keyed by its global offsets) named after the
leaf's path, and ``manifest.json`` with the step and each leaf's shape,
dtype and shard files: one shard at offset 0 for a leaf on one device,
each rank's own shards on a mesh (``save.py``). A bfloat16 leaf is stored as numpy stores ml_dtypes' bfloat16: its 16-bit
patterns as two-byte voids (``'<V2'``), with ``"bfloat16"`` in the
manifest."""
from __future__ import annotations

import json
import os


def leaf_key(path) -> str:
    """A leaf's path (dict keys and list indices) as "a/b/0/c"."""
    return "/".join(str(p) for p in path) or "root"


def shard_filename(key: str, start_indices) -> str:
    off = "_".join(str(int(s)) for s in start_indices)
    return f"{key.replace('/', '.')}__{off}.npy"


def write_manifest(ckpt_dir, step, leaves):
    """leaves: {key: {shape, dtype, shards: [{offset, shape, file}]}}"""
    with open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": leaves}, f, indent=1)


def read_manifest(ckpt_dir):
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        return json.load(f)

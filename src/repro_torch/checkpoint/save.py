"""Checkpoint save, on one device or on a mesh.

Every leaf of the tree (a tensor) is written as ``.npy`` shards keyed by
the leaf's path and each shard's global offset, and a JSON manifest
records the tree (``manifest.py``); a step's directory appears under its
final name only once it is complete (written as ``step_<n>.tmp``, then
renamed). ``AsyncCheckpointer`` copies the tensors to host memory on the
caller's thread, then writes them on a background thread, so the train
loop does not wait for the disk.

A plain tensor is one shard at offset 0. On a mesh (DTensor leaves under
an initialised process group) each rank writes only its own shards, as
the reference's ``addressable_shards`` loop does: a leaf replicated over
a mesh axis is written once, by the rank at coordinate 0 of that axis;
rank 0 merges the ranks' shard lists into the one manifest and renames
the step only after a barrier, once every rank has written, so a
half-written step never looks complete. ``AsyncCheckpointer``'s ranks meet
over a gloo group of their own, which its background write can use while
the train loop's collectives run on the default group.
"""
from __future__ import annotations

import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.checkpoint.manifest import (
    leaf_key,
    shard_filename,
    write_manifest,
)
from repro_torch.sharding.regions import is_dtensor
from repro_torch.sharding.rules import local_slices
from repro_torch.tree import tree_leaves_with_path


def host_array(t) -> np.ndarray:
    """A host copy of tensor ``t`` as numpy (bfloat16 as its uint16 bit
    patterns), which no later update of ``t`` changes."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _save_npy(path, arr, dtype):
    """``np.save``; a bfloat16 leaf's 16-bit patterns go under the header
    numpy writes for ml_dtypes' bfloat16 (descr ``'<V2'``), so the file is
    the reference's byte for byte."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _own_shards(leaf):
    """[(global offset, host array)]: the shards of ``leaf`` this rank
    writes."""
    if not is_dtensor(leaf):
        return [((0,) * leaf.dim(), host_array(leaf))]
    from torch.distributed.tensor import Replicate

    mesh = leaf.device_mesh
    if any(p.is_partial() for p in leaf.placements):
        leaf = leaf.redistribute(mesh, tuple(
            Replicate() if p.is_partial() else p for p in leaf.placements))
    if any(p.is_replicate() and mesh.get_local_rank(m)
           for m, p in enumerate(leaf.placements)):
        return []              # another rank writes this replica
    sl = local_slices(leaf.shape, leaf.placements, mesh)
    return [(tuple(s.start for s in sl), host_array(leaf.to_local()))]


def _snapshot(tree):
    """(host, meta): host [(key, [(offset, array)])] of this rank's shards;
    meta {key: (global shape, manifest dtype)}."""
    host, meta = [], {}
    for path, leaf in tree_leaves_with_path(tree):
        key = leaf_key(path)
        shards = _own_shards(leaf)
        host.append((key, shards))
        dtype = ("bfloat16" if leaf.dtype == torch.bfloat16
                 else str(np.dtype(str(leaf.dtype).split(".")[-1])))
        meta[key] = (list(leaf.shape), dtype)
    return host, meta


def _distributed(tree) -> bool:
    import torch.distributed as dist

    return dist.is_initialized() and any(
        is_dtensor(leaf) for _, leaf in tree_leaves_with_path(tree))


def _write(host, meta, ckpt_dir):
    """This rank's shard files -> {key: [shard entries]}."""
    shards = {}
    for key, own in host:
        shards[key] = []
        for offset, arr in own:
            fn = shard_filename(key, offset)
            _save_npy(os.path.join(ckpt_dir, fn), arr, meta[key][1])
            shards[key].append({"offset": list(offset),
                                "shape": list(arr.shape), "file": fn})
    return shards


def _commit(host, meta, base_dir, step, group=None, distributed=False):
    """Write the step as ``step_<n>.tmp`` and rename it ``step_<n>``: on a
    mesh every rank its shards, rank 0 the manifest and the rename after
    a barrier of ``group``."""
    import torch.distributed as dist

    final = os.path.join(base_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    lead = not distributed or dist.get_rank() == 0
    if lead:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    if distributed:
        dist.barrier(group=group)
    shards = _write(host, meta, tmp)
    if distributed:
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, shards, group=group)
        dist.barrier(group=group)        # every rank's files are written
    else:
        every = [shards]
    if lead:
        leaves_meta = {}
        for key, (shape, dtype) in meta.items():
            own = sorted((e for s in every for e in s[key]),
                         key=lambda e: e["offset"])
            leaves_meta[key] = {"shape": shape, "dtype": dtype,
                                "shards": own}
        write_manifest(tmp, step, leaves_meta)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    if distributed:
        dist.barrier(group=group)        # the step is complete for all
    return final


def save_checkpoint(tree, base_dir: str, step: int):
    """Synchronous save into <base>/step_<n> (atomic via tmp rename); on a
    mesh every rank calls it, over the default group."""
    return _commit(*_snapshot(tree), base_dir, step, None,
                   _distributed(tree))


class AsyncCheckpointer:
    """Snapshot to host on the caller's thread, disk I/O on a worker;
    keeps the ``keep`` newest steps. Under an initialised process group
    every rank makes one, at the same point: it makes its ranks' gloo group
    then (a collective call)."""

    def __init__(self, base_dir: str, *, keep: int = 3):
        import torch.distributed as dist

        self.base_dir = base_dir
        self.keep = keep
        self._thread = None
        self._error = None
        self._group = (dist.new_group(backend="gloo")
                       if dist.is_initialized() else None)

    def save(self, tree, step: int):
        self.wait()
        distributed = _distributed(tree)
        host, meta = _snapshot(tree)

        def work():
            try:
                _commit(host, meta, self.base_dir, step, self._group,
                        distributed)
                self._gc(distributed)
            except Exception as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self, distributed=False):
        import torch.distributed as dist

        if distributed and dist.get_rank() != 0:
            return
        steps = sorted(
            d for d in os.listdir(self.base_dir)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.base_dir, d), ignore_errors=True)

    def wait(self):
        """Block until the pending write is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

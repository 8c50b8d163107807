"""Checkpoint save on one device.

Every leaf of the tree (a tensor) is written as one ``.npy`` keyed by its
path, and a JSON manifest records the tree (``manifest.py``); a step's
directory appears under its final name only once it is complete (written
as ``step_<n>.tmp``, then renamed). ``AsyncCheckpointer`` copies the
tensors to host memory on the caller's thread, then writes them on a
background thread, so the train loop does not wait for the disk.
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


def _write(host, dtypes, ckpt_dir, step):
    """host: [(path, np.ndarray)]; dtypes: {key: manifest dtype}."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves_meta = {}
    for path, arr in host:
        key = leaf_key(path)
        fn = shard_filename(key, (0,) * arr.ndim)
        _save_npy(os.path.join(ckpt_dir, fn), arr, dtypes[key])
        leaves_meta[key] = {
            "shape": list(arr.shape), "dtype": dtypes[key],
            "shards": [{"offset": [0] * arr.ndim, "shape": list(arr.shape),
                        "file": fn}],
        }
    write_manifest(ckpt_dir, step, leaves_meta)


def _snapshot(tree):
    flat = tree_leaves_with_path(tree)
    host = [(path, host_array(leaf)) for path, leaf in flat]
    dtypes = {leaf_key(path): ("bfloat16" if leaf.dtype == torch.bfloat16
                               else str(arr.dtype))
              for (path, leaf), (_, arr) in zip(flat, host)}
    return host, dtypes


def _commit(host, dtypes, base_dir, step):
    final = os.path.join(base_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    _write(host, dtypes, tmp, step)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save_checkpoint(tree, base_dir: str, step: int):
    """Synchronous save into <base>/step_<n> (atomic via tmp rename)."""
    return _commit(*_snapshot(tree), base_dir, step)


class AsyncCheckpointer:
    """Snapshot to host on the caller's thread, disk I/O on a worker;
    keeps the ``keep`` newest steps."""

    def __init__(self, base_dir: str, *, keep: int = 3):
        self.base_dir = base_dir
        self.keep = keep
        self._thread = None
        self._error = None

    def save(self, tree, step: int):
        self.wait()
        host, dtypes = _snapshot(tree)

        def work():
            try:
                _commit(host, dtypes, self.base_dir, step)
                self._gc()
            except Exception as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
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

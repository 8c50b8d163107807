"""Per-rank sharded loading (the port of
``repro/data/sharded_loader.py``): each rank holds only its rows of the
global batch, and the global batch is a DTensor split on its rows over
the mesh's batch axes (``data``, or ``(pod, data)``,
``sharding/rules.py:batch_axes``). No rank sends or receives a row."""
from __future__ import annotations

import torch

from repro_torch.sharding.rules import batch_axes as _batch_axes
from repro_torch.sharding.rules import local_slices, placements


class ShardedLoader:
    """``source``: an object with ``.batch(step, n) -> np.ndarray`` of the
    global rows (``data/synthetic.py``, ``data/dataset.py``); ``mesh``: a
    ``DeviceMesh``, or None for one device; ``batch_axes``: the mesh axes
    the rows split over (default ``sharding/rules.py:batch_axes``)."""

    def __init__(self, source, mesh=None, *, batch_axes=None, device=None):
        self.source = source
        self.mesh = mesh
        self.batch_axes = (tuple(batch_axes) if batch_axes is not None
                           else _batch_axes(mesh) if mesh is not None
                           else None)
        self.device = device

    def _device(self):
        if self.device is not None:
            return torch.device(self.device)
        if self.mesh is not None and self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def load(self, step: int, global_batch: int):
        """The batch of ``step``: a DTensor of ``global_batch`` rows split
        over the batch axes, this rank's rows ``source.batch(step,
        global_batch)[start:stop]`` as the reference's callback cuts
        them; off a mesh the plain tensor of every row."""
        rows = self.source.batch(step, global_batch)
        if self.mesh is None:
            return torch.from_numpy(rows).to(self._device())
        from torch.distributed.tensor import DTensor

        spec = (self.batch_axes,) + (None,) * (rows.ndim - 1)
        pl = placements(spec, self.mesh)
        sl = local_slices(rows.shape, pl, self.mesh)
        local = torch.from_numpy(rows[sl[0]].copy()).to(self._device())
        return DTensor.from_local(local, self.mesh, pl, run_check=False,
                                  shape=torch.Size(rows.shape),
                                  stride=local.stride())

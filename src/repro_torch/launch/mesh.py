"""Production mesh builders and the current mesh (the port of
``repro/launch/mesh.py``).

Single pod: (data=16, model=16), 256 ranks. Multi-pod: (pod=2, data=16,
model=16), 512 ranks; the ``pod`` axis carries data parallelism and joins
the FSDP axis of the large models. Each builder makes a
``torch.distributed.device_mesh`` on whatever process group is
initialised: the dry run (``launch/dryrun.py``) initialises a fake one of
256 or 512 ranks in one process, the train launcher on a mesh
(``launch/train.py`` under torchrun) a real one, whose
``make_mesh_for_host`` is the reference's: (world / 2, 2) from 4 ranks
up, else (world, 1). Importing this module initialises nothing.

Each mesh function's ``device_type`` is the mesh's: "cuda" on cards
(NCCL), "cpu" for gloo ranks. The dry run keeps "cuda" over its fake process group on a
machine without a card: DTensor picks its collectives by it, and on a
"cpu" mesh it replaces every all-to-all by an all-gather and a chunk
(gloo has no all-to-all), which would price an exchange as a gather.

torch has no ambient mesh, as JAX's ``set_mesh`` gives one, so
``set_mesh`` keeps the current mesh in a context variable, which
``sharding/constraints.py`` reads.
"""
from __future__ import annotations

import contextlib
import contextvars

_CURRENT = contextvars.ContextVar("repro_torch_mesh", default=None)


def production_shape(multi_pod: bool = False):
    """(mesh shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(n_data: int = 4, n_model: int = 2, *,
                    device_type: str = "cuda"):
    """A small (data, model) mesh for tests over a handful of ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def host_mesh_shape(n: int) -> tuple:
    """The (data, model) shape ``make_mesh_for_host`` gives ``n`` ranks."""
    return (n // 2, 2) if n >= 4 else (n, 1)


def make_mesh_for_host(*, device_type: str = "cuda"):
    """The train launcher's mesh over every rank of the initialised
    process group (``repro.launch.train.make_mesh_for_host``): (data=n/2,
    model=2) from 4 ranks up, else (data=n, model=1)."""
    import torch.distributed as dist

    return make_debug_mesh(*host_mesh_shape(dist.get_world_size()),
                           device_type=device_type)


def mesh_axes(mesh) -> dict:
    """{axis name: size} in the mesh's order, of a ``DeviceMesh`` or of
    such a dict itself."""
    if isinstance(mesh, dict):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@contextlib.contextmanager
def set_mesh(mesh):
    """``with set_mesh(mesh):`` makes ``mesh`` the current mesh."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current_mesh():
    """The mesh of the innermost ``set_mesh`` block, or None."""
    return _CURRENT.get()

"""The fixed layout rules of ``sharding/layouts.py``: the placements a view,
a product and an element-wise op over DTensors take, as functions of
shapes and placements (no process group), and the mode on a fake mesh.
"""
import types

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from torch.distributed.tensor import Partial, Replicate, Shard  # noqa: E402

from repro_torch.sharding.layouts import (  # noqa: E402
    pointwise_layout,
    product_layout,
    view_layout,
)

R, P = Replicate(), Partial()
S0, S1, S2 = Shard(0), Shard(1), Shard(2)


def _t(shape, placements, mesh=(16, 16)):
    """A stand-in DTensor: its global shape and placements on a mesh of
    ``mesh`` sizes."""
    return types.SimpleNamespace(
        shape=torch.Size(shape), placements=tuple(placements),
        dim=lambda: len(shape), numel=lambda: int(torch.Size(shape).numel()),
        device_mesh=types.SimpleNamespace(size=lambda m: mesh[m]))


@pytest.mark.parametrize("src,pl,dst,want,out", [
    # a flatten of (batch, sequence) split on both keeps the batch's split
    ((256, 4096, 896), (S0, S1), (1048576, 896), (S0, R), (S0, R)),
    # its unflatten, the rows split over both axes: the batch over both
    ((1048576, 896), (S0, S0), (256, 4096, 896), (S0, S0), (S0, S0)),
    # a leading 1 skipped: the split moves to the first dim it can
    ((1, 1048576, 896), (S1, R), (256, 4096, 1, 14, 64), (S1, R), (S0, R)),
    # an uneven unflatten gathers the split that does not divide
    ((4, 56), (S0, S1), (4, 7, 8), (S0, R), (S0, R)),
    # a partial sum stays partial
    ((256, 4096, 896), (S0, P), (1048576, 896), (S0, P), (S0, P)),
])
def test_view_layout(src, pl, dst, want, out):
    mesh = (4, 2) if src == (4, 56) else (16, 16)
    assert view_layout(_t(src, pl, mesh), dst) == (want, out)


@pytest.mark.parametrize("x,px,w,pw,want_x,want_w,out", [
    # rows over data, K over model against a row-parallel weight
    ((8192, 4864), (S0, S1), (4864, 896), (R, S0), (S0, S1), (R, S0),
     (S0, P)),
    # a column-parallel weight
    ((8192, 896), (S0, R), (896, 4864), (R, S1), (S0, R), (R, S1),
     (S0, S1)),
    # rows over both against columns over model: the smaller (w) gathered
    ((8192, 896), (S0, S0), (896, 4864), (R, S1), (S0, S0), (R, R),
     (S0, S0)),
    # ... and the larger weight keeps its split, the rows gathered on model
    ((64, 896), (S0, S0), (896, 4864), (R, S1), (S0, R), (R, S1),
     (S0, S1)),
    # a partial sum beside a split is reduced
    ((8192, 896), (S0, P), (896, 4864), (R, S1), (S0, R), (R, S1),
     (S0, S1)),
    # a replicated operand is sliced to its partner's contracted split
    ((64, 896), (R, R), (896, 4864), (S0, R), (S1, R), (S0, R), (P, R)),
    # a batched product: the weight sliced to the batch split
    ((16, 64, 32), (S0, R), (16, 32, 8), (R, R), (S0, R), (S0, R),
     (S0, R)),
])
def test_product_layout(x, px, w, pw, want_x, want_w, out):
    assert product_layout(_t(x, px), _t(w, pw)) == (want_x, want_w, out)


def test_pointwise_layout():
    add, mul = torch.ops.aten.add.Tensor, torch.ops.aten.mul.Tensor
    x = _t((256, 4096, 896), (S0, S1))
    h = _t((256, 4096, 896), (S0, P))
    gain = _t((896,), (R, R))
    # a residual add: the partial sum scattered to the split sequence
    assert pointwise_layout(add, [h, x]) == [(S0, S1), (S0, S1)]
    # a broadcast operand replicated where the split dim is not its own
    assert pointwise_layout(mul, [x, gain]) == [(S0, S1), (R, R)]
    # a replicated largest operand is sliced to the split one
    y = _t((256, 4096, 896), (S0, R))
    assert pointwise_layout(add, [y, x]) == [(S0, S1), (S0, S1)]
    # partial sums: added they stay, multiplied they are reduced
    assert pointwise_layout(add, [h, h]) == [(S0, P), (S0, P)]
    assert pointwise_layout(mul, [h, h]) == [(S0, R), (S0, R)]


def test_fixed_layouts_product_on_a_fake_mesh():
    """The mode runs a product the rules lay out on each rank's shards:
    a split of K on both sides gives a partial sum, one local product of
    1/8 the FLOPs, no collective."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.op_costs import OpCounter
    from repro_torch.sharding.layouts import FixedLayouts

    fake_process_group(8)
    try:
        mesh = make_debug_mesh(4, 2)
        x = DTensor.from_local(torch.empty(16, 8, device="meta"), mesh,
                               (S0, S1), run_check=False)
        w = DTensor.from_local(torch.empty(8, 32, device="meta"), mesh,
                               (R, S0), run_check=False)
        with OpCounter() as c, FixedLayouts() as fixed:
            y = x @ w
    finally:
        dist.destroy_process_group()
    assert tuple(y.shape) == (64, 32) and tuple(y.placements) == (S0, P)
    assert fixed.resharded == 0 and c.totals()["collectives"] == []
    assert c.totals()["flops"] == 2 * 16 * 8 * 32

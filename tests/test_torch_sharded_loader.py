"""The port's sharded loader (``repro_torch.data.sharded_loader``) on 8
gloo ranks over a (4, 2) (data, model) mesh and on a (2, 2, 2) (pod,
data, model) one: each rank's rows of the global batch equal the rows
``repro.data.SyntheticLMDataset(...).batch(step, n)[start:stop]`` that
the reference's callback cuts for its shard, exactly, and the gathered
batch equals the reference's whole batch. Off a mesh the loader returns
the plain batch."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.synthetic import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro_torch.data import ShardedLoader, SyntheticLMDataset  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402

VOCAB, SEQ, BATCH, STEPS = 512, 40, 8, (0, 3)

_SCRIPT = r"""
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.data import ShardedLoader, SyntheticLMDataset

data = SyntheticLMDataset(int(sys.argv[1]), int(sys.argv[2]), seed=0)
for shape, names in (((4, 2), ("data", "model")),
                     ((2, 2, 2), ("pod", "data", "model"))):
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    loader = ShardedLoader(data, mesh)
    for step in (0, 3):
        b = loader.load(step, int(sys.argv[3]))
        local = b.to_local()
        coord = {n: mesh.get_local_rank(n) for n in names}
        emit({"mesh": list(shape), "step": step, "coord": coord,
              "axes": list(loader.batch_axes), "shape": list(b.shape),
              "rows": local.tolist(), "full": b.full_tensor().tolist()})
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def rank_outputs():
    return run_ranks(8, _SCRIPT, args=[VOCAB, SEQ, BATCH])


def _start(rec):
    """The first row of a rank's shard, as the reference's sharding of
    dim 0 over ('pod', 'data') (major first) or 'data' cuts it."""
    c = rec["coord"]
    if rec["axes"] == ["pod", "data"]:
        return (c["pod"] * 2 + c["data"]) * BATCH // 4
    return c["data"] * BATCH // 4


@pytest.mark.parametrize("mesh", [[4, 2], [2, 2, 2]],
                         ids=["data-model", "pod-data-model"])
def test_each_rank_holds_the_reference_rows(rank_outputs, mesh):
    ref = JaxDataset(VOCAB, SEQ, seed=0)
    seen = 0
    for outs in rank_outputs:
        for rec in outs:
            if rec["mesh"] != mesh:
                continue
            want = ref.batch(rec["step"], BATCH)
            start = _start(rec)
            rows = np.asarray(rec["rows"], np.int32)
            assert rec["shape"] == [BATCH, SEQ]
            assert rec["axes"] == (["data"] if len(mesh) == 2
                                   else ["pod", "data"])
            np.testing.assert_array_equal(
                rows, want[start:start + BATCH // 4])
            np.testing.assert_array_equal(
                np.asarray(rec["full"], np.int32), want)
            seen += 1
    assert seen == 8 * len(STEPS)


def test_off_a_mesh_the_loader_returns_the_whole_batch():
    data = SyntheticLMDataset(VOCAB, SEQ, seed=0)
    got = ShardedLoader(data).load(5, BATCH)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  JaxDataset(VOCAB, SEQ, seed=0).batch(5,
                                                                       BATCH))

"""The port's GPipe pipeline (``repro_torch.distributed.pipeline``), the
twin of ``tests/test_pipeline.py``: 4 stages on 4 gloo ranks (a ("pp",)
mesh), 8 microbatches of 2 x 16, ``tanh(x @ w)`` a stage, each rank
holding only its stage's weight. Every rank's outputs are held within
1e-5 of the sequential product in float32 and of ``repro``'s sequential
jnp result on the same numpy weights."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_ranks import run_ranks  # noqa: E402

N_STAGES, N_MICRO, MB, D = 4, 8, 2, 16

_SCRIPT = r"""
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed import pipeline_forward

z = np.load(sys.argv[1])
ws, xs = torch.from_numpy(z["ws"]), torch.from_numpy(z["xs"])
mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("pp",))
out = pipeline_forward(lambda w, x: torch.tanh(x @ w), ws[RANK], xs, mesh,
                       axis="pp")
emit(out.tolist())
dist.destroy_process_group()
"""


def _inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((N_STAGES, D, D)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    return ws, xs


@pytest.fixture(scope="module")
def rank_outputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("pipeline") / "inputs.npz"
    ws, xs = _inputs()
    np.savez(path, ws=ws, xs=xs)
    outs = run_ranks(N_STAGES, _SCRIPT, args=[path])
    return [np.asarray(o[0], np.float32) for o in outs]


def test_pipeline_matches_sequential(rank_outputs):
    ws, xs = _inputs()
    ref = torch.from_numpy(xs)
    for s in range(N_STAGES):
        ref = torch.tanh(ref @ torch.from_numpy(ws[s]))
    assert len(rank_outputs) == N_STAGES
    for out in rank_outputs:      # the last stage's outputs on every rank
        assert out.shape == (N_MICRO, MB, D)
        np.testing.assert_allclose(out, ref.numpy(), atol=1e-5, rtol=1e-5)


def test_pipeline_matches_repro_sequential(rank_outputs):
    ws, xs = _inputs()
    ref = jnp.asarray(xs)
    for s in range(N_STAGES):
        ref = jnp.tanh(ref @ jnp.asarray(ws[s]))
    for out in rank_outputs:
        np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


def test_pipeline_needs_a_full_pipe():
    """Fewer microbatches than stages is refused, as the reference's
    assert does (checked before any collective)."""
    from repro_torch.distributed.pipeline import pipeline_forward

    class Mesh:
        mesh_dim_names = ("pp",)

        def size(self, _):
            return 4

    with pytest.raises(AssertionError, match="microbatches"):
        pipeline_forward(None, None, torch.zeros(3, 2, 16), Mesh())

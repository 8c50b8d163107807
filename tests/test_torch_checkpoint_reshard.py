"""Per-rank checkpoints restored onto any mesh, the twin of
``tests/test_checkpoint.py:test_elastic_reshard_across_meshes``: on 8 gloo
ranks ``arange(64 * 32)`` sharded ("data", "model") over a (4, 2) mesh,
a bfloat16 leaf replicated over 'model' and an int32 scalar are saved,
each rank writing its own shards (a replica once, by the rank at
coordinate 0 of the axis it is replicated on), synchronously and through
``AsyncCheckpointer``; then restored as ("model", "data") onto a (2, 4)
mesh of the same ranks, onto a (2, 2) mesh of a fresh group of 4 ranks,
and onto one device: every rank's slice and every gathered leaf equal to
what was saved, exactly. A half-written step (its ``.tmp`` directory) is
not a step. The reference's restore reads the port's files, and the
port's restore reads the reference's."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.restore import (  # noqa: E402
    latest_step,
    restore_checkpoint,
)
from torch_ranks import free_port, run_ranks  # noqa: E402

_COMMON = r"""
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.checkpoint.restore import restore_checkpoint
from repro_torch.checkpoint.save import AsyncCheckpointer, save_checkpoint
from repro_torch.sharding.rules import Sharding, shard_local

base = sys.argv[1]

def whole():
    w = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    h = (torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8) / 7
         ).to(torch.bfloat16)
    return {"w": w, "h": h, "step": torch.tensor(7, dtype=torch.int32)}

def restored(mesh, step):
    target = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in whole().items()}
    specs = {"w": Sharding(("model", "data")), "h": Sharding(("model", None)),
             "step": Sharding(())}
    tree, got = restore_checkpoint(target, base, step, shardings=specs,
                                   mesh=mesh)
    out = {"at": got, "coord": [mesh.get_local_rank(n)
                                  for n in mesh.mesh_dim_names]}
    for k, v in tree.items():
        out[k] = {"local": v.to_local().float().tolist(),
                  "full": v.full_tensor().float().tolist(),
                  "dtype": str(v.dtype),
                  "placements": [str(p) for p in v.placements]}
    return out
"""

_SAVE = _COMMON + r"""
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
specs = {"w": ("data", "model"), "h": ("data", None), "step": ()}
tree = {k: shard_local(v, specs[k], mesh) for k, v in whole().items()}
save_checkpoint(tree, base, 5)
ck = AsyncCheckpointer(base, keep=3)
ck.save(tree, 6)
ck.wait()
mesh2 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
emit(restored(mesh2, 5))
emit(restored(mesh2, 6))
dist.destroy_process_group()
if RANK == 0:      # a half-written step: its directory never renamed
    os.makedirs(os.path.join(base, "step_00000009.tmp"))
    with open(os.path.join(base, "step_00000009.tmp", "w__0_0.npy"),
              "wb") as f:
        f.write(b"partial")
# ranks 0-3 as a fresh group of 4 on a (2, 2) mesh; the latest step
if RANK < 4:
    os.environ.update(WORLD_SIZE="4", MASTER_PORT=sys.argv[2])
    dist.init_process_group("gloo")
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    emit(restored(mesh, None))
    dist.destroy_process_group()
"""


def _whole():
    w = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    h = (torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8) / 7).to(
        torch.bfloat16).float().numpy()
    return w, h


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("reshard"))
    outs = run_ranks(8, _SAVE, args=[base, free_port()])
    return base, [o[:2] for o in outs], [o[2:] for o in outs[:4]]


def _check(rec, mesh_shape):
    w, h = _whole()
    m, d = rec["coord"]            # (data, model) coordinates
    n_data, n_model = mesh_shape
    np.testing.assert_array_equal(np.asarray(rec["w"]["full"]), w)
    np.testing.assert_array_equal(np.asarray(rec["h"]["full"]), h)
    assert rec["w"]["dtype"] == "torch.float32"
    assert rec["h"]["dtype"] == "torch.bfloat16"
    assert rec["step"]["full"] == 7 and rec["step"]["dtype"] == "torch.int32"
    # ("model", "data"): rows over 'model', columns over 'data'
    r, c = 64 // n_model, 32 // n_data
    np.testing.assert_array_equal(
        np.asarray(rec["w"]["local"]), w[d * r:(d + 1) * r, m * c:(m + 1) * c])
    r = 16 // n_model
    np.testing.assert_array_equal(np.asarray(rec["h"]["local"]),
                                  h[d * r:(d + 1) * r])


def test_written_on_4x2_restores_onto_2x4(runs):
    _, saved, _ = runs
    for outs in saved:
        assert [o["at"] for o in outs] == [5, 6]
        for rec in outs:
            _check(rec, (2, 4))


def test_written_on_4x2_restores_onto_2x2(runs):
    _, _, later = runs
    assert len(later) == 4
    for (rec,) in later:
        assert rec["at"] == 6       # the latest complete step, not the .tmp
        _check(rec, (2, 2))


@pytest.mark.parametrize("step", [5, 6], ids=["sync", "async"])
def test_written_on_4x2_restores_onto_one_device(runs, step):
    base, _, _ = runs
    w, h = _whole()
    target = {"w": torch.zeros(64, 32), "h": torch.zeros(16, 8,
                                                          dtype=torch.bfloat16),
              "step": torch.tensor(0, dtype=torch.int32)}
    tree, got = restore_checkpoint(target, base, step)
    assert got == step
    assert torch.equal(tree["w"], torch.from_numpy(w))
    assert tree["h"].dtype == torch.bfloat16
    assert torch.equal(tree["h"].float(), torch.from_numpy(h))
    assert int(tree["step"]) == 7


def test_each_shard_written_once_and_the_tmp_step_unseen(runs):
    base, _, _ = runs
    assert latest_step(base) == 6
    for step in (5, 6):
        d = os.path.join(base, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            leaves = json.load(f)["leaves"]
        w, h, s = leaves["w"]["shards"], leaves["h"]["shards"], \
            leaves["step"]["shards"]
        assert [e["offset"] for e in w] == sorted(
            [r * 16, c * 16] for r in range(4) for c in range(2))
        assert all(e["shape"] == [16, 16] for e in w)
        # replicated over 'model': one copy a 'data' shard
        assert [e["offset"] for e in h] == [[r * 4, 0] for r in range(4)]
        assert leaves["h"]["dtype"] == "bfloat16"
        assert [e["offset"] for e in s] == [[]]
        files = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
        assert len(files) == 8 + 4 + 1
        # bfloat16 shards under numpy's header for ml_dtypes' bfloat16
        hdr = np.lib.format.read_magic(open(os.path.join(
            d, h[0]["file"]), "rb"))
        assert hdr == (1, 0)
    assert not any(d.endswith(".tmp") and d != "step_00000009.tmp"
                   for d in os.listdir(base))


def test_the_reference_reads_the_port_and_the_port_reads_the_reference(
        runs, tmp_path):
    """``repro``'s restore reads the port's per-rank shards (its float32
    and int32 leaves: ``repro``'s own restore cannot cast the two-byte
    voids of a bfloat16 shard), and the port's restore assembles a leaf
    ``repro`` saved in shards of a (4, 2) mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.checkpoint.restore import restore_checkpoint as jax_restore

    base, _, _ = runs
    w, h = _whole()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    shapes = {"w": jax.ShapeDtypeStruct((64, 32), jnp.float32),
              "step": jax.ShapeDtypeStruct((), jnp.int32)}
    sh = {k: NamedSharding(mesh, P()) for k in shapes}
    tree, step = jax_restore(shapes, sh, base, 6)
    assert step == 6
    np.testing.assert_array_equal(np.asarray(tree["w"]), w)
    assert int(tree["step"]) == 7
    # repro's shards, each at its global offset, read back by the port
    ref_dir = tmp_path / "ref"
    write_dir = ref_dir / "step_00000003"
    write_dir.mkdir(parents=True)
    shards = []
    for r in range(4):
        for c in range(2):
            fn = f"w__{r * 16}_{c * 16}.npy"
            np.save(write_dir / fn, w[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16])
            shards.append({"offset": [r * 16, c * 16], "shape": [16, 16],
                           "file": fn})
    from repro.checkpoint.manifest import write_manifest

    write_manifest(str(write_dir), 3, {"w": {
        "shape": [64, 32], "dtype": "float32", "shards": shards}})
    got, step = restore_checkpoint({"w": torch.zeros(64, 32)}, str(ref_dir))
    assert step == 3 and torch.equal(got["w"], torch.from_numpy(w))

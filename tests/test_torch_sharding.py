"""Port parity of the multi-device plan's rules: the shape cells,
``input_specs``, and ``sharding/rules.py`` against ``repro``'s, leaf by
leaf, for every registered arch at full size on the production meshes
(16 x 16 over (data, model) and 2 x 16 x 16 over (pod, data, model)).

``repro``'s rules run on a ``jax.sharding.AbstractMesh`` (no devices);
the port's spec of layer i's leaf must be ``repro``'s spec of its stacked
leaf with the leading layer axis dropped. The local shard shapes the
port's DTensor placements give on a fake process group (computed by
DTensor itself) must equal what JAX's ``NamedSharding.shard_shape`` gives
for ``repro``'s spec.
"""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro.models import inputs as ref_inputs  # noqa: E402
from repro.optim.adamw import adamw as ref_adamw  # noqa: E402
from repro.sharding import rules as ref_rules  # noqa: E402
from repro.train.step import make_train_state_specs as ref_state  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_IDS,
    SHAPES,
    cells_for,
    get_config,
)
from repro_torch.configs import shapes as port_shapes  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.inputs import input_specs  # noqa: E402
from repro_torch.optim.adamw import adamw  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.train.step import make_train_state_specs  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LAYER_KEYS = ("layers", "enc_layers", "dec_layers")


def _abstract(mesh):
    dims, names = MESHES[mesh]
    return AbstractMesh(dims, names)


def _sizes(mesh):
    dims, names = MESHES[mesh]
    return dict(zip(names, dims))


def _keys(path):
    return tuple(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))
                 for k in path)


def _ref_leaves(tree):
    return {_keys(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_path(path, cfg):
    """The reference's stacked path of the port's layer-i leaf (and whether
    it is stacked)."""
    if path[0] == "layers":
        return ("units", path[1] % len(cfg.block_pattern)) + path[2:], True
    if path[0] == "enc_layers":
        return ("enc_units", path[1] % len(cfg.block_pattern)) + path[2:], True
    if path[0] == "dec_layers":
        return ("dec_units", 0) + path[2:], True
    return path, False


def _ref_spec(spec, stacked, ndim):
    spec = tuple(spec)[1:] if stacked else tuple(spec)
    return spec + (None,) * (ndim - len(spec))


# ---------------------------------------------------------------------------
# cells and batch specs
# ---------------------------------------------------------------------------
def test_shapes_match_repro():
    assert SHAPES == {k: port_shapes.ShapeSpec(*v.__dict__.values())
                      for k, v in ref_shapes.SHAPES.items()}
    assert port_shapes.SUBQUADRATIC_ARCHS == ref_shapes.SUBQUADRATIC_ARCHS
    for arch in ARCH_IDS:
        assert [tuple(s.__dict__.values()) for s in cells_for(arch)] == \
            [tuple(s.__dict__.values()) for s in ref_shapes.cells_for(arch)]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_repro(kind):
    for arch in ARCH_IDS:
        cfg, rcfg = get_config(arch), ref_config(arch)
        for shape in cells_for(arch):
            kw = dict(seq_len=shape.seq_len, global_batch=shape.global_batch,
                      kind=kind)
            got = input_specs(cfg, **kw)
            want = ref_inputs.input_specs(rcfg, **kw)
            assert list(got) == list(want), arch
            for name, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == want[name].shape, (arch, name)
                assert str(t.dtype).split(".")[-1] == \
                    np.dtype(want[name].dtype).name, (arch, name)


def test_meta_model_builds_without_drawing():
    cfg = get_config("kimi-k2-1t-a32b")
    params = api.init_model(cfg, device="meta")
    leaves = tree_leaves(params)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == cfg.param_count()
    state = make_train_state_specs(cfg, adamw(3e-4, moment_dtype="bfloat16"))
    assert {t.dtype for t in tree_leaves(state["opt"]["m"])} == \
        {torch.bfloat16}


# ---------------------------------------------------------------------------
# parameter specs, leaf by leaf
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_matches_repro_leaf_by_leaf(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    ref = _ref_leaves(jax.eval_shape(lambda k: ref_api.init_model(k, rcfg),
                                     jax.random.PRNGKey(0)))
    port = tree_leaves_with_path(api.init_model(cfg, device="meta"))
    assert len(port) > 0
    for mesh in MESHES:
        am = _abstract(mesh)
        for path, leaf in port:
            rpath, stacked = _ref_path(path, rcfg)
            rleaf = ref[rpath]
            assert tuple(rleaf.shape[int(stacked):]) == tuple(leaf.shape), \
                path
            want = _ref_spec(ref_rules.param_spec(rpath, rleaf.shape, am),
                             stacked, leaf.dim())
            got = rules.param_spec(path, tuple(leaf.shape), _sizes(mesh))
            assert got == want, (mesh, path, got, want)
            local = rules.local_shape(tuple(leaf.shape), got, _sizes(mesh))
            jax_local = NamedSharding(am, jax.sharding.PartitionSpec(*want)) \
                .shard_shape(tuple(leaf.shape))
            assert local == tuple(jax_local), (mesh, path)


@pytest.fixture(scope="module", params=list(MESHES))
def fake_mesh(request):
    """A fake process group of the mesh's size and the port's mesh on it."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.launch.mesh import make_production_mesh

    multi = request.param == "2x16x16"
    fake_process_group(512 if multi else 256)
    try:
        yield request.param, make_production_mesh(multi_pod=multi)
    finally:
        dist.destroy_process_group()


def _dtensor_local_shape(shape, spec, mesh):
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    return tuple(compute_local_shape_and_global_offset(
        shape, mesh, rules.placements(spec, mesh))[0])


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "kimi-k2-1t-a32b",
                                  "xlstm-1.3b", "seamless-m4t-medium",
                                  "minicpm3-4b", "recurrentgemma-2b"])
def test_placements_give_jax_local_shapes(fake_mesh, arch):
    name, mesh = fake_mesh
    am = _abstract(name)
    params = api.init_model(get_config(arch), device="meta")
    for path, leaf in tree_leaves_with_path(params):
        spec = rules.param_spec(path, tuple(leaf.shape), mesh)
        want = NamedSharding(am, jax.sharding.PartitionSpec(*spec)) \
            .shard_shape(tuple(leaf.shape))
        assert _dtensor_local_shape(tuple(leaf.shape), spec, mesh) == \
            tuple(want), (path, spec)


# ---------------------------------------------------------------------------
# the train-state, batch and decode-state trees at the dry run's cells
# ---------------------------------------------------------------------------
def _port_locals(tree, shardings, sizes):
    return [(p, rules.local_shape(tuple(l.shape), s.spec, sizes))
            for (p, l), s in zip(tree_leaves_with_path(tree),
                                 tree_leaves(shardings))]


def _ref_local(sharding, shape):
    return tuple(sharding.shard_shape(tuple(shape)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_and_batch_shardings_match_repro(arch, mesh):
    cfg, rcfg = get_config(arch), ref_config(arch)
    am, sizes = _abstract(mesh), _sizes(mesh)
    state = make_train_state_specs(
        cfg, adamw(3e-4, moment_dtype=cfg.opt_state_dtype))
    rstate = ref_state(rcfg, ref_adamw(3e-4,
                                       moment_dtype=rcfg.opt_state_dtype))
    rsh = _ref_leaves(ref_rules.state_shardings(rstate, am))
    rshapes = _ref_leaves(rstate)
    for path, local in _port_locals(state, rules.state_shardings(state,
                                                                 sizes),
                                    sizes):
        i = next((j for j, k in enumerate(path) if k in LAYER_KEYS), None)
        if i is None:
            rpath, stacked = path, False
        else:
            sub, stacked = _ref_path(path[i:], rcfg)
            rpath = path[:i] + sub
        want = _ref_local(rsh[rpath], rshapes[rpath].shape)
        assert local == want[int(stacked):], (path, local, want)
    for shape in cells_for(arch):
        batch = input_specs(cfg, seq_len=shape.seq_len,
                            global_batch=shape.global_batch, kind=shape.kind)
        rbatch = ref_inputs.input_specs(rcfg, seq_len=shape.seq_len,
                                        global_batch=shape.global_batch,
                                        kind=shape.kind)
        rb = ref_rules.batch_shardings(rbatch, am)
        for (path, local) in _port_locals(
                batch, rules.batch_shardings(batch, sizes), sizes):
            assert local == _ref_local(rb[path[0]],
                                       rbatch[path[0]].shape), (arch, path)


def _ref_decode_leaf(path, cfg):
    """The reference's stacked decode-state path of a port leaf."""
    if path[0] == "caches":
        if cfg.encoder_layers:
            return ("caches", 0) + path[2:]
        return ("caches", path[1] % len(cfg.block_pattern)) + path[2:]
    if path[0] == "cross_kv":
        return ("cross_kv", path[2])
    return path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_shardings_match_repro(arch, mesh):
    cfg, rcfg = get_config(arch), ref_config(arch)
    am, sizes = _abstract(mesh), _sizes(mesh)
    for shape in cells_for(arch):
        if shape.kind != "decode":
            continue
        B, S = shape.global_batch, shape.seq_len
        kw = {"enc_len": cfg.frontend_tokens} if cfg.encoder_layers else {}
        state = api.init_decode_state(cfg, B, S, device="meta", **kw)
        rstate = jax.eval_shape(
            lambda: ref_api.init_decode_state(rcfg, B, S, **kw))
        rsh = _ref_leaves(ref_rules.decode_state_shardings(rstate, am, rcfg))
        rshapes = _ref_leaves(rstate)
        port = _port_locals(state, rules.decode_state_shardings(state, sizes,
                                                                cfg), sizes)
        assert port
        for path, local in port:
            rpath = _ref_decode_leaf(path, rcfg)
            want = _ref_local(rsh[rpath], rshapes[rpath].shape)
            stacked = path[0] in ("caches", "cross_kv")
            assert local == want[int(stacked):], (shape.name, path, local,
                                                  want)

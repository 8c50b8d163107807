"""The port's checkpointing and train-side fault tolerance, held to the
assertions of ``tests/test_checkpoint.py`` (single-device round trip,
async == sync, garbage collection keeps the latest) and
``tests/test_fault_and_compression.py`` (straggler flags, a supervisor
restart reaching the same final state), plus a fault-injected run of the
port's launcher whose losses end as an uninterrupted run's; and the
reference's on-disk layout, held against ``repro.checkpoint`` on a
converted smoke train state (float32 parameters, bfloat16 moments, an
int32 step) in both directions."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.restore import (  # noqa: E402
    latest_step,
    restore_checkpoint,
)
from repro_torch.checkpoint.save import (  # noqa: E402
    AsyncCheckpointer,
    save_checkpoint,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMDataset  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.optim.adamw import adamw  # noqa: E402
from repro_torch.reliability import (  # noqa: E402
    FaultInjector,
    RestartSupervisor,
    StragglerWatchdog,
)
from repro_torch.train.step import build_train_step, make_train_state  # noqa: E402
from repro_torch.tree import (  # noqa: E402
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
)


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "w": torch.randn(64, 32, generator=g),
            "layers": [{"a": torch.randn(16, 8, generator=g)},
                       {"a": torch.randn(16, 8, generator=g)}],
            "h": torch.randn(5, generator=g).to(torch.bfloat16),
        },
        "opt": {"step": torch.tensor(7, dtype=torch.int32)},
    }


def _assert_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _template(tree):
    return tree_map(torch.zeros_like, tree)


def test_roundtrip_single_device(tmp_path):
    tree = _tree(0)
    save_checkpoint(tree, str(tmp_path), 7)
    assert latest_step(str(tmp_path)) == 7
    restored, step = restore_checkpoint(_template(tree), str(tmp_path))
    assert step == 7
    _assert_equal(tree, restored)
    # the reference's layout: one .npy per leaf keyed by its path + manifest
    ckpt = tmp_path / "step_00000007"
    manifest = json.loads((ckpt / "manifest.json").read_text())
    assert manifest["step"] == 7
    meta = manifest["leaves"]["params/layers/1/a"]
    assert meta["shape"] == [16, 8] and meta["dtype"] == "float32"
    assert os.path.exists(ckpt / meta["shards"][0]["file"])
    assert manifest["leaves"]["params/h"]["dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint({**_template(tree), "opt": {
            "step": torch.zeros(2, dtype=torch.int32)}}, str(tmp_path))


def test_async_checkpointer_matches_sync(tmp_path):
    tree = _tree(1)
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    ck.save(tree, 10)
    ck.wait()
    restored, step = restore_checkpoint(_template(tree), str(tmp_path))
    assert step == 10
    _assert_equal(tree, restored)
    # the snapshot is taken at save(): a later in-place update is not in it
    tree2 = _tree(2)
    saved = tree2["params"]["w"].clone()
    ck.save(tree2, 11)
    tree2["params"]["w"].add_(1.0)
    ck.wait()
    restored, _ = restore_checkpoint(_template(tree), str(tmp_path))
    assert torch.equal(restored["params"]["w"], saved)


def test_gc_keeps_latest(tmp_path):
    tree = _tree(2)
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save(tree, s)
        ck.wait()
    assert latest_step(str(tmp_path)) == 3
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                           "step_00000003"]


def test_straggler_watchdog_flags_outliers():
    wd = StragglerWatchdog(threshold=2.0, warmup=3)
    for s in range(20):
        dt = 1.0 if s != 15 else 5.0
        flagged = wd.observe(s, dt)
        assert flagged == (s == 15)
    assert len(wd.flagged) == 1 and wd.flagged[0][0] == 15


def test_supervisor_restarts_from_checkpoint(tmp_path):
    """Inject a fault mid-run; training resumes from the last checkpoint
    and ends in the same state as an uninterrupted run."""
    def step_fn(state, step):
        return {"x": state["x"] + 1.0}, {"x": float(state["x"])}

    def run(inject):
        base = str(tmp_path / ("f" if inject else "nf"))
        ck = AsyncCheckpointer(base, keep=5)

        def restore():
            return restore_checkpoint({"x": torch.zeros(())}, base,
                                      latest_step(base))

        sup = RestartSupervisor(
            step_fn, ck, restore, ckpt_every=10,
            fault_injector=FaultInjector([25] if inject else []))
        state, end = sup.run({"x": torch.zeros(())}, 0, 40)
        return float(state["x"]), sup.restarts, end

    x_clean, r0, end0 = run(False)
    x_fault, r1, end1 = run(True)
    assert r0 == 0 and r1 == 1
    assert x_clean == 40.0 and end0 == end1 == 40
    # after the restart from the step-20 checkpoint the run still does 40
    assert x_fault == 40.0


def test_launcher_restart_after_injected_fault(tmp_path):
    """``--inject-fault-at 3 --ckpt-every 2``: the launcher restarts from
    the step-2 checkpoint, redoes steps 2 and 3, and its last loss equals
    an uninterrupted run's, bit for bit (the same computation on the
    CPU)."""
    argv = ["--smoke", "--device", "cpu", "--steps", "5", "--batch", "2",
            "--seq", "32", "--log-every", "1"]
    clean = launch.main(argv)
    faulted = launch.main(argv + ["--ckpt-dir", str(tmp_path / "ck"),
                                  "--ckpt-every", "2", "--inject-fault-at",
                                  "3"])
    assert len(clean) == 5
    assert len(faulted) == 6        # step 2 ran twice: before and after
    assert faulted[:3] == clean[:3] and faulted[3:] == clean[2:]
    assert np.isfinite(clean).all()
    assert latest_step(str(tmp_path / "ck")) == 4


def _smoke_train_state(jax):
    """The port's train state of smoke qwen2-0.5b from converted ``repro``
    weights after one step: float32 parameters, bfloat16 AdamW moments,
    an int32 step."""
    from repro.configs import get_config as jax_get_config
    from repro.models.api import init_model as jax_init_model

    over = dict(dtype="float32", param_dtype="float32")
    jparams = jax_init_model(jax.random.PRNGKey(0),
                             jax_get_config("qwen2-0.5b", smoke=True, **over))
    cfg = get_config("qwen2-0.5b", smoke=True, **over)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    opt = adamw(1e-3, moment_dtype="bfloat16")
    tokens = SyntheticLMDataset(cfg.vocab_size, 16, seed=0).batch(0, 2)
    state, _ = build_train_step(cfg, opt)(make_train_state(params, opt),
                                          {"tokens": torch.from_numpy(tokens)})
    dtypes = {t.dtype for t in tree_leaves(state)}
    assert dtypes == {torch.float32, torch.bfloat16, torch.int32}
    return state


def _to_jax(jnp, tree):
    """The same tree as JAX arrays, bfloat16 through its bit patterns."""
    def leaf(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return tree_map(leaf, tree)


def test_repro_checkpoint_restores_in_the_port(tmp_path):
    """``repro.checkpoint.save_checkpoint`` of a converted train state: the
    port writes the same manifest (its leaves in the tree's order, the
    reference's in sorted order) and the same ``.npy`` files byte for
    byte, and restores the reference's files bit-equal, bfloat16 leaves
    included."""
    jax = pytest.importorskip("jax")
    from repro.checkpoint import save_checkpoint as jax_save

    state = _smoke_train_state(jax)
    jax_save(_to_jax(jax.numpy, state), str(tmp_path / "repro"), 3)
    save_checkpoint(state, str(tmp_path / "port"), 3)
    ref, ours = tmp_path / "repro" / "step_00000003", \
        tmp_path / "port" / "step_00000003"
    manifest = json.loads((ref / "manifest.json").read_text())
    assert json.loads((ours / "manifest.json").read_text()) == manifest
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref))
    for name in os.listdir(ref):
        if name.endswith(".npy"):
            assert (ours / name).read_bytes() == (ref / name).read_bytes(), \
                name
    assert manifest["leaves"]["opt/m/layers/0/mix/wq"]["dtype"] == "bfloat16"

    restored, step = restore_checkpoint(_template(state),
                                        str(tmp_path / "repro"))
    assert step == 3
    _assert_equal(state, restored)


def test_port_checkpoint_restores_in_repro(tmp_path):
    """The port's checkpoint through ``repro.checkpoint.restore_checkpoint``
    onto one device: every float32 and int32 leaf bit-equal. The reference
    restores no bfloat16 leaf, its own included (numpy has no cast from
    the stored two-byte voids to bfloat16); the port's bfloat16 files are
    the reference's byte for byte (the test above)."""
    jax = pytest.importorskip("jax")
    from repro.checkpoint import restore_checkpoint as jax_restore

    state = _smoke_train_state(jax)
    save_checkpoint(state, str(tmp_path), 5)
    kept = {"params": state["params"], "opt": {"step": state["opt"]["step"]}}
    shapes = tree_map(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), np.dtype(str(t.dtype).removeprefix("torch."))), kept)
    device = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    restored, step = jax_restore(shapes, tree_map(lambda _: device, kept),
                                 str(tmp_path))
    assert step == 5
    flat = dict(tree_leaves_with_path(kept))
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(restored)[0]:
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        want = flat[key].numpy()
        got = np.asarray(leaf)
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=str(key))
        n += 1
    assert n == len(flat)

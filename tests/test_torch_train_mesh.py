"""The train launcher on a mesh (``repro_torch.launch.train`` under a
process group): qwen2-0.5b's smoke config, float32, ExpMul, at 8 gloo
ranks on ``make_mesh_for_host``'s (4, 2) mesh for three steps of 8 x 40
tokens, from the converted weights of ``repro``'s PRNGKey(0) (a step-0
checkpoint on one device that the launcher restores onto the mesh), with
a checkpoint at step 2 (each rank its shards). Its losses are held within
1e-4 of their values against the one-device launcher and against
``repro``'s jitted train step on the same weights and batches, as
``tests/test_torch_train_launch.py`` holds the launcher. The step-2
checkpoint resumed on 4 ranks ((2, 2)) gives the uninterrupted step 3's
loss within 1e-5. One step on ``make_debug_mesh(2, 4)``, where the 4 / 2
heads divide no 'model' axis of 4, so each rank's flash call takes a
quarter of the queries at its query offset, gives the one-device step's
loss within 1e-6 and its gradients within 1e-5 of their magnitude. At
world 1 the mesh launcher's losses are the one-device launcher's bit for
bit."""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.optim.adamw import adamw as jax_adamw  # noqa: E402
from repro.optim.schedule import cosine_schedule as jax_cosine  # noqa: E402
from repro.train.step import build_train_step as jax_build_step  # noqa: E402
from repro_torch.checkpoint.save import save_checkpoint  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMDataset  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.launch.mesh import host_mesh_shape  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402
from repro_torch.train.step import make_train_state, value_and_grad  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402
from torch_ranks import free_port, run_ranks  # noqa: E402
from torch_training import SEQ, models  # noqa: E402

ARCH, STEPS, BATCH = "qwen2-0.5b", 3, 8
CFG = ('get_config("qwen2-0.5b", smoke=True, dtype="float32", '
       'param_dtype="float32", attention_variant="expmul", '
       'attention_block_k=32)')

_LAUNCH = r"""
from repro_torch.configs import get_config
from repro_torch.launch import train as launch

losses = launch.main(sys.argv[2:], cfg_override=%s)
emit({"losses": losses, "rank": RANK})
""" % CFG

# one group of 8 ranks: the launcher at 8 ranks; then ranks 0-3 as a
# fresh group of 4 resuming its checkpoint; then all 8 as a fresh group
# for one step on make_debug_mesh(2, 4)
_GROUP = r"""
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.core import attention as core
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_debug_mesh, set_mesh
from repro_torch.sharding.layouts import FixedLayouts
from repro_torch.sharding.rules import param_shardings, shard_local
from repro_torch.train.step import value_and_grad
from repro_torch.tree import tree_leaves, tree_unflatten_like

cfg = %s
port4, port8, path_in, path_out = sys.argv[1:5]
argv = sys.argv[5:]
emit({"eight": launch.main(argv, cfg_override=cfg)})
if RANK < 4:
    os.environ.update(WORLD_SIZE="4", MASTER_PORT=port4)
    emit({"four": launch.main(argv, cfg_override=cfg)})

os.environ.update(WORLD_SIZE="8", MASTER_PORT=port8)
dist.init_process_group("gloo")
z = np.load(path_in)
keys = [k for k in z.files if k != "tokens"]
params = {}
for k in keys:                     # "layers/0/mix/wq" -> nested dicts
    parts = k.split("/")
    d = params
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    d[parts[-1]] = torch.from_numpy(z[k])
params["layers"] = [params["layers"][str(i)]
                    for i in range(len(params["layers"]))]
mesh = make_debug_mesh(2, 4, device_type="cpu")
sh = param_shardings(params, mesh)
dparams = tree_unflatten_like(params, [
    shard_local(l, s.spec, mesh) for l, s in zip(tree_leaves(params),
                                                 tree_leaves(sh))])
tokens = shard_local(torch.from_numpy(z["tokens"]), ("data",), mesh)
offsets = set()
apply = core.FlashAttention.apply

def spy(*a):
    offsets.add(a[-1])
    return apply(*a)

core.FlashAttention.apply = spy
with set_mesh(mesh), implicit_replication(), FixedLayouts():
    loss, grads = value_and_grad(dparams, {"tokens": tokens}, cfg)
full = {"loss": np.asarray(loss.full_tensor())}
for (path, g) in zip(keys, tree_leaves(grads)):
    full[path] = g.full_tensor().numpy()
if RANK == 0:
    np.savez(path_out, **full)
emit({"offsets": sorted(offsets), "model": mesh.get_local_rank("model")})
dist.destroy_process_group()
""" % CFG


def _jax_losses(jcfg, jparams):
    """``repro``'s jitted step over STEPS steps of BATCH rows, as
    ``repro.launch.train`` runs it."""
    jopt = jax_adamw(jax_cosine(3e-3, 20, STEPS),
                     moment_dtype=jcfg.opt_state_dtype)
    data = JaxDataset(jcfg.vocab_size, SEQ, seed=0)
    step = jax.jit(jax_build_step(jcfg, jopt))
    state = {"params": jparams, "opt": jopt.init(jparams)}
    losses = []
    for i in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(data.batch(i, BATCH))})
        losses.append(float(m["loss"]))
    return losses


def _argv(ckpt):
    return ["--steps", str(STEPS), "--batch", str(BATCH), "--seq", str(SEQ),
            "--variant", "expmul", "--log-every", "1", "--device", "cpu",
            "--ckpt-dir", str(ckpt), "--ckpt-every", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("train_mesh")
    jcfg, jparams, cfg, params = models(ARCH)
    opt = adamw(cosine_schedule(3e-3, 20, STEPS),
                moment_dtype=cfg.opt_state_dtype)
    save_checkpoint(make_train_state(params, opt), str(base / "mesh"), 0)
    for d in ("one", "world1"):
        shutil.copytree(base / "mesh", base / d)
    tokens = SyntheticLMDataset(cfg.vocab_size, SEQ, seed=0).batch(0, BATCH)
    np.savez(base / "in.npz", tokens=tokens, **{
        "/".join(map(str, p)): leaf.numpy()
        for p, leaf in tree_leaves_with_path(params)})
    group = run_ranks(8, _GROUP, args=[
        free_port(), free_port(), base / "in.npz", base / "out.npz"]
        + _argv(base / "mesh"), init=False, timeout=240)
    (world1,), = run_ranks(1, _LAUNCH, args=["-"] + _argv(base / "world1"),
                           init=False)
    one = launch.main(_argv(base / "one"), cfg_override=cfg)
    return dict(jcfg=jcfg, jparams=jparams, cfg=cfg, params=params,
                tokens=tokens, one=one, world1=world1["losses"],
                eight=[o[0]["eight"] for o in group],
                four=[o[1]["four"] for o in group[:4]],
                split=[o[-1] for o in group],
                grads=dict(np.load(base / "out.npz")),
                steps=sorted(os.listdir(base / "mesh")))


def _close(a, b, tol):
    return np.isfinite(a) and abs(a - b) <= tol * abs(b)


def test_host_mesh_shapes():
    """``make_mesh_for_host``'s shapes are the reference's: (n // 2, 2)
    from 4 ranks up, else (n, 1)."""
    assert [host_mesh_shape(n) for n in (1, 2, 4, 8, 16)] == [
        (1, 1), (2, 1), (2, 2), (4, 2), (8, 2)]


def test_mesh_launcher_matches_one_device_and_repro(runs):
    eight, one = runs["eight"], runs["one"]
    want = _jax_losses(runs["jcfg"], runs["jparams"])
    assert len(one) == len(want) == STEPS
    for losses in eight:          # every rank returns the same losses
        assert losses == eight[0]
    for got, a, b in zip(eight[0], one, want):
        assert _close(got, a, 1e-4) and _close(got, b, 1e-4), (
            eight[0], one, want)
    # the mesh run wrote its step-2 checkpoint beside the step-0 one
    assert runs["steps"] == ["step_00000000", "step_00000002"]


def test_world_one_mesh_launcher_is_the_one_device_launcher(runs):
    """At world 1 (a (1, 1) mesh, as one card runs it) every collective is
    over one rank and each rank's op the one-device op: the losses are the
    one-device launcher's bit for bit."""
    assert runs["world1"] == runs["one"]


def test_mesh_checkpoint_resumes_on_four_ranks(runs):
    four, eight = runs["four"], runs["eight"][0]
    for losses in four:           # the resumed run takes step 3 alone
        assert len(losses) == 1
        assert _close(losses[0], eight[2], 1e-5), (losses, eight)


def test_query_split_step_matches_one_device(runs):
    cfg, params, tokens = runs["cfg"], runs["params"], runs["tokens"]
    for rec in runs["split"]:     # each rank's flash at its rows' offset
        assert rec["offsets"] == [rec["model"] * SEQ // 4]
    got = runs["grads"]
    loss, grads = value_and_grad(params, {"tokens": torch.from_numpy(tokens)},
                                 cfg)
    assert abs(float(got["loss"]) - float(loss)) <= 1e-6 * abs(float(loss))
    for path, g in tree_leaves_with_path(grads):
        k = "/".join(map(str, path))
        ref = g.numpy().astype(np.float64)
        err = np.max(np.abs(got[k] - ref)) / max(np.max(np.abs(ref)), 1e-30)
        assert err <= 1e-5, (k, err)

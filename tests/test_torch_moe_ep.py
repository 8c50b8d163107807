"""The expert-parallel ``balanced`` MoE dispatch on real ranks
(``layers/moe.py:_expert_ffn_ep``): arctic-480b's and kimi-k2-1t-a32b's
smoke configs on 8 gloo ranks over a (4, 2) (data, model) mesh, the layer's
weights sharded by the port's rules (experts over 'model', d_model over
'data') and gathered as the layer gathers them, the tokens over 'data'
(14 copies a rank, so a rank's copies start mid-way through the experts'
round: 2 of arctic's 4, 6, 4 and 2 of kimi's 8). The output of
``moe_apply(impl="balanced")`` and the gradients of ``sum(y * r)`` with
respect to every weight and to x are held against the port's one-device
``balanced`` path and against ``repro``'s ``moe_apply(impl="balanced")``
off a mesh (``jax.value_and_grad``), on converted weights in float32: the
outputs within 1e-6 of their magnitude, as ``tests/test_torch_moe.py``
holds the layer, the gradients within 1e-5 (the weight gradients are
summed over the ranks' tokens by a reduce-scatter, in another order).

A second group runs kimi's smoke config with 12 experts on 6 ranks over a
(3, 2) mesh: the (C, E, d) buffer's E * C = 12 * 512 rows split into
shares of 2,048, not a multiple of 12, so each rank's zero rows before
its copies depend on its share as well as on its copies
(``sharding/regions.py:pad_rows``); it is held as the first group is."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.layers import moe as jmoe  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.layers import moe  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402

ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
F32 = dict(dtype="float32", param_dtype="float32")
OUT_TOL, GRAD_TOL = 1e-6, 1e-5

_SCRIPT = r"""
import dataclasses
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.launch.mesh import set_mesh
from repro_torch.layers.moe import moe_apply
from repro_torch.sharding.layouts import FixedLayouts
from repro_torch.sharding.rules import param_shardings, shard_local
from repro_torch.tree import tree_leaves, tree_unflatten_like

shape = tuple(int(n) for n in sys.argv[1].split("x"))
mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
runs = [sys.argv[i:i + 4] for i in range(2, len(sys.argv), 4)]
for arch, experts, path, out_path in runs:
    z = np.load(path)
    cfg = get_config(arch, smoke=True, dtype="float32",
                     param_dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=int(experts)))
    names = [k for k in z.files if k.startswith("ffn/")]
    ffn = {}
    for k in names:          # "ffn/dense/w_up" -> ffn["dense"]["w_up"]
        d, parts = ffn, k.split("/")[1:]
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = torch.from_numpy(z[k])
    tree = {"layers": [{"ffn": ffn}]}
    sh = param_shardings(tree, mesh)
    tree = tree_unflatten_like(tree, [
        shard_local(l, s.spec, mesh).requires_grad_(True)
        for l, s in zip(tree_leaves(tree), tree_leaves(sh))])
    x = shard_local(torch.from_numpy(z["x"]), ("data",), mesh)
    x.requires_grad_(True)
    r = shard_local(torch.from_numpy(z["r"]), ("data",), mesh)
    with set_mesh(mesh), implicit_replication(), FixedLayouts():
        y = moe_apply(tree["layers"][0]["ffn"], x, cfg, impl="balanced")
        loss = torch.sum(y * r)
        leaves = tree_leaves(tree) + [x]
        grads = torch.autograd.grad(loss, leaves)
    out = {"y": y.full_tensor().detach().numpy(),
           "dx": grads[-1].full_tensor().numpy()}
    for k, g in zip(names, grads[:-1]):
        out["d" + k] = g.full_tensor().numpy()
    if RANK == 0:
        np.savez(out_path, **out)
    emit({"arch": arch, "placements": {
        k: [str(p) for p in l.placements]
        for k, l in zip(names, tree_leaves(tree))}})
dist.destroy_process_group()
"""


def _experts(cfg, n):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=n or cfg.moe.num_experts))


def _layer(arch, experts=0):
    """(jax cfg, jax ffn params of layer 0, port cfg, port ffn params), at
    ``experts`` experts (0: the config's)."""
    jcfg = _experts(jax_get_config(arch, smoke=True, **F32), experts)
    cfg = _experts(get_config(arch, smoke=True, **F32), experts)
    params = japi.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    jffn = jax.tree.map(lambda a: a[0], params["units"][0]["ffn"])
    return jcfg, jffn, cfg, tparams["layers"][0]["ffn"]


def _inputs(cfg, batch=4):
    rng = np.random.default_rng(3)
    shape = (batch, 7, cfg.d_model)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _run_group(d, ranks, mesh, cases):
    """Each (arch, experts, batch) of ``cases`` through ``moe_apply`` on
    ``ranks`` gloo ranks over a ``mesh`` (data, model) mesh: (the layers
    and inputs by case, rank 0's outputs by case, every rank's records)."""
    args, layers = [mesh], {}
    for case in cases:
        arch, experts, batch = case
        jcfg, jffn, cfg, ffn = _layer(arch, experts)
        x, r = _inputs(cfg, batch)
        arrays = {"ffn/" + "/".join(p): leaf.numpy()
                  for p, leaf in tree_leaves_with_path(ffn)}
        name = f"{arch}-{cfg.moe.num_experts}"
        np.savez(d / f"{name}.npz", x=x, r=r, **arrays)
        args += [arch, cfg.moe.num_experts, d / f"{name}.npz",
                 d / f"{name}.out.npz"]
        layers[case] = (jcfg, jffn, cfg, ffn, x, r, d / f"{name}.out.npz")
    outs = run_ranks(ranks, _SCRIPT, args=args, timeout=180)
    got = {case: dict(np.load(layers[case][-1])) for case in cases}
    return {c: v[:-1] for c, v in layers.items()}, got, outs


# 12 experts on a (3, 2) mesh: a share of 12 * 512 / 3 = 2,048 rows
UNEVEN = ("kimi-k2-1t-a32b", 12, 6)


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    layers, got, outs = _run_group(tmp_path_factory.mktemp("moe_ep"), 8,
                                   "4x2", [(a, 0, 4) for a in ARCHS])
    return ({a: layers[(a, 0, 4)] for a in ARCHS},
            {a: got[(a, 0, 4)] for a in ARCHS}, outs)


@pytest.fixture(scope="module")
def ep_run_uneven(tmp_path_factory):
    layers, got, _ = _run_group(tmp_path_factory.mktemp("moe_ep_uneven"), 6,
                                "3x2", [UNEVEN])
    return layers[UNEVEN], got[UNEVEN]


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _port_one_device(cfg, ffn, x, r):
    leaves = [(p, leaf.clone().requires_grad_(True))
              for p, leaf in tree_leaves_with_path(ffn)]
    tree = {}
    for p, leaf in leaves:
        d = tree
        for k in p[:-1]:
            d = d.setdefault(k, {})
        d[p[-1]] = leaf
    xt = torch.from_numpy(x).requires_grad_(True)
    y = moe.moe_apply(tree, xt, cfg, impl="balanced")
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(r)),
                                [leaf for _, leaf in leaves] + [xt])
    out = {"y": y.detach().numpy(), "dx": grads[-1].numpy()}
    for (p, _), g in zip(leaves, grads[:-1]):
        out["dffn/" + "/".join(p)] = g.numpy()
    return out


def _repro(jcfg, jffn, x, r):
    def f(p, xx):
        y = jmoe.moe_apply(p, xx, jcfg, impl="balanced")
        return jnp.sum(y * jnp.asarray(r)), y

    (_, y), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jffn, jnp.asarray(x))
    out = {"y": np.asarray(y), "dx": np.asarray(gx)}
    for path, g in jax.tree_util.tree_flatten_with_path(gp)[0]:
        out["dffn/" + "/".join(k.key for k in path)] = np.asarray(g)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_weights_enter_sharded_over_experts_and_fsdp(ep_runs, arch):
    _, _, outs = ep_runs
    for recs in outs:
        (pl,) = [rec["placements"] for rec in recs if rec["arch"] == arch]
        # (E, d, f): experts over 'model', d_model over 'data'
        assert pl["ffn/w_up"] == ["S(1)", "S(0)"]
        assert pl["ffn/w_down"] == ["S(2)", "S(0)"]


def _check(layer, got, against):
    jcfg, jffn, cfg, ffn, x, r = layer
    want = (_port_one_device(cfg, ffn, x, r) if against == "port"
            else _repro(jcfg, jffn, x, r))
    assert set(want) == set(got)
    assert _rel(got["y"], want["y"]) <= OUT_TOL
    for k in want:
        if k != "y":
            assert np.isfinite(got[k]).all()
            assert _rel(got[k], want[k]) <= GRAD_TOL, k


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("against", ["port", "repro"])
def test_ep_balanced_matches_off_mesh(ep_runs, arch, against):
    layers, got, _ = ep_runs
    _check(layers[arch], got[arch], against)


@pytest.mark.parametrize("against", ["port", "repro"])
def test_ep_balanced_matches_where_a_share_is_not_whole_rounds(
        ep_run_uneven, against):
    layer, got = ep_run_uneven
    _check(layer, got, against)

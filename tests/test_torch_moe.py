"""The mixture-of-experts archs in the port, arctic-480b (128 experts,
top-2, a dense SwiGLU residual in parallel, an untied head, head dim 128)
and kimi-k2-1t-a32b (384 experts, top-8, no residual, head dim 112), held
against ``repro`` on converted weights in float32.

The config and its accounting (``param_count``, ``active_param_count``,
``analytic_prefill_flops``) equal ``repro``'s, full and smoke. The layer
(``layers/moe.py``) against ``repro.layers.moe``: the ``scatter`` dispatch
serving runs, at the configs' capacity factor and at 0.5, where copies are
dropped; the no-mesh ``balanced`` dispatch; the dense oracle ``moe_ref``;
routing ties and an all-NaN token (the same expert ids as
``jax.lax.top_k``, the other tokens' outputs equal to ``repro``'s). Then
the untied head and the converter, and the slice: prefill and decode tick
logits (``test_torch_model.py``'s walks at its ``SAME_WALK_TOL``) and
temp-0 engine streams (``test_torch_engine.py``'s) against ``repro`` at
``attention_impl="pallas"``. Every row of a tick routes through the MoE,
idle and padding rows too, and takes expert capacity: the streams match
only because the port feeds it the same rows. Kimi's head dim, 112, passes
the serving kernels' checks, and a narrowed kimi (8 / 1 heads of 112, 16
experts top-8) emits ``repro``'s temp-0 streams on both layouts.

The expert GEMMs and the router sum in another order than XLA's, so
outputs are held within 1e-6 of their magnitude (measured: under 4e-7).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.layers import embedding as jembedding  # noqa: E402
from repro.layers import moe as jmoe  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serve.engine import analytic_prefill_flops as jax_flops  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.decode import decode  # noqa: E402
from repro_torch.kernels.flash import prefill  # noqa: E402
from repro_torch.layers import embedding, moe  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.serve.engine import analytic_prefill_flops  # noqa: E402
from test_torch_engine import contiguous_streams, paged_streams  # noqa: E402
from test_torch_model import contiguous_ticks, paged_ticks  # noqa: E402

ARCTIC, KIMI = "arctic-480b", "kimi-k2-1t-a32b"
F32 = dict(dtype="float32", param_dtype="float32")
TOL = 1e-6


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _layer(arch, capacity_factor=None, seed=0):
    """(jax cfg, jax ffn params of layer 0, port cfg, port ffn params)."""
    jcfg = jax_get_config(arch, smoke=True, **F32)
    cfg = get_config(arch, smoke=True, **F32)
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    params = japi.init_model(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    jffn = jax.tree.map(lambda a: a[0], params["units"][0]["ffn"])
    return jcfg, jffn, cfg, tparams["layers"][0]["ffn"]


@pytest.mark.parametrize("arch", [ARCTIC, KIMI])
def test_config_matches_repro(arch):
    assert arch in ARCH_IDS
    for smoke in (False, True):
        cfg, jcfg = get_config(arch, smoke=smoke), jax_get_config(
            arch, smoke=smoke)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab_size", "activation", "tie_embeddings",
                  "rope_base"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        for f in ("num_experts", "top_k", "d_ff", "dense_residual",
                  "dense_d_ff", "capacity_factor", "router_dtype"):
            assert getattr(cfg.moe, f) == getattr(jcfg.moe, f), f
        assert cfg.resolved_head_dim() == jcfg.resolved_head_dim()
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.active_param_count() < cfg.param_count()
        assert (analytic_prefill_flops(cfg, 100, 356)
                == jax_flops(jcfg, 100, 356))
    full = get_config(arch)
    if arch == ARCTIC:
        assert full.resolved_head_dim() == 128
        assert full.param_count() == 476_850_275_328
        assert full.replace(num_layers=2).param_count() == 27_681_131_520
        # a prefilled token is priced at the active parameters, ~30x fewer
        assert full.param_count() > 30 * full.active_param_count()
    else:
        assert full.resolved_head_dim() == 112


@pytest.mark.parametrize("arch", [ARCTIC, KIMI])
@pytest.mark.parametrize("impl", ["scatter", "balanced"])
@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_apply_matches_repro(arch, impl, capacity_factor):
    jcfg, jffn, cfg, ffn = _layer(arch, capacity_factor)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, cfg.d_model)).astype(np.float32)
    ref = np.asarray(jmoe.moe_apply(jffn, jnp.asarray(x), jcfg, impl=impl))
    got = moe.moe_apply(ffn, torch.from_numpy(x), cfg, impl=impl).numpy()
    assert got.shape == x.shape and np.isfinite(got).all()
    assert _rel(got, ref) <= TOL
    if impl == "scatter" and capacity_factor is not None:
        # copies were really dropped, and that moved the output
        T, m = 21, cfg.moe
        _, ids = moe.route(ffn, torch.from_numpy(x.reshape(T, -1)), m)
        _, keep = moe.dispatch(ids, m.num_experts, moe.capacity(T, m))
        assert 0 < int(keep.sum()) < T * m.top_k
        full = moe.moe_apply(_layer(arch)[3], torch.from_numpy(x),
                             get_config(arch, smoke=True, **F32)).numpy()
        assert _rel(got, full) > 1e-3


@pytest.mark.parametrize("arch", [ARCTIC, KIMI])
def test_moe_ref_matches_repro(arch):
    jcfg, jffn, cfg, ffn = _layer(arch)
    x = np.random.default_rng(1).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    ref = np.asarray(jmoe.moe_ref(jffn, jnp.asarray(x), jcfg))
    got = moe.moe_ref(ffn, torch.from_numpy(x), cfg).numpy()
    assert _rel(got, ref) <= TOL
    # the dense oracle and the scatter agree where nothing is dropped
    big = dataclasses.replace(cfg.moe, capacity_factor=float(
        cfg.moe.num_experts))
    scat = moe.moe_apply(ffn, torch.from_numpy(x), cfg.replace(moe=big))
    assert _rel(scat.numpy(), got) <= TOL


def test_top_k_matches_jax_on_ties_nan_and_inf():
    """``torch.topk`` picks other ids on ties and on an all-NaN row; the
    stable sort picks ``jax.lax.top_k``'s."""
    nan, inf = float("nan"), float("inf")
    rows = np.array([[1, 1, 0.2, 1], [nan] * 4, [inf, 0.5, -inf, inf],
                     [-inf, -inf, 0.3, -inf], [0.1, 0.7, 0.7, 0.7]],
                    np.float32)
    wide = np.round(np.random.default_rng(2).standard_normal((64, 16)) * 2
                    ) / 2
    wide[3] = nan
    for x in (rows, wide.astype(np.float32)):
        for k in (1, 2, 3):
            ref_w, ref_ids = jax.lax.top_k(jnp.asarray(x), k)
            got_w, got_ids = moe.top_k(torch.from_numpy(x), k)
            np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ref_ids))
            np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref_w))
    assert moe.top_k(torch.from_numpy(rows), 2)[1][:2].tolist() == [[0, 1],
                                                                    [0, 1]]


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_tie_and_nan_tokens_route_as_repro(capacity_factor):
    """A router whose columns 0, 1 and 3 are equal ties every token
    between those experts; one token is all NaN. The ids equal
    ``repro``'s, the NaN token's output is NaN on both sides, and every
    other token's output equals ``repro``'s."""
    jcfg, jffn, cfg, ffn = _layer(ARCTIC, capacity_factor, seed=3)
    router = np.asarray(jffn["router"]).copy()
    router[:, 1] = router[:, 0]
    router[:, 3] = router[:, 0]
    jffn = dict(jffn, router=jnp.asarray(router))
    ffn = dict(ffn, router=torch.from_numpy(router))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    x[1, 2] = np.nan
    x2 = x.reshape(12, -1)
    _, ref_ids = jmoe._route(jffn, jnp.asarray(x2), jcfg.moe)
    _, ids = moe.route(ffn, torch.from_numpy(x2), cfg.moe)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    assert torch.topk(moe.router_logits(ffn, torch.from_numpy(x2)),
                      2).indices[8].tolist() != ids[8].tolist()
    ref = np.asarray(jmoe.moe_apply(jffn, jnp.asarray(x), jcfg))
    got = moe.moe_apply(ffn, torch.from_numpy(x), cfg).numpy()
    nan = ~np.isfinite(ref).all(-1)
    np.testing.assert_array_equal(~np.isfinite(got).all(-1), nan)
    assert nan[1, 2] and nan.sum() == 1
    assert _rel(got[~nan], ref[~nan]) <= TOL


def test_untied_head_and_convert_match_repro():
    jcfg = jax_get_config(ARCTIC, smoke=True, **F32)
    cfg = get_config(ARCTIC, smoke=True, **F32)
    params = japi.init_model(jax.random.PRNGKey(5), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    out = tparams["embed"]["out"]
    assert tuple(out.shape) == (cfg.d_model, cfg.vocab_size)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(params["embed"]["out"]))
    ffn = tparams["layers"][1]["ffn"]
    assert tuple(ffn["w_up"].shape) == (4, 64, 32)
    assert tuple(ffn["dense"]["w_down"].shape) == (32, 64)
    np.testing.assert_array_equal(
        ffn["w_gate"].numpy(),
        np.asarray(params["units"][0]["ffn"]["w_gate"][1]))
    x = np.random.default_rng(6).standard_normal((3, cfg.d_model)).astype(
        np.float32)
    ref = np.asarray(jembedding.logits_apply(
        params["embed"], jnp.asarray(x), jcfg))
    got = embedding.logits_apply(tparams["embed"], torch.from_numpy(x), cfg)
    assert _rel(got.numpy(), ref) <= TOL
    # the tied head of the same table is another function
    tied = embedding.logits_apply(tparams["embed"], torch.from_numpy(x),
                                  cfg.replace(tie_embeddings=True))
    assert tied.shape == got.shape and _rel(tied.numpy(), ref) > 1e-2


@pytest.mark.parametrize("arch", [ARCTIC, KIMI])
def test_init_model_matches_repro_shapes_and_count(arch):
    cfg = get_config(arch, smoke=True, **F32)
    ours = tapi.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    ref = japi.init_model(jax.random.PRNGKey(0),
                          jax_get_config(arch, smoke=True, **F32))
    assert tuple(ours["embed"]["out"].shape) == ref["embed"]["out"].shape
    ffn, jffn = ours["layers"][1]["ffn"], ref["units"][0]["ffn"]
    assert sorted(ffn) == sorted(jffn)
    for name, leaf in jax.tree_util.tree_leaves_with_path(jffn):
        path = [k.key for k in name]
        t = ffn
        for k in path:
            t = t[k]
        assert tuple(t.shape) == leaf.shape[1:], path
    assert sum(t.numel() for t in jax.tree.leaves(ours)) == cfg.param_count()
    # an expert stack is drawn in blocks of slabs at the reference's fan-in std
    # (E * d): the whole stack's spread, not one slab's
    std = float(ffn["w_up"].std())
    fan_in = cfg.moe.num_experts * cfg.d_model
    assert abs(std - 0.88 / fan_in ** 0.5) < 0.1 / fan_in ** 0.5


@pytest.mark.parametrize("arch,layout,variant,kv_dtype", [
    (ARCTIC, "paged", "expmul", "int8"), (ARCTIC, "paged", "exact", "int8"),
    (ARCTIC, "contiguous", "expmul", "fp32"),
    (KIMI, "paged", "expmul", "int8")])
def test_ticks_match_repro(arch, layout, variant, kv_dtype):
    if layout == "paged":
        paged_ticks(variant, kv_dtype, arch=arch)
    else:
        contiguous_ticks(variant, kv_dtype, None, 24, ([5, 0, 3], [4, 0, 2]),
                         arch=arch)


@pytest.mark.parametrize("arch,layout,variant,kv_dtype", [
    (ARCTIC, "paged", "expmul", "int8"),
    (ARCTIC, "contiguous", "expmul", "fp32"),
    (ARCTIC, "contiguous", "exact", "fp32"),
    (KIMI, "contiguous", "expmul", "fp32")])
def test_temp0_streams_match_repro_engine(arch, layout, variant, kv_dtype):
    if layout == "paged":
        paged_streams(variant, kv_dtype, arch=arch)
    else:
        contiguous_streams(variant, kv_dtype, arch=arch)


# kimi-k2-1t-a32b narrowed, keeping its head dim (896 / 8 = 112) and a GQA
# group of 8, over 16 experts at top-8
KIMI_NARROW = dict(num_layers=2, d_model=896, num_heads=8, num_kv_heads=1,
                   vocab_size=256,
                   moe=dict(num_experts=16, top_k=8, d_ff=64))


@pytest.mark.parametrize("layout,kv_dtype", [("paged", "int8"),
                                             ("contiguous", "fp32")])
def test_kimi_head_dim_112_streams_match_repro_engine(layout, kv_dtype):
    """Kimi at its head dim (8 / 1 heads of 112, 16 experts top-8): the
    temp-0 streams equal ``repro``'s engine at ``attention_impl="pallas"``,
    its Pallas kernels at D 112 in interpret mode."""
    run = paged_streams if layout == "paged" else contiguous_streams
    run("expmul", kv_dtype, arch=KIMI, narrow=KIMI_NARROW)


def test_kimi_head_dim_112_passes_the_checks_and_80_is_refused():
    """Kimi's full width, 64 / 8 heads of 112: the contiguous kernels'
    ``check_head_dims`` and the paged kernels' checks pass for every KV
    dtype, on operands shaped as a tick would give them; so do 80 (phi-2's
    head dim, which the kernels once refused: every head dim up to 256 is
    taken now), and 257, past the kernels' limit, raises before any
    launch."""
    cfg = get_config(KIMI)
    D, Hkv, group = cfg.resolved_head_dim(), cfg.num_kv_heads, 8
    assert D == 112 and decode.MAX_HEAD_DIM == 256
    B, ps, nblk, C = 2, 16, 8, 4
    bt = torch.zeros((B, 4), dtype=torch.int32)
    lens = torch.tensor([5, 9], dtype=torch.int32)

    def checks(d, dt):
        codes = dt in decode.CODE_DTYPES
        pool = torch.zeros((nblk, ps, Hkv, d)).to(dt)
        spool = torch.zeros((nblk, ps, Hkv)) if codes else None
        chunk = torch.zeros((B * Hkv, C, d)).to(dt)
        schunk = torch.zeros((B * Hkv, C)) if codes else None
        for name in ("decode", "prefill"):
            decode.check_head_dims(name, d, d)
        decode._check(bt, lens, torch.zeros((B * Hkv, group, d)), pool, pool,
                      spool, spool, ps, Hkv)
        prefill._check(bt, lens, lens, torch.zeros((B * Hkv * group, C, d)),
                       pool, pool, chunk, chunk, spool, spool, schunk, schunk,
                       ps, Hkv * group, Hkv)

    for dt in decode.KV_DTYPES:
        checks(D, dt)
        checks(80, dt)
        with pytest.raises(ValueError, match="outside"):
            checks(257, dt)

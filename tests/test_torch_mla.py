"""minicpm3-4b (multi-head latent attention) in the port, held against
``repro`` on converted weights.

The config and its accounting (``param_count``, ``kv_token_bytes``,
``attn_kv_geometry``, ``analytic_prefill_flops``) equal ``repro``'s, full
and smoke. On the smoke config (qk 8 + 8 = 16, v 12: Dq != Dv) in
float32: the full-sequence forward against ``repro``'s at
``attention_impl="flash_jnp"`` (its Pallas flash kernel takes Dq == Dv
only, so ``repro`` runs MLA's forward there); every prefill and decode
tick's logits, and the latent caches after them, on contiguous and paged
layouts at fp32 and int8 latents, within ``test_torch_model.py``'s
``SAME_WALK_TOL``; and temp-0 ``ServeEngine`` streams equal to ``repro``'s
engine, exact and ExpMul, paged int8 and contiguous fp32 — ``repro`` at
``attention_impl="pallas"`` throughout (its Pallas kernels in interpret
mode). Both layouts run only the contiguous kernels' plain versions: an
MLA pool holds latents, which each tick gathers and expands. Then the
converter's nested norm leaves, and ``copy_paged_block`` /
``poison_paged_block`` on latent pools.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.costs import attn_kv_geometry as jax_geometry  # noqa: E402
from repro.layers import mla as jmla  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.engine import analytic_prefill_flops as jax_flops  # noqa: E402
from repro.serve.paged import kv_token_bytes as jax_token_bytes  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.costs import attn_kv_geometry  # noqa: E402
from repro_torch.layers import mla  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    ServeEngine,
    analytic_prefill_flops,
)
from repro_torch.serve.paged import kv_token_bytes  # noqa: E402
from test_torch_model import SAME_WALK_TOL  # noqa: E402

ARCH = "minicpm3-4b"
PS, NBLK, MB = 4, 14, 6
ENGINE = dict(slots=3, max_len=48, chunk_size=8)


def _models(variant, kv_dtype="fp32", impl="pallas"):
    over = dict(dtype="float32", param_dtype="float32",
                attention_variant=variant, kv_dtype=kv_dtype)
    jcfg = jax_get_config(ARCH, smoke=True, attention_impl=impl, **over)
    params = japi.init_model(jax.random.PRNGKey(0), jcfg)
    tcfg = get_config(ARCH, smoke=True, **over)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return jcfg, params, tcfg, tparams


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref))
                 / np.max(np.abs(ref)))


def _latents(c, kv_dtype):
    """A cache's or pool's latents as float32 (dequantized for codes)."""
    out = []
    for name in ("kv_lat", "k_rope"):
        x = np.asarray(c[name]).astype(np.float32)
        if kv_dtype != "fp32":
            x = x * np.asarray(c[f"{name}_scale"])[..., None]
        out.append(x)
    return out


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_and_accounting_match_repro(smoke):
    assert ARCH in ARCH_IDS
    cfg, jcfg = get_config(ARCH, smoke=smoke), jax_get_config(ARCH,
                                                              smoke=smoke)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "activation", "qkv_bias", "tie_embeddings",
              "scale_embeddings", "rope_base", "dtype"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert dataclasses.asdict(cfg.mla) == dataclasses.asdict(jcfg.mla)
    assert cfg.param_count() == jcfg.param_count()
    for kv_dtype in ("fp32", "int8", "fp8"):
        assert (kv_token_bytes(cfg, kv_dtype)
                == jax_token_bytes(jcfg, kv_dtype)), kv_dtype
    assert attn_kv_geometry(cfg) == jax_geometry(jcfg)
    for start, end in ((0, 1), (100, 356), (0, 4096)):
        assert (analytic_prefill_flops(cfg, start, end)
                == jax_flops(jcfg, start, end))
    if not smoke:
        assert cfg.param_count() == 4_073_812_480
        # bf16 latents: (256 + 32) x 2 B, or int8 codes plus two f32
        # scales, per layer, against 40 x (96 + 64) x 2 B of expanded K/V
        assert kv_token_bytes(cfg, "int8") == 18_352
        assert kv_token_bytes(cfg, "fp32") == 35_712
        assert attn_kv_geometry(cfg)["d_qk"] == 96
        # resolved_head_dim is d_model / H, neither of MLA's head dims
        assert cfg.resolved_head_dim() == 64


def test_convert_keeps_nested_norm_leaves():
    _, params, tcfg, tparams = _models("exact")
    ref = params["units"][0]["mix"]
    for i, layer in enumerate(tparams["layers"]):
        mix = layer["mix"]
        assert set(mix) == set(ref)
        for norm in ("q_norm", "kv_norm"):
            assert set(mix[norm]) == {"scale"}
            np.testing.assert_array_equal(mix[norm]["scale"].numpy(),
                                          np.asarray(ref[norm]["scale"][i]))
        for name in ("w_dq", "w_uq", "w_dkv", "w_ukv", "wo"):
            np.testing.assert_array_equal(mix[name].numpy(),
                                          np.asarray(ref[name][i]))
    m, H = tcfg.mla, tcfg.num_heads
    assert tuple(tparams["layers"][0]["mix"]["w_ukv"].shape) == (
        m.kv_lora_rank, H, m.qk_nope_dim + m.v_head_dim)


def test_init_model_shapes_match_repro():
    cfg = get_config(ARCH, smoke=True, dtype="float32", param_dtype="float32")
    ours = tapi.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, params, _, _ = _models("exact")
    ref = params["units"][0]["mix"]
    mix = ours["layers"][0]["mix"]
    for name in ("w_dq", "w_uq", "w_dkv", "w_ukv", "wo"):
        assert tuple(mix[name].shape) == tuple(ref[name].shape[1:]), name
    assert tuple(mix["q_norm"]["scale"].shape) == (cfg.mla.q_lora_rank,)
    # param_count leaves out MLA's two latent norms, as repro's does
    norms = cfg.num_layers * (cfg.mla.q_lora_rank + cfg.mla.kv_lora_rank)
    assert sum(t.numel() for t in jax.tree.leaves(ours)) \
        == cfg.param_count() + norms
    assert sum(a.size for a in jax.tree.leaves(params)) \
        == cfg.param_count() + norms


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_mla_apply_and_forward_match_repro(variant):
    """The layer and the whole forward over the sequence, against
    ``repro`` at ``flash_jnp``: the same math in another summation order
    (float32), held at 1e-5 of the output's magnitude."""
    jcfg, params, tcfg, tparams = _models(variant, impl="flash_jnp")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[1], params["units"][0]["mix"])
    ref = jmla.mla_apply(lp, jnp.asarray(x), jcfg)
    got = mla.mla_apply(tparams["layers"][1]["mix"], torch.from_numpy(x),
                        tcfg)
    assert tuple(got.shape) == x.shape
    assert _rel(got.detach().numpy(), ref) <= 1e-5
    toks = rng.integers(1, tcfg.vocab_size, (2, 40)).astype(np.int32)
    ref = japi.forward(params, {"tokens": jnp.asarray(toks)}, jcfg)
    got = tapi.forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert _rel(got.detach().numpy(), ref) <= 1e-5


def test_mla_forward_has_gradients():
    _, _, tcfg, tparams = _models("expmul", impl="flash_jnp")
    for p in tparams["layers"][0]["mix"].values():
        for t in (p.values() if isinstance(p, dict) else [p]):
            t.requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, tcfg.vocab_size, (2, 24)).astype(np.int32))
    tapi.loss_fn(tparams, {"tokens": toks}, tcfg).backward()
    g = tparams["layers"][0]["mix"]["w_ukv"].grad
    assert g is not None and bool(torch.isfinite(g).all())
    assert float(g.abs().max()) > 0


def _walk(layout, variant, kv_dtype):
    """Two prefill chunks (rows 0 and 2 ragged, row 1 idle), then two
    decodes, on both sides; every tick's logits on the active rows, then
    the latents, are compared."""
    jcfg, params, tcfg, tparams = _models(variant, kv_dtype)
    rng = np.random.default_rng(0)
    B, C = 3, 5
    paged = layout == "paged"
    if paged:
        perm = list(rng.permutation(NBLK))
        bt = np.full((B, MB), NBLK, np.int32)
        for b, n in ((0, 4), (2, 3)):
            for i in range(n):
                bt[b, i] = perm.pop()
        jstate = japi.init_paged_state(jcfg, B, NBLK, PS)
        tstate = tapi.init_paged_state(tcfg, B, NBLK, PS, device="cpu")
        jkw, tkw = (dict(page_size=PS), dict(page_size=PS))
        jt, tt = (jnp.asarray(bt),), (torch.from_numpy(bt),)
    else:
        jstate = japi.init_decode_state(jcfg, B, 24)
        tstate = tapi.init_decode_state(tcfg, B, 24, device="cpu")
        jkw, tkw, jt, tt = {}, {}, (), ()
    jpre = japi.prefill_paged if paged else japi.prefill
    tpre = tapi.prefill_paged if paged else tapi.prefill
    jdec = japi.decode_step_paged if paged else japi.decode_step
    tdec = tapi.decode_step_paged if paged else tapi.decode_step
    tol = SAME_WALK_TOL[kv_dtype]
    lens = np.zeros(B, np.int32)
    before = dict(build.COUNTS)
    for nv in ([5, 0, 3], [4, 0, 2]):
        toks = rng.integers(1, tcfg.vocab_size, (B, C)).astype(np.int32)
        nv = np.asarray(nv, np.int32)
        jl, jstate = jpre(params, jstate, jnp.asarray(toks),
                          jnp.asarray(lens), jnp.asarray(nv), *jt, jcfg,
                          **jkw)
        tl, tstate = tpre(tparams, tstate, torch.from_numpy(toks),
                          torch.from_numpy(lens), torch.from_numpy(nv), *tt,
                          tcfg, **tkw)
        rows = nv > 0
        assert _rel(tl.numpy()[rows], np.asarray(jl)[rows]) <= tol
        lens = lens + nv
    for _ in range(2):
        tok = rng.integers(1, tcfg.vocab_size, (B,)).astype(np.int32)
        jl, jstate = jdec(params, jstate, jnp.asarray(tok),
                          jnp.asarray(lens), *jt, jcfg, **jkw)
        tl, tstate = tdec(tparams, tstate, torch.from_numpy(tok),
                          torch.from_numpy(lens), *tt, tcfg, **tkw)
        assert _rel(tl.numpy()[[0, 2]], np.asarray(jl)[[0, 2]]) <= tol
        lens = lens + np.array([1, 0, 1], np.int32)
    # the latents hold what repro wrote (int8 codes may differ by one step
    # where a projection rounds differently, so compare dequantized rows)
    jc = jstate["caches"][0]
    for layer, tc in enumerate(tstate["caches"]):
        ref = _latents({k: v[layer] for k, v in jc.items()}, kv_dtype)
        got = _latents({k: v.numpy() for k, v in tc.items()}, kv_dtype)
        for a, b in zip(got, ref):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=5e-2 if kv_dtype != "fp32"
                                       else 1e-5)
    # an MLA layer runs the contiguous kernels (their plain versions on the
    # CPU) on either layout, never a paged kernel, never a launch
    ran = {k: build.COUNTS[k] - before.get(k, 0) for k in build.COUNTS}
    assert ran.get("prefill_plain") == 2 * tcfg.num_layers
    assert ran.get("decode_plain") == 2 * tcfg.num_layers
    assert not any(n for k, n in ran.items()
                   if k not in ("prefill_plain", "decode_plain"))


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_ticks_match_repro(layout, kv_dtype, variant):
    _walk(layout, variant, kv_dtype)


def _prompts(seed=0, lens=(13, 5, 22, 9)):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, 256, size=n)) for n in lens]


def _serve(engine, prompts, max_new=8):
    reqs = [engine.submit(p, max_new, rid=i) for i, p in enumerate(prompts)]
    engine.run()
    assert all(r.done and r.finish_reason == "length" for r in reqs)
    return [r.out for r in reqs]


@pytest.mark.parametrize("layout,kv_dtype", [("paged", "int8"),
                                             ("contiguous", "fp32")])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_temp0_streams_match_repro_engine(layout, kv_dtype, variant):
    jcfg, params, tcfg, tparams = _models(variant)
    kw = dict(ENGINE, kv_layout=layout, kv_dtype=kv_dtype)
    if layout == "paged":
        kw.update(page_size=PS, prefix_cache=False)
    prompts = _prompts()
    ref = _serve(JaxServeEngine(params, jcfg, attention_impl="pallas", **kw),
                 prompts)
    before = dict(build.COUNTS)
    eng = ServeEngine(tparams, tcfg, attention_impl="kernel", device="cpu",
                      **kw)
    assert _serve(eng, prompts) == ref
    assert eng.prefill_steps > 0 and eng.decode_steps > 0
    ran = {k: build.COUNTS[k] - before.get(k, 0) for k in build.COUNTS}
    assert ran.get("prefill_plain", 0) > 0 and ran.get("decode_plain", 0) > 0
    assert not ran.get("paged_prefill_plain") and not ran.get(
        "paged_decode_plain")


def _paged_pair(kv_dtype):
    """Both frameworks' paged latent pools after the same two prefill
    chunks over the same block tables."""
    jcfg, params, tcfg, tparams = _models("exact", kv_dtype)
    rng = np.random.default_rng(5)
    bt = np.arange(2 * MB, dtype=np.int32).reshape(2, MB)
    jstate = japi.init_paged_state(jcfg, 2, NBLK, PS)
    tstate = tapi.init_paged_state(tcfg, 2, NBLK, PS, device="cpu")
    lens = np.zeros(2, np.int32)
    for _ in range(2):
        toks = rng.integers(1, tcfg.vocab_size, (2, 6)).astype(np.int32)
        nv = np.array([6, 6], np.int32)
        _, jstate = japi.prefill_paged(params, jstate, jnp.asarray(toks),
                                       jnp.asarray(lens), jnp.asarray(nv),
                                       jnp.asarray(bt), jcfg, page_size=PS)
        _, tstate = tapi.prefill_paged(tparams, tstate,
                                       torch.from_numpy(toks),
                                       torch.from_numpy(lens),
                                       torch.from_numpy(nv),
                                       torch.from_numpy(bt), tcfg,
                                       page_size=PS)
        lens = lens + nv
    return jcfg, jstate, tcfg, tstate


def _same_leaves(jstate, tstate, kv_dtype):
    """Every leaf's NaN rows (float leaves) or most negative codes (code
    leaves) where ``repro``'s are, and the latents within the walks'
    limits elsewhere."""
    jc = jstate["caches"][0]
    for layer, tc in enumerate(tstate["caches"]):
        assert set(tc) == set(jc)
        ref = {k: np.asarray(v[layer]) for k, v in jc.items()}
        got = {k: (v.to(torch.float32) if v.is_floating_point() else v)
               .numpy() for k, v in tc.items()}
        for name, r in ref.items():
            if np.issubdtype(r.dtype, np.integer):
                low = np.iinfo(r.dtype).min
                np.testing.assert_array_equal(got[name] == low, r == low)
            else:
                np.testing.assert_array_equal(
                    np.isnan(got[name]), np.isnan(r.astype(np.float32)))
        for a, b in zip(_latents(got, kv_dtype), _latents(ref, kv_dtype)):
            ok = np.isfinite(b)
            np.testing.assert_array_equal(np.isfinite(a), ok)
            np.testing.assert_allclose(a[ok], b[ok], atol=5e-2
                                       if kv_dtype != "fp32" else 1e-5)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_copy_and_poison_paged_block_cover_latents(kv_dtype):
    jcfg, jstate, tcfg, tstate = _paged_pair(kv_dtype)
    # copy-on-write: page 2 (written) onto page 9 (never written)
    jstate = japi.copy_paged_block(jstate, jcfg, 2, 9, page_size=PS)
    tstate = tapi.copy_paged_block(tstate, tcfg, 2, 9, page_size=PS)
    _same_leaves(jstate, tstate, kv_dtype)
    for tc in tstate["caches"]:
        for leaf in tc.values():
            assert torch.equal(leaf[9 * PS:10 * PS], leaf[2 * PS:3 * PS])
    # the kv_corrupt fault: NaN in float leaves, the most negative code in
    # code leaves; then the quarantine scrub
    jstate = japi.poison_paged_block(jstate, jcfg, 1, page_size=PS)
    tstate = tapi.poison_paged_block(tstate, tcfg, 1, page_size=PS)
    _same_leaves(jstate, tstate, kv_dtype)
    for tc in tstate["caches"]:
        for name, leaf in tc.items():
            page = leaf[PS:2 * PS]
            if leaf.is_floating_point():
                assert bool(torch.isnan(page).all()), name
            else:
                assert bool((page == torch.iinfo(leaf.dtype).min).all())
    jstate = japi.poison_paged_block(jstate, jcfg, 1, page_size=PS, value=0)
    tstate = tapi.poison_paged_block(tstate, tcfg, 1, page_size=PS, value=0)
    _same_leaves(jstate, tstate, kv_dtype)


def test_windowed_mla_prefill_is_refused():
    """As ``repro``: the latent caches' prefill does not mask by window."""
    tcfg = get_config(ARCH, smoke=True, dtype="float32",
                      param_dtype="float32", window=4)
    params = tapi.init_model(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    state = tapi.init_decode_state(tcfg, 1, 16, device="cpu")
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="windowed MLA"):
        tapi.prefill(params, state, torch.ones((1, 4), dtype=torch.int32),
                     0 * one, 4 * one, tcfg)

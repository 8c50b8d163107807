"""The attention kernels' contract: the inputs their Pallas kernels take.

The five kernels take any head dims up to 256 (Dv != D over int8 / fp8
codes too, flash at Dv == D), any GQA group and pages of up to 256
tokens, as ``repro``'s Pallas kernels do. On the CPU:

* the plain versions against ``repro``'s Pallas kernels (interpret mode)
  on the same numpy inputs at shapes the CUDA kernels were not built for:
  the paged decode at head dim 80, GQA group 40, pages of 64 (float32
  pool); the paged prefill at (D, Dv) = (48, 32) over int8 codes in pages
  of 64; both paged kernels at pages of 48 and 200 (pages that the
  kernels' 64-row sub-tiles and a rank's rows do not divide); the contiguous decode and prefill at (48, 32) over int8 codes;
  flash at head dim 80. Dyadic inputs (every score exact in any order)
  are held at 1e-6 of the output's magnitude, random ones at
  ``tests/cells.py``'s ``_ref_tol`` of their cell;
* each wrapper's ``meta`` route (the dry run's) accepting those shapes and
  reporting the FLOPs and bytes of the true D and Dv, and refusing
  D 257, Dv 257 and a page of 257 tokens;
* MLA's forward at ``v_head_dim`` 24 over a qk width of 16 on the
  ``flash_jnp`` and ``plain`` routes, against ``repro``'s ``flash_jnp``,
  at 1e-5 of the output's magnitude (float32, another summation order).

The CUDA kernels are held against these plain versions at the same
contract by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s phase
"contracts".
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cells import _ref_tol  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.decode.ops import (  # noqa: E402
    fused_paged_decode_attention_pallas,
    quant_decode_attention_pallas,
)
from repro.kernels.flash.ops import (  # noqa: E402
    flash_attention_fwd as jax_flash,
)
from repro.kernels.flash.ops import (  # noqa: E402
    fused_paged_prefill_attention_pallas,
    quant_fused_paged_prefill_attention_pallas,
    quant_prefill_attention_pallas,
)
from repro.layers import mla as jmla  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.kernels.decode import decode  # noqa: E402
from repro_torch.kernels.decode.ops import (  # noqa: E402
    fused_paged_decode_attention,
    quant_decode_attention,
)
from repro_torch.kernels.flash import flash, prefill  # noqa: E402
from repro_torch.kernels.flash.ops import (  # noqa: E402
    flash_attention_fwd,
    fused_paged_prefill_attention,
    quant_fused_paged_prefill_attention,
    quant_prefill_attention,
)
from repro_torch.layers import mla  # noqa: E402

VARIANTS = ["exact", "expmul"]
DYADIC = pytest.mark.parametrize("dyadic", [True, False],
                                 ids=["dyadic", "random"])


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _tol(variant, kv_dtype, dyadic):
    return 1e-6 if dyadic else _ref_tol(variant, kv_dtype)


def _values(rng, shape, dyadic):
    if dyadic:
        return (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _codes(rng, shape, dyadic):
    """int8 codes and float32 scale rows."""
    codes = rng.integers(-127, 128, shape).astype(np.int8)
    scale = (2.0 ** rng.integers(-7, -3, shape[:-1]) if dyadic
             else rng.uniform(0.004, 0.03, shape[:-1]))
    return codes, scale.astype(np.float32)


def _tables(rng, need, nblk, ps, mb):
    perm = list(rng.permutation(nblk))
    bt = np.full((len(need), mb), nblk, np.int32)
    for b, n in enumerate(need):
        for i in range(-(-n // ps)):
            bt[b, i] = perm.pop()
    return bt


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the plain versions at the new shapes, against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", VARIANTS)
@DYADIC
def test_paged_decode_head_dim_80_group_40_page_64(variant, dyadic):
    """MQA at head dim 80 (40 query heads on one KV head) over pages of 64:
    lengths across pages, an idle row, a row ending mid-page."""
    rng = np.random.default_rng(80)
    H, Hkv, D, ps, nblk, mb = 40, 1, 80, 64, 8, 4
    lens = np.array([150, 0, 64], np.int32)
    q = _values(rng, (3, H, D), dyadic)
    k = _values(rng, (nblk * ps, Hkv, D), dyadic)
    v = _values(rng, (nblk * ps, Hkv, D), dyadic)
    bt = _tables(rng, lens, nblk, ps, mb)
    kw = dict(page_size=ps, variant=variant, window=None)
    ref = fused_paged_decode_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v, bt, lens)), **kw)
    got = fused_paged_decode_attention(*(_t(a) for a in (q, k, v, bt, lens)),
                                       **kw).numpy()
    assert got.shape == (3, H, D)
    np.testing.assert_array_equal(got[1], 0.0)
    assert _rel_err(got, ref) <= _tol(variant, "fp32", dyadic)


@pytest.mark.parametrize("variant", VARIANTS)
@DYADIC
def test_paged_prefill_dv_32_of_48_int8_page_64(variant, dyadic):
    """K rows of 48 and V rows of 32 over int8 codes, pages of 64: a chunk
    after a page and a part, an idle row, a chunk on a fresh sequence."""
    rng = np.random.default_rng(48)
    H, Hkv, D, Dv, ps, nblk, mb, C = 4, 2, 48, 32, 64, 8, 3, 20
    lens, nv = np.array([70, 0, 0], np.int32), np.array([20, 0, 13],
                                                         np.int32)
    q = _values(rng, (3, H, C, D), dyadic)
    kn, ksn = _codes(rng, (3, Hkv, C, D), dyadic)
    vn, vsn = _codes(rng, (3, Hkv, C, Dv), dyadic)
    k, ks = _codes(rng, (nblk * ps, Hkv, D), dyadic)
    v, vs = _codes(rng, (nblk * ps, Hkv, Dv), dyadic)
    bt = _tables(rng, lens + nv, nblk, ps, mb)
    ops = (q, kn, vn, ksn, vsn, k, v, ks, vs, bt, lens, nv)
    kw = dict(page_size=ps, variant=variant, window=None)
    ref = quant_fused_paged_prefill_attention_pallas(
        *(jnp.asarray(a) for a in ops), **kw)
    got = quant_fused_paged_prefill_attention(*(_t(a) for a in ops),
                                              **kw).numpy()
    assert got.shape == (3, H, C, Dv)
    np.testing.assert_array_equal(got[1], 0.0)
    assert _rel_err(got, ref) <= _tol(variant, "int8", dyadic)


@pytest.mark.parametrize("ps", [48, 200])
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
@pytest.mark.parametrize("variant", VARIANTS)
@DYADIC
def test_paged_pair_at_pages_off_the_staging_rows(ps, kernel, variant,
                                                  dyadic):
    """Pages that do not divide the kernels' staging rows (64-row
    sub-tiles, a rank's R rows): 48, and 200 (a wide page staged in
    pieces, its last one partial), float32 pools at head dim 16, GQA group
    2, a row across pages, an idle row, one ending mid-page."""
    rng = np.random.default_rng(ps)
    H, Hkv, D, nblk, mb = 4, 2, 16, 8, 3
    lens = np.array([ps + 30, 0, ps - 5], np.int32)
    k = _values(rng, (nblk * ps, Hkv, D), dyadic)
    v = _values(rng, (nblk * ps, Hkv, D), dyadic)
    kw = dict(page_size=ps, variant=variant, window=None)
    J = jnp.asarray
    if kernel == "decode":
        q = _values(rng, (3, H, D), dyadic)
        bt = _tables(rng, lens, nblk, ps, mb)
        ops = (q, k, v, bt, lens)
        ref = fused_paged_decode_attention_pallas(*(J(a) for a in ops), **kw)
        got = fused_paged_decode_attention(*(_t(a) for a in ops),
                                           **kw).numpy()
        shape = (3, H, D)
    else:
        C = 20
        nv = np.array([20, 0, 11], np.int32)
        q = _values(rng, (3, H, C, D), dyadic)
        kn = _values(rng, (3, Hkv, C, D), dyadic)
        vn = _values(rng, (3, Hkv, C, D), dyadic)
        bt = _tables(rng, lens + nv, nblk, ps, mb)
        ops = (q, kn, vn, k, v, bt, lens, nv)
        ref = fused_paged_prefill_attention_pallas(*(J(a) for a in ops),
                                                   **kw)
        got = fused_paged_prefill_attention(*(_t(a) for a in ops),
                                            **kw).numpy()
        shape = (3, H, C, D)
    assert got.shape == shape
    np.testing.assert_array_equal(got[1], 0.0)
    assert _rel_err(got, ref) <= _tol(variant, "fp32", dyadic)


@pytest.mark.parametrize("kernel", ["decode", "prefill"])
@pytest.mark.parametrize("variant", VARIANTS)
@DYADIC
def test_contiguous_dv_32_of_48_int8(kernel, variant, dyadic):
    """The contiguous decode (two 256-wide tiles, an idle row, a full
    cache) and prefill (a partial chunk, an idle row) at K rows of 48 and
    V rows of 32 over int8 codes."""
    rng = np.random.default_rng(32)
    H, Hkv, D, Dv = 4, 2, 48, 32
    S = 300 if kernel == "decode" else 64
    lens = np.array([13, 0, S] if kernel == "decode" else [40, 0, 7],
                    np.int32)
    k, ks = _codes(rng, (3, Hkv, S, D), dyadic)
    v, vs = _codes(rng, (3, Hkv, S, Dv), dyadic)
    J = jnp.asarray
    if kernel == "decode":
        q = _values(rng, (3, H, D), dyadic)
        ref = quant_decode_attention_pallas(
            J(q), J(k), J(v), J(ks), J(vs), J(lens), variant=variant)
        got = quant_decode_attention(*(_t(a) for a in (q, k, v, ks, vs,
                                                       lens)),
                                     variant=variant).numpy()
        shape = (3, H, Dv)
    else:
        C = 24
        nv = np.array([24, 0, 9], np.int32)
        q = _values(rng, (3, H, C, D), dyadic)
        kn, ksn = _codes(rng, (3, Hkv, C, D), dyadic)
        vn, vsn = _codes(rng, (3, Hkv, C, Dv), dyadic)
        ops = (q, k, v, ks, vs, kn, vn, ksn, vsn, lens, nv)
        kw = dict(variant=variant, window=None, rolling=False)
        ref = quant_prefill_attention_pallas(*(J(a) for a in ops), **kw)
        got = quant_prefill_attention(*(_t(a) for a in ops), **kw).numpy()
        shape = (3, H, C, Dv)
    assert got.shape == shape
    np.testing.assert_array_equal(got[1], 0.0)
    assert _rel_err(got, ref) <= _tol(variant, "int8", dyadic)


@pytest.mark.parametrize("variant", VARIANTS)
@DYADIC
def test_flash_head_dim_80(variant, dyadic):
    """Causal over 80 tokens in 32-wide tiles (K padded to 96), 2 query
    heads over 1 KV head, float32."""
    rng = np.random.default_rng(81)
    S, D = 80, 80
    q, k, v = (_values(rng, (1, h, S, D), dyadic) for h in (2, 1, 1))
    ref = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                    window=None, variant=variant, block_q=16, block_k=32)
    got = flash_attention_fwd(*(_t(a) for a in (q, k, v)), causal=True,
                              window=None, variant=variant,
                              block_k=32).numpy()
    assert _rel_err(got, ref) <= _tol(variant, "fp32", dyadic)


# ---------------------------------------------------------------------------
# the meta routes: the contract's shapes taken, priced at the true widths
# ---------------------------------------------------------------------------
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _calls(B=2, Hkv=1, group=40, D=80, Dv=80, ps=64, mb=3, C=24, S=300,
           kv=torch.float32):
    """Each wrapper's meta call at these dims: name -> (call, flops the
    true widths need, kv bytes of its paged span)."""
    codes = kv in decode.CODE_DTYPES
    H = Hkv * group
    nblk = 7
    sc = (lambda *s: _meta(*s)) if codes else (lambda *s: None)
    lens = _meta(B, dtype=torch.int32)
    bt = _meta(B, mb, dtype=torch.int32)
    kw = dict(scale=0.1, variant="expmul")
    span = mb * ps
    kv_bytes = B * span * Hkv * (D + Dv) * _meta(1, dtype=kv).element_size()
    kv_bytes += B * span * Hkv * 8 if codes else 0
    pool = (nblk, ps, Hkv)
    flops = lambda q_tokens, kv_tokens, batch, heads: (  # noqa: E731
        batch * 2 * heads * (D + Dv) * q_tokens * kv_tokens)
    return {
        "paged_decode": (lambda: decode.paged_decode_fwd(
            bt, lens, _meta(B * Hkv, group, D), _meta(*pool, D, dtype=kv),
            _meta(*pool, Dv, dtype=kv), sc(*pool), sc(*pool), page_size=ps,
            window=None, num_kv_heads=Hkv, **kw),
            flops(1, span, B * Hkv, group), kv_bytes),
        "paged_prefill": (lambda: prefill.paged_prefill_fwd(
            bt, lens, lens, _meta(B * H, C, D), _meta(*pool, D, dtype=kv),
            _meta(*pool, Dv, dtype=kv), _meta(B * Hkv, C, D, dtype=kv),
            _meta(B * Hkv, C, Dv, dtype=kv), sc(*pool), sc(*pool),
            sc(B * Hkv, C), sc(B * Hkv, C), window=None, page_size=ps,
            num_q_heads=H, num_kv_heads=Hkv, **kw),
            flops(C, span + C, B * H, 1), kv_bytes),
        "decode": (lambda: decode.decode_fwd(
            _meta(B * Hkv, group, D), _meta(B * Hkv, S, D, dtype=kv),
            _meta(B * Hkv, S, Dv, dtype=kv), lens, sc(B * Hkv, S),
            sc(B * Hkv, S), num_kv_heads=Hkv, **kw),
            flops(1, S, B * Hkv, group), 0),
        "prefill": (lambda: prefill.prefill_fwd(
            _meta(B * H, C, D), _meta(B * Hkv, S, D, dtype=kv),
            _meta(B * Hkv, S, Dv, dtype=kv), _meta(B * Hkv, C, D, dtype=kv),
            _meta(B * Hkv, C, Dv, dtype=kv), lens, lens, sc(B * Hkv, S),
            sc(B * Hkv, S), sc(B * Hkv, C), sc(B * Hkv, C), window=None,
            rolling=False, num_q_heads=H, num_kv_heads=Hkv, **kw),
            flops(C, S + C, B * H, 1), 0),
        "flash": (lambda: flash.flash_fwd(
            _meta(B * H, S, D), _meta(B * Hkv, S, D), _meta(B * Hkv, S, D),
            causal=True, window=None, block_k=100, num_q_heads=H,
            num_kv_heads=Hkv, kv_len=S, **kw),
            flops(S, S, B * H, 1) if D == Dv else None, 0),
    }


@pytest.mark.parametrize("dims", [
    dict(group=40, D=80, Dv=80, ps=64),
    dict(group=2, D=48, Dv=32, ps=64, kv=torch.int8),
    dict(group=3, D=192, Dv=128, ps=256, kv=torch.float8_e4m3fn)],
    ids=["d80-g40-p64", "d48-dv32-int8-p64", "d192-dv128-fp8-p256"])
def test_meta_routes_take_the_contract_at_true_widths(dims):
    """Every wrapper's meta call at the contract's shapes returns the
    output of the true Dv and prices the true D and Dv: its FLOPs
    ``2 (D + Dv)`` a (query, key) pair and head, its bytes each operand
    in its own width (the paged pools' span at D + Dv a row)."""
    seen = []
    costs.COST_SINKS.append(lambda name, **c: seen.append((name, c)))
    try:
        for name, (call, flops, _) in _calls(**dims).items():
            if name == "flash" and dims["D"] != dims["Dv"]:
                continue            # flash takes Dv == D, as its Pallas kernel
            out = call()
            assert out.shape[-1] == dims["Dv"], name
            got_name, got = seen.pop()
            assert got_name == name
            assert got["flops"] == flops, name
    finally:
        costs.COST_SINKS.pop()
    # the bytes: each operand once, the paged pools over the tables' span
    calls = _calls(**dims)
    costs.COST_SINKS.append(lambda name, **c: seen.append((name, c)))
    try:
        out = calls["paged_decode"][0]()
        _, got = seen.pop()
        B, Hkv, group, D = 2, 1, dims["group"], dims["D"]
        kv_dtype = dims.get("kv", torch.float32)
        small = (B * Hkv * group * (D + dims["Dv"]) * 4     # q and the output
                 + B * 3 * 4 + B * 4)                      # tables, lengths
        assert got["bytes"] == small + calls["paged_decode"][2], kv_dtype
        assert out.dtype == torch.float32
    finally:
        costs.COST_SINKS.pop()


@pytest.mark.parametrize("kernel,what", [
    (k, w) for k in ("paged_decode", "paged_prefill") for w in ("D", "Dv",
                                                               "page")]
    + [(k, w) for k in ("decode", "prefill") for w in ("D", "Dv")]
    + [("flash", "D")])
def test_meta_routes_refuse_past_the_limits(kernel, what):
    """D 257, Dv 257 and a page of 257 tokens each raise before any launch,
    naming the limit (flash takes Dv == D; the contiguous kernels have no
    pages)."""
    dims = {"D": dict(D=257, Dv=64), "Dv": dict(D=64, Dv=257),
            "page": dict(D=64, Dv=64, ps=257, mb=2)}[what]
    if kernel == "flash":
        dims.update(Dv=257)
    call = _calls(group=2, **dims)[kernel][0]
    with pytest.raises(ValueError, match="outside"):
        call()


# ---------------------------------------------------------------------------
# MLA's forward at v_head_dim > the qk width
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["flash_jnp", "plain"])
def test_mla_forward_at_v_wider_than_qk_matches_repro(impl):
    """minicpm3-4b's smoke config with ``v_head_dim`` 24 over a qk width
    of 16 (8 + 8): the port's ``mla_apply`` on ``impl`` (``flash_jnp``
    takes K and V as they are; ``plain``, the flash kernel's route,
    zero-pads q and K to 24 and keeps the qk scale) against ``repro``'s
    ``flash_jnp``, float32, within 1e-5 of the output's magnitude."""
    over = dict(dtype="float32", param_dtype="float32",
                attention_variant="expmul", kv_dtype="fp32")
    jcfg = jax_get_config("minicpm3-4b", smoke=True, attention_impl="flash_jnp",
                          **over)
    jcfg = dataclasses.replace(jcfg, mla=dataclasses.replace(jcfg.mla,
                                                             v_head_dim=24))
    tcfg = get_config("minicpm3-4b", smoke=True, attention_impl=impl, **over)
    tcfg = dataclasses.replace(tcfg, mla=dataclasses.replace(tcfg.mla,
                                                             v_head_dim=24))
    m = tcfg.mla
    assert m.v_head_dim > m.qk_nope_dim + m.qk_rope_dim
    params = japi.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    x = np.random.default_rng(24).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], params["units"][0]["mix"])
    ref = jmla.mla_apply(lp, jnp.asarray(x), jcfg)
    got = mla.mla_apply(tparams["layers"][0]["mix"], torch.from_numpy(x),
                        tcfg)
    assert tuple(got.shape) == x.shape
    assert _rel_err(got.detach().numpy(), ref) <= 1e-5

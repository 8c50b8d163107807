"""Port contiguous attention kernels against ``repro``.

The plain versions of the contiguous decode and prefill kernels
(``decode_fwd_plain``, ``prefill_fwd_plain``) equal ``repro``'s Pallas
kernels (``decode_attention_pallas``, ``quant_decode_attention_pallas``,
``prefill_attention_pallas``, ``quant_prefill_attention_pallas``, run in
interpret mode on the CPU, as ``repro``'s own tests run them) on the same
numpy inputs, over {exact, expmul} x {fp32, int8, fp8} x {dyadic, random}:

* decode: ragged lengths, an idle row (length 0), a row of exactly ``S``,
  and stale rows past each length holding large finite values (a previous
  occupant's), over two reference-width tiles (``S`` > 256);
* prefill: fresh and rolling caches, windows, a cache shorter than the
  span, a buffer that has wrapped, a chunk longer than the span, an idle
  row (``n_valid = 0``), and the ``length < span`` rolling case, in which a
  C-style modulo (truncating toward zero) would unmask stale slots;
* both at kimi-k2-1t-a32b's head dim 112, over fp32 and int8;
* both at Dv != D, MLA's expanded latents (V rows narrower than K rows):
  ``tests/cells.py``'s "mla" shape (D 24, Dv 16) and minicpm3-4b's (96,
  64), float32 values (MLA never hands them codes), one KV head per query
  head; and the wrappers' contract: any (D, Dv) up to 256 over every KV
  dtype, and a refusal past it (``check_head_dims``).

Both sides walk the same tiles in the same order. Dyadic inputs (q and
values in multiples of 2^-3, integer codes, power-of-two scales) make every
score exact in any summation order, so no ExpMul L_hat can flip: held at
1e-6 of the output's magnitude. Random inputs: 1e-5.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode.ops import (  # noqa: E402
    decode_attention_pallas,
    quant_decode_attention_pallas,
)
from repro.kernels.flash.ops import (  # noqa: E402
    prefill_attention_pallas,
    quant_prefill_attention_pallas,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode.decode import (  # noqa: E402
    check_head_dims,
    decode_fwd,
    decode_fwd_plain,
)
from repro_torch.kernels.decode.ops import (  # noqa: E402
    decode_attention,
    quant_decode_attention,
)
from repro_torch.kernels.flash.ops import (  # noqa: E402
    prefill_attention,
    quant_prefill_attention,
)
from repro_torch.kernels.flash.prefill import prefill_fwd_plain  # noqa: E402

H, HKV, D = 4, 2, 16
TOL = {True: 1e-6, False: 1e-5}           # dyadic, random
VARIANTS = ["exact", "expmul"]
KV_DTYPES = ["fp32", "int8", "fp8"]
DYADIC = pytest.mark.parametrize("dyadic", [True, False],
                                 ids=["dyadic", "random"])
STALE = 1e4                                # finite garbage past the length


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _values(rng, shape, dyadic):
    if dyadic:
        return (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _fp8(x):
    """float32 values that e4m3fn holds exactly (rounded through jnp)."""
    return np.array(jnp.asarray(x, jnp.float32).astype(jnp.float8_e4m3fn)
                    .astype(jnp.float32))


def _kv(rng, shape, kv_dtype, dyadic):
    """(values or codes as float32, scales or None) for a K or V operand."""
    if kv_dtype == "fp32":
        return _values(rng, shape, dyadic), None
    if kv_dtype == "int8":
        codes = rng.integers(-127, 128, shape).astype(np.float32)
    elif dyadic:               # integers up to 15 are exact in e4m3
        codes = rng.integers(-15, 16, shape).astype(np.float32)
    else:
        codes = _fp8(np.clip(rng.standard_normal(shape) * 100, -448, 448))
    if dyadic:
        scale = 2.0 ** rng.integers(-7, -3, shape[:-1])
    else:
        scale = rng.uniform(0.004, 0.03, shape[:-1])
    return codes, scale.astype(np.float32)


def _stale(kv, scale, filled, kv_dtype):
    """Rows of each (B, Hkv, S) cache at or past ``filled[b]`` hold large
    finite values: +-STALE, or the largest code with a large scale."""
    for b, n in enumerate(filled):
        sign = np.where(np.arange(kv.shape[-1]) % 2, 1.0, -1.0)
        if kv_dtype == "fp32":
            kv[b, :, n:] = STALE * sign
        else:
            kv[b, :, n:] = (127.0 if kv_dtype == "int8" else 448.0) * sign
            scale[b, :, n:] = 64.0


def _jax(a, kv_dtype):
    a = jnp.asarray(a)
    if kv_dtype == "int8":
        return a.astype(jnp.int8)
    if kv_dtype == "fp8":
        return a.astype(jnp.float8_e4m3fn)
    return a


def _torch(a, kv_dtype):
    t = torch.from_numpy(np.ascontiguousarray(a))
    if kv_dtype == "int8":
        return t.to(torch.int8)
    if kv_dtype == "fp8":
        return t.to(torch.float8_e4m3fn)
    return t


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _decode_case(seed, kv_dtype, dyadic, lengths, S, d=D):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    q = _values(rng, (B, H, d), dyadic)
    k, ks = _kv(rng, (B, HKV, S, d), kv_dtype, dyadic)
    v, vs = _kv(rng, (B, HKV, S, d), kv_dtype, dyadic)
    _stale(k, ks, lengths, kv_dtype)
    _stale(v, vs, lengths, kv_dtype)
    return q, k, v, ks, vs, np.asarray(lengths, np.int32)


def _decode_pallas(case, variant, kv_dtype, block_k=256):
    q, k, v, ks, vs, lens = case
    J = jnp.asarray
    if kv_dtype == "fp32":
        return np.asarray(decode_attention_pallas(
            J(q), J(k), J(v), J(lens), variant=variant, block_k=block_k))
    return np.asarray(quant_decode_attention_pallas(
        J(q), _jax(k, kv_dtype), _jax(v, kv_dtype), J(ks), J(vs), J(lens),
        variant=variant, block_k=block_k))


def _decode_port(case, variant, kv_dtype):
    q, k, v, ks, vs, lens = case
    T = _torch
    if kv_dtype == "fp32":
        out = decode_attention(T(q, "fp32"), T(k, "fp32"), T(v, "fp32"),
                               T(lens, "fp32"), variant=variant)
    else:
        out = quant_decode_attention(
            T(q, "fp32"), T(k, kv_dtype), T(v, kv_dtype), T(ks, "fp32"),
            T(vs, "fp32"), T(lens, "fp32"), variant=variant)
    return out.numpy()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@DYADIC
def test_decode_plain_matches_pallas(variant, kv_dtype, dyadic):
    # two 256-wide tiles; ragged, idle (0), exactly S, and stale rows
    S = 300
    case = _decode_case(10, kv_dtype, dyadic, [13, 0, S, 261], S)
    before = dict(build.COUNTS)
    got = _decode_port(case, variant, kv_dtype)
    # on the CPU the plain version runs, never a launch
    assert build.COUNTS["decode_plain"] == before.get("decode_plain", 0) + 1
    assert build.COUNTS["decode"] == before.get("decode", 0)
    np.testing.assert_array_equal(got[1], 0.0)        # the idle row
    assert _rel_err(got, _decode_pallas(case, variant, kv_dtype)) \
        <= TOL[dyadic]


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_plain_narrow_tiles_match_pallas(variant):
    """Many tiles of 8 columns, ending mid-tile: the same walk as Pallas
    with ``block_k=8``."""
    S = 29
    q, k, v, ks, vs, lens = case = _decode_case(11, "int8", True,
                                                [29, 5, 17, 0], S)
    B = len(lens)
    got = decode_fwd_plain(
        torch.from_numpy(q.reshape(B * HKV, H // HKV, D)),
        _torch(k.reshape(B * HKV, S, D), "int8"),
        _torch(v.reshape(B * HKV, S, D), "int8"), torch.from_numpy(lens),
        torch.from_numpy(ks.reshape(B * HKV, S)),
        torch.from_numpy(vs.reshape(B * HKV, S)), scale=D ** -0.5,
        variant=variant, num_kv_heads=HKV, block_k=8)
    ref = _decode_pallas(case, variant, "int8", block_k=8)
    assert _rel_err(got.reshape(B, H, D).numpy(), ref) <= 1e-6


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def _prefill_case(seed, kv_dtype, dyadic, lengths, n_valid, S, C,
                  rolling, d=D):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    q = _values(rng, (B, H, C, d), dyadic)
    kc, ksc = _kv(rng, (B, HKV, S, d), kv_dtype, dyadic)
    vc, vsc = _kv(rng, (B, HKV, S, d), kv_dtype, dyadic)
    kn, ksn = _kv(rng, (B, HKV, C, d), kv_dtype, dyadic)
    vn, vsn = _kv(rng, (B, HKV, C, d), kv_dtype, dyadic)
    # slots never written yet hold a previous occupant's rows
    filled = [min(n, S) for n in lengths]
    _stale(kc, ksc, filled, kv_dtype)
    _stale(vc, vsc, filled, kv_dtype)
    return dict(q=q, kc=kc, vc=vc, ksc=ksc, vsc=vsc, kn=kn, vn=vn, ksn=ksn,
                vsn=vsn, lens=np.asarray(lengths, np.int32),
                nv=np.asarray(n_valid, np.int32), rolling=rolling)


def _prefill_pallas(c, variant, kv_dtype, window, block_q=128, block_k=512):
    """The Pallas kernel at the blocks the serving path gives it
    (``cfg.attention_block_q/k``) unless told otherwise."""
    J = jnp.asarray
    kw = dict(variant=variant, window=window, rolling=c["rolling"],
              block_q=block_q, block_k=block_k)
    if kv_dtype == "fp32":
        return np.asarray(prefill_attention_pallas(
            J(c["q"]), J(c["kc"]), J(c["vc"]), J(c["kn"]), J(c["vn"]),
            J(c["lens"]), J(c["nv"]), **kw))
    X = (lambda a: _jax(a, kv_dtype))
    return np.asarray(quant_prefill_attention_pallas(
        J(c["q"]), X(c["kc"]), X(c["vc"]), J(c["ksc"]), J(c["vsc"]),
        X(c["kn"]), X(c["vn"]), J(c["ksn"]), J(c["vsn"]), J(c["lens"]),
        J(c["nv"]), **kw))


def _prefill_port(c, variant, kv_dtype, window):
    T = (lambda a: _torch(a, kv_dtype))
    F = (lambda a: _torch(a, "fp32"))
    kw = dict(variant=variant, window=window, rolling=c["rolling"])
    if kv_dtype == "fp32":
        out = prefill_attention(F(c["q"]), F(c["kc"]), F(c["vc"]),
                                F(c["kn"]), F(c["vn"]), F(c["lens"]),
                                F(c["nv"]), **kw)
    else:
        out = quant_prefill_attention(
            F(c["q"]), T(c["kc"]), T(c["vc"]), F(c["ksc"]), F(c["vsc"]),
            T(c["kn"]), T(c["vn"]), F(c["ksn"]), F(c["vsn"]), F(c["lens"]),
            F(c["nv"]), **kw)
    return out.numpy()


def _prefill_port_blocked(c, variant, kv_dtype, window, block_q, block_k):
    """``prefill_fwd_plain`` at explicit blocks, as Pallas takes them."""
    B, _, C, _ = c["q"].shape
    S = c["kc"].shape[2]
    T = (lambda a, *s: _torch(a.reshape((B * HKV,) + s), kv_dtype))
    F = (lambda a, *s: torch.from_numpy(a.reshape((B * HKV,) + s)))
    quant = kv_dtype != "fp32"
    out = prefill_fwd_plain(
        torch.from_numpy(c["q"].reshape(B * H, C, D)), T(c["kc"], S, D),
        T(c["vc"], S, D), T(c["kn"], C, D), T(c["vn"], C, D),
        torch.from_numpy(c["lens"]), torch.from_numpy(c["nv"]),
        F(c["ksc"], S) if quant else None, F(c["vsc"], S) if quant else None,
        F(c["ksn"], C) if quant else None, F(c["vsn"], C) if quant else None,
        scale=D ** -0.5, variant=variant, window=window,
        rolling=c["rolling"], num_q_heads=H, num_kv_heads=HKV,
        block_q=block_q, block_k=block_k)
    return out.reshape(B, H, C, D).numpy()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@DYADIC
def test_prefill_plain_matches_pallas(variant, kv_dtype, dyadic):
    # a fresh cache over two 512-wide tiles: ragged lengths, a chunk into
    # an empty cache, an idle row, a cache filled to its last slot but C
    S, C = 600, 8
    c = _prefill_case(20, kv_dtype, dyadic, [530, 0, 17, S - C],
                      [8, 8, 0, 5], S, C, rolling=False)
    before = dict(build.COUNTS)
    got = _prefill_port(c, variant, kv_dtype, None)
    assert build.COUNTS["prefill_plain"] == before.get("prefill_plain", 0) + 1
    assert build.COUNTS["prefill"] == before.get("prefill", 0)
    assert _rel_err(got, _prefill_pallas(c, variant, kv_dtype, None)) \
        <= TOL[dyadic]


@pytest.mark.parametrize("kernel", ["decode", "prefill"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_pallas_at_head_dim_128(kernel, variant):
    """arctic-480b's head dim, 128 (the kernels' D 128 instantiations):
    one small case each, int8 codes, random inputs; decode over two
    256-wide tiles, prefill into a fresh cache."""
    if kernel == "decode":
        S = 300
        case = _decode_case(12, "int8", False, [13, 0, S, 261], S, d=128)
        got = _decode_port(case, variant, "int8")
        assert got.shape[-1] == 128
        np.testing.assert_array_equal(got[1], 0.0)    # the idle row
        ref = _decode_pallas(case, variant, "int8")
    else:
        S, C = 600, 8
        c = _prefill_case(21, "int8", False, [530, 0, 17, S - C],
                          [8, 8, 0, 5], S, C, rolling=False, d=128)
        got = _prefill_port(c, variant, "int8", None)
        ref = _prefill_pallas(c, variant, "int8", None)
    assert _rel_err(got, ref) <= TOL[False]


@pytest.mark.parametrize("kernel", ["decode", "prefill"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_plain_matches_pallas_at_head_dim_112(kernel, variant, kv_dtype):
    """kimi-k2-1t-a32b's head dim, 112 (the decode kernel's K rows in two
    depth steps of 56, the prefill's value side padded to 128): one small
    case each, random inputs; decode over two 256-wide tiles, prefill into
    a fresh cache."""
    if kernel == "decode":
        S = 300
        case = _decode_case(15, kv_dtype, False, [13, 0, S, 261], S, d=112)
        got = _decode_port(case, variant, kv_dtype)
        assert got.shape[-1] == 112
        np.testing.assert_array_equal(got[1], 0.0)    # the idle row
        ref = _decode_pallas(case, variant, kv_dtype)
    else:
        S, C = 600, 8
        c = _prefill_case(24, kv_dtype, False, [530, 0, 17, S - C],
                          [8, 8, 0, 5], S, C, rolling=False, d=112)
        got = _prefill_port(c, variant, kv_dtype, None)
        ref = _prefill_pallas(c, variant, kv_dtype, None)
    assert _rel_err(got, ref) <= TOL[False]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@DYADIC
def test_prefill_rolling_plain_matches_pallas(variant, kv_dtype, dyadic):
    # a rolling buffer of span 7 (window 7): one row wrapped twice over,
    # one shorter than the span (length < span: stale slots stay masked),
    # one empty, one whose 12-token chunk is longer than the span
    S, C, W = 7, 12, 7
    c = _prefill_case(21, kv_dtype, dyadic, [17, 3, 0, 9], [5, 12, 4, 12],
                      S, C, rolling=True)
    assert _rel_err(_prefill_port(c, variant, kv_dtype, W),
                    _prefill_pallas(c, variant, kv_dtype, W)) <= TOL[dyadic]


# (cache_len, chunk, n_valid, window, span, seed), after the contiguous
# edge splits of tests/test_fused_prefill.py, at 4 x 4 blocks
EDGE_SPLITS = [
    (0, 8, 8, None, 20, 0),     # fresh prompt: empty cache
    (13, 1, 1, None, 20, 1),    # chunk_size=1 legacy tick
    (11, 1, 1, 5, 5, 2),        # legacy tick into a rolling buffer
    (17, 8, 5, 7, 7, 3),        # rolling buffer wrapped, partial chunk
    (3, 8, 8, 7, 7, 4),         # cache shorter than the window span
    (20, 6, 0, None, 20, 5),    # idle slot: n_valid = 0
    (5, 11, 11, 4, 4, 6),       # chunk longer than the span
    (2, 3, 3, 6, 6, 7),         # length < span: C's % would unmask slots
    (9, 5, 5, 3, 20, 8),        # window on a fresh cache: tiles skipped
]


@pytest.mark.parametrize("split", EDGE_SPLITS,
                         ids=lambda s: f"len{s[0]}-c{s[1]}-w{s[3]}-s{s[4]}")
@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_edge_splits_match_pallas(split, variant):
    cache_len, C, n_valid, window, span, seed = split
    rolling = window is not None and span == window
    lens = [cache_len, max(0, cache_len - 3)]
    nv = [n_valid, min(C, n_valid + 1)]
    if not rolling:
        lens = [min(n, span) for n in lens]          # a fresh cache: <= S
    c = _prefill_case(30 + seed, "int8", True, lens, nv, span, C, rolling)
    got = _prefill_port_blocked(c, variant, "int8", window, 4, 4)
    ref = _prefill_pallas(c, variant, "int8", window, block_q=4, block_k=4)
    assert _rel_err(got, ref) <= 1e-6


def test_rolling_mask_uses_python_modulo():
    """The rolling slot formula on a buffer shorter than its span: slots
    past ``last`` map to negative positions (masked); C's truncating %
    would map them to themselves."""
    last, span = torch.tensor(2), 6
    cols = torch.arange(span)
    pos = last - torch.remainder(last - cols, span)
    assert pos.tolist() == [0, 1, 2, -3, -2, -1]
    assert (last - torch.fmod(last - cols, span)).tolist() == list(range(6))


# ---------------------------------------------------------------------------
# Dv != D: MLA's expanded latents
# ---------------------------------------------------------------------------
# (D, Dv): tests/cells.py's "mla" family shape, and minicpm3-4b's
MLA_DIMS = pytest.mark.parametrize("dims", [(24, 16), (96, 64)],
                                   ids=["cells-mla", "minicpm3"])
MLA_H = 4            # MLA expands the latents to every head: group 1


@pytest.mark.parametrize("variant", VARIANTS)
@MLA_DIMS
@DYADIC
def test_decode_plain_matches_pallas_at_dv_ne_d(variant, dims, dyadic):
    D_, Dv = dims
    S = 300                                  # two 256-wide tiles
    lens = np.asarray([13, 0, S, 261], np.int32)
    rng = np.random.default_rng(40)
    q = _values(rng, (4, MLA_H, D_), dyadic)
    k = _values(rng, (4, MLA_H, S, D_), dyadic)
    v = _values(rng, (4, MLA_H, S, Dv), dyadic)
    _stale(k, None, lens, "fp32")
    _stale(v, None, lens, "fp32")
    got = decode_attention(*(torch.from_numpy(a) for a in (q, k, v, lens)),
                           variant=variant).numpy()
    assert got.shape == (4, MLA_H, Dv)
    np.testing.assert_array_equal(got[1], 0.0)        # the idle row
    ref = decode_attention_pallas(*(jnp.asarray(a) for a in (q, k, v, lens)),
                                  variant=variant, block_k=256)
    assert _rel_err(got, ref) <= TOL[dyadic]


@pytest.mark.parametrize("variant", VARIANTS)
@MLA_DIMS
@DYADIC
def test_prefill_plain_matches_pallas_at_dv_ne_d(variant, dims, dyadic):
    D_, Dv = dims
    S, C = 40, 8                             # a short cache, one tile
    lens = np.asarray([29, 0, 3, S], np.int32)
    nv = np.asarray([8, 8, 0, 5], np.int32)
    rng = np.random.default_rng(41)
    q = _values(rng, (4, MLA_H, C, D_), dyadic)
    kc = _values(rng, (4, MLA_H, S, D_), dyadic)
    vc = _values(rng, (4, MLA_H, S, Dv), dyadic)
    kn = _values(rng, (4, MLA_H, C, D_), dyadic)
    vn = _values(rng, (4, MLA_H, C, Dv), dyadic)
    _stale(kc, None, lens, "fp32")
    _stale(vc, None, lens, "fp32")
    ops = (q, kc, vc, kn, vn, lens, nv)
    got = prefill_attention(*(torch.from_numpy(a) for a in ops),
                            variant=variant).numpy()
    assert got.shape == (4, MLA_H, C, Dv)
    ref = prefill_attention_pallas(*(jnp.asarray(a) for a in ops),
                                   variant=variant, window=None,
                                   rolling=False, block_q=128, block_k=512)
    assert _rel_err(got, ref) <= TOL[dyadic]


@pytest.mark.parametrize("D_,Dv,kv_dtype,refused", [
    (96, 64, torch.float32, None), (96, 64, torch.bfloat16, None),
    (64, 64, torch.int8, None), (256, 256, torch.float8_e4m3fn, None),
    (128, 128, torch.int8, None), (112, 112, torch.float32, None),
    (96, 64, torch.int8, "codes"), (96, 64, torch.float8_e4m3fn, "codes"),
    (64, 32, torch.float32, "head dims"), (96, 96, torch.float32,
                                           "head dims"),
    (24, 16, torch.float32, "head dims"), (80, 80, torch.float32,
                                           "head dims")])
def test_contiguous_kernels_refuse_unbuilt_head_dims(D_, Dv, kv_dtype,
                                                     refused):
    """The contiguous kernels take any (D, Dv) up to 256 over every KV
    dtype, as their Pallas kernels do: the pairs and codes that were
    refused before (``refused`` names why) pass ``check_head_dims`` and the
    ``meta`` route's checks, and the same pair with K or V rows past 256
    raises before any launch. The plain versions take any dims."""
    check_head_dims("decode", D_, Dv)
    B, Hkv, group, S = 2, 2, 3, 8
    codes = kv_dtype in (torch.int8, torch.float8_e4m3fn)

    def run(d, dv):
        meta = dict(device="meta")
        k = torch.empty((B * Hkv, S, d), dtype=kv_dtype, **meta)
        v = torch.empty((B * Hkv, S, dv), dtype=kv_dtype, **meta)
        sc = torch.empty((B * Hkv, S), **meta) if codes else None
        return decode_fwd(
            torch.empty((B * Hkv, group, d), **meta), k, v,
            torch.empty((B,), dtype=torch.int32, **meta), sc, sc,
            scale=0.125, variant="expmul", num_kv_heads=Hkv)

    assert tuple(run(D_, Dv).shape) == (B * Hkv, group, Dv)
    for d, dv in ((D_ + 256, Dv), (D_, Dv + 256)):
        with pytest.raises(ValueError, match="outside"):
            check_head_dims("decode", d, dv)
        with pytest.raises(ValueError, match="outside"):
            run(d, dv)

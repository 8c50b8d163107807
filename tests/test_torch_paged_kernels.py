"""Port paged primitives and paged attention kernels against ``repro``.

* ``repro_torch.kernels.paged`` equals ``repro.kernels.paged`` on the same
  tables, including out-of-table positions and dropped scatters.
* The plain versions of the paged decode and prefill kernels equal the
  JAX Pallas kernels (run in interpret mode on the CPU, as ``repro``'s own
  tests run them) over {exact, expmul} x {fp32, int8}, with shuffled block
  tables, sentinel entries, an idle row, a window, and a chunk that starts
  mid-page; at head dims 16, 128 (arctic-480b's) and 112 (kimi-k2-1t-a32b's). Dyadic inputs (q in multiples of 2^-3, integer codes,
  power-of-two scales) make every score exact in any summation order, so
  no L_hat can flip and both variants are held at 1e-6 of the output's
  magnitude. Random N(0,1) inputs are held at the ``tests/cells.py``
  tolerance of their {variant} x {kv_dtype} cell.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cells import CELLS  # noqa: E402
from repro.kernels import paged as jpaged  # noqa: E402
from repro.kernels.decode.ops import (  # noqa: E402
    fused_paged_decode_attention_pallas,
    quant_fused_paged_decode_attention_pallas,
)
from repro.kernels.flash.ops import (  # noqa: E402
    fused_paged_prefill_attention_pallas,
    quant_fused_paged_prefill_attention_pallas,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged as tpaged  # noqa: E402
from repro_torch.kernels.decode.ops import (  # noqa: E402
    fused_paged_decode_attention,
    quant_fused_paged_decode_attention,
)
from repro_torch.kernels.flash.ops import (  # noqa: E402
    fused_paged_prefill_attention,
    quant_fused_paged_prefill_attention,
)
from repro_torch.kernels.flash.prefill import (  # noqa: E402
    paged_prefill_fwd_plain,
)

H, HKV, D, PS, NBLK, MB = 4, 2, 16, 4, 24, 7


def _ref_tol(variant, kv_dtype):
    cell = next(c for c in CELLS if (c.variant, c.kv_dtype, c.layout,
                                     c.family, c.mode)
                == (variant, kv_dtype, "paged", "gqa", "fused"))
    return cell.ref_tol


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _tables(rng, need_tokens):
    """Shuffled, fragmented block tables; entries past each row's need are
    the sentinel (= NBLK); a row needing 0 tokens is all sentinel."""
    perm = list(rng.permutation(NBLK))
    bt = np.full((len(need_tokens), MB), NBLK, np.int32)
    for b, n in enumerate(need_tokens):
        for i in range(-(-n // PS)):
            bt[b, i] = perm.pop()
    return bt


def _values(rng, shape, dyadic):
    if dyadic:
        return (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _kv(rng, shape, kv_dtype, dyadic):
    """(codes or values, scales or None) for a K or V operand."""
    if kv_dtype == "fp32":
        return _values(rng, shape, dyadic), None
    codes = rng.integers(-127, 128, shape).astype(np.int8)
    if dyadic:
        scale = 2.0 ** rng.integers(-7, -3, shape[:-1])
    else:
        scale = rng.uniform(0.004, 0.03, shape[:-1])
    return codes, scale.astype(np.float32)


# ---------------------------------------------------------------------------
# paged primitives
# ---------------------------------------------------------------------------
def test_slot_and_token_rows_match_repro():
    rng = np.random.default_rng(0)
    bt = _tables(rng, [13, 0, 27])
    np.testing.assert_array_equal(
        tpaged.slot_rows(_t(bt), PS).numpy(),
        np.asarray(jpaged.slot_rows(jnp.asarray(bt), PS)))
    pos = np.array([[0, 5, 12, 13, 27, 28, -1, -9, MB * PS, MB * PS + 3],
                    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9],
                    [26, 25, 4, 3, 15, 16, 2**20, -2**20, 27, 0]], np.int32)
    np.testing.assert_array_equal(
        tpaged.token_rows(_t(bt), _t(pos), PS).numpy(),
        np.asarray(jpaged.token_rows(jnp.asarray(bt), jnp.asarray(pos), PS)))
    one = pos[:, 3]
    np.testing.assert_array_equal(
        tpaged.token_rows(_t(bt), _t(one), PS).numpy(),
        np.asarray(jpaged.token_rows(jnp.asarray(bt), jnp.asarray(one), PS)))


def test_gather_and_scatter_rows_match_repro():
    rng = np.random.default_rng(1)
    pool = rng.standard_normal((NBLK * PS, HKV, D)).astype(np.float32)
    rows = rng.integers(-5, NBLK * PS + 8, (3, 11)).astype(np.int32)
    rows[0, :3] = tpaged.OUT_OF_TABLE_ROW
    np.testing.assert_array_equal(
        tpaged.gather_rows(_t(pool), _t(rows)).numpy(),
        np.asarray(jpaged.gather_rows(jnp.asarray(pool), jnp.asarray(rows))))

    flat = rng.permutation(NBLK * PS + 10)[:14].astype(np.int32)  # distinct
    flat[:3] = [NBLK * PS + 1, tpaged.OUT_OF_TABLE_ROW, -3]    # dropped, wraps
    vals = rng.standard_normal((14, HKV, D)).astype(np.float32)
    valid = rng.random(14) < 0.7
    for v in (None, valid):
        ref = jpaged.scatter_rows(jnp.asarray(pool), jnp.asarray(flat),
                                  jnp.asarray(vals),
                                  None if v is None else jnp.asarray(v))
        tp = _t(pool.copy())
        out = tpaged.scatter_rows(tp, _t(flat), _t(vals),
                                  None if v is None else _t(v))
        assert out is tp                                       # in place
        np.testing.assert_array_equal(tp.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# paged decode: plain version vs the Pallas kernel
# ---------------------------------------------------------------------------
def _decode_case(seed, kv_dtype, dyadic, lengths, d=D):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    q = _values(rng, (B, H, d), dyadic)
    k, ks = _kv(rng, (NBLK * PS, HKV, d), kv_dtype, dyadic)
    v, vs = _kv(rng, (NBLK * PS, HKV, d), kv_dtype, dyadic)
    return q, k, v, ks, vs, _tables(rng, lengths), np.asarray(lengths,
                                                              np.int32)


def _decode_pair(variant, kv_dtype, case, window=None):
    q, k, v, ks, vs, bt, lens = case
    kw = dict(page_size=PS, variant=variant, window=window)
    if kv_dtype == "fp32":
        ref = fused_paged_decode_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
            jnp.asarray(lens), **kw)
        got = fused_paged_decode_attention(_t(q), _t(k), _t(v), _t(bt),
                                           _t(lens), **kw)
    else:
        ref = quant_fused_paged_decode_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks),
            jnp.asarray(vs), jnp.asarray(bt), jnp.asarray(lens), **kw)
        got = quant_fused_paged_decode_attention(
            _t(q), _t(k), _t(v), _t(ks), _t(vs), _t(bt), _t(lens), **kw)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "random"])
def test_paged_decode_plain_matches_pallas(variant, kv_dtype, dyadic):
    # ragged lengths, an idle row (length 0), a full-table row
    case = _decode_case(10, kv_dtype, dyadic, [13, 0, MB * PS, 6])
    before = dict(build.COUNTS)
    got, ref = _decode_pair(variant, kv_dtype, case)
    assert (build.COUNTS["paged_decode_plain"]
            == before.get("paged_decode_plain", 0) + 1)
    # no kernel on the CPU
    assert build.COUNTS["paged_decode"] == before.get("paged_decode", 0)
    np.testing.assert_array_equal(got[1], 0.0)        # the idle row
    tol = 1e-6 if dyadic else _ref_tol(variant, kv_dtype)
    assert _rel_err(got, ref) <= tol


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_paged_decode_length_past_table_matches_pallas(variant):
    """A length beyond the table's span: the walk stops at the table's
    width, as the Pallas grid does, and never indexes past it."""
    case = _decode_case(12, "int8", True, [MB * PS, 3])
    q, k, v, ks, vs, bt, lens = case
    lens = np.array([MB * PS + 9, 3], np.int32)
    got, ref = _decode_pair(variant, "int8", (q, k, v, ks, vs, bt, lens))
    assert _rel_err(got, ref) <= 1e-6


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_paged_decode_plain_matches_pallas_windowed(variant):
    case = _decode_case(11, "int8", True, [23, 5, 0, 17])
    got, ref = _decode_pair(variant, "int8", case, window=6)
    assert _rel_err(got, ref) <= 1e-6


# ---------------------------------------------------------------------------
# paged prefill: plain version vs the Pallas kernel
# ---------------------------------------------------------------------------
def _prefill_case(seed, kv_dtype, dyadic, lengths, n_valid, C, d=D):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    q = _values(rng, (B, H, C, d), dyadic)
    kn, ksn = _kv(rng, (B, HKV, C, d), kv_dtype, dyadic)
    vn, vsn = _kv(rng, (B, HKV, C, d), kv_dtype, dyadic)
    k, ks = _kv(rng, (NBLK * PS, HKV, d), kv_dtype, dyadic)
    v, vs = _kv(rng, (NBLK * PS, HKV, d), kv_dtype, dyadic)
    bt = _tables(rng, [n + m for n, m in zip(lengths, n_valid)])
    return (q, kn, vn, ksn, vsn, k, v, ks, vs, bt,
            np.asarray(lengths, np.int32), np.asarray(n_valid, np.int32))


def _prefill_pair(variant, kv_dtype, case, window=None):
    q, kn, vn, ksn, vsn, k, v, ks, vs, bt, lens, nv = case
    kw = dict(page_size=PS, variant=variant, window=window)
    J = jnp.asarray
    if kv_dtype == "fp32":
        ref = fused_paged_prefill_attention_pallas(
            J(q), J(kn), J(vn), J(k), J(v), J(bt), J(lens), J(nv), **kw)
        got = fused_paged_prefill_attention(
            _t(q), _t(kn), _t(vn), _t(k), _t(v), _t(bt), _t(lens), _t(nv),
            **kw)
    else:
        ref = quant_fused_paged_prefill_attention_pallas(
            J(q), J(kn), J(vn), J(ksn), J(vsn), J(k), J(v), J(ks), J(vs),
            J(bt), J(lens), J(nv), **kw)
        got = quant_fused_paged_prefill_attention(
            _t(q), _t(kn), _t(vn), _t(ksn), _t(vsn), _t(k), _t(v), _t(ks),
            _t(vs), _t(bt), _t(lens), _t(nv), **kw)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "random"])
def test_paged_prefill_plain_matches_pallas(variant, kv_dtype, dyadic):
    # chunks starting mid-page (6, 9) and on a page boundary (0), a ragged
    # chunk, an idle row (0, 0)
    case = _prefill_case(20, kv_dtype, dyadic, [6, 0, 9, 0], [7, 0, 5, 3],
                         C=7)
    before = dict(build.COUNTS)
    got, ref = _prefill_pair(variant, kv_dtype, case)
    assert (build.COUNTS["paged_prefill_plain"]
            == before.get("paged_prefill_plain", 0) + 1)
    assert build.COUNTS["paged_prefill"] == before.get("paged_prefill", 0)
    np.testing.assert_array_equal(got[1], 0.0)        # the idle row
    tol = 1e-6 if dyadic else _ref_tol(variant, kv_dtype)
    assert _rel_err(got, ref) <= tol


@pytest.mark.parametrize("kernel", ["decode", "prefill"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_paged_plain_matches_pallas_at_head_dim_128(kernel, variant):
    """arctic-480b's head dim, 128 (the kernels' D 128 instantiations):
    one small case each, int8 codes, random inputs, ragged lengths, an
    idle row."""
    if kernel == "decode":
        case = _decode_case(13, "int8", False, [13, 0, MB * PS, 6], d=128)
        got, ref = _decode_pair(variant, "int8", case)
    else:
        case = _prefill_case(21, "int8", False, [6, 0, 9, 0], [7, 0, 5, 3],
                             C=7, d=128)
        got, ref = _prefill_pair(variant, "int8", case)
    assert got.shape[-1] == 128
    np.testing.assert_array_equal(got[1], 0.0)        # the idle row
    assert _rel_err(got, ref) <= _ref_tol(variant, "int8")


@pytest.mark.parametrize("kernel", ["decode", "prefill"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_paged_plain_matches_pallas_at_head_dim_112(kernel, variant,
                                                    kv_dtype):
    """kimi-k2-1t-a32b's head dim, 112 (28 feature groups, which the
    kernels' value side pads to 128): one small case each, random inputs,
    ragged lengths, an idle row."""
    if kernel == "decode":
        case = _decode_case(14, kv_dtype, False, [13, 0, MB * PS, 6], d=112)
        got, ref = _decode_pair(variant, kv_dtype, case)
    else:
        case = _prefill_case(23, kv_dtype, False, [6, 0, 9, 0], [7, 0, 5, 3],
                             C=7, d=112)
        got, ref = _prefill_pair(variant, kv_dtype, case)
    assert got.shape[-1] == 112
    np.testing.assert_array_equal(got[1], 0.0)        # the idle row
    assert _rel_err(got, ref) <= _ref_tol(variant, kv_dtype)


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_paged_prefill_length_past_table_matches_pallas(variant):
    case = list(_prefill_case(22, "int8", True, [MB * PS - 4, 2], [4, 4],
                              C=4))
    case[10] = np.array([MB * PS + 5, 2], np.int32)      # lengths
    got, ref = _prefill_pair(variant, "int8", tuple(case))
    assert _rel_err(got, ref) <= 1e-6


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_paged_prefill_plain_matches_pallas_windowed_blocked(variant):
    """A window, and query blocks smaller than the chunk: the plain version
    skips the same tiles per block as the Pallas kernel."""
    q, kn, vn, ksn, vsn, k, v, ks, vs, bt, lens, nv = _prefill_case(
        21, "int8", True, [10, 3, 0], [9, 9, 4], C=9)
    J = jnp.asarray
    ref = quant_fused_paged_prefill_attention_pallas(
        J(q), J(kn), J(vn), J(ksn), J(vsn), J(k), J(v), J(ks), J(vs),
        J(bt), J(lens), J(nv), page_size=PS, variant=variant, window=5,
        block_q=4)
    B, _, C, _ = q.shape

    def pages(a):      # (pool_tokens, Hkv, ...) -> (blocks, PS, Hkv, ...)
        return _t(a.reshape((NBLK, PS) + a.shape[1:]))

    def fold(a):       # (B, Hkv, C, ...) -> (B*Hkv, C, ...)
        return _t(a.reshape((B * HKV,) + a.shape[2:]))

    got = paged_prefill_fwd_plain(
        _t(bt), _t(lens), _t(nv), _t(q.reshape(B * H, C, D)), pages(k),
        pages(v), fold(kn), fold(vn), pages(ks), pages(vs), fold(ksn),
        fold(vsn), scale=D ** -0.5, variant=variant, window=5, page_size=PS,
        num_q_heads=H, num_kv_heads=HKV, block_q=4)
    assert _rel_err(got.reshape(B, H, C, D).numpy(), ref) <= 1e-6

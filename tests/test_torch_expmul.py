"""Port parity of the standalone ExpMul operator: ``repro_torch``'s
``expmul_fwd`` (its plain version on the CPU: the kernel ``csrc/expmul.cu``
runs only on a card), the frexp/ldexp oracle, ``expmul_rows`` and the
merged [l, o] update against ``repro`` (the Pallas kernel in interpret
mode, its oracle and ops) on the same numpy inputs, bit for bit; then the
contract's edge cases and properties, as ``tests/test_kernel_expmul.py``
states them for the reference.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels.expmul import ops as jops  # noqa: E402
from repro.kernels.expmul.expmul import expmul_pallas  # noqa: E402
from repro.kernels.expmul.ref import _lhat_ref as jax_lhat_ref  # noqa: E402
from repro.kernels.expmul.ref import expmul_exact_ref as jax_exact_ref  # noqa: E402
from repro.kernels.expmul.ref import expmul_ref as jax_expmul_ref  # noqa: E402
from repro.numerics import log2exp as jlog  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.expmul import (  # noqa: E402
    expmul_bcast,
    expmul_exact_ref,
    expmul_fwd,
    expmul_ref,
    expmul_rows,
)
from repro_torch.kernels.expmul.expmul import expmul_fwd_plain  # noqa: E402
from repro_torch.kernels.expmul.ops import merged_output_update  # noqa: E402
from repro_torch.kernels.expmul.ref import _lhat_ref  # noqa: E402
from repro_torch.numerics.log2exp import exact_expmul  # noqa: E402
from repro_torch.numerics.log2exp import expmul as expmul_bits  # noqa: E402

# the reference's sweep, plus the merged [l, o] rows of d + 1 = 65
SHAPES = [(1, 1), (3, 7), (8, 16), (32, 64), (128, 256), (257, 130),
          (64, 1024), (300, 65)]
DTYPES = ["float32", "bfloat16"]


def _t(a, dtype="float32"):
    """A numpy float32 array as a torch tensor of ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _bits(a):
    """Raw bits of a torch tensor or a JAX/numpy array (f32 or bf16)."""
    if isinstance(a, torch.Tensor):
        w = torch.int32 if a.dtype == torch.float32 else torch.int16
        return a.contiguous().view(w).numpy()
    a = np.asarray(a)
    return a.view(np.int32 if a.dtype == np.float32 else np.int16)


def _draw(rng, shape, scale=10.0):
    """x from [-20, 0] (the clip zone included), v of N(0, scale^2)."""
    x = -rng.uniform(0.0, 20.0, shape[0]).astype(np.float32)
    v = (rng.standard_normal(shape) * scale).astype(np.float32)
    return x, v


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_expmul_fwd_matches_pallas(shape, dtype):
    rng = np.random.default_rng(shape[0] * 7919 + shape[1])
    x, v = _draw(rng, shape)
    want = expmul_pallas(_j(x), _j(v, dtype))
    before = build.COUNTS["expmul_plain"]
    got = expmul_fwd(_t(x), _t(v, dtype))
    assert build.COUNTS["expmul_plain"] == before + 1
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the oracle agrees, and with the reference's oracle
    np.testing.assert_array_equal(
        _bits(expmul_ref(_t(x)[:, None], _t(v, dtype))), _bits(want))
    np.testing.assert_array_equal(
        _bits(jax_expmul_ref(_j(x)[:, None], _j(v, dtype))), _bits(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_oracle_and_bit_path_match_repro_oracle(dtype):
    """The reference's wider draw (x from [-30, 0], v of N(0, 100^2)) plus
    -1e6, 0, -0.0 and values near the exponent limits."""
    rng = np.random.default_rng(0)
    x = -rng.uniform(0.0, 30.0, (512, 1)).astype(np.float32)
    x[:4, 0] = [-1e6, 0.0, -0.0, -15.0]
    v = (rng.standard_normal((512, 64)) * 100.0).astype(np.float32)
    v[:, :6] = [3e38, -3e38, 2.0 ** -125, -(2.0 ** -126), 1.1754944e-38,
                -1.7e38]
    want = _bits(jax_expmul_ref(_j(x), _j(v, dtype)))
    np.testing.assert_array_equal(
        _bits(expmul_ref(_t(x), _t(v, dtype))), want)
    np.testing.assert_array_equal(
        _bits(expmul_bits(_t(x), _t(v, dtype))), want)
    np.testing.assert_array_equal(
        _bits(expmul_fwd(_t(x[:, 0]), _t(v, dtype))), want)


def test_lhat_ref_matches_repro_on_its_range():
    x = np.concatenate([np.linspace(-100, 0, 997, dtype=np.float32),
                        -np.arange(0, 15 * 2048 + 1, dtype=np.float32) / 2048,
                        np.array([-1e6, 0.0, -0.0], np.float32)])
    got = _lhat_ref(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_lhat_ref(_j(x))))
    assert got.dtype == np.int32 and got.min() >= 0 and got.max() <= 22


@pytest.mark.parametrize("dtype", DTYPES)
def test_exact_baselines_match_repro(dtype):
    """``torch.exp`` and XLA's exp differ by up to two float32 ulps, so the
    unfused baselines agree within 1e-6 relative in float32, and within
    one bfloat16 ulp (2^-7) where that rounds to bfloat16."""
    rng = np.random.default_rng(4)
    x, v = _draw(rng, (64, 48))
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for port, ref in ((exact_expmul, jlog.exact_expmul),
                      (expmul_exact_ref, jax_exact_ref)):
        got = port(_t(x)[:, None], _t(v, dtype))
        assert got.dtype == getattr(torch, dtype)
        want = np.asarray(ref(_j(x)[:, None], _j(v, dtype)), np.float32)
        np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                                   rtol=rtol, atol=0)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_merged_output_update_matches_repro(use_pallas, dtype):
    """Eq. 5 on (rows, d + 1) = (96, 65) merged [l, o] rows against the
    reference at either ``use_pallas``; the port always goes through
    ``expmul_fwd`` (its plain version on the CPU), twice."""
    rng = np.random.default_rng(5)
    rows, d1 = 96, 65
    o_star = (rng.standard_normal((rows, d1)) * 4).astype(np.float32)
    v_star = (rng.standard_normal((rows, d1)) * 4).astype(np.float32)
    m_prev = rng.uniform(-3, 1, rows).astype(np.float32)
    m_cur = np.maximum(m_prev, rng.uniform(-3, 1, rows).astype(np.float32))
    s = m_cur - rng.uniform(0, 18, rows).astype(np.float32)
    want = jops.merged_output_update(
        _j(o_star, dtype), _j(v_star, dtype), _j(m_prev), _j(m_cur), _j(s),
        use_pallas=use_pallas)
    before = build.COUNTS["expmul_plain"]
    got = merged_output_update(
        _t(o_star, dtype), _t(v_star, dtype), _t(m_prev), _t(m_cur), _t(s))
    assert build.COUNTS["expmul_plain"] == before + 2
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_expmul_rows_broadcast_path_matches_repro(use_pallas):
    """A 3-D V takes the broadcasting bit path in the reference, whatever
    the flag, and a 2-D V does with the flag off; the port flattens every
    such V to the kernel's (rows, d) and goes through ``expmul_fwd`` (its
    plain version on the CPU), with the same bits."""
    rng = np.random.default_rng(6)
    x = -rng.uniform(0, 20, 12).astype(np.float32)
    v3 = (rng.standard_normal((12, 5, 9)) * 10).astype(np.float32)
    before = build.COUNTS["expmul_plain"]
    got = expmul_rows(_t(x), _t(v3))
    assert build.COUNTS["expmul_plain"] == before + 1
    assert got.shape == (12, 5, 9)
    want = jops.expmul_rows(_j(x), _j(v3), use_pallas=use_pallas)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    v2 = v3[:, 0]
    got = expmul_rows(_t(x), _t(v2))
    assert build.COUNTS["expmul_plain"] == before + 2
    np.testing.assert_array_equal(
        _bits(got), _bits(jops.expmul_rows(_j(x), _j(v2),
                                           use_pallas=use_pallas)))
    np.testing.assert_array_equal(
        _bits(expmul_bcast(_t(x)[:, None, None], _t(v3))),
        _bits(jops.expmul_bcast(_j(x)[:, None, None], _j(v3))))


@pytest.mark.parametrize("x_shape", [(12, 5), (12, 1), (1, 5)])
def test_expmul_rows_flattens_leading_axes_like_repro(x_shape):
    """An x over several leading axes of V (or broadcasting over some of
    them) is expanded and flattened to the kernel's (rows,) against
    (rows, d), with the reference's bits."""
    rng = np.random.default_rng(8)
    x = -rng.uniform(0, 20, x_shape).astype(np.float32)
    v = (rng.standard_normal((12, 5, 9)) * 10).astype(np.float32)
    before = build.COUNTS["expmul_plain"]
    got = expmul_rows(_t(x), _t(v, "bfloat16"))
    assert build.COUNTS["expmul_plain"] == before + 1
    assert got.shape == v.shape and got.dtype == torch.bfloat16
    want = jops.expmul_rows(_j(x), _j(v, "bfloat16"))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("x_shape,v_shape",
                         [((12, 5), (12,)), ((12, 5), (12, 1)),
                          ((3,), (12, 5))])
def test_expmul_rows_refuses_a_broadcast_that_grows_v(x_shape, v_shape):
    with pytest.raises(ValueError, match="expmul_rows"):
        expmul_rows(torch.zeros(x_shape), torch.ones(v_shape))


def test_expmul_fwd_takes_views_and_any_float_x():
    rng = np.random.default_rng(7)
    x, v = _draw(rng, (40, 24))
    vt = _t(v.T.copy()).t()                       # a strided view
    assert not vt.is_contiguous()
    want = expmul_fwd(_t(x), _t(v))
    np.testing.assert_array_equal(_bits(expmul_fwd(_t(x), vt)), _bits(want))
    # x is cast to float32 first, as the reference does
    xd = torch.from_numpy(x.astype(np.float64))
    np.testing.assert_array_equal(_bits(expmul_fwd(xd, _t(v))), _bits(want))
    xb = _t(x, "bfloat16")
    np.testing.assert_array_equal(
        _bits(expmul_fwd(xb, _t(v))),
        _bits(expmul_pallas(_j(x, "bfloat16"), _j(v))))


def test_expmul_fwd_rejects_what_neither_version_takes():
    x, v = torch.zeros(4), torch.ones(4, 8)
    with pytest.raises(ValueError, match="rows"):
        expmul_fwd(torch.zeros(5), v)
    with pytest.raises(ValueError, match="rows"):
        expmul_fwd(torch.zeros(4, 1), v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        expmul_fwd(x, v.to(torch.float16))
    with pytest.raises(ValueError, match="float tensor"):
        expmul_fwd_plain(torch.zeros(4, dtype=torch.int32), v)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        expmul_fwd(x.to("meta"), v.to("meta"))


# ---------------------------------------------------------------------------
# edge cases and properties of the contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_x_zero_is_identity(dtype):
    rng = np.random.default_rng(1)
    v = _t(rng.standard_normal((16, 16)) * 10, dtype)
    np.testing.assert_array_equal(_bits(expmul_fwd(torch.zeros(16), v)),
                                  _bits(v))


@pytest.mark.parametrize("dtype", DTYPES)
def test_clip_region_scales_by_3_times_2_pow_22(dtype):
    # x << -15 clips to -15 -> L = round(15 * 1.4375) = round(21.5625) = 22
    out = expmul_fwd(torch.full((4,), -1e6), _t(np.full((4, 8), 3.0), dtype))
    assert (out.to(torch.float32) == 3.0 * 2.0 ** -22).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_zero_and_denormal_v_flush_to_plus_zero(dtype):
    x = torch.tensor([0.0, -0.5, -3.0])
    v = np.array([[0.0, -0.0, 1e-40, -1e-39],
                  [0.0, -0.0, 1e-40, -1e-39],
                  [2.0 ** -125, -(2.0 ** -125), 0.0, -0.0]], np.float32)
    out = expmul_fwd(x, _t(v, dtype))
    assert (_bits(out) == 0).all()      # +0 everywhere, no -0
    assert (_bits(expmul_ref(x[:, None], _t(v, dtype))) == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_sign_and_mantissa_kept_where_not_flushed(dtype):
    rng = np.random.default_rng(7)
    x = -rng.uniform(0.0, 15.0, 256).astype(np.float32)
    v = _t(rng.standard_normal((256, 32)) * 10, dtype)
    ob = _bits(expmul_fwd(_t(x), v))
    vb = _bits(v)
    keep = (np.array(0x807FFFFF, np.uint32).view(np.int32)  # sign, mantissa
            if dtype == "float32" else np.array(0x807F, np.uint16).view(np.int16))
    nonzero = ob != 0
    assert nonzero.mean() > 0.9
    assert np.all((vb & keep)[nonzero] == (ob & keep)[nonzero])


def test_quantization_error_bound():
    """|log2(expmul / exact)| <= 0.5 (rounding) + |x| (log2 e - 1.4375)
    + the fixed point's 2e-3."""
    x = np.linspace(-15.0, 0.0, 4001).astype(np.float32)
    q = expmul_fwd(_t(x), torch.ones(4001, 1)).numpy()[:, 0]
    ratio_log2 = np.log2(q / np.exp(x.astype(np.float64)))
    bound = 0.5 + np.abs(x) * (math.log2(math.e) - 1.4375) + 2e-3
    assert np.all(np.abs(ratio_log2) <= bound + 1e-6)


def test_relative_softmax_consistency():
    """Numerator and denominator quantize with the same weights: a row
    normalized from ExpMul weights sums to 1."""
    rng = np.random.default_rng(3)
    s = (rng.standard_normal(64) * 4.0).astype(np.float32)
    w = expmul_fwd(_t(s - s.max()), torch.ones(64, 1)).numpy()[:, 0]
    p = w / w.sum()
    assert abs(p.sum() - 1.0) < 1e-6


@settings(max_examples=200, deadline=None)
@given(x=st.floats(min_value=-60.0, max_value=0.0),
       v=st.floats(min_value=-8e24, max_value=8e24).filter(
           lambda t: t == 0.0 or abs(t) > 1e-35))
def test_property_scalar_matches_repro_oracle(x, v):
    want = _bits(jax_expmul_ref(_j([[x]]), _j([[v]])))
    np.testing.assert_array_equal(_bits(expmul_fwd(_t([x]), _t([[v]]))), want)
    np.testing.assert_array_equal(_bits(expmul_ref(_t([[x]]), _t([[v]]))),
                                  want)


@settings(max_examples=200, deadline=None)
@given(x=st.floats(min_value=-60.0, max_value=0.0),
       v=st.floats(min_value=-3e38, max_value=3e38).filter(
           lambda t: t == 0.0 or abs(t) > 1e-35))
def test_property_bfloat16_scalar_matches_repro_oracle(x, v):
    want = _bits(jax_expmul_ref(_j([[x]]), _j([[v]], "bfloat16")))
    got = expmul_fwd(_t([x]), _t([[v]], "bfloat16"))
    np.testing.assert_array_equal(_bits(got), want)
    np.testing.assert_array_equal(
        _bits(expmul_ref(_t([[x]]), _t([[v]], "bfloat16"))), want)


@settings(max_examples=100, deadline=None)
@given(x=st.floats(min_value=-100.0, max_value=0.0))
def test_property_lhat_ref_matches_repro(x):
    assert int(_lhat_ref(_t([x]))[0]) == int(jax_lhat_ref(_j([x]))[0])


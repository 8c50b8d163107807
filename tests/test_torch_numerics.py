"""Port numerics parity: ``repro_torch.numerics`` against ``repro.numerics``
bit for bit on shared numpy inputs (the ExpMul contract of log2exp.py and
the KV codecs of quant.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.numerics import log2exp as jl  # noqa: E402
from repro.numerics import quant as jq  # noqa: E402
from repro_torch.numerics import log2exp as tl  # noqa: E402
from repro_torch.numerics import quant as tq  # noqa: E402


def _grid():
    """[-15, 0] on a fine grid, below -15, the half-way points of the
    fixed-point and L_hat roundings, +-0 and denormals."""
    rng = np.random.default_rng(0)
    xs = [np.linspace(-15.0, 0.0, 30721, dtype=np.float32),
          -np.arange(0, 15 * 1024 + 1, dtype=np.float32) / 1024.0,
          (-np.arange(0, 15 * 2048 + 1, dtype=np.float32) - 0.5) / 2048.0,
          np.array([-15.0001, -16.0, -100.0, -1e30, 0.0, -0.0, 1e-3,
                    -1e-45, -1e-40, 1e-40], dtype=np.float32),
          -np.abs(rng.standard_normal(4096).astype(np.float32)) * 6]
    return np.concatenate(xs)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a, dtype):
    if dtype == "float32":
        return np.asarray(a, np.float32).view(np.uint32)
    return np.asarray(a).view(np.uint16)


def test_log2exp_lhat_bit_exact():
    x = _grid()
    ref = np.asarray(jl.log2exp_lhat(jnp.asarray(x)))
    got = tl.log2exp_lhat(_t(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_log2exp_and_expmul_nan_inf_x_bit_exact(dtype):
    """Outside the contract (finite inputs), still as the reference: a NaN
    x gives L_hat 0 (``repro`` clips, then casts), +inf 0 and -inf 22;
    ExpMul then scales v by those, NaN and inf v included. The bfloat16 v
    is built from raw bits on both sides, since a NaN's conversion from
    float32 differs between the frameworks."""
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    x = np.array([nan, -nan, inf, -inf, 0.0, -0.0, -3.0], np.float32)
    np.testing.assert_array_equal(tl.log2exp_lhat(_t(x)).numpy(),
                                  np.asarray(jl.log2exp_lhat(jnp.asarray(x))))
    v32 = np.array([nan, inf, -inf, 1.0, -1.5, 1e-40, -0.0, 3e38], np.float32)
    X = np.repeat(x[:, None], v32.size, 1)
    if dtype == "float32":
        V = np.repeat(v32[None], x.size, 0)
        jv, tv = jnp.asarray(V), _t(V)
    else:
        bits = np.repeat(np.asarray(jnp.asarray(v32).astype(jnp.bfloat16))
                         .view(np.uint16)[None], x.size, 0)
        jv = jnp.asarray(bits.view(ml_dtypes.bfloat16))
        tv = _t(bits.view(np.int16)).view(torch.bfloat16)
    ref = np.asarray(jl.expmul(jnp.asarray(X), jv))
    got = tl.expmul(_t(X), tv)
    got_bits = (got.numpy().view(np.uint32) if dtype == "float32"
                else got.view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(got_bits, _bits(ref, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_pow2_scale_bit_exact(dtype):
    rng = np.random.default_rng(1)
    v = np.concatenate([
        rng.standard_normal(20000).astype(np.float32) * 10,
        np.array([0.0, -0.0, 1e-40, -1e-40, 1e-38, -1.2e-38, 2.0**-126,
                  -(2.0**-126), 2.0**-120, 3e38], dtype=np.float32)])
    lhat = rng.integers(0, 23, size=v.shape).astype(np.int32)
    lhat[-10:] = 0   # the flush of denormals and -0 at L_hat = 0
    lhat[:64] = 0
    if dtype == "float32":
        jv, tv = jnp.asarray(v), _t(v)
    else:
        jv = jnp.asarray(v).astype(jnp.bfloat16)
        tv = _t(v).to(torch.bfloat16)
    ref = np.asarray(jl.apply_pow2_scale(jv, jnp.asarray(lhat)))
    got = tl.apply_pow2_scale(tv, _t(lhat))
    if dtype == "float32":
        got_bits = got.numpy().view(np.uint32)
    else:
        got_bits = got.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got_bits, _bits(ref, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pow2_neg_and_expmul_bit_exact(dtype):
    lhat = np.arange(0, 200, dtype=np.int32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = np.asarray(jl.pow2_neg(jnp.asarray(lhat), jd))
    got = tl.pow2_neg(_t(lhat), td)
    got_bits = (got.numpy().view(np.uint32) if dtype == "float32"
                else got.view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(got_bits, _bits(ref, dtype))

    x = _grid()[:4096].reshape(-1, 1)
    v = np.random.default_rng(2).standard_normal((4096, 8)).astype(np.float32)
    ref = np.asarray(jl.expmul(jnp.asarray(x), jnp.asarray(v).astype(jd)))
    got = tl.expmul(_t(x), _t(v).to(td))
    got_bits = (got.numpy().view(np.uint32) if dtype == "float32"
                else got.view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(got_bits, _bits(ref, dtype))


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantize_kv_bit_exact(kv_dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 5, 64)).astype(np.float32) * 3
    x[0, 0] = 0.0                        # all-zero rows: scale 1, codes 0
    x[1, :, ::2] = 0.0
    x[2, 1] = np.linspace(-1, 1, 64) * 1e-3
    x[3, 2, :8] = [0.5, -0.5, 1.5, -1.5, 2.5, 1e-9, -1e-9, 127]  # halves
    ref = jq.quantize_kv(jnp.asarray(x), kv_dtype)
    got = tq.quantize_kv(_t(x), kv_dtype)
    np.testing.assert_array_equal(got.scale.numpy().view(np.uint32),
                                  np.asarray(ref.scale).view(np.uint32))
    ref_codes = np.asarray(ref.codes)
    if kv_dtype == "int8":
        np.testing.assert_array_equal(got.codes.numpy(), ref_codes)
    else:
        np.testing.assert_array_equal(
            got.codes.view(torch.uint8).numpy(),
            ref_codes.view(np.uint8))
        assert ref_codes.dtype == ml_dtypes.float8_e4m3fn
    # bf16 inputs quantize from their float32 values on both sides
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref_b = jq.quantize_kv(xb, kv_dtype)
    got_b = tq.quantize_kv(_t(x).to(torch.bfloat16), kv_dtype)
    np.testing.assert_array_equal(got_b.scale.numpy(), np.asarray(ref_b.scale))
    np.testing.assert_array_equal(
        got_b.codes.view(torch.uint8 if kv_dtype == "fp8" else torch.int8)
        .numpy(), np.asarray(ref_b.codes).view(
            np.uint8 if kv_dtype == "fp8" else np.int8))
    # dequantization: codes * scale in float32
    dq_ref = np.asarray(jq.dequantize_kv(ref.codes, ref.scale, kv_dtype))
    np.testing.assert_array_equal(
        tq.dequantize_kv(got.codes, got.scale, kv_dtype).numpy(), dq_ref)

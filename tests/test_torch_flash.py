"""Port parity of the training path's attention: ``repro_torch``'s
full-sequence flash forward (the plain version of ``csrc/flash.cu``), its
recompute backward and the STE numerics, against ``repro`` (the Pallas
kernel in interpret mode, ``flash_jnp`` and ``jax.vjp``) on the same numpy
inputs.

Both forwards walk the same padded KV tiles in the same order, so they are
held at 1e-6 of the output's magnitude on dyadic inputs (every score is
exact) and 1e-5 on random ones, and at one bf16 ulp (2^-7 of the
magnitude) for a bfloat16 output. Sq = 80 with 32-wide tiles makes the
forward pad K to 96 columns while the backward takes 20-wide blocks (the
largest divisor of 80 not above 32); Sq = 64 exercises the backward's
causal query chunks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.attention import attention as jax_attention  # noqa: E402
from repro.core.attention import attention_ref as jax_attention_ref  # noqa: E402
from repro.core.attention import flash_jnp  # noqa: E402
from repro.kernels.flash.ops import flash_attention_fwd as jax_flash  # noqa: E402
from repro.numerics import log2exp as jlog  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.attention import (  # noqa: E402
    attention,
    attention_ref,
    flash_ref,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash.flash import flash_fwd_plain  # noqa: E402
from repro_torch.kernels.flash.ops import flash_attention_fwd  # noqa: E402
from repro_torch.numerics.log2exp import expmul_ste, qexp_ste  # noqa: E402

D = 16
BQ, BK = 16, 32   # the reference's query block (the port has none) and tile
# (Sq, Sk, causal, window): causal, causal + window, non-causal Sk != Sq
MASKS = {"causal": lambda s: (s, s, True, None),
         "window": lambda s: (s, s, True, 24),
         "cross": lambda s: (s, s + 16, False, None)}


def _act(rng, shape, dyadic):
    if dyadic:
        return rng.integers(-16, 17, shape).astype(np.float32) / 8.0
    return rng.standard_normal(shape).astype(np.float32)


def _inputs(rng, B, H, Hkv, Sq, Sk, dyadic):
    return tuple(_act(rng, shape, dyadic) for shape in
                 ((B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)))


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("Sq", [64, 80])
@pytest.mark.parametrize("heads", [(4, 2), (4, 1)], ids=["gqa", "mqa"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_flash_forward_plain_matches_pallas(variant, dtype, mask, heads, Sq):
    H, Hkv = heads
    Sq, Sk, causal, window = MASKS[mask](Sq)
    rng = np.random.default_rng(Sq + 7 * H * Hkv)
    tdt = getattr(torch, dtype)
    for dyadic in (True, False):
        q, k, v = _inputs(rng, 2, H, Hkv, Sq, Sk, dyadic)
        want = jax_flash(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                         causal=causal, window=window, variant=variant,
                         block_q=BQ, block_k=BK)
        before = build.COUNTS["flash_plain"]
        got = flash_attention_fwd(
            *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
            causal=causal, window=window, variant=variant, block_k=BK)
        assert build.COUNTS["flash_plain"] == before + 1
        assert got.dtype == tdt and tuple(got.shape) == (2, H, Sq, D)
        if dtype == "bfloat16":
            tol = 2.0 ** -7
        else:
            tol = 1e-6 if dyadic else 1e-5
        err = _rel(_np(got), np.asarray(want, np.float32))
        assert err <= tol, (dyadic, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_flash_forward_plain_matches_pallas_head_dim_32(variant, dtype):
    """Head dim 32 (one accumulator value a lane in ``csrc/flash.cu``), the
    width of the fidelity study's model: causal over 80 tokens, GQA 4/2,
    at the limits of the test above."""
    rng = np.random.default_rng(32)
    tdt = getattr(torch, dtype)
    for dyadic in (True, False):
        q, k, v = (_act(rng, s, dyadic) for s in
                   ((2, 4, 80, 32), (2, 2, 80, 32), (2, 2, 80, 32)))
        want = jax_flash(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                         causal=True, variant=variant, block_q=BQ,
                         block_k=BK)
        got = flash_attention_fwd(
            *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal=True,
            variant=variant, block_k=BK)
        assert got.dtype == tdt and tuple(got.shape) == (2, 4, 80, 32)
        if dtype == "bfloat16":
            tol = 2.0 ** -7
        else:
            tol = 1e-6 if dyadic else 1e-5
        err = _rel(_np(got), np.asarray(want, np.float32))
        assert err <= tol, (dyadic, err)


def test_flash_plain_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(2, 4, 64, D)
    kv = torch.zeros(2, 2, 64, D)
    kw = dict(causal=True, scale=0.25, window=None, variant="exact",
              num_q_heads=4, num_kv_heads=2, kv_len=64)
    fold = (lambda t: t.reshape(-1, 64, D))
    with pytest.raises(ValueError, match="block_k"):
        flash_fwd_plain(fold(q), fold(kv), fold(kv), block_k=1024, **kw)
    with pytest.raises(ValueError, match="share float32"):
        flash_fwd_plain(fold(q), fold(kv).to(torch.bfloat16), fold(kv),
                        block_k=64, **kw)
    with pytest.raises(ValueError, match="Dq == Dv"):
        flash_attention_fwd(q, kv, torch.zeros(2, 2, 64, 2 * D))


@pytest.mark.parametrize("Sq,mask", [(64, "causal"), (80, "causal"),
                                     (80, "window"), (80, "cross")])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_flash_ref_and_grads_match_flash_jnp(variant, Sq, mask):
    Sq, Sk, causal, window = MASKS[mask](Sq)
    rng = np.random.default_rng(Sq)
    q, k, v = _inputs(rng, 2, 4, 2, Sq, Sk, False)
    g = rng.standard_normal((2, 4, Sq, D)).astype(np.float32)
    ste = variant == "expmul"
    kw = dict(causal=causal, window=window, variant=variant, use_ste=ste,
              block_k=BK)

    want, pullback = jax.vjp(lambda *a: flash_jnp(*a, **kw),
                             *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = pullback(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = flash_ref(tq, tk, tv, **kw)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(g))
    assert _rel(_np(got), want) <= 1e-5
    for a, b in zip(grads, want_grads):
        assert _rel(_np(a), b) <= 1e-4
    # the full-softmax reference agrees with the block walk (exact) and
    # runs the same quantized weights (ExpMul, here without STE)
    ref = attention_ref(tq, tk, tv, causal=causal, window=window,
                        variant=variant)
    jref = jax_attention_ref(*(jnp.asarray(x) for x in (q, k, v)),
                             causal=causal, window=window, variant=variant)
    assert _rel(_np(ref), jref) <= 1e-5


def test_reference_default_route_gives_expmul_queries_no_gradient():
    """The reference's ``flash_jnp`` without STE (its launcher's default
    route) differentiates ExpMul's integer Log2Exp: q and k get exactly
    zero gradient. The port's training path is the "pallas" route, whose
    backward uses STE; its q and k gradients are not zero."""
    rng = np.random.default_rng(3)
    q, k, v = _inputs(rng, 1, 4, 2, 32, 32, False)

    def loss(q, k, v):
        return jnp.sum(flash_jnp(q, k, v, variant="expmul", block_k=16) ** 2)

    dq, dk, _ = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    assert float(jnp.abs(dq).max()) == 0.0 and float(jnp.abs(dk).max()) == 0.0
    cfg = get_config("qwen2-0.5b", smoke=True, attention_block_k=BK)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    gq, gk, _ = torch.autograd.grad(
        (attention(tq, tk, tv, cfg) ** 2).sum(), (tq, tk, tv))
    assert float(gq.abs().max()) > 0 and float(gk.abs().max()) > 0


@pytest.mark.parametrize("Sq", [64, 80])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_attention_function_grads_match_pallas_vjp(variant, Sq):
    """The twin of ``tests/test_kernel_flash.py``'s custom-VJP test: the
    port's autograd Function (flash forward, recompute backward), through
    either ``attention_impl``, against ``jax.grad`` through
    ``attention(impl="pallas")``."""
    rng = np.random.default_rng(40 + Sq)
    q, k, v = _inputs(rng, 2, 4, 2, Sq, Sq, False)
    g = rng.standard_normal((2, 4, Sq, D)).astype(np.float32)

    def loss(q, k, v):
        o = jax_attention(q, k, v, impl="pallas", causal=True,
                          variant=variant, block_q=BQ, block_k=BK)
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    for impl in ("kernel", "plain"):
        cfg = get_config("qwen2-0.5b", smoke=True, attention_variant=variant,
                         attention_impl=impl, attention_block_k=BK)
        tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                      for x in (q, k, v))
        o = attention(tq, tk, tv, cfg)
        got = torch.autograd.grad((o * torch.from_numpy(g)).sum(),
                                  (tq, tk, tv))
        for a, b in zip(got, want):
            assert _rel(_np(a), b) <= 1e-4, impl


def test_ste_forms_match_repro():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-20, 1, 4000),
                        np.array([0.0, -15.0, -1e-8, 2.5, -1e30])]
                       ).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = qexp_ste(tx)
    (dx,) = torch.autograd.grad(out, tx, torch.from_numpy(g))
    want, pullback = jax.vjp(jlog.qexp_ste, jnp.asarray(x))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    (wdx,) = pullback(jnp.asarray(g))
    assert _rel(dx.numpy(), wdx) <= 1e-6

    # expmul_ste with a per-row x broadcast against value rows
    xr = rng.uniform(-16, 0, (64, 1)).astype(np.float32)
    vr = rng.standard_normal((64, 24)).astype(np.float32)
    gr = rng.standard_normal((64, 24)).astype(np.float32)
    txr = torch.from_numpy(xr).requires_grad_(True)
    tvr = torch.from_numpy(vr).requires_grad_(True)
    out = expmul_ste(txr, tvr)
    dxr, dvr = torch.autograd.grad(out, (txr, tvr), torch.from_numpy(gr))
    want, pullback = jax.vjp(jlog.expmul_ste, jnp.asarray(xr),
                             jnp.asarray(vr))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    wdx, wdv = pullback(jnp.asarray(gr))
    assert dxr.shape == xr.shape
    assert _rel(dxr.numpy(), wdx) <= 1e-6
    assert _rel(dvr.numpy(), wdv) <= 1e-6

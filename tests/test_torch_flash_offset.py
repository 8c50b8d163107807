"""The full-sequence flash forward and its recompute backward at a query
offset (``q_offset``): a call on rows a: of a causal sequence, the keys
the whole sequence's, as each rank of a query-split call runs it
(``sharding/regions.py:sharded_attention``). On numpy inputs from a seed:

- the plain version at ``q_offset=a`` equals rows a: (and a - 16: a) of
  the whole plain call bit for bit, causal and windowed, exact and
  ExpMul, float32 and bfloat16, at offsets on and off the 16-row query
  block and the 32-wide tiles, and so equals rows a: of ``repro``'s
  Pallas flash (interpret mode) within ``tests/test_torch_flash.py``'s
  bounds;
- ``FlashAttention``'s recompute backward at ``q_offset=a`` gives the
  whole call's dq rows a: bit for bit, and the dk and dv of the whole
  call whose output gradient is zero above row a, when a is a multiple
  of the backward's query chunk (the whole call's chunks then split as
  the rank's do); and within 1e-6 of them at any other offset;
- the kernel wrapper refuses a negative offset.

The card holds the kernel likewise (``tests/test_torch_cuda.py``,
``chip_smoke.py``'s "flash offset" phase)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash.ops import flash_attention_fwd as jax_flash  # noqa: E402
from repro_torch.core.attention import FlashAttention  # noqa: E402
from repro_torch.kernels.flash.flash import flash_fwd_plain  # noqa: E402
from repro_torch.kernels.flash.ops import flash_attention_fwd  # noqa: E402

B, H, HKV, S, D, BQ, BK = 2, 4, 2, 128, 16, 16, 32


def _inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, H, S, D), (B, HKV, S, D), (B, HKV, S, D), (B, H, S, D))]
    return arrays, [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("window", [None, 24], ids=["causal", "window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_offset_forward_is_the_whole_calls_rows(variant, dtype, window):
    arrays, (q, k, v, _) = _inputs(5, getattr(torch, dtype))
    kw = dict(causal=True, window=window, variant=variant, block_k=BK,
              plain=True)
    whole = flash_attention_fwd(q, k, v, **kw)
    want = np.asarray(jax_flash(*(jnp.asarray(x, dtype) for x in arrays[:3]),
                                causal=True, window=window, variant=variant,
                                block_q=BQ, block_k=BK), np.float32)
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    for a in (16, 32, 40, 64, 100, 127):
        got = flash_attention_fwd(q[:, :, a:], k, v, q_offset=a, **kw)
        assert torch.equal(got, whole[:, :, a:]), a
        # a middle rank's rows: a - 16 .. a
        mid = flash_attention_fwd(q[:, :, a - 16:a], k, v, q_offset=a - 16,
                                  **kw)
        assert torch.equal(mid, whole[:, :, a - 16:a]), a
        ref = want[:, :, a:]
        err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
        assert err <= tol, (a, err)


def _grads(q, k, v, g, a, variant):
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = FlashAttention.apply(q, k, v, True, 1.0 / math.sqrt(D), None,
                             variant, BK, True, a)
    return torch.autograd.grad(o, (q, k, v), g)


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_offset_recompute_backward_is_the_whole_calls(variant):
    _, (q, k, v, g) = _inputs(9, torch.float32)
    dq, _, _ = _grads(q, k, v, g, 0, variant)
    # the backward's 32-wide blocks and 4 causal chunks of 32 rows
    for a, exact in ((32, True), (64, True), (96, True), (40, False),
                     (100, False)):
        dqa, dka, dva = _grads(q[:, :, a:], k, v, g[:, :, a:], a, variant)
        g0 = g.clone()
        g0[:, :, :a] = 0
        _, dk0, dv0 = _grads(q, k, v, g0, 0, variant)
        for got, want in ((dqa, dq[:, :, a:]), (dka, dk0), (dva, dv0)):
            if exact:
                assert torch.equal(got, want), a
            else:
                err = float((got - want).abs().max() / want.abs().max())
                assert err <= 1e-6, (a, err)


def test_negative_offset_is_refused():
    _, (q, k, v, _) = _inputs(1, torch.float32)
    with pytest.raises(ValueError, match="q_offset"):
        flash_fwd_plain(q.reshape(B * H, S, D), k.reshape(B * HKV, S, D),
                        v.reshape(B * HKV, S, D), causal=True, scale=0.25,
                        window=None, variant="exact", block_k=BK,
                        num_q_heads=H, num_kv_heads=HKV, kv_len=S,
                        q_offset=-1)

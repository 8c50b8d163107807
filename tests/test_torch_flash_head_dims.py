"""Port parity of the full-sequence flash forward at the head dims the
CUDA kernel learned for training: 96 (minicpm3-4b's qk width, V
zero-padded to it), 112 (kimi-k2-1t-a32b) and 256 (gemma-7b,
recurrentgemma-2b). The plain version (``kernels/flash/flash.py:
flash_fwd_plain``, through ``flash_attention_fwd`` on CPU tensors) against
``repro``'s Pallas kernel in interpret mode on the same numpy inputs, at
``tests/test_torch_flash.py``'s limits: 1e-6 of the output's magnitude on
dyadic inputs, 1e-5 on random ones, one bf16 ulp for a bfloat16 output.
Causal over 80 tokens with 32-wide tiles (K padded to 96), windowed, and
non-causal 80 queries over 96 keys; one sequence, 2 query heads over 1 KV
head (the interpreted Pallas kernel's time grows with its grid).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash.ops import (  # noqa: E402
    flash_attention_fwd as jax_flash,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode.decode import check_head_dims  # noqa: E402
from repro_torch.kernels.flash.ops import flash_attention_fwd  # noqa: E402

BQ, BK, S = 16, 32, 80
MASKS = {"causal": (S, True, None), "window": (S, True, 24),
         "cross": (S + 16, False, None)}


def _act(rng, shape, dyadic):
    if dyadic:
        return rng.integers(-16, 17, shape).astype(np.float32) / 8.0
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("D", [96, 112, 256])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_flash_forward_plain_matches_pallas_new_head_dims(variant, dtype,
                                                          mask, D):
    check_head_dims("flash", D, D)        # the kernel takes it too
    H, Hkv = 2, 1
    Sk, causal, window = MASKS[mask]
    rng = np.random.default_rng(D + 7 * H * Hkv)
    tdt = getattr(torch, dtype)
    for dyadic in (True, False):
        q, k, v = (_act(rng, s, dyadic) for s in
                   ((1, H, S, D), (1, Hkv, Sk, D), (1, Hkv, Sk, D)))
        want = np.asarray(jax_flash(
            *(jnp.asarray(x, dtype) for x in (q, k, v)), causal=causal,
            window=window, variant=variant, block_q=BQ, block_k=BK),
            np.float32)
        before = build.COUNTS["flash_plain"]
        got = flash_attention_fwd(
            *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
            causal=causal, window=window, variant=variant, block_k=BK)
        assert build.COUNTS["flash_plain"] == before + 1
        assert got.dtype == tdt and tuple(got.shape) == (1, H, S, D)
        if dtype == "bfloat16":
            tol = 2.0 ** -7
        else:
            tol = 1e-6 if dyadic else 1e-5
        got = got.to(torch.float32).numpy()
        err = float(np.abs(got - want).max() / np.abs(want).max())
        assert err <= tol, (dyadic, err)

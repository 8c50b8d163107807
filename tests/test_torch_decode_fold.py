"""The contiguous decode kernel's algorithm against the sequential walk,
on the CPU.

``csrc/decode.cu`` runs the reference's KV tiles in parallel: each tile's
weights, weight sum and value product come from the prefix maximum of the
tiles' maxima, and only the fold of those partials runs in tile order.
``kernels/flash/tile.py:decode_fold`` is that algorithm in plain PyTorch;
it must equal ``decode_fwd_plain`` (the reference's sequential walk, which
the kernel is held against on the card) bit for bit: {exact, expmul} x
{f32, bf16, int8, fp8} caches, lengths {0, 1, 255, 256, 257, 1024, S}
(those within S) over S in {300, 2048}, GQA groups {1, 7}, stale rows past
every length. One case is also held against ``repro``'s Pallas kernel in
interpret mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode.ops import (  # noqa: E402
    quant_decode_attention_pallas,
)
from repro_torch.kernels.checks import contiguous_case  # noqa: E402
from repro_torch.kernels.decode.decode import decode_fwd_plain  # noqa: E402
from repro_torch.kernels.flash.tile import decode_fold  # noqa: E402

HKV, D = 2, 16
LENGTHS = (0, 1, 255, 256, 257, 1024)


def _case(kv, S, group, seed):
    lengths = [n for n in LENGTHS if n <= S] + [S]
    rng = np.random.default_rng(seed)
    case = contiguous_case(rng, B=len(lengths), H=HKV * group, Hkv=HKV, D=D,
                           S=S, lengths=lengths, kv=kv, dyadic=False,
                           device="cpu")
    B = len(lengths)
    fold = (lambda t: None if t is None
            else t.reshape((B * HKV,) + tuple(t.shape[2:])))
    return (case["q"].reshape(B * HKV, group, D), fold(case["k"]),
            fold(case["v"]), case["lengths"], fold(case["ks"]),
            fold(case["vs"]))


@pytest.mark.parametrize("group", [1, 7])
@pytest.mark.parametrize("S", [300, 2048])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_decode_fold_equals_sequential_walk(variant, kv, S, group):
    q3, k3, v3, lens, ks2, vs2 = _case(kv, S, group, seed=S + group)
    kw = dict(scale=D ** -0.5, variant=variant, num_kv_heads=HKV)
    got = decode_fold(q3, k3, v3, lens, ks2, vs2, **kw)
    ref = decode_fwd_plain(q3, k3, v3, lens, ks2, vs2, **kw)
    assert torch.isfinite(ref).all()
    assert torch.equal(got, ref)
    assert float(got.view(-1, HKV, group, D)[0].abs().max()) == 0.0  # length 0


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_decode_fold_matches_pallas(variant):
    """int8 codes, S = 300 (two tiles, the second ragged), group 7, against
    ``quant_decode_attention_pallas`` in interpret mode: 1e-5 of the
    output's magnitude, the plain versions' tolerance against it."""
    group, S = 7, 300
    q3, k3, v3, lens, ks2, vs2 = _case("int8", S, group, seed=5)
    B = lens.shape[0]
    got = decode_fold(q3, k3, v3, lens, ks2, vs2, scale=D ** -0.5,
                      variant=variant, num_kv_heads=HKV)
    J = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    ref = np.asarray(quant_decode_attention_pallas(
        J(q3.reshape(B, HKV * group, D)),
        J(k3.reshape(B, HKV, S, D)).astype(jnp.int8),
        J(v3.reshape(B, HKV, S, D)).astype(jnp.int8),
        J(ks2.reshape(B, HKV, S)), J(vs2.reshape(B, HKV, S)), J(lens),
        variant=variant, block_k=256), np.float64)
    got = got.reshape(B, HKV * group, D).numpy().astype(np.float64)
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) <= 1e-5

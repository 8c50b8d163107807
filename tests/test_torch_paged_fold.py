"""The paged decode kernel's algorithm against the sequential walk, and the
summation order of the plain tile step's products, on the CPU.

``csrc/paged_decode.cu`` runs the reference's pages in parallel over the
ranks of a thread-block cluster, several pages a rank a round: each page's
weights, weight sum and value product come from its prefix maximum, and
only the fold of those partials runs in page order.
``kernels/flash/tile.py:paged_decode_fold`` is that algorithm in plain
PyTorch; it must equal ``paged_decode_fwd_plain`` (the reference's
sequential walk, which the kernel is held against on the card) bit for
bit: {exact, expmul} x {f32, int8} pools, shuffled tables, lengths 0, 1,
ps - 1, ps, ps + 1, the table's full width and past it, a sentinel inside
a length, with and without a window, at 1, 3 and 8 pages a rank over
clusters of 2 and 8; and at gemma-7b's head dim 256 over float32 pools,
at the pages a rank takes there (2 of 16 rows, 1 of 32). One case is also
held against ``repro``'s Pallas kernel in interpret mode.

``fma_chain`` sums a product as the kernels do, one fused multiply-add
chain per output in index order: pinned here on inputs where the order,
or rounding the product first, changes the result.
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode.ops import (  # noqa: E402
    quant_fused_paged_decode_attention_pallas,
)
from repro_torch.kernels.checks import paged_case, sentinel_within  # noqa: E402
from repro_torch.kernels.decode.decode import (  # noqa: E402
    paged_decode_fwd_plain,
)
from repro_torch.kernels.flash.tile import (  # noqa: E402
    fma_chain,
    paged_decode_fold,
)

HKV, GROUP, D, PS, MB = 2, 7, 16, 16, 24


def _case(kv, seed, window):
    """Rows: idle, 1, ps - 1, ps, ps + 1, the table's full width, past it
    (the walk stops at the width), and 83 tokens with a sentinel at page 2
    (clamped to the last pool block)."""
    lengths = [0, 1, PS - 1, PS, PS + 1, MB * PS, MB * PS, 83]
    case = paged_case(np.random.default_rng(seed), B=len(lengths),
                      H=HKV * GROUP, Hkv=HKV, D=D, page_size=PS,
                      max_blocks=MB, lengths=lengths, kv=kv, dyadic=False,
                      window=window, device="cpu")
    case["lengths"][6] = MB * PS + 9
    sentinel_within(case, 7, 2)
    nblk = case["k_pool"].shape[0] // PS

    def pool(t, *tail):
        return None if t is None else t.view((nblk, PS, HKV) + tail)

    B = len(lengths)
    return (case["block_tables"], case["lengths"],
            case["q"].reshape(B * HKV, GROUP, D), pool(case["k_pool"], D),
            pool(case["v_pool"], D), pool(case["ks_pool"]),
            pool(case["vs_pool"]))


@pytest.mark.parametrize("pages,cluster", [(1, 8), (8, 8), (3, 2)],
                         ids=["1page-cl8", "8pages-cl8", "3pages-cl2"])
@pytest.mark.parametrize("window", [None, 21], ids=["full", "window21"])
@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_paged_decode_fold_equals_sequential_walk(variant, kv, window, pages,
                                                  cluster):
    args = _case(kv, seed=len(kv) + (window or 0), window=window)
    kw = dict(scale=D ** -0.5, variant=variant, page_size=PS, window=window,
              num_kv_heads=HKV)
    got = paged_decode_fold(*args, pages_per_rank=pages, cluster=cluster,
                            **kw)
    ref = paged_decode_fwd_plain(*args, **kw)
    assert torch.isfinite(ref).all()
    assert torch.equal(got, ref)
    assert float(got.view(-1, HKV, GROUP, D)[0].abs().max()) == 0.0  # idle


@pytest.mark.parametrize("ps,pages", [(16, 2), (32, 1)],
                         ids=["ps16-2pages", "ps32-1page"])
@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_paged_decode_fold_at_head_dim_256(variant, ps, pages):
    """At head dim 256 a rank stages 32 float32 pool rows a round
    (``csrc/paged_decode.cu:rank_rows``): 2 pages of 16 or 1 of 32 over a
    cluster of 8, so 256 tokens a round: a 300-token row and the table's
    full width (512) take 2 rounds. The fold is still the sequential walk
    bit for bit."""
    hkv, d, mb = 2, 256, 512 // ps
    lengths = [0, 1, ps + 1, 300, mb * ps]
    case = paged_case(np.random.default_rng(ps), B=len(lengths), H=hkv,
                      Hkv=hkv, D=d, page_size=ps, max_blocks=mb,
                      lengths=lengths, kv="f32", dyadic=False, device="cpu")
    nblk = case["k_pool"].shape[0] // ps
    args = (case["block_tables"], case["lengths"],
            case["q"].reshape(len(lengths) * hkv, 1, d),
            case["k_pool"].view(nblk, ps, hkv, d),
            case["v_pool"].view(nblk, ps, hkv, d))
    kw = dict(scale=d ** -0.5, variant=variant, page_size=ps, window=None,
              num_kv_heads=hkv)
    got = paged_decode_fold(*args, pages_per_rank=pages, cluster=8, **kw)
    ref = paged_decode_fwd_plain(*args, **kw)
    assert torch.isfinite(ref).all()
    assert torch.equal(got, ref)
    assert float(got[:hkv].abs().max()) == 0.0                      # idle


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_paged_decode_fold_matches_pallas(variant):
    """int8 codes, the rows above, 8 pages a rank over a cluster of 8,
    against ``quant_fused_paged_decode_attention_pallas`` in interpret
    mode: 1e-5 of the output's magnitude, the plain versions' tolerance
    against it."""
    bt, lens, q3, k4, v4, ks3, vs3 = _case("int8", seed=5, window=None)
    B = lens.shape[0]
    got = paged_decode_fold(bt, lens, q3, k4, v4, ks3, vs3, scale=D ** -0.5,
                            variant=variant, page_size=PS, window=None,
                            num_kv_heads=HKV, pages_per_rank=8, cluster=8)
    J = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    ref = np.asarray(quant_fused_paged_decode_attention_pallas(
        J(q3.reshape(B, HKV * GROUP, D)), J(k4.flatten(0, 1)),
        J(v4.flatten(0, 1)), J(ks3.flatten(0, 1)), J(vs3.flatten(0, 1)),
        J(bt), J(lens), page_size=PS, variant=variant), np.float64)
    got = got.reshape(B, HKV * GROUP, D).numpy().astype(np.float64)
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) <= 1e-5


def test_fma_chain_sums_in_index_order():
    """q = 1s, k = [2^25, 1, -2^25]: in index order 2^25 + 1 rounds to
    2^25 and the chain ends at 0; pairing the large terms first gives 1."""
    q = torch.ones(1, 3)
    k = torch.tensor([[2.0 ** 25], [1.0], [-2.0 ** 25]])
    assert fma_chain(q, k).item() == 0.0
    terms = (q[0] * k[:, 0]).tolist()
    paired = torch.tensor(terms[0]) + torch.tensor(terms[2]) \
        + torch.tensor(terms[1])
    assert paired.item() == 1.0


def _round_f32(x: Fraction) -> float:
    """x rounded to the nearest float32, ties to even."""
    f = np.float32(float(x))
    near = [f, np.nextafter(f, np.float32(np.inf)),
            np.nextafter(f, np.float32(-np.inf))]
    return float(min(near, key=lambda c: (abs(Fraction(float(c)) - x),
                                          int(np.array(c).view(np.int32))
                                          & 1)))


def test_fma_chain_rounds_each_step_once():
    """Each step is a * b + c rounded once to float32 (CUDA's fmaf): at
    x = 2^-11, 1 + 2^-24 (1 + x) (1 - x + x^2) is 1 + 2^-24 + 2^-57 and
    rounds to 1 + 2^-23, where rounding the product first (or a float64
    sum) gives 1. Random chains over a wide spread of exponents equal
    exact rational arithmetic rounded at every step."""
    x = 2.0 ** -11
    a = torch.tensor([[1.0, 2.0 ** -24 * (1 + x)]])
    b = torch.tensor([[1.0], [1 - x + x * x]])
    assert fma_chain(a, b).item() == 1.0 + 2.0 ** -23
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((6, 12)) * 2.0 ** rng.integers(-24, 25, (6, 12))
         ).astype(np.float32)
    B = (rng.standard_normal((12, 5)) * 2.0 ** rng.integers(-24, 25, (12, 5))
         ).astype(np.float32)
    got = fma_chain(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    for m in range(6):
        for n in range(5):
            acc = 0.0
            for k in range(12):
                acc = _round_f32(Fraction(float(A[m, k])) * Fraction(
                    float(B[k, n])) + Fraction(acc))
            assert float(got[m, n]) == acc


def test_fma_chain_broadcasts_like_matmul():
    """Batched and broadcast operands: on dyadic values every sum is exact
    in any order, so the chain equals ``torch.matmul`` bit for bit."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(-16, 17, (3, 1, 5, 8)) / 8.0).float()
    b = torch.from_numpy(rng.integers(-16, 17, (4, 8, 6)) / 8.0).float()
    got = fma_chain(a, b)
    assert got.shape == (3, 4, 5, 6) and got.dtype == torch.float32
    assert torch.equal(got, torch.matmul(a, b))

"""The port's small public functions against ``repro``'s.

* ``configs.registry.zoo_table()`` equals ``repro``'s string, character
  for character (it reads ``family``, the layer counts and
  ``param_count``), and ``family`` / ``max_seq_len`` equal ``repro``'s on
  every arch, full and smoke.
* ``optim.schedule.linear_warmup`` equals ``repro``'s at every step of a
  warmup and past it (bit for bit: one division and one product).
* ``serve.engine.stream_match_rate`` equals ``repro``'s on streams with
  mismatches, an empty stream and unequal lengths.
* ``kernels.flash.ref.flash2_blocked_ref``, ``attention_ref`` and
  ``kernels.decode.ref.decode_attention_ref`` equal ``repro``'s within
  1e-5 (``tests/cells.py``'s fp32 bound is 1e-4; these are float32
  products of the same tiles in another summation order), exact and
  ExpMul, causal and windowed, over keys past ``kv_len``, over ragged
  lengths and a length of 0.
* ``flash2_alg4_ref`` (the paper's per-key recurrence) in ExpMul is bit
  for bit ``repro``'s wherever the scores are: on dyadic inputs (q, k in
  multiples of 2^-3, scale 1) every score is exact in any order, each step
  is a power-of-two scaling and an add, so the outputs are equal; on
  random inputs it holds within 1e-5, exact and ExpMul.
* ``serve.sampling.sample_token`` at temperature 0 equals ``repro``'s (the
  argmax, ties to the first); above 0 it draws from its generator, into
  the top-k set.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.registry import zoo_table as jzoo_table  # noqa: E402
from repro.kernels.decode.ref import (  # noqa: E402
    decode_attention_ref as jdecode_ref,
)
from repro.kernels.flash import ref as jref  # noqa: E402
from repro.optim.schedule import linear_warmup as jwarmup  # noqa: E402
from repro.serve.engine import stream_match_rate as jmatch  # noqa: E402
from repro.serve.sampling import sample_token as jsample  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.registry import zoo_table  # noqa: E402
from repro_torch.kernels.decode.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash import ref  # noqa: E402
from repro_torch.optim import linear_warmup  # noqa: E402
from repro_torch.serve import sample_token, stream_match_rate  # noqa: E402

TOL = 1e-5


def test_zoo_table_equals_repro():
    assert zoo_table() == jzoo_table()
    assert set(ARCH_IDS) == set(JARCH_IDS)
    for arch in ARCH_IDS:
        for smoke in (False, True):
            t, j = get_config(arch, smoke=smoke), jget_config(arch,
                                                              smoke=smoke)
            assert (t.family, t.max_seq_len) == (j.family, j.max_seq_len)


def test_linear_warmup_equals_repro():
    for peak, warm in ((3e-4, 10), (1.0, 0), (0.5, 7)):
        steps = np.arange(0, 25, dtype=np.int32)
        got = linear_warmup(peak, warm)(torch.from_numpy(steps)).numpy()
        want = np.asarray(jwarmup(peak, warm)(jnp.asarray(steps)))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_stream_match_rate_equals_repro():
    ref_streams = [[1, 2, 3, 4], [5, 6], [], [7, 8, 9]]
    cases = [ref_streams, [[1, 2, 0, 4], [6, 6], [], [7, 8]],
             [[0, 0, 0, 0], [5, 6, 1], [3], [7, 8, 9]]]
    for streams in cases:
        assert stream_match_rate(ref_streams, streams) == \
            jmatch(ref_streams, streams)
    assert stream_match_rate(ref_streams, ref_streams) == 1.0


def _jit(fn, *args):
    """``repro``'s ``fn(*args)`` jitted (one compilation, not one a
    primitive), as numpy."""
    return np.asarray(jax.jit(fn)(*args))


def _ops(rng, Sq, Sk, D, dyadic=False):
    if dyadic:
        q, k = (rng.integers(-8, 9, size=(n, D)).astype(np.float32) / 8
                for n in (Sq, Sk))
    else:
        q, k = (rng.standard_normal((n, D)).astype(np.float32)
                for n in (Sq, Sk))
    v = rng.standard_normal((Sk, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_blocked_and_full_refs_match_repro(variant):
    rng = np.random.default_rng(1)
    q, k, v = _ops(rng, 21, 27, 16)
    T = torch.from_numpy
    blocked = (dict(causal=True, window=9), dict(causal=False, kv_len=20))
    full = (dict(causal=True), dict(causal=False, window=5))
    got = ([ref.flash2_blocked_ref(T(q), T(k), T(v), variant=variant,
                                   block_q=16, block_k=8, **kw)
            for kw in blocked]
           + [ref.attention_ref(T(q), T(k), T(v), **kw) for kw in full])
    want = jax.jit(lambda q, k, v: (
        [jref.flash2_blocked_ref(q, k, v, variant=variant, block_q=16,
                                 block_k=8, **kw) for kw in blocked]
        + [jref.attention_ref(q, k, v, **kw) for kw in full]))(q, k, v)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_decode_ref_matches_repro(variant):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 24, 16)).astype(np.float32)
            for _ in "kv")
    lens = np.array([17, 0], np.int32)
    got = decode_attention_ref(*map(torch.from_numpy, (q, k, v)),
                               torch.from_numpy(lens), variant=variant,
                               block_k=8)
    want = _jit(lambda q, k, v: jdecode_ref(q, k, v, lens, variant=variant,
                                            block_k=8), q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_alg4_ref_bit_for_bit_where_scores_are():
    rng = np.random.default_rng(3)
    q, k, v = _ops(rng, 12, 20, 8, dyadic=True)
    for causal in (True, False):
        got = ref.flash2_alg4_ref(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, scale=1.0)
        want = _jit(lambda q, k, v: jref.flash2_alg4_ref(
            q, k, v, causal=causal, scale=1.0), q, k, v)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_alg4_ref_random_matches_repro(variant):
    rng = np.random.default_rng(4)
    q, k, v = _ops(rng, 10, 24, 16)
    got = ref.flash2_alg4_ref(*map(torch.from_numpy, (q, k, v)),
                              causal=True, variant=variant)
    want = _jit(lambda q, k, v: jref.flash2_alg4_ref(
        q, k, v, causal=True, variant=variant), q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_sample_token_greedy_equals_repro():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, 50)).astype(np.float32)
    logits[2, [3, 9]] = 10.0                    # a tie: the first wins
    got = sample_token(torch.Generator().manual_seed(0),
                       torch.from_numpy(logits))
    want = jsample(jax.random.PRNGKey(0), jnp.asarray(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = sample_token(torch.Generator().manual_seed(1),
                         torch.from_numpy(logits), temperature=0.7, top_k=3)
    top3 = np.argsort(-logits, axis=-1)[:, :3]
    assert all(int(t) in top3[i] for i, t in enumerate(drawn))
    again = sample_token(torch.Generator().manual_seed(1),
                         torch.from_numpy(logits), temperature=0.7, top_k=3)
    assert torch.equal(drawn, again)

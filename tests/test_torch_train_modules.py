"""Port parity of the last training modules ``repro`` has: Adafactor,
the memmap token dataset and its file writer, document packing, and
gradient compression with error feedback, each against ``repro``'s on
the same numpy inputs.

Adafactor and the compression run in float32 in the same order of
operations as the reference, so updates, moments and residuals are held
within 1e-6 of their magnitude; int8 codes are equal (both packages round
half to even). The dataset and packing are integer work: equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data.dataset import MemmapTokenDataset as JaxMemmap  # noqa: E402
from repro.data.dataset import write_token_file as jax_write  # noqa: E402
from repro.data.packing import pack_documents as jax_pack  # noqa: E402
from repro.distributed import compression as jc  # noqa: E402
from repro.optim.adafactor import adafactor as jax_adafactor  # noqa: E402
from repro.optim.schedule import cosine_schedule as jax_cosine  # noqa: E402
from repro_torch.data import (  # noqa: E402
    MemmapTokenDataset,
    pack_documents,
    write_token_file,
)
from repro_torch.distributed import compression as tc  # noqa: E402
from repro_torch.optim import adafactor, cosine_schedule  # noqa: E402

SHAPES = {"w": (16, 8), "stack": (3, 5, 4), "b": (8,), "s": ()}


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max(initial=0.0) <= \
        1e-6 * np.abs(want).max(initial=0.0), what


@pytest.mark.parametrize("lr", ["constant", "cosine"])
def test_adafactor_matches_repro(lr):
    """Three updates of factored leaves (a matrix, a stack of three) and
    unfactored ones (a vector, a scalar), with gradients of three scales
    so that the update clip acts on some steps."""
    rng = np.random.default_rng(3)
    params = {k: np.asarray(rng.standard_normal(s), np.float32)
              for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    const = lr == "constant"
    jopt = jax_adafactor(1e-2 if const else jax_cosine(1e-2, 2, 5))
    topt = adafactor(1e-2 if const else cosine_schedule(1e-2, 2, 5))
    jst, tst = jopt.init(jp), topt.init(tp)
    assert set(tst["v"]["w"]) == {"vr", "vc"} and set(tst["v"]["b"]) == {"v"}
    assert tuple(tst["v"]["stack"]["vc"].shape) == (3, 4)
    for i in range(3):
        g = {k: np.asarray(rng.standard_normal(s) * 10.0 ** (i - 1),
                           np.float32) for k, s in SHAPES.items()}
        ju, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                              jst, jp)
        tu, tst = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                              tst, tp)
        for k in SHAPES:
            _close(tu[k], ju[k], (i, "update", k))
            for name, want in jst["v"][k].items():
                _close(tst["v"][k][name], want, (i, name, k))
            jp[k] = jp[k] + ju[k]
            tp[k] = tp[k] + tu[k]
    assert int(tst["step"]) == int(jst["step"]) == 3


@pytest.mark.parametrize("high", [50_000, 100_000], ids=["uint16", "uint32"])
def test_memmap_dataset_reads_either_packages_file(tmp_path, high):
    """A token file written by each package's ``write_token_file`` (uint16
    below 2**16, uint32 above) reads the same windows and batches through
    both datasets, over two epochs' shuffles and past the window count."""
    toks = np.random.default_rng(5).integers(0, high, 1000)
    for name, write in (("jax", jax_write), ("torch", write_token_file)):
        path = str(tmp_path / f"{name}.bin")
        write(path, toks)
        for seq in (16, 33):
            ours = MemmapTokenDataset(path, seq, seed=2)
            theirs = JaxMemmap(path, seq, seed=2)
            assert ours.num_windows == theirs.num_windows == 1000 // seq
            for epoch in (0, 1):
                got = ours.batch(epoch, ours.num_windows - 2, 4)
                want = theirs.batch(epoch, theirs.num_windows - 2, 4)
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want)
    assert (tmp_path / "jax.bin").read_bytes() == \
        (tmp_path / "torch.bin").read_bytes()
    assert (tmp_path / "jax.bin.meta.json").read_text() == \
        (tmp_path / "torch.bin.meta.json").read_text()


def test_pack_documents_matches_repro():
    rng = np.random.default_rng(7)
    docs = [rng.integers(1, 100, rng.integers(1, 30)) for _ in range(40)]
    for seq_len in (1, 8, 37, 128, 10_000):
        for eos in (0, 99):
            got = pack_documents(docs, seq_len, eos_id=eos)
            want = jax_pack(docs, seq_len, eos_id=eos)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def _grads(rng, scale):
    return {"w": (rng.standard_normal((12, 7)) * scale).astype(np.float32),
            "b": (rng.standard_normal(5) * scale).astype(np.float32),
            "z": np.zeros((3,), np.float32)}


def test_int8_compression_with_error_feedback_matches_repro():
    """``int8_compress`` on values at half steps of the scale (round half
    to even) and on a zero leaf (the 1e-12 scale floor); then three steps
    of ``error_feedback_int8`` from ``init_residuals``, the residuals
    carried."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 3.49], np.float32)
    for arr in (x, np.zeros(4, np.float32), _grads(np.random.default_rng(0),
                                                   1.0)["w"]):
        q, s = tc.int8_compress(torch.from_numpy(arr))
        jq, js = jc.int8_compress(jnp.asarray(arr))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        _close(tc.int8_decompress(q, s), jc.int8_decompress(jq, js),
               "decompress")
    rng = np.random.default_rng(1)
    g0 = _grads(rng, 1.0)
    tres = tc.init_residuals({k: torch.from_numpy(v) for k, v in g0.items()})
    jres = jc.init_residuals({k: jnp.asarray(v) for k, v in g0.items()})
    assert all(r.dtype == torch.float32 and not r.any()
               for r in tres.values())
    for i in range(3):
        g = _grads(rng, 10.0 ** -i)
        tg, tres = tc.error_feedback_int8(
            {k: torch.from_numpy(v) for k, v in g.items()}, tres)
        jg, jres = jc.error_feedback_int8(
            {k: jnp.asarray(v) for k, v in g.items()}, jres)
        for k in g:
            _close(tg[k], jg[k], (i, "grad", k))
            _close(tres[k], jres[k], (i, "residual", k))


def test_topk_compression_with_error_feedback_matches_repro():
    """``topk_compress`` at three fractions, on values without ties in
    |x|, and on ties (a stable sort keeps the lower index first, as
    ``jax.lax.top_k`` does); then three steps of ``error_feedback_topk``."""
    rng = np.random.default_rng(2)
    x = rng.permutation(np.arange(1, 201, dtype=np.float32)).reshape(20, 10)
    x *= np.where(rng.random((20, 10)) < 0.5, -1.0, 1.0).astype(np.float32)
    ties = np.array([1.0, -3.0, 3.0, 2.0, -3.0, 3.0, 1.0], np.float32)
    for arr, frac in ((x, 0.01), (x, 0.05), (x, 0.5), (ties, 0.3),
                      (ties, 0.5)):
        np.testing.assert_array_equal(
            tc.topk_compress(torch.from_numpy(arr), frac).numpy(),
            np.asarray(jc.topk_compress(jnp.asarray(arr), frac)))
    g0 = _grads(rng, 1.0)
    tres = tc.init_residuals({k: torch.from_numpy(v) for k, v in g0.items()})
    jres = jc.init_residuals({k: jnp.asarray(v) for k, v in g0.items()})
    for i in range(3):
        g = _grads(rng, 10.0 ** -i)
        tg, tres = tc.error_feedback_topk(
            {k: torch.from_numpy(v) for k, v in g.items()}, tres, frac=0.1)
        jg, jres = jc.error_feedback_topk(
            {k: jnp.asarray(v) for k, v in g.items()}, jres, frac=0.1)
        for k in g:
            _close(tg[k], jg[k], (i, "grad", k))
            _close(tres[k], jres[k], (i, "residual", k))

"""Port parity of the paper-reproduction entry points: ``python -m
repro_torch.launch.quickstart`` against ``examples/quickstart.py``'s calls,
and ``python -m repro_torch.launch.fidelity`` against
``benchmarks/table1_fidelity.py``, on the CPU (the kernels' plain
versions).

Quickstart: the L_hat and ExpMul lines it prints are the reference's
(the operator is bit-exact); its flash outputs, on its own seeded inputs
converted to JAX, are held at ``checks.kernel_tol`` against
``flash_attention_fwd`` (the Pallas kernel in interpret mode), and the
composable API's two calls against ``attention(impl="flash_jnp")`` and
``attention(impl="pallas")``.

Fidelity: from ``table1-lm`` weights of ``repro``'s ``init_model``
(PRNGKey(0)) converted with ``params_from_jax``, three training steps of
8 x 64 tokens run in the reference's own ``_train`` and in the port's
``train``; every leaf then agrees within 1e-3 of its magnitude (measured
2.9e-4 at most, on a value projection: without a clip, AdamW's first,
sign-like steps turn float rounding of near-zero gradients into gaps of a
few 1e-5). One batch (1000) is then evaluated on the grid.

Which route the port matches: the port's forward is the twin of the
reference's "pallas" route, and the study runs the reference's default
"flash_jnp". At 64 tokens and ``block_k`` 512 both walk one 64-wide tile
with no causal query chunks, so FP32 rows and ExpMul weights agree;
``flash_jnp`` also rounds P to the values' dtype before the value
product, which changes only BF16-exact rows (ExpMul's P is a power of
two, exact in bfloat16). The port is held to both routes. Measured on
the CPU, port against reference: FP32 perplexities 5.0e-7 relative on
either route, argmaxes equal; BF16 perplexities 2.6e-5 (exact,
flash_jnp), 1.6e-4 (exact, pallas) and 3.6e-5 (ExpMul, both routes),
greedy agreement 100% (exact) and 99.8% (ExpMul, one token of 512). The
limits: FP32 within 1e-4 relative and argmaxes equal; BF16 within 1e-3
relative and at least 98% agreement.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.attention import attention as jax_attention  # noqa: E402
from repro.kernels.expmul.ops import expmul_rows as jax_expmul_rows  # noqa: E402
from repro.kernels.flash.ops import flash_attention_fwd as jax_flash  # noqa: E402
from repro.models.api import forward as jax_forward  # noqa: E402
from repro.models.api import init_model as jax_init_model  # noqa: E402
from repro.numerics.log2exp import log2exp_lhat as jax_lhat  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.checks import kernel_tol, rel_err  # noqa: E402
from repro_torch.launch import fidelity, quickstart  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
GRID = [("float32", "exact"), ("float32", "expmul"), ("bfloat16", "exact"),
        ("bfloat16", "expmul")]


def _table1():
    """The reference study's module (``benchmarks/`` is no package)."""
    spec = importlib.util.spec_from_file_location(
        "table1_fidelity", ROOT / "benchmarks" / "table1_fidelity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(t):
    return t.detach().to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qs_run():
    """The port's quickstart on the CPU: its stdout, its tensors and the
    plain versions it ran."""
    import contextlib
    import io

    build.reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = quickstart.main(["--device", "cpu"])
    return buf.getvalue(), out, dict(build.COUNTS)


def test_quickstart_operator_lines_match_repro(qs_run):
    text, out, counts = qs_run
    x = jnp.array([-0.5, -2.0, -7.3])
    v = jnp.ones((3, 4)) * jnp.array([1.5, 2.0, 3.0])[:, None]
    lhat = np.asarray(jax_lhat(x))
    em = np.asarray(jax_expmul_rows(x, v))
    np.testing.assert_array_equal(_np(out["x"]), np.asarray(x))
    np.testing.assert_array_equal(_np(out["v"]), np.asarray(v))
    np.testing.assert_array_equal(out["lhat"].numpy(), lhat)
    np.testing.assert_array_equal(_np(out["expmul"]).view(np.int32),
                                  em.view(np.int32))
    assert f"L_hat = round(-x * 1.4375): {lhat}" in text
    assert f"ExpMul(x, V)   = {em[:, 0]}" in text
    # the operator and the three attention calls ran the plain versions
    assert counts == {"expmul_plain": 1, "flash_plain": 3}


@pytest.mark.parametrize("variant", ["exact", "expmul"])
def test_quickstart_flash_matches_repro(qs_run, variant):
    _, out, _ = qs_run
    q, k, v = (jnp.asarray(_np(out[n])) for n in ("q", "k", "vv"))
    assert q.shape == (1, 4, 256, 64)
    want = jax_flash(q, k, v, causal=True, variant=variant)
    got = out["o_exact" if variant == "exact" else "o_expmul"]
    assert rel_err(got, torch.from_numpy(np.array(want))) \
        <= kernel_tol(variant, torch.float32)


@pytest.mark.parametrize("impl", ["flash_jnp", "pallas"])
def test_quickstart_attention_api_matches_repro(qs_run, impl):
    _, out, _ = qs_run
    q, k, v = (jnp.asarray(_np(out[n])) for n in ("q", "k", "vv"))
    want = jax_attention(q, k, v, impl=impl, variant="expmul")
    got = out["o_ref" if impl == "flash_jnp" else "o_api"]
    assert got.shape == (1, 4, 256, 64) and got.dtype == torch.float32
    assert rel_err(got, torch.from_numpy(np.array(want))) <= 1e-5


@pytest.mark.parametrize("cli", [quickstart, fidelity])
def test_clis_default_to_cuda(cli):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(SystemExit) as exc:
        cli.main([])
    assert exc.value.code == 2


# ---------------------------------------------------------------------------
# the Table I study
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trained():
    """Three steps of 8 x 64 tokens from the same weights: the reference's
    ``_train`` (jitted, PRNGKey(0) weights) and the port's ``train`` on
    them converted."""
    t1 = _table1()
    jp0 = jax_init_model(jax.random.PRNGKey(0), t1.CFG)
    jp, jdata = t1._train(steps=3, batch=8, seq=64)
    tp0 = params_from_jax(jax.tree.map(np.asarray, jp0), fidelity.CFG,
                          device="cpu")
    tp, tdata = fidelity.train(3, 8, 64, device="cpu", params=tp0)
    return dict(t1=t1, jp=jp, jdata=jdata, tp=tp, tdata=tdata)


def _jax_eval(t1, params, data, variant, dtype, impl):
    """The reference study's evaluation loop on batch 1000, on ``impl``."""
    cfg = t1.CFG.replace(attention_variant=variant, dtype=dtype,
                         attention_impl=impl)
    p = params if dtype == "float32" else jax.tree.map(
        lambda l: l.astype(dtype), params)
    toks = jnp.asarray(data.batch(1000, 8))
    logits = jax.jit(lambda pp, b: jax_forward(pp, b, cfg))(
        p, {"tokens": toks}).astype(jnp.float32)
    lp = jax.nn.log_softmax(logits[:, :-1], -1)
    nll = -np.mean(np.asarray(
        jnp.take_along_axis(lp, toks[:, 1:][..., None], -1)))
    return float(np.exp(nll)), np.asarray(jnp.argmax(logits, -1))


def test_train_steps_match_repro(trained):
    assert trained["tdata"].batch(7, 8).tolist() == \
        trained["jdata"].batch(7, 8).tolist()
    want = params_from_jax(jax.tree.map(np.asarray, trained["jp"]),
                           fidelity.CFG, device="cpu")
    for (path, a), (_, b) in zip(tree_leaves_with_path(trained["tp"]),
                                 tree_leaves_with_path(want)):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()), \
            path


@pytest.mark.parametrize("impl", ["flash_jnp", "pallas"])
@pytest.mark.parametrize("dtype,variant", GRID)
def test_grid_row_matches_repro(trained, dtype, variant, impl):
    ppl, am = fidelity.evaluate(trained["tp"], trained["tdata"], variant,
                                dtype, steps=(1000,))
    jppl, jam = _jax_eval(trained["t1"], trained["jp"], trained["jdata"],
                          variant, dtype, impl)
    assert am.shape == jam.shape == (8, 64)
    gap = abs(ppl - jppl) / jppl
    if dtype == "float32":
        assert gap <= 1e-4, gap
        np.testing.assert_array_equal(am, jam)
    else:
        assert gap <= 1e-3, gap
        assert np.mean(am == jam) >= 0.98


def test_run_reports_the_grid():
    """``run`` end to end at a small size: four rows in the reference's
    order, FP32-exact agreeing with itself, finite perplexities, and the
    raw attention error of ExpMul."""
    build.reset_counts()
    rows, attn_err, _ = fidelity.run(steps=2, device="cpu",
                                     eval_steps=(1000,))
    assert [r["config"] for r in rows] == ["FP32", "FP32-ExpMul", "BF16",
                                           "BF16-ExpMul"]
    assert rows[0]["greedy_agree"] == 1.0
    assert all(np.isfinite(r["perplexity"]) and r["perplexity"] > 1
               for r in rows)
    assert 0.0 < attn_err < 0.1
    counts = dict(build.COUNTS)
    assert set(counts) == {"flash_plain"} and counts["flash_plain"] > 0

"""Port serving engine against ``repro``'s engine, and the port's import
and device guards.

* Temp-0 token streams of ``repro_torch.serve.ServeEngine`` equal those of
  ``repro.serve.ServeEngine(attention_impl="pallas")`` on the same
  converted weights, on both layouts (paged with ``prefix_cache=False``),
  at exact/int8, exact/fp32 and expmul/int8. The ExpMul streams are
  identical too: both engines walk the same tiles in the same order, so
  the power-of-two weights round alike (an L_hat flip would need a score
  that differs across frameworks and sits on a rounding boundary).
* On the contiguous layout (the default): ``chunk_size=1`` streams equal
  chunked ones, a reused slot shows no stale rows, and paged streams
  equal contiguous ones (exact variant: ExpMul results depend on the
  tile width, which differs between the layouts).
* A tight pool preempts and requeues without changing any stream.
* A temp>0 draw depends only on (seed, admission order, tokens so far).
* ``python -m repro_torch.launch.serve --smoke --device cpu`` serves.
* Importing all of ``repro_torch`` loads no ``jax`` and no ``repro``; the
  engine defaults to ``device="cuda"`` and raises without a card.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.api import init_model as jax_init_model  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.sampling import row_seed, sample_tokens  # noqa: E402

ENGINE = dict(slots=3, max_len=48, chunk_size=8, kv_layout="paged",
              page_size=4)
CONTIGUOUS = dict(slots=3, max_len=48, chunk_size=8)


def _narrowed(cfg, narrow):
    """``cfg`` with the fields of ``narrow`` replaced (its ``moe`` entry a
    dict of the MoE config's fields), in either package's config type."""
    if not narrow:
        return cfg
    narrow = dict(narrow)
    if "moe" in narrow:
        narrow["moe"] = dataclasses.replace(cfg.moe, **narrow["moe"])
    return cfg.replace(**narrow)


def _models(variant, arch="qwen2-0.5b", narrow=None):
    over = dict(dtype="float32", param_dtype="float32",
                attention_variant=variant)
    jcfg = _narrowed(jax_get_config(arch, smoke=True, **over), narrow)
    params = jax_init_model(jax.random.PRNGKey(0), jcfg)
    tcfg = _narrowed(get_config(arch, smoke=True, **over), narrow)
    return jcfg, params, tcfg, params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, device="cpu")


def _prompts(seed=0, lens=(13, 5, 22, 9)):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, 256, size=n)) for n in lens]


def _serve(engine, prompts, max_new=8):
    reqs = [engine.submit(p, max_new, rid=i) for i, p in enumerate(prompts)]
    engine.run()
    assert all(r.done and r.finish_reason == "length" for r in reqs)
    return [r.out for r in reqs]


def paged_streams(variant, kv_dtype, arch="qwen2-0.5b", narrow=None):
    """Both engines' temp-0 streams on the paged layout, held equal."""
    jcfg, params, tcfg, tparams = _models(variant, arch, narrow)
    prompts = _prompts()
    ref = _serve(JaxServeEngine(params, jcfg, kv_dtype=kv_dtype,
                                attention_impl="pallas", prefix_cache=False,
                                **ENGINE), prompts)
    before = build.COUNTS["paged_prefill_plain"]
    eng = ServeEngine(tparams, tcfg, kv_dtype=kv_dtype,
                      attention_impl="kernel", prefix_cache=False,
                      device="cpu", **ENGINE)
    assert _serve(eng, prompts) == ref
    assert eng.prefill_steps > 0 and eng.decode_steps > 0
    assert build.COUNTS["paged_prefill_plain"] > before


@pytest.mark.parametrize("variant,kv_dtype", [
    ("exact", "int8"), ("exact", "fp32"), ("expmul", "int8")])
def test_temp0_streams_match_repro_engine(variant, kv_dtype):
    paged_streams(variant, kv_dtype)


def contiguous_streams(variant, kv_dtype, arch="qwen2-0.5b", narrow=None):
    """Both engines' temp-0 streams on the contiguous layout, held equal."""
    jcfg, params, tcfg, tparams = _models(variant, arch, narrow)
    prompts = _prompts()
    ref = _serve(JaxServeEngine(params, jcfg, kv_layout="contiguous",
                                kv_dtype=kv_dtype, attention_impl="pallas",
                                **CONTIGUOUS), prompts)
    before = build.COUNTS["prefill_plain"]
    eng = ServeEngine(tparams, tcfg, kv_dtype=kv_dtype, device="cpu",
                      **CONTIGUOUS)
    assert eng.kv_layout == "contiguous" and eng.pool is None
    assert _serve(eng, prompts) == ref
    assert eng.prefill_steps > 0 and eng.decode_steps > 0
    assert build.COUNTS["prefill_plain"] > before


@pytest.mark.parametrize("variant,kv_dtype", [
    ("exact", "int8"), ("exact", "fp32"), ("expmul", "int8")])
def test_contiguous_temp0_streams_match_repro_engine(variant, kv_dtype):
    contiguous_streams(variant, kv_dtype)


def test_contiguous_chunked_matches_legacy_and_paged():
    """Teacher-forcing (chunk_size=1), 4-token chunks and the paged layout
    emit the same temp-0 streams."""
    _, _, tcfg, tparams = _models("exact")
    prompts = _prompts(4, (5, 9, 3, 14))
    kw = dict(slots=2, max_len=64, device="cpu")
    legacy = ServeEngine(tparams, tcfg, chunk_size=1, **kw)
    out = _serve(legacy, prompts, max_new=6)
    chunked = ServeEngine(tparams, tcfg, chunk_size=4, **kw)
    assert _serve(chunked, prompts, max_new=6) == out
    assert legacy.prefill_steps == 0 and chunked.ticks < legacy.ticks
    paged = ServeEngine(tparams, tcfg, chunk_size=4, kv_layout="paged",
                        page_size=8, **kw)
    assert _serve(paged, prompts, max_new=6) == out
    assert paged.preemptions == 0


def test_contiguous_slot_reuse_has_no_stale_rows():
    """A short request admitted into a slot a long one filled must match
    the same request in a fresh engine: the stale rows are masked."""
    _, _, tcfg, tparams = _models("expmul")
    long_first, short_second = _prompts(5, (30, 6))
    kw = dict(slots=1, max_len=64, chunk_size=8, kv_dtype="int8",
              device="cpu")
    reused = ServeEngine(tparams, tcfg, **kw)
    outs = _serve(reused, [long_first, short_second], max_new=5)
    fresh = ServeEngine(tparams, tcfg, **kw)
    assert _serve(fresh, [short_second], max_new=5) == outs[1:]
    # the slot really was dirty past the short request's rows
    k = reused.state["caches"][0]["k"]
    assert bool((k[0, :, 6 + 5:30].to(torch.float32) != 0).any())


def test_serve_cli_smoke_on_cpu(capsys):
    reqs = serve_cli.main(["--smoke", "--device", "cpu", "--requests", "3",
                           "--max-new", "4", "--chunk", "8"])
    assert [len(r.out) for r in reqs] == [4, 4, 4]
    assert all(r.finish_reason == "length" for r in reqs)
    out = capsys.readouterr().out
    assert "kv=contiguous/fp32" in out and "on cpu" in out
    paged = serve_cli.main(["--smoke", "--device", "cpu", "--requests", "3",
                            "--max-new", "4", "--chunk", "8", "--kv-layout",
                            "paged", "--kv-dtype", "int8"])
    assert all(len(r.out) == 4 for r in paged)
    assert "kv=paged/int8" in capsys.readouterr().out


def test_tight_pool_preemption_keeps_streams():
    _, _, tcfg, tparams = _models("expmul")
    prompts = _prompts(1, (9, 21, 6, 13, 17))
    kw = dict(ENGINE, kv_dtype="int8", prefix_cache=False)
    ref = ServeEngine(tparams, tcfg, device="cpu", **kw)
    ref_out = _serve(ref, prompts, max_new=6)
    assert ref.preemptions == 0
    # a 4-block unquantized budget holds ~12 int8 blocks of 4 tokens:
    # three slots of 20+ tokens cannot all stay resident
    tight = ServeEngine(tparams, tcfg, device="cpu", pool_blocks=4, **kw)
    assert tight.pool.pool_blocks > 4
    assert _serve(tight, prompts, max_new=6) == ref_out
    assert tight.preemptions > 0
    assert tight.pool.stats.evictions == tight.preemptions
    assert tight.pool.used_blocks == 0
    assert tight.recompute_tokens > 0


def test_pool_too_small_for_first_chunk_raises():
    _, _, tcfg, tparams = _models("exact")
    eng = ServeEngine(tparams, tcfg, device="cpu", slots=1, max_len=64,
                      chunk_size=16, kv_layout="paged", page_size=4,
                      pool_blocks=1)
    eng.submit(list(range(1, 30)), 4)
    with pytest.raises(RuntimeError, match="pool too small"):
        eng.run()


def test_temperature_draws_depend_only_on_row_history():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((3, 50)).astype(np.float32))
    seeds = [row_seed(7, order, n) for order, n in ((0, 4), (1, 0), (2, 9))]
    full = sample_tokens(seeds, logits, temperature=0.9)
    # the same row, alone or beside other rows, in another position
    for i in range(3):
        alone = sample_tokens([seeds[i]], logits[i:i + 1], temperature=0.9)
        assert int(alone[0]) == int(full[i])
    swapped = sample_tokens(seeds[::-1], logits.flip(0), temperature=0.9)
    assert swapped.flip(0).tolist() == full.tolist()
    assert row_seed(7, 1, 2) != row_seed(7, 2, 1)
    # the engine keys each row by (seed, admission order, len(out))
    _, _, tcfg, tparams = _models("exact")
    runs = []
    for slots in (3, 1):   # a different batch schedule
        eng = ServeEngine(tparams, tcfg, device="cpu", temperature=0.8,
                          seed=5, **dict(ENGINE, slots=slots))
        runs.append(_serve(eng, _prompts(3, (6,)), max_new=10))
    assert runs[0] == runs[1]
    assert sample_tokens([0], logits[:1]).item() == int(logits[0].argmax())


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    _, _, tcfg, tparams = _models("exact")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(tparams, tcfg)


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith(('jax.', 'jaxlib')) or n == 'repro' or "
        "n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.serve.engine' in sys.modules\n"
        "assert 'repro_torch.launch.serve' in sys.modules\n"
        "assert 'repro_torch.launch.train' in sys.modules\n"
        "assert 'repro_torch.train.step' in sys.modules\n"
        "assert 'repro_torch.kernels.expmul' in sys.modules\n"
        "assert 'repro_torch.launch.quickstart' in sys.modules\n"
        "assert 'repro_torch.launch.fidelity' in sys.modules\n"
        "assert 'repro_torch.serve.metrics' in sys.modules\n"
        "assert 'repro_torch.kernels.costs' in sys.modules\n"
        "assert 'repro_torch.layers.moe' in sys.modules\n"
        "assert 'repro_torch.configs.arctic_480b' in sys.modules\n"
        "assert 'repro_torch.configs.kimi_k2_1t' in sys.modules\n"
        "assert 'repro_torch.layers.xlstm' in sys.modules\n"
        "assert 'repro_torch.configs.xlstm_1_3b' in sys.modules\n"
        "assert 'repro_torch.configs.llava_next_34b' in sys.modules\n"
        "assert 'repro_torch.configs.seamless_m4t_medium' in sys.modules\n"
        "assert 'repro_torch.models.inputs' in sys.modules\n"
        "print('ok')\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

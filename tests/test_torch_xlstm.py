"""xlstm-1.3b in the port (mLSTM and sLSTM blocks, no attention layer)
against ``repro``, on converted weights.

The layers in float32: ``mlstm_apply`` (chunkwise at chunk 4: three
chunks, five of L = 2, one shorter than the chunk), ``slstm_apply``,
both decode steps from their fresh caches (m = -1e30) and from a random
state, and the chunked prefill steps against ``repro``'s gated scan of
the decode step (idle rows bit for bit unchanged), within ``TOL`` of the
magnitude (XLA's exp, logistic and tanh on the CPU differ from
PyTorch's by an ulp, and the chunkwise sums and the port's scan pair
products in another order). The same layers in bfloat16 within
``BF16_TOL`` (a missing cast of the reference's, the recurrent ``h``
before ``r_*`` or ``h * g`` before ``w_down``, mixes dtypes in a
product, which PyTorch refuses), and ``k / sqrt(dh)`` bit for bit with
the divisor rounded to bf16 as JAX rounds it. The model: ``forward`` over two units
and a ``decode_step`` loop. The slice: temp-0 engine streams equal to
``repro``'s engine on both layouts (3 prompts over 2 slots, so a slot is
reused; chunk 1; a chaos schedule that preempts and quarantines), the
admission reset of the stabilizers to 0 as ``repro`` does it (and that
a reset to -1e30 would give greedy decoding by ``forward`` instead),
the attention-free memory accounting, the refusals, snapshots and the
CLI.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_serving as ts  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.costs import attn_kv_geometry as jax_geometry  # noqa: E402
from repro.layers import xlstm as jxlstm  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.engine import analytic_prefill_flops as jax_flops  # noqa: E402
from repro.serve.engine import validate_kv_dtype as jax_validate  # noqa: E402
from repro.serve.paged import kv_token_bytes as jax_kv_bytes  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.costs import attn_kv_geometry  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.layers import xlstm  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    ServeEngine,
    analytic_prefill_flops,
    validate_kv_dtype,
)
from repro_torch.serve.paged import kv_token_bytes  # noqa: E402
from repro_torch.serve.snapshot import restore_engine  # noqa: E402
from test_torch_engine import _models  # noqa: E402

ARCH = "xlstm-1.3b"
F32 = dict(dtype="float32", param_dtype="float32")
# port vs repro in float32, relative to the magnitude (measured: at most
# ~3e-7 on the layers' outputs and states)
TOL = 1e-5
# the model's logits in float32: the layers' rounding differences grow
# through the depth (measured over 16 layers: 2.5e-5 on the logits of
# ``forward``, from 4.9e-7 after the first layer; ``repro``'s own CPU test
# holds its chunkwise ``forward`` and its decode loop within 3e-4)
MODEL_TOL = 1e-4
# in bfloat16: one bf16 step is 2^-8 of a value; products rounded at
# other places (XLA rounds SiLU's sigmoid to bf16) move a few of them
BF16_TOL = 2e-2
ENGINE = dict(slots=2, max_len=64, chunk_size=4)
LENS = (5, 9, 3)   # three prompts over two slots: the third reuses a slot


@pytest.fixture(scope="module")
def m():
    return _models("expmul", ARCH)


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref))
                 / np.max(np.abs(ref)))


def _f32(t):
    return np.asarray(jnp.asarray(t, jnp.float32)) if not isinstance(
        t, torch.Tensor) else t.to(torch.float32).numpy()


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 256, size=n))) for n in lens]


def _serve(eng, prompts, max_new=6):
    reqs = [eng.submit(p, max_new, rid=i) for i, p in enumerate(prompts)]
    eng.run()
    assert all(r.done and r.finish_reason == "length" for r in reqs)
    return [r.out for r in reqs]


def test_config_matches_repro():
    assert ARCH in ARCH_IDS
    for smoke in (False, True):
        cfg, jcfg = get_config(ARCH, smoke=smoke), jax_get_config(ARCH,
                                                                  smoke=smoke)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab_size", "tie_embeddings", "block_pattern"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert cfg.pattern_for() == jcfg.pattern_for()
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert (analytic_prefill_flops(cfg, 100, 356)
                == jax_flops(jcfg, 100, 356))
        assert attn_kv_geometry(cfg) == jax_geometry(jcfg)
        assert kv_token_bytes(cfg, "fp32") == jax_kv_bytes(jcfg, "fp32") == 0
    cfg = get_config(ARCH)
    assert cfg.param_count() == 1_345_218_560
    assert cfg.pattern_for().count("mlstm") == 42
    assert cfg.pattern_for().count("slstm") == 6
    assert "attn" not in cfg.pattern_for()
    # ~397 MB of float32 state a slot: 42 layers of (4, 768, 768) matrices
    state = sum(v.numel() * 4 for v in xlstm.mlstm_init_cache(
        cfg, 1, None, "meta").values())
    assert 42 * state == 396_878_496


def _layer(kind, dtype="float32", seed=0):
    cfg = get_config(ARCH, smoke=True, dtype=dtype, param_dtype=dtype)
    jcfg = jax_get_config(ARCH, smoke=True, dtype=dtype, param_dtype=dtype)
    init = jxlstm.mlstm_init if kind == "mlstm" else jxlstm.slstm_init
    p = init(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    unit = {"mix": {k: np.asarray(v)[None] for k, v in p.items()}}
    tp = params_from_jax({"units": (unit,), "embed": {},
                          "final_norm": {"scale": np.zeros(1)}},
                         cfg.replace(num_layers=1, block_pattern=(kind,)),
                         device="cpu")["layers"][0]["mix"]
    for name, v in p.items():
        np.testing.assert_array_equal(_f32(tp[name]), _f32(v))
    return cfg, jcfg, p, tp, np.random.default_rng(seed)


def _x(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [768, 48])
def test_k_scale_rounds_as_jax(dh, dtype):
    """``k / sqrt(dh)`` bit for bit as ``repro`` computes it (the divisor
    rounded to k's dtype: 27.75 for sqrt(768) in bf16); dividing by the
    float32 root instead moves bf16 values at 768."""
    k = np.random.default_rng(dh).standard_normal(4096).astype(np.float32)
    jk, tk = jnp.asarray(k, jnp.dtype(dtype)), torch.from_numpy(k).to(
        getattr(torch, dtype))
    ref = _f32(jk / jnp.sqrt(dh))
    np.testing.assert_array_equal(_f32(xlstm.scale_k(tk, dh)), ref)
    if dtype == "bfloat16" and dh == 768:
        assert (_f32(tk / float(np.sqrt(np.float32(dh)))) != ref).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [12, 10, 3])
def test_mlstm_apply_matches_repro(S, dtype):
    """Chunk 4 over S = 12 (three chunks), 10 (L = 2, the largest divisor
    of 10 not above 4: five chunks) and 3 (L = S, one chunk)."""
    cfg, jcfg, p, tp, rng = _layer("mlstm", dtype)
    jx, tx = _x(rng, (2, S, cfg.d_model), dtype)
    ref = jxlstm.mlstm_apply(p, jx, jcfg, chunk=4)
    got = xlstm.mlstm_apply(tp, tx, cfg, chunk=4)
    assert got.dtype == tx.dtype
    assert _rel(_f32(got), _f32(ref)) <= (TOL if dtype == "float32"
                                          else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_apply_matches_repro(dtype):
    cfg, jcfg, p, tp, rng = _layer("slstm", dtype)
    jx, tx = _x(rng, (2, 9, cfg.d_model), dtype)
    ref = jxlstm.slstm_apply(p, jx, jcfg)
    got = xlstm.slstm_apply(tp, tx, cfg)
    assert got.dtype == tx.dtype
    assert _rel(_f32(got), _f32(ref)) <= (TOL if dtype == "float32"
                                          else BF16_TOL)


def _random_cache(kind, cfg, rng, B):
    """A reachable state: scaled as the recurrence keeps it (m the running
    max of the gate pre-activations)."""
    c = {k: v.numpy().copy() for k, v in getattr(
        xlstm, f"{kind}_init_cache")(cfg, B, None, "cpu").items()}
    for k in c:
        if k == "m":
            c[k] = rng.uniform(-2, 2, c[k].shape).astype(np.float32)
        elif k == "n" and kind == "slstm":
            c[k] = rng.uniform(0.5, 3, c[k].shape).astype(np.float32)
        else:
            c[k] = (rng.standard_normal(c[k].shape) * 0.3).astype(np.float32)
    return c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_match_repro(kind, dtype):
    """Four steps from the fresh cache (m = -1e30 at the first), then one
    from a random state; the cache advanced in place."""
    cfg, jcfg, p, tp, rng = _layer(kind, dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    jstep = getattr(jxlstm, f"{kind}_decode_step")
    tstep = getattr(xlstm, f"{kind}_decode_step")
    B = 3
    jc = getattr(jxlstm, f"{kind}_init_cache")(jcfg, B, jnp.float32)
    tc = getattr(xlstm, f"{kind}_init_cache")(cfg, B, None, "cpu")
    assert float(tc["m"].max()) == np.float32(xlstm.M_INIT)
    addrs = {k: v.data_ptr() for k, v in tc.items()}
    for step in range(5):
        if step == 4:
            cache = _random_cache(kind, cfg, rng, B)
            jc = {k: jnp.asarray(v) for k, v in cache.items()}
            tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
            addrs = {k: v.data_ptr() for k, v in tc.items()}
        jx, tx = _x(rng, (B, cfg.d_model), dtype)
        jc, jy = jstep(p, jc, jx, jcfg)
        out, ty = tstep(tp, tc, tx, cfg)
        assert out is tc and {k: v.data_ptr() for k, v in tc.items()} == addrs
        assert ty.dtype == tx.dtype
        assert _rel(_f32(ty), _f32(jy)) <= tol, step
        for k in tc:
            assert _rel(tc[k].numpy(), np.asarray(jc[k])) <= tol, (step, k)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_matches_repro_scan(kind):
    """The chunk step against ``repro``'s gated scan of the decode step, at
    the block level (norm, mix, residual): n_valid of C, 0 (idle), 1 and
    5. Every token's output, past n_valid too (one ungated step from the
    last valid state), and the state; the idle row's state bit for bit."""
    cfg = get_config(ARCH, smoke=True, **F32)
    jcfg = jax_get_config(ARCH, smoke=True, **F32)
    p = jblocks.block_init(jax.random.PRNGKey(3), jcfg, kind, jnp.float32)
    assert set(p) == {"norm_mix", "mix"}          # no FFN on xLSTM blocks
    tp = jax.tree.map(lambda v: torch.from_numpy(np.array(v)), p)
    rng = np.random.default_rng(3)
    B, C = 4, 7
    cache = _random_cache(kind, cfg, rng, B)
    x = rng.standard_normal((B, C, cfg.d_model)).astype(np.float32)
    nv = np.array([C, 0, 1, 5], np.int32)
    lengths = np.array([3, 9, 0, 4], np.int32)
    jc, jy = jblocks.block_prefill(
        p, {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(x),
        jcfg, kind, jnp.asarray(lengths), jnp.asarray(nv))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    _, ty = blocks.block_prefill(tp, tc, torch.from_numpy(x), cfg, kind,
                                 torch.from_numpy(lengths),
                                 torch.from_numpy(nv), None)
    assert _rel(ty.numpy(), jy) <= TOL
    for k in tc:
        assert _rel(tc[k].numpy(), np.asarray(jc[k])) <= TOL, k
        np.testing.assert_array_equal(tc[k].numpy()[1], cache[k][1])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_prefill_steps_follow_decode_steps(kind):
    """In the port, chunks of 3 advance the state as the decode step does
    token by token, from the fresh cache."""
    cfg, _, _, tp, rng = _layer(kind, seed=4)
    init = getattr(xlstm, f"{kind}_init_cache")
    x = torch.from_numpy(rng.standard_normal((3, 6, cfg.d_model))
                         .astype(np.float32))
    dec = init(cfg, 3, None, "cpu")
    ys = [getattr(xlstm, f"{kind}_decode_step")(tp, dec, x[:, t], cfg)[1]
          for t in range(6)]
    pf = init(cfg, 3, None, "cpu")
    outs = [getattr(xlstm, f"{kind}_prefill_step")(
        tp, pf, x[:, t:t + 3], cfg, torch.tensor([3, 3, 3]))[1]
        for t in (0, 3)]
    for k in pf:
        assert _rel(pf[k].numpy(), dec[k].numpy()) <= TOL, k
    assert _rel(torch.cat(outs, 1).numpy(),
                torch.stack(ys, 1).numpy()) <= TOL


def test_forward_and_decode_loop_match_repro(m):
    """Sixteen layers, two units of seven mLSTM and one sLSTM block (the
    smoke weights, then the same scaled by 0.9: a converter that swapped
    the unit and the position would run another model): ``forward`` over
    12 tokens, and a ``decode_step`` loop over them from
    ``init_decode_state``, each against ``repro``'s."""
    jcfg, params, cfg, _ = m
    jcfg, cfg = jcfg.replace(num_layers=16), cfg.replace(num_layers=16)
    params = dict(params, units=jax.tree.map(
        lambda a: jnp.concatenate([a, a * 0.9]), params["units"]))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    assert [("wqh" in p["mix"]) for p in tparams["layers"]] == [
        k == "mlstm" for k in cfg.pattern_for()]
    np.testing.assert_array_equal(
        tparams["layers"][10]["mix"]["wkh"].numpy(),
        np.asarray(params["units"][2]["mix"]["wkh"][1]))
    np.testing.assert_array_equal(
        tparams["layers"][15]["mix"]["r_f"].numpy(),
        np.asarray(params["units"][7]["mix"]["r_f"][1]))
    rng = np.random.default_rng(5)
    toks = rng.integers(1, cfg.vocab_size, (2, 12)).astype(np.int32)
    ref = np.asarray(japi.forward(params, {"tokens": jnp.asarray(toks)},
                                  jcfg))
    with torch.no_grad():
        got = tapi.forward(tparams, {"tokens": torch.from_numpy(toks)},
                           cfg).numpy()
    assert _rel(got, ref) <= MODEL_TOL
    swapped = dict(tparams, layers=[tparams["layers"][i] for i in
                                    (8, 1, 2, 3, 4, 5, 6, 7, 0, 9, 10, 11,
                                     12, 13, 14, 15)])
    with torch.no_grad():
        other = tapi.forward(swapped, {"tokens": torch.from_numpy(toks)},
                             cfg).numpy()
    assert _rel(other, ref) > 1e-3
    jstate = japi.init_decode_state(jcfg, 2, 16)
    tstate = tapi.init_decode_state(cfg, 2, 16, device="cpu")
    jstep = jax.jit(lambda s, t, n: japi.decode_step(params, s, t, n, jcfg))
    for t in range(12):
        lens = np.full((2,), t, np.int32)
        jl, jstate = jstep(jstate, jnp.asarray(toks[:, t]), jnp.asarray(lens))
        tl, _ = tapi.decode_step(tparams, tstate, torch.from_numpy(toks[:, t]),
                                 torch.from_numpy(lens), cfg)
        assert _rel(tl.numpy(), jl) <= MODEL_TOL, t
        # the loop is the forward, token by token (repro's own CPU test
        # holds 3e-4)
        assert _rel(tl.numpy(), got[:, t]) <= 3e-4, t


def _ledger(eng):
    return {kind: {f: row[f] for f in ("calls", "steps", "kv_tokens",
                                       "analytic_bytes", "analytic_flops")}
            for kind, row in eng.attention_ledger().items()}


@pytest.fixture(scope="module")
def ref_runs(m):
    """``repro``'s engine on each layout after serving the prompts: its
    temp-0 streams, ``memory_stats()`` and attention ledger."""
    jcfg, params, _, _ = m
    runs = {}
    for layout in ("contiguous", "paged"):
        eng = JaxServeEngine(params, jcfg, kv_layout=layout, **ENGINE)
        runs[layout] = (_serve(eng, _prompts(0, LENS)), eng.memory_stats(),
                        _ledger(eng))
    assert runs["paged"][0] == runs["contiguous"][0]
    return runs


@pytest.fixture(scope="module")
def ref_streams(ref_runs):
    return ref_runs["contiguous"][0]


@pytest.mark.parametrize("kw", [
    dict(), dict(kv_layout="paged"), dict(chunk_size=1)],
    ids=["contiguous", "paged", "chunk1"])
def test_engine_streams_match_repro_engine(m, ref_runs, kw):
    """Three prompts of 5, 9 and 3 tokens over 2 slots (the third reuses a
    slot), 6 new each at temperature 0: equal to ``repro``'s engine on
    either layout, and at chunk 1 (teacher forcing by decode ticks). No
    kernel runs: the pattern has no attention layer. With no attention
    layer there are 0 KV bytes a token: the pool sized and accounted as
    ``repro``'s, and the same attention ledger after the run."""
    _, _, cfg, tparams = m
    layout = kw.get("kv_layout", "contiguous")
    streams, memory, ledger = ref_runs[layout]
    before = dict(build.COUNTS)
    eng = ServeEngine(tparams, cfg, device="cpu", **dict(ENGINE, **kw))
    assert _serve(eng, _prompts(0, LENS)) == streams
    assert dict(build.COUNTS) == before
    assert eng.decode_steps > 0
    assert (eng.prefill_steps > 0) == (eng.chunk_size > 1)
    if eng.chunk_size > 1:
        assert eng.memory_stats() == memory
        assert eng.memory_stats()["kv_token_bytes"] == 0
        assert _ledger(eng) == ledger


def test_admission_zeroes_the_stabilizers_as_repro(m):
    """A fresh state holds m = -1e30; an admission zeroes the slot's
    recurrent state, ``m`` included, in both engines (so their streams
    are not greedy decoding by ``forward``)."""
    jcfg, params, cfg, tparams = m
    assert all(float(c["m"].max()) == np.float32(-1e30) for c in
               tapi.init_decode_state(cfg, 2, 16, device="cpu")["caches"])
    for layout in ("contiguous", "paged"):
        kw = dict(ENGINE, kv_layout=layout)
        eng = ServeEngine(tparams, cfg, device="cpu", **kw)
        jeng = JaxServeEngine(params, jcfg, **kw)
        for e in (eng, jeng):
            e.submit(_prompts(0, (5,))[0], 2, rid=0)
            e._admit()
        for c, jc in zip(eng.state["caches"], jeng.state["caches"]):
            assert set(c) == set(jc)
            for name in c:
                np.testing.assert_array_equal(c[name].numpy(),
                                              np.asarray(jc[name])[0])
            assert bool((c["m"][0] == 0).all())
            assert float(c["m"][1].max()) == np.float32(-1e30)
        assert len(eng._recurrent) == 7 * 3 + 4     # C, n, m; c, n, h, m


def _greedy(tparams, cfg, prompt, n):
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits = tapi.forward(tparams, {"tokens": torch.tensor(
                [toks], dtype=torch.int32)}, cfg)
            toks.append(int(logits[0, -1].argmax()))
    return toks[len(prompt):]


def test_engine_streams_follow_the_reset_not_forward(m, ref_streams):
    """What the reset of ``m`` to 0 changes: the engines' streams are not
    greedy decoding by ``forward``, and an engine whose reset puts the
    stabilizers back to -1e30 gives exactly the greedy streams."""
    _, _, cfg, tparams = m
    prompts = _prompts(0, LENS)
    greedy = [_greedy(tparams, cfg, p, 6) for p in prompts]
    assert greedy != ref_streams
    eng = ServeEngine(tparams, cfg, device="cpu", **ENGINE)
    zero = eng._reset_slot_state

    def reset(s):
        zero(s)
        for cache in eng.state["caches"]:
            cache["m"][s].fill_(xlstm.M_INIT)

    eng._reset_slot_state = reset
    assert _serve(eng, prompts) == greedy


def test_chaos_run_matches_repro_engine(m):
    """A schedule that preempts (recompute resumption), delays an
    admission, corrupts a page (nothing to poison without attention) and
    quarantines a request on non-finite logits: the same outcome as
    ``repro``'s engine (reasons, streams, quarantines, preemptions, the
    pool's dump, the fires)."""
    mods = ts.Models(*m)
    kw = dict(slots=2, max_len=64, chunk_size=4, kv_layout="paged",
              page_size=4)
    sched = dict(at={"preempt": [2, 5], "admission": [1],
                     "kv_corrupt": [3], "logits": [6]})
    out = []
    for jax_side in (True, False):
        inj = ts.install(sched, jax_side)
        try:
            eng = ts.engine(mods, jax_side, **kw)
            reqs = [eng.submit(p, 6) for p in _prompts(1, (7, 11, 4, 9))]
            eng.run(max_steps=300)
        finally:
            ts.uninstall()
        eng.pool.check_consistency()
        out.append(ts.outcome(eng, reqs, inj))
    assert out[1] == out[0]
    assert out[1]["preemptions"] > 0 and out[1]["quarantined"] == 1


def test_refusals_match_repro(m):
    """int8/fp8 KV and the prefix cache are refused as "attention-only";
    a ``pool_blocks`` budget divides by 0 KV bytes a token in both
    engines."""
    jcfg, params, cfg, tparams = m
    for kv in ("int8", "fp8"):
        with pytest.raises(ValueError, match="attention-only"):
            jax_validate(jcfg, kv)
        with pytest.raises(ValueError, match="attention-only"):
            validate_kv_dtype(cfg, kv)
        with pytest.raises(ValueError, match="attention-only"):
            ServeEngine(None, cfg, kv_dtype=kv)     # before any device
    with pytest.raises(ValueError, match="attention-only"):
        JaxServeEngine(params, jcfg, kv_layout="paged", prefix_cache=True)
    with pytest.raises(ValueError, match="attention-only"):
        ServeEngine(tparams, cfg, kv_layout="paged", prefix_cache=True,
                    device="cpu")
    assert not ServeEngine(tparams, cfg, kv_layout="paged",
                           device="cpu").prefix_cache
    for make in (lambda: JaxServeEngine(params, jcfg, kv_layout="paged",
                                        pool_blocks=8),
                 lambda: ServeEngine(tparams, cfg, kv_layout="paged",
                                     pool_blocks=8, device="cpu")):
        with pytest.raises(ZeroDivisionError):
            make()


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_snapshot_round_trips_matrix_memory(m, tmp_path, layout):
    _, _, cfg, tparams = m
    kw = dict(ENGINE, kv_layout=layout, device="cpu")
    prompts = _prompts(6, (10, 7, 12))
    oracle = _serve(ServeEngine(tparams, cfg, **kw), prompts)
    eng = ServeEngine(tparams, cfg, **kw)
    reqs = [eng.submit(p, 6, rid=i) for i, p in enumerate(prompts)]
    for _ in range(4):
        eng.tick()
    assert any(r.out for r in reqs) and not all(r.done for r in reqs)
    path = str(tmp_path / "engine.npz")
    eng.save_snapshot(path)
    restored = restore_engine(path, tparams, cfg, device="cpu")
    for a, b in zip(eng._recurrent, restored._recurrent):
        assert torch.equal(a, b)
    carried = ([r for r in restored.requests if r is not None]
               + list(restored.queue))
    assert carried
    restored.run()
    for r in carried:
        assert r.finish_reason == "length" and r.out == oracle[r.rid]


def test_serve_cli_on_cpu(capsys):
    for layout in ("contiguous", "paged"):
        reqs = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--requests", "3", "--max-new", "4",
                               "--chunk", "8", "--kv-layout", layout])
        assert [len(r.out) for r in reqs] == [4, 4, 4]
        assert f"kv={layout}/fp32" in capsys.readouterr().out
    with pytest.raises(ValueError, match="attention-only"):
        serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--kv-dtype", "int8"])

"""recurrentgemma-2b in the port (RG-LRU blocks beside local-attention MQA
blocks, a 13-block unit, a logit softcap) against ``repro``, at its smoke
config in float32 on converted weights, ``repro`` at
``attention_impl="pallas"`` (interpret mode).

The layer: XLA's exp, logistic and tanh on the CPU differ from PyTorch's
in the last bit, so ``rglru_decode_step`` is held bit for bit where the
arithmetic is shared (the conv state, and the state with those three
functions' results given alike) and within ``RGLRU_TOL`` of the
magnitude otherwise; ``rglru_apply`` (a scan of the port's own beside
``jax.lax.associative_scan``) and the chunked prefill step (the
reference scans the decode step token by token) within ``RGLRU_TOL``,
idle rows bit for bit unchanged. The model: ``forward`` over two units,
so that layer order is checked through the converter. The slice: per-tick
logits on both layouts (``tests/test_torch_recurrentgemma_ticks.py``),
temp-0 engine streams equal to ``repro``'s with prompts longer than the
window, chunk 1 against chunked, paged against contiguous, a preemption
run, a reused slot, a snapshot round trip with recurrent state, and the
refusals of int8/fp8 KV and of the prefix cache for a recurrent pattern.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.costs import attn_kv_geometry as jax_geometry  # noqa: E402
from repro.layers import embedding as jembedding  # noqa: E402
from repro.layers import rglru as jrglru  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.engine import analytic_prefill_flops as jax_flops  # noqa: E402
from repro.serve.paged import kv_token_bytes as jax_kv_bytes  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.costs import attn_kv_geometry  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.layers import embedding, rglru  # noqa: E402
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

ARCH = "recurrentgemma-2b"
F32 = dict(dtype="float32", param_dtype="float32")
# port vs repro, relative to the magnitude: XLA's exp, logistic and tanh
# against PyTorch's differ by an ulp (measured: 7e-9 on h, 1e-7 on y)
RGLRU_TOL = 1e-6
# the prompts of tests/test_prefill.py:102, longer than the window of 32
LONG = (40, 7, 35)


@pytest.fixture(scope="module")
def m():
    return _models("exact", ARCH)


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref))
                 / np.max(np.abs(ref)))


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, 200, size=n)) for n in lens]


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
                  "d_ff", "vocab_size", "activation", "tie_embeddings",
                  "scale_embeddings", "block_pattern", "window", "lru_width",
                  "logits_softcap"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert cfg.pattern_for() == jcfg.pattern_for()
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert (analytic_prefill_flops(cfg, 100, 356)
                == jax_flops(jcfg, 100, 356))
        assert attn_kv_geometry(cfg) == jax_geometry(jcfg)
        assert kv_token_bytes(cfg, "fp32") == jax_kv_bytes(jcfg, "fp32")
    cfg = get_config(ARCH)
    assert cfg.param_count() == 2_894_528_000
    assert cfg.pattern_for().count("attn") == 8
    assert cfg.pattern_for().count("rglru") == 18
    assert cfg.num_heads // cfg.num_kv_heads == 10
    assert cfg.resolved_head_dim() == 256
    with pytest.raises(ValueError, match="do not tile"):
        cfg.pattern_for(25)


def test_kv_token_bytes_counts_attention_layers_only():
    """As ``tests/test_kvquant.py:318``: recurrent kinds hold no KV."""
    cfg = get_config(ARCH, smoke=True, **F32)
    n_attn = sum(k == "attn" for k in cfg.pattern_for())
    assert n_attn < len(cfg.pattern_for())
    assert kv_token_bytes(cfg, "fp32") == (
        n_attn * 2 * cfg.num_kv_heads * cfg.resolved_head_dim() * 4)
    full = get_config(ARCH)                                  # bf16 storage
    assert kv_token_bytes(full, "fp32") == 8 * 2 * 1 * 256 * 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softcap_logits_match_repro(dtype):
    cfg = get_config(ARCH, smoke=True, dtype=dtype, param_dtype=dtype)
    jcfg = jax_get_config(ARCH, smoke=True, dtype=dtype, param_dtype=dtype)
    rng = np.random.default_rng(0)
    table = rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(
        np.float32)
    x = (rng.standard_normal((3, 5, cfg.d_model)) * 4).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = np.asarray(jembedding.logits_apply(
        {"table": jnp.asarray(table, jdt)}, jnp.asarray(x, jdt), jcfg)
        .astype(jnp.float32))
    got = embedding.logits_apply({"table": torch.from_numpy(table).to(tdt)},
                                 torch.from_numpy(x).to(tdt), cfg)
    assert got.dtype == tdt
    got = got.to(torch.float32).numpy()
    # tanh of XLA and of PyTorch differ in the last bits; a bf16 cast may
    # round them one step apart
    assert _rel(got, ref) <= (1e-6 if dtype == "float32" else 2.0 ** -7)
    assert np.abs(got).max() <= 30.0 and np.abs(ref).max() > 25.0
    uncapped = (torch.from_numpy(x) @ torch.from_numpy(table).T).numpy()
    assert np.abs(uncapped).max() > 40.0     # the cap bit


def _layer(seed=0, batch=5):
    cfg = get_config(ARCH, smoke=True, **F32)
    jcfg = jax_get_config(ARCH, smoke=True, **F32)
    p = jrglru.rglru_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    rng = np.random.default_rng(seed)
    w = cfg.lru_width
    cache = {"h": (rng.standard_normal((batch, w)) * 0.5).astype(np.float32),
             "conv": rng.standard_normal((batch, 3, w)).astype(np.float32)}
    return cfg, jcfg, p, tp, cache, rng


def _tcache(cache):
    return {k: torch.from_numpy(v.copy()) for k, v in cache.items()}


def test_rglru_decode_step_matches_repro():
    cfg, jcfg, p, tp, cache, rng = _layer()
    x = rng.standard_normal((5, cfg.d_model)).astype(np.float32)
    jc, jy = jrglru.rglru_decode_step(
        p, {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(x),
        jcfg)
    tc = _tcache(cache)
    h_addr = tc["h"].data_ptr()
    out, ty = rglru.rglru_decode_step(tp, tc, torch.from_numpy(x), cfg)
    # in place: the same tensors, advanced
    assert out is tc and tc["h"].data_ptr() == h_addr
    np.testing.assert_array_equal(tc["conv"].numpy(), np.asarray(jc["conv"]))
    assert _rel(tc["h"].numpy(), jc["h"]) <= RGLRU_TOL
    assert _rel(ty.numpy(), jy) <= RGLRU_TOL
    # given the gates alike, the recurrence and the casts are bit for bit
    u = np.asarray(jnp.asarray(x) @ p["w_in_rec"])
    u2, _ = jrglru._conv(p, jnp.asarray(u)[:, None, :],
                         jnp.asarray(cache["conv"]))
    a, b = jrglru._gates(p, u2[:, 0])
    h = np.asarray(a) * cache["h"] + np.asarray(b)
    np.testing.assert_array_equal(
        (torch.from_numpy(np.asarray(a)) * torch.from_numpy(cache["h"])
         + torch.from_numpy(np.asarray(b))).numpy(), h)
    tu2, _ = rglru._conv(tp, torch.from_numpy(u)[:, None, :],
                         torch.from_numpy(cache["conv"]))
    np.testing.assert_array_equal(tu2.numpy(), np.asarray(u2))


def test_rglru_apply_matches_repro():
    cfg, jcfg, p, tp, _, rng = _layer(1)
    x = rng.standard_normal((2, 45, cfg.d_model)).astype(np.float32)
    ref = np.asarray(jrglru.rglru_apply(p, jnp.asarray(x), jcfg))
    got = rglru.rglru_apply(tp, torch.from_numpy(x), cfg).numpy()
    assert _rel(got, ref) <= 10 * RGLRU_TOL


def test_rglru_block_prefill_matches_repro_scan():
    """The chunk step against ``repro``'s gated scan of the decode step, at
    the block level (norm, RG-LRU, residual, GeGLU FFN): n_valid of C, 0
    (idle), 1 and 2 (the conv state gathers old rows), 5. The idle row's
    state stays bit for bit, its conv state too where n_valid < 3 keeps
    old rows."""
    cfg = get_config(ARCH, smoke=True, **F32)
    jcfg = jax_get_config(ARCH, smoke=True, **F32)
    p = jblocks.block_init(jax.random.PRNGKey(3), jcfg, "rglru", jnp.float32)
    tp = jax.tree.map(lambda v: torch.from_numpy(np.array(v)), p)
    rng = np.random.default_rng(3)
    B, C, w = 5, 7, cfg.lru_width
    cache = {"h": (rng.standard_normal((B, w)) * 0.5).astype(np.float32),
             "conv": rng.standard_normal((B, 3, w)).astype(np.float32)}
    x = rng.standard_normal((B, C, cfg.d_model)).astype(np.float32)
    nv = np.array([C, 0, 1, 2, 5], np.int32)
    lengths = np.array([3, 9, 0, 4, 11], np.int32)
    jc, jy = jblocks.block_prefill(
        p, {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(x),
        jcfg, "rglru", jnp.asarray(lengths), jnp.asarray(nv))
    tc = _tcache(cache)
    _, ty = blocks.block_prefill(tp, tc, torch.from_numpy(x), cfg, "rglru",
                                 torch.from_numpy(lengths),
                                 torch.from_numpy(nv), None)
    # the valid tokens, and the one after them (an idle row's logits read
    # it); the rest are not defined
    jy, ty = np.asarray(jy), ty.numpy()
    for row, n in enumerate(nv):
        k = min(int(n) + 1, C)
        assert _rel(ty[row, :k], jy[row, :k]) <= 10 * RGLRU_TOL, row
    assert _rel(tc["h"].numpy(), jc["h"]) <= RGLRU_TOL
    np.testing.assert_array_equal(tc["h"].numpy()[1], cache["h"][1])
    np.testing.assert_array_equal(tc["conv"].numpy()[1], cache["conv"][1])
    # the conv state: the last three inputs, old rows where n_valid < 3
    assert _rel(tc["conv"].numpy(), jc["conv"]) <= RGLRU_TOL
    np.testing.assert_array_equal(tc["conv"].numpy()[2, :2],
                                  cache["conv"][2, 1:])
    np.testing.assert_array_equal(tc["conv"].numpy()[3, 0],
                                  cache["conv"][3, 2])


def test_rglru_prefill_steps_equal_decode_steps():
    """In the port, chunks of 1 and of 3 advance the state as the decode
    step does, token by token: the same float32 recurrence in the same
    order."""
    cfg, _, _, tp, cache, rng = _layer(4, batch=3)
    x = rng.standard_normal((3, 6, cfg.d_model)).astype(np.float32)
    dec = _tcache(cache)
    ys = [rglru.rglru_decode_step(tp, dec, torch.from_numpy(x[:, t]),
                                  cfg)[1] for t in range(6)]
    pf = _tcache(cache)
    outs = [rglru.rglru_prefill_step(tp, pf, torch.from_numpy(x[:, t:t + 3]),
                                     cfg, torch.tensor([3, 3, 3]))[1]
            for t in (0, 3)]
    assert _rel(pf["h"].numpy(), dec["h"].numpy()) <= RGLRU_TOL
    np.testing.assert_array_equal(pf["conv"].numpy(), dec["conv"].numpy())
    assert _rel(torch.cat(outs, 1).numpy(),
                torch.stack(ys, 1).numpy()) <= RGLRU_TOL


def test_forward_over_two_units_matches_repro():
    """Six layers, two units of (rglru, rglru, attn): a converter that
    swapped the unit and the position would run another model."""
    over = dict(F32, num_layers=6, attention_variant="exact")
    jcfg = jax_get_config(ARCH, smoke=True, attention_impl="pallas", **over)
    cfg = get_config(ARCH, smoke=True, **over)
    params = japi.init_model(jax.random.PRNGKey(5), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    assert [("w_in_rec" in p["mix"]) for p in tparams["layers"]] == [
        k == "rglru" for k in cfg.pattern_for()]
    np.testing.assert_array_equal(
        tparams["layers"][3]["mix"]["w_a"].numpy(),
        np.asarray(params["units"][0]["mix"]["w_a"][1]))
    np.testing.assert_array_equal(
        tparams["layers"][5]["mix"]["wq"].numpy(),
        np.asarray(params["units"][2]["mix"]["wq"][1]))
    rng = np.random.default_rng(5)
    toks = rng.integers(1, cfg.vocab_size, (2, 40)).astype(np.int32)
    ref = np.asarray(japi.forward(params, {"tokens": jnp.asarray(toks)},
                                  jcfg))
    got = tapi.forward(tparams, {"tokens": torch.from_numpy(toks)},
                       cfg).detach().numpy()
    assert _rel(got, ref) <= 1e-5
    swapped = dict(tparams, layers=[tparams["layers"][i]
                                    for i in (0, 4, 2, 3, 1, 5)])
    other = tapi.forward(swapped, {"tokens": torch.from_numpy(toks)},
                         cfg).detach().numpy()
    assert _rel(other, ref) > 1e-3


def test_state_kinds_and_page_ops_skip_recurrent_state(m):
    """Every layer's state is of its kind; a page copy or poison touches
    attention pools only."""
    _, _, cfg, _ = m
    state = tapi.init_paged_state(cfg, 2, 6, 4, device="cpu")
    for kind, cache in zip(cfg.pattern_for(), state["caches"]):
        if kind == "rglru":
            assert set(cache) == {"h", "conv"}
            assert cache["h"].shape == (2, cfg.lru_width)
            assert cache["h"].dtype == torch.float32
            assert cache["conv"].shape == (2, 3, cfg.lru_width)
            cache["h"].fill_(1.0)
        else:
            assert "k" in cache and cache["k"].shape[0] >= 6 * 4
    tapi.poison_paged_block(state, cfg, 1, page_size=4)
    tapi.copy_paged_block(state, cfg, 1, 2, page_size=4)
    for kind, cache in zip(cfg.pattern_for(), state["caches"]):
        if kind == "rglru":
            assert bool((cache["h"] == 1.0).all())
            assert bool((cache["conv"] == 0).all())
        else:
            assert bool(torch.isnan(cache["k"][8:12]).all())
    cstate = tapi.init_decode_state(cfg, 3, 64, device="cpu")
    spans = [c["k"].shape[2] for c, k in zip(cstate["caches"],
                                             cfg.pattern_for()) if k == "attn"]
    assert spans == [cfg.window]                # a rolling buffer of 32


def test_refusals_name_attention_only(m):
    _, _, cfg, tparams = m
    for kv in ("int8", "fp8"):
        with pytest.raises(ValueError, match="attention-only"):
            validate_kv_dtype(cfg, kv)
        with pytest.raises(ValueError, match="attention-only"):
            ServeEngine(None, cfg, kv_dtype=kv)     # before any device
    assert validate_kv_dtype(cfg, "fp32") == "fp32"
    with pytest.raises(ValueError, match="attention-only"):
        ServeEngine(tparams, cfg, kv_layout="paged", prefix_cache=True,
                    device="cpu")
    assert not ServeEngine(tparams, cfg, kv_layout="paged",
                           device="cpu").prefix_cache
    with pytest.raises(ValueError, match="attention-only"):
        serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--kv-dtype", "int8"])


def test_serve_cli_on_cpu(capsys):
    reqs = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--requests", "3", "--max-new", "4", "--chunk",
                           "8", "--kv-layout", "paged"])
    assert [len(r.out) for r in reqs] == [4, 4, 4]
    assert "kv=paged/fp32" in capsys.readouterr().out


@pytest.fixture(scope="module")
def long_ref(m):
    """``repro``'s temp-0 streams over the long prompts, contiguous."""
    jcfg, params, _, _ = m
    return _serve(JaxServeEngine(params, jcfg, slots=2, max_len=64,
                                 chunk_size=8, attention_impl="pallas"),
                  _prompts(2, LONG))


@pytest.mark.parametrize("kw", [
    dict(chunk_size=8), dict(chunk_size=1),
    dict(chunk_size=8, kv_layout="paged", page_size=8)],
    ids=["contiguous", "chunk1", "paged"])
def test_long_prompt_streams_match_repro_engine(m, long_ref, kw):
    """``tests/test_prefill.py:102`` and ``tests/test_paged.py:155``:
    prompts of 40, 7 and 35 tokens over a window of 32 (the rolling buffer
    wraps; the paged kernels mask by the window), chunked, chunk 1 and
    paged, each equal to ``repro``'s chunked contiguous streams."""
    _, _, cfg, tparams = m
    before = dict(build.COUNTS)
    eng = ServeEngine(tparams, cfg, slots=2, max_len=64, device="cpu", **kw)
    assert _serve(eng, _prompts(2, LONG)) == long_ref
    plain = "paged_prefill_plain" if eng.paged else "prefill_plain"
    if kw["chunk_size"] > 1:
        assert build.COUNTS[plain] > before.get(plain, 0)


def test_paged_expmul_streams_match_repro_engine():
    """ExpMul on the paged layout, both engines walking the same tiles."""
    jcfg, params, cfg, tparams = _models("expmul", ARCH)
    kw = dict(slots=3, max_len=64, chunk_size=8, kv_layout="paged",
              page_size=4, prefix_cache=False)
    prompts = _prompts(0, (13, 5, 38, 9))
    ref = _serve(JaxServeEngine(params, jcfg, attention_impl="pallas", **kw),
                 prompts)
    assert _serve(ServeEngine(tparams, cfg, device="cpu", **kw),
                  prompts) == ref


def test_preemption_keeps_streams(m):
    """``tests/test_paged.py:190``: a pool too small for three slots
    preempts and requeues (recompute resumption), the recurrent state of a
    re-admitted slot zeroed, and every stream is ``repro``'s."""
    jcfg, params, cfg, tparams = m
    prompts = _prompts(1, (9, 21, 6, 13, 17))
    ref = _serve(JaxServeEngine(params, jcfg, slots=3, max_len=64,
                                chunk_size=8, attention_impl="pallas"),
                 prompts)
    tight = ServeEngine(tparams, cfg, slots=3, max_len=64, chunk_size=8,
                        kv_layout="paged", page_size=4, pool_blocks=12,
                        device="cpu")
    assert _serve(tight, prompts) == ref
    assert tight.preemptions > 0
    assert tight.pool.stats.evictions == tight.preemptions
    assert tight.pool.used_blocks == 0


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_reused_slot_gives_a_fresh_engines_stream(m, layout):
    """A request admitted into the slot a finished one held: its recurrent
    state is zeroed at admission, in place, so its stream is a fresh
    engine's. As a witness, NaN left in the slot's state reaches the
    stream when the reset is skipped (the request fails)."""
    _, _, cfg, tparams = m
    long_first, short_second = _prompts(4, (30, 6))
    kw = dict(slots=1, max_len=64, chunk_size=8, kv_layout=layout,
              device="cpu")
    fresh = _serve(ServeEngine(tparams, cfg, **kw), [short_second], max_new=5)
    for reset in (True, False):
        eng = ServeEngine(tparams, cfg, **kw)
        if not reset:
            eng._reset_slot_state = lambda s: None
        addrs = [t.data_ptr() for t in eng._recurrent]
        first = eng.submit(long_first, 5)
        eng.run()
        assert first.finish_reason == "length"
        for leaf in eng._recurrent:
            leaf.fill_(float("nan"))
        second = eng.submit(short_second, 5)
        eng.run()
        assert [t.data_ptr() for t in eng._recurrent] == addrs
        if reset:
            assert second.finish_reason == "length"
            assert [second.out] == fresh
        else:
            assert second.finish_reason == "failed"


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_snapshot_round_trips_recurrent_state(m, tmp_path, layout):
    _, _, cfg, tparams = m
    kw = dict(slots=2, max_len=64, chunk_size=8, kv_layout=layout,
              device="cpu")
    prompts = _prompts(6, (20, 11, 36))
    oracle = _serve(ServeEngine(tparams, cfg, **kw), prompts)
    eng = ServeEngine(tparams, cfg, **kw)
    reqs = [eng.submit(p, 6, rid=i) for i, p in enumerate(prompts)]
    for _ in range(4):
        eng.tick()
    assert any(r.out for r in reqs) and not all(r.done for r in reqs)
    assert any(bool(t.abs().sum() > 0) for t in eng._recurrent)
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
    for r in reqs:
        if r.done:
            assert r.out == oracle[r.rid]

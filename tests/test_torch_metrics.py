"""The port's observability layer (DESIGN.md §12) against the assertions of
``tests/test_metrics.py``, and against ``repro``'s registry and engine.

* Histogram quantiles are numpy's inverted-CDF percentiles; overflow and
  empty histograms behave; the Prometheus text, the snapshot and the
  Chrome trace of the port's registry equal ``repro``'s for the same
  recorded values.
* A traced paged run: lifecycle ordering, a valid Chrome trace (matched
  B/E, only X/B/E/i/M phases), TTFT/TPOT histograms equal to the requests'
  own fields, the executed-cost ledger equal to the engine's steps; with
  tracing off no event is recorded.
* The attention wrappers count one dispatch per call, per impl.
* ``memory_stats()``, ``pool.stats`` and the engine's attributes equal the
  registry after a preemption-heavy run.
* For the same traced workload the port's ``attention_ledger()`` and its
  step-valued TTFT/TPOT quantiles equal those of ``repro``'s engine at
  ``attention_impl="pallas"`` (the ms twins come from the host clock and
  are not compared).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.api import init_model as jax_init_model  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.metrics import MetricsRegistry as JaxRegistry  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.decode.ops import (  # noqa: E402
    decode_attention,
    fused_paged_decode_attention,
    quant_decode_attention,
)
from repro_torch.kernels.flash.ops import (  # noqa: E402
    flash_attention_fwd,
    prefill_attention,
)
from repro_torch.numerics.quant import quantize_kv  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.metrics import (  # noqa: E402
    MS_BUCKETS,
    Histogram,
    MetricsRegistry,
    install_dispatch_counters,
)

TRACED = dict(slots=2, max_len=64, chunk_size=8, kv_layout="paged",
              page_size=4)


@pytest.fixture(scope="module")
def models():
    over = dict(dtype="float32", param_dtype="float32")
    jcfg = jax_get_config("qwen2-0.5b", smoke=True, **over)
    params = jax_init_model(jax.random.PRNGKey(0), jcfg)
    tcfg = get_config("qwen2-0.5b", smoke=True, **over)
    return jcfg, params, tcfg, params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, device="cpu")


def _traced_prompts():
    rng = np.random.default_rng(3)
    return [list(rng.integers(1, 200, size=n)) for n in (11, 4, 19)]


@pytest.fixture(scope="module")
def traced_run(models):
    """One traced paged serve run shared by the lifecycle/trace tests."""
    _, _, tcfg, tparams = models
    eng = ServeEngine(tparams, tcfg, device="cpu", trace=True, **TRACED)
    reqs = [eng.submit(p, 5, rid=i) for i, p in enumerate(_traced_prompts())]
    eng.run()
    assert all(r.done for r in reqs)
    return eng, reqs


# -- histograms and the registry ---------------------------------------------

def test_histogram_quantiles_match_numpy():
    rng = np.random.default_rng(0)
    data = rng.integers(1, 100, size=257)
    h = Histogram(buckets=tuple(range(1, 129)))
    for v in data:
        h.record(int(v))
    for q in (0.50, 0.90, 0.99):
        want = np.percentile(data, 100 * q, method="inverted_cdf")
        assert h.quantile(q) == float(want), (q, h.quantile(q), want)
    assert h.count == len(data)
    assert h.total == data.sum()
    assert np.isclose(h.mean, data.mean())


def test_histogram_overflow_and_empty():
    h = Histogram(buckets=(1, 2, 4))
    assert np.isnan(h.quantile(0.5))
    h.record(3)
    h.record(100)
    assert h.overflow == 1 and h.count == 2
    assert h.quantile(0.5) == 4.0
    assert h.quantile(0.99) == 4.0


def _record(m):
    """The same instrument operations on either package's registry."""
    m.counter("requests_total", kind="a").inc(3)
    m.counter("requests_total", kind="b").inc()
    m.gauge("depth").set(7)
    m.gauge("peak").set_max(5)
    m.gauge("peak").set_max(2)
    h = m.histogram("lat", buckets=(1, 2))
    for v in (1, 2, 5):
        h.record(v)
    ms = m.histogram("lat_ms", buckets=MS_BUCKETS, kind="a")
    for v in (0.013, 2.5, 7.0, 1e6):
        ms.record(v)
    m.name_track(1, 0, "engine steps")
    m.name_track(2, 4, "req 4")
    m.begin("req 4", pid=2, tid=4, step=0)
    with m.span("decode_step", step=1, active=1):
        pass
    m.instant("first_token", pid=2, tid=4, step=1)
    m.end("req 4", pid=2, tid=4, step=1)


def test_registry_prometheus_exposition_equals_repro():
    port, ref = MetricsRegistry(trace=True), JaxRegistry(trace=True)
    _record(port)
    _record(ref)
    text = port.prometheus_text()
    assert text == ref.prometheus_text()
    assert '# TYPE requests_total counter' in text
    assert 'requests_total{kind="a"} 3' in text
    assert "depth 7" in text
    assert 'lat_bucket{le="1"} 1' in text
    assert 'lat_bucket{le="+Inf"} 3' in text
    assert "lat_count 3" in text
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())
    # the traces differ only in their host timestamps
    strip = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
             for e in port.chrome_trace()["traceEvents"]]
    assert strip == [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                     for e in ref.chrome_trace()["traceEvents"]]


# -- request lifecycle --------------------------------------------------------

def test_lifecycle_event_ordering(traced_run):
    eng, reqs = traced_run
    evs = eng.metrics.events
    for r in reqs:
        per = [e for e in evs if e.get("tid") == r.rid and e["pid"] == 2]
        phases = [e["ph"] for e in per]
        assert phases[0] == "B" and phases[-1] == "E", phases
        first_tok = next(e for e in per if e["name"] == "first_token")
        b, e = per[0], per[-1]
        assert b["ts"] <= first_tok["ts"] <= e["ts"]
        assert b["args"]["step"] < first_tok["args"]["step"] <= \
            e["args"]["step"]
        assert first_tok["args"]["step"] == r.first_token_step
        assert b["args"]["step"] == r.admit_step
    steps = [e for e in evs if e["ph"] == "X"]
    assert len(steps) == eng.ticks
    assert all(e["dur"] >= 0 for e in steps)
    assert all(e["name"] in ("prefill_step", "decode_step") for e in steps)


def test_ttft_tpot_histograms_match_request_fields(traced_run):
    eng, reqs = traced_run
    snap = eng.metrics_snapshot()
    ttfts = [r.first_token_step - r.admit_step + 1 for r in reqs]
    h = snap["histograms"]["serve_ttft_steps"]
    assert h["count"] == len(reqs)
    assert h["sum"] == sum(ttfts)
    for q, key in ((50, "ttft_steps_p50"), (99, "ttft_steps_p99")):
        want = float(np.percentile(ttfts, q, method="inverted_cdf"))
        assert snap[key] == want, (key, snap[key], want)
    tpot = snap["histograms"]["serve_tpot_steps"]
    assert tpot["count"] == eng.tokens_generated - len(reqs)
    assert np.isfinite(snap["tpot_steps_p50"])
    assert snap["histograms"]["serve_ttft_ms"]["count"] == len(reqs)


def test_chrome_trace_valid_json_matched_events(traced_run, tmp_path):
    eng, reqs = traced_run
    path = tmp_path / "trace.json"
    eng.metrics.write_chrome_trace(path)
    tr = json.loads(path.read_text())
    evs = tr["traceEvents"]
    assert evs and all(e["ph"] in ("X", "B", "E", "i", "M") for e in evs)
    n_b = sum(1 for e in evs if e["ph"] == "B")
    n_e = sum(1 for e in evs if e["ph"] == "E")
    assert n_b == n_e == len(reqs)
    assert all(e["dur"] >= 0 for e in evs if e["ph"] == "X")
    names = {(e["pid"], e["tid"]): e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert names[(1, 0)] == "engine steps"
    assert all((2, r.rid) in names for r in reqs)


def test_disabled_mode_records_no_spans(models):
    _, _, tcfg, tparams = models
    eng = ServeEngine(tparams, tcfg, device="cpu", slots=2, max_len=64,
                      chunk_size=8)
    eng.submit([1, 2, 3, 4, 5, 6, 7], 4)
    eng.run()
    assert eng.metrics.events == []
    snap = eng.metrics_snapshot()
    assert snap["trace_events"] == 0
    assert snap["counters"]["serve_tokens_generated_total"] == 4
    # every terminal state is counted, the unused ones at 0 (§13)
    assert snap["finish_reasons"] == {"length": 1, "deadline": 0,
                                      "cancelled": 0, "failed": 0,
                                      "preempt_limit": 0}
    assert snap["quarantined"] == 0
    assert np.isfinite(snap["ttft_steps_p50"])
    assert json.loads(json.dumps(snap))
    assert "serve_steps_total" in eng.prometheus_text()


# -- dispatch counters (the attention wrappers' hook) -------------------------

def test_eager_dispatch_counters_per_impl():
    """Each wrapper call counts once under its kind and impl ("kernel":
    the kernel's route, its plain version for CPU tensors; "plain": the
    plain version forced), priced with analytic bytes and FLOPs."""
    m = MetricsRegistry()
    install_dispatch_counters(m)
    try:
        rng = np.random.default_rng(0)
        B, H, Hkv, D, S = 1, 2, 1, 16, 16

        def t(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32))

        q, k, v = t(B, H, D), t(B, Hkv, S, D), t(B, Hkv, S, D)
        lengths = torch.tensor([4], dtype=torch.int32)
        for _ in range(3):
            decode_attention(q, k, v, lengths)
        decode_attention(q, k, v, lengths, plain=True)
        kq, vq = quantize_kv(k, "int8"), quantize_kv(v, "int8")
        quant_decode_attention(q, kq.codes, vq.codes, kq.scale, vq.scale,
                               lengths)
        pool_k, pool_v = t(S, Hkv, D), t(S, Hkv, D)
        tables = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
        fused_paged_decode_attention(q, pool_k, pool_v, tables, lengths,
                                     page_size=4)
        C = 4
        prefill_attention(t(B, H, C, D), k, v, t(B, Hkv, C, D),
                          t(B, Hkv, C, D), lengths,
                          torch.tensor([C], dtype=torch.int32))
        flash_attention_fwd(t(B, H, S, D), k, v, block_k=16)
        common = dict(variant="exact", layout="contiguous")
        count = m.counter_value
        assert count("attention_dispatch_total", kind="decode",
                     impl="kernel", kv_dtype="fp32", **common) == 3
        assert count("attention_dispatch_total", kind="decode",
                     impl="plain", kv_dtype="fp32", **common) == 1
        assert count("attention_dispatch_total", kind="decode",
                     impl="kernel", kv_dtype="int8", **common) == 1
        assert count("attention_dispatch_total", kind="paged_decode",
                     impl="kernel", kv_dtype="fp32", variant="exact",
                     layout="paged") == 1
        assert count("attention_dispatch_total", kind="prefill",
                     impl="kernel", kv_dtype="fp32", **common) == 1
        assert count("attention_dispatch_total", kind="full",
                     impl="kernel", kv_dtype="fp32", **common) == 1
        assert count("attention_dispatch_analytic_bytes", kind="decode",
                     impl="kernel", kv_dtype="fp32", **common) > 0
        assert count("attention_dispatch_analytic_flops", kind="decode",
                     impl="plain", kv_dtype="fp32", **common) > 0
    finally:
        install_dispatch_counters(None)


def test_engine_exec_ledger_matches_steps(traced_run):
    eng, reqs = traced_run
    led = eng.attention_ledger()
    assert led["prefill"]["steps"] == eng.prefill_steps
    assert led["decode"]["steps"] == eng.decode_steps
    assert led["decode"]["calls"] >= eng.decode_steps
    assert led["decode"]["calls"] <= eng.decode_steps * eng.slots
    for kind in ("prefill", "decode"):
        assert led[kind]["analytic_bytes"] > 0
        assert led[kind]["analytic_flops"] > 0
        assert led[kind]["path"] == "fused"
        assert led[kind]["impl"] == "kernel"
    # the engine installed its registry: the wrappers counted every layer
    c = eng.metrics.snapshot()["counters"]
    n = sum(v for k, v in c.items()
            if k.startswith("attention_dispatch_total"))
    assert n == eng.ticks * eng.cfg.num_layers


def test_engine_sink_observes_its_own_ticks_only(models):
    """Each engine's dispatch counters see its own ticks: the slot holds
    the engine's sink only while it ticks, and the sink found before is put
    back, so a second live engine and calls between ticks count nowhere
    else."""
    from repro_torch.kernels import build

    _, _, tcfg, tparams = models
    outer = MetricsRegistry()
    install_dispatch_counters(outer)
    try:
        prev = build.DISPATCH_SINK
        a = ServeEngine(tparams, tcfg, device="cpu", **TRACED)
        b = ServeEngine(tparams, tcfg, device="cpu", **TRACED)
        assert build.DISPATCH_SINK is prev
        a.submit([5, 6, 7, 8, 9], 3)
        a.run()
        assert build.DISPATCH_SINK is prev

        def dispatched(m):
            return sum(v for k, v in m.snapshot()["counters"].items()
                       if k.startswith("attention_dispatch_total"))

        assert dispatched(a.metrics) == a.ticks * tcfg.num_layers
        assert dispatched(b.metrics) == 0 and dispatched(outer) == 0
        # with the engine's sink off, its ticks count nowhere
        b.dispatch_sink = None
        b.submit([5, 6, 7, 8, 9], 3)
        b.run()
        assert b.ticks > 0
        assert dispatched(b.metrics) == 0 and dispatched(outer) == 0
        assert build.DISPATCH_SINK is prev
    finally:
        install_dispatch_counters(None)


# -- single-ownership contract ------------------------------------------------

def test_memory_stats_equals_registry_after_preemptions(models):
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(1, 200, size=n)) for n in (9, 21, 6, 13)]
    eng = ServeEngine(tparams, tcfg, device="cpu", slots=3, max_len=64,
                      chunk_size=8, kv_layout="paged", page_size=4,
                      pool_blocks=12)
    reqs = [eng.submit(p, 6, rid=i) for i, p in enumerate(prompts)]
    eng.run()
    assert all(r.done for r in reqs)
    assert eng.preemptions > 0

    st = eng.memory_stats()
    c = eng.metrics.snapshot()["counters"]
    assert st["preemptions"] == c["serve_preemptions_total"]
    assert st["recompute_tokens"] == c["serve_recompute_tokens_total"]
    assert st["evictions"] == c["pool_evictions_total"]
    assert st["alloc_failures"] == c["pool_alloc_failures_total"]
    ps = eng.pool.stats
    assert ps.evictions == c["pool_evictions_total"]
    assert ps.allocs == c["pool_allocs_total"]
    assert ps.frees == c["pool_frees_total"]
    assert ps.cow_copies == c.get("pool_cow_copies_total", 0)
    assert ps.cache_hits == c["pool_cache_hits_total"]
    assert ps.hit_blocks == c["pool_hit_blocks_total"]
    assert eng.ticks == c["serve_steps_total"]
    assert eng.tokens_generated == c["serve_tokens_generated_total"]
    assert eng.prefix_hit_tokens == c["serve_prefix_hit_tokens_total"]
    g = eng.metrics.snapshot()["gauges"]
    assert st["kv_used_blocks"] == g["pool_used_blocks"]
    assert st["kv_cached_blocks"] == g["pool_cached_blocks"]
    assert st["kv_free_blocks"] == g["pool_free_blocks"]
    assert st["kv_peak_used_tokens"] == g["serve_peak_kv_used_tokens"]


# -- parity with repro's books ------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_ledger_and_step_quantiles_match_repro_engine(models, kv_dtype):
    jcfg, params, tcfg, tparams = models
    kw = dict(TRACED, kv_dtype=kv_dtype, trace=True)
    jeng = JaxServeEngine(params, jcfg, attention_impl="pallas", **kw)
    teng = ServeEngine(tparams, tcfg, device="cpu", **kw)
    outs = []
    for eng in (jeng, teng):
        reqs = [eng.submit(p, 5, rid=i)
                for i, p in enumerate(_traced_prompts())]
        eng.run()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    keys = ("calls", "steps", "kv_tokens", "analytic_bytes",
            "analytic_flops", "path")
    tl, jl = teng.attention_ledger(), jeng.attention_ledger()
    for kind in ("prefill", "decode"):
        assert {k: tl[kind][k] for k in keys} == \
            {k: jl[kind][k] for k in keys}, kind
    ts, js = teng.metrics_snapshot(), jeng.metrics_snapshot()
    for key in ("ttft_steps_p50", "ttft_steps_p99", "tpot_steps_p50",
                "tpot_steps_p99"):
        assert ts[key] == js[key], key
    for name in ("serve_ttft_steps", "serve_tpot_steps"):
        assert ts["histograms"][name] == js["histograms"][name], name
    # the step-valued books, instant for instant
    def steps(eng):
        return [(e["name"], e["ph"], e.get("tid"), e["args"].get("step"))
                for e in eng.metrics.events]
    assert steps(teng) == steps(jeng)

"""The compiled serving ticks of ``repro_torch`` (``serve/graphs.py``) on the
CPU, where the engine runs its static-buffer tick path eagerly.

* The fixed-shape KV writes a captured tick makes (``scatter_index`` /
  ``scatter_fixed`` on the paged pools, ``chunk_index`` / ``chunk_write``
  on per-slot caches and rolling buffers) leave every pool and cache
  exactly as the ``nonzero`` write plans did: idle slots, sentinel and
  ``OUT_OF_TABLE_ROW`` rows, negative rows, a chunk longer than a rolling
  span, ``n_valid`` of 0.
* The engine on its static buffers against ``repro``'s jitted engine at
  ``attention_impl="pallas"``: temp-0 streams, every tick's logits on the
  active rows (within the model tests' same-walk tolerance), the pool's
  dump, for paged int8 ExpMul and contiguous fp32.
* The state, the static buffers and the parameters keep their addresses
  across ticks, a copy on write, a quarantine scrub and ``restore_engine``.
* A graph's launches and dispatch-sink calls, recorded at capture and
  re-applied once per replay, read as an eager run's (``COUNTS`` and
  ``attention_dispatch_total``), with the capture emulated on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged as jpaged  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged as tpaged  # noqa: E402
from repro_torch.layers.attention_layer import (  # noqa: E402
    chunk_gate,
    chunk_index,
    chunk_write,
)
from repro_torch.serve import graphs  # noqa: E402
from repro_torch.serve import snapshot as snapshot_mod  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.faults import (  # noqa: E402
    ChaosInjector,
    install_fault_injector,
)
from torch_serving import models  # noqa: E402

HKV, D = 2, 8
SAME_WALK_TOL = {"fp32": 1e-4, "int8": 1e-3}   # as tests/test_torch_model.py


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plan_scatter(pool, rows, values, valid):
    """Today's paged write: the ``nonzero`` plan of ``scatter_rows``."""
    return tpaged.scatter_rows(pool, rows, values, valid)


def _plan_chunk_write(buf, new, positions, gate):
    """The ``nonzero`` chunk plan the fixed-shape write replaced."""
    span = buf.shape[2]
    keep = gate & (positions >= 0) & (positions < span)
    b, c = torch.nonzero(keep, as_tuple=True)
    buf[b, :, positions[b, c]] = new[b, :, c].to(buf.dtype)
    return buf


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("leaf", ["values", "scales"])
def test_fixed_paged_write_equals_nonzero_plan(seed, leaf):
    """Random write rows over a pool of 12 pages of 4: sentinel pages
    (rows past the pool), ``OUT_OF_TABLE_ROW``, rows in [-n, 0) that count
    from the end and rows below -n, invalid tokens and whole idle rows.
    The pool equals the ``nonzero`` plan's, and ``repro``'s scatter."""
    rng = np.random.default_rng(seed)
    n = 12 * 4
    tail = (HKV, D) if leaf == "values" else (HKV,)
    B, C = 3, 9
    # distinct rows, some counted from the end, then four the write drops
    flat = rng.permutation(n)[:B * C].astype(np.int32)
    flat -= n * (rng.random(B * C) < 0.3)
    flat[:4] = [n, n + 3, tpaged.OUT_OF_TABLE_ROW, -n - 5]
    valid = rng.random(B * C) < 0.7
    valid[C:2 * C] = False                                     # an idle row
    vals = rng.standard_normal((B * C,) + tail).astype(np.float32)
    start = rng.standard_normal((n,) + tail).astype(np.float32)
    for v in (None, valid):
        fixed = tpaged.zeros_with_scratch((n,) + tail, HKV * D, torch.float32,
                                          "cpu")
        fixed.copy_(_t(start))
        index = tpaged.scatter_index(_t(flat), n,
                                     None if v is None else _t(v))
        assert index.shape == (B * C,)
        assert tpaged.scatter_fixed(fixed, index, _t(vals)) is fixed
        ref = _plan_scatter(_t(start.copy()), _t(flat), _t(vals),
                            None if v is None else _t(v))
        assert torch.equal(fixed, ref)
        jref = jpaged.scatter_rows(jnp.asarray(start), jnp.asarray(flat),
                                   jnp.asarray(vals),
                                   None if v is None else jnp.asarray(v))
        np.testing.assert_array_equal(fixed.numpy(), np.asarray(jref))


def test_scatter_fixed_needs_the_scratch_row():
    pool = torch.zeros((8, HKV, D))
    index = tpaged.scatter_index(torch.tensor([9], dtype=torch.int32), 8)
    with pytest.raises(RuntimeError):
        tpaged.scatter_fixed(pool, index, torch.ones((1, HKV, D)))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("rolling,span,C", [(False, 16, 5), (True, 6, 4),
                                            (True, 6, 9), (True, 5, 5)])
@pytest.mark.parametrize("leaf", ["values", "scales"])
def test_fixed_chunk_write_equals_nonzero_plan(seed, rolling, span, C, leaf):
    """Per-slot caches and rolling buffers: ragged ``n_valid`` with a 0
    (an idle slot), lengths that wrap the span, a chunk longer than the
    span (only its last ``span`` tokens written), positions past the cache
    (dropped). The cache equals the ``nonzero`` plan's."""
    rng = np.random.default_rng(100 + seed)
    B = 4
    tail = (D,) if leaf == "values" else ()
    lengths = rng.integers(0, 3 * span if rolling else span + 3, B)
    nv = rng.integers(0, C + 1, B)
    nv[1] = 0
    new = _t(rng.standard_normal((B, HKV, C) + tail).astype(np.float32))
    start = rng.standard_normal((B, HKV, span) + tail).astype(np.float32)
    lengths, nv = _t(lengths.astype(np.int32)), _t(nv.astype(np.int32))
    positions, gate = chunk_gate(lengths, nv, C, span, rolling)
    buf = tpaged.zeros_with_scratch((B, HKV, span) + tail,
                                    HKV * int(np.prod(tail)), torch.float32,
                                    "cpu")
    buf.copy_(_t(start))
    index = chunk_index(positions, gate, span, HKV)
    assert index.shape == (B * C * HKV,)
    assert chunk_write(buf, new, index) is buf
    ref = _plan_chunk_write(_t(start.copy()), new, positions, gate)
    assert torch.equal(buf, ref)


# -- the engine on its static-buffer ticks against repro's jitted engine -----

CELLS = {
    "paged/int8": dict(kv_layout="paged", page_size=4, kv_dtype="int8",
                       prefix_cache=False),
    "contiguous/fp32": dict(kv_layout="contiguous", kv_dtype="fp32"),
}
ENGINE = dict(slots=3, max_len=48, chunk_size=8)


def _prompts(seed=0, lens=(13, 5, 22, 9)):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, 256, size=n)) for n in lens]


def _logged(eng):
    """Record each tick's logits (as numpy) where both engines pass them
    to their chaos point, and which slots were active."""
    ticks = []
    chaos = eng._chaos_logits

    def hook(active, logits):
        ticks.append((list(active), np.asarray(logits, np.float64)))
        return chaos(active, logits)

    eng._chaos_logits = hook
    return ticks


@pytest.fixture(scope="module")
def expmul_models():
    return models("expmul")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_static_buffer_ticks_match_repro_jit(expmul_models, cell):
    m = expmul_models
    kw = dict(ENGINE, **CELLS[cell])
    prompts = _prompts()
    jeng = JaxServeEngine(m.jparams, m.jcfg, attention_impl="pallas", **kw)
    eng = ServeEngine(m.params, m.cfg, device="cpu", **kw)
    assert eng.eager_ticks
    runs = []
    for e in (jeng, eng):
        ticks = _logged(e)
        reqs = [e.submit(p, 8, rid=i) for i, p in enumerate(prompts)]
        e.run()
        runs.append((ticks, [r.out for r in reqs]))
    (jticks, jout), (tticks, tout) = runs
    assert tout == jout
    assert len(tticks) == len(jticks) and eng.prefill_steps > 0
    tol = SAME_WALK_TOL[kw["kv_dtype"]]
    for (ja, jl), (ta, tl) in zip(jticks, tticks):
        assert ta == ja and tl.shape == jl.shape
        err = np.max(np.abs(tl[ta] - jl[ta])) / np.max(np.abs(jl[ta]))
        assert err <= tol
    if eng.paged:
        assert eng.pool.dump_state() == jeng.pool.dump_state()


# -- addresses ---------------------------------------------------------------

def _addresses(eng):
    ptrs = [t.data_ptr() for c in eng.state["caches"] for t in c.values()]
    for g in (eng._prefill_graph, eng._decode_graph):
        ptrs += [b.data_ptr() for b in g.buffers.values()]
    ptrs += [p.data_ptr() for layer in eng.params["layers"]
             for mod in layer.values() for p in mod.values()]
    return ptrs


@pytest.mark.parametrize("path", ["ticks", "cow", "scrub", "restore"])
def test_state_and_buffers_keep_their_addresses(expmul_models, path,
                                                tmp_path, monkeypatch):
    m = expmul_models
    kw = dict(slots=2, max_len=48, chunk_size=6, page_size=4,
              kv_layout="paged", kv_dtype="int8", device="cpu")
    shared = _prompts(3, (22,))[0]
    if path == "restore":
        built = []

        class Recorded(ServeEngine):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                built.append(_addresses(self))

        monkeypatch.setattr("repro_torch.serve.engine.ServeEngine", Recorded)
        eng = Recorded(m.params, m.cfg, **kw)
        for p in _prompts(4, (9, 14)):
            eng.submit(p, 6)
        eng.tick()
        eng.save_snapshot(str(tmp_path / "e.npz"))
        eng = snapshot_mod.restore_engine(str(tmp_path / "e.npz"), m.params,
                                          m.cfg, device="cpu")
        assert _addresses(eng) == built[-1]     # copied into, in place
        before = _addresses(eng)
        eng.run()
        assert _addresses(eng) == before
        return
    eng = ServeEngine(m.params, m.cfg, **kw)
    before = _addresses(eng)
    if path == "cow":
        eng.submit(shared + [7], 1, rid=100)
        eng.run()
        reqs = [eng.submit(shared + t, 4) for t in ([3, 4], [5])]
        eng.run()
        assert eng.memory_stats()["cow_copies"] > 0
    elif path == "scrub":
        install_fault_injector(ChaosInjector(at={"kv_corrupt": [2]}))
        try:
            reqs = [eng.submit(p, 6) for p in _prompts(5, (9, 12))]
            eng.run()
        finally:
            install_fault_injector(None)
        assert eng.metrics_snapshot()["quarantined"] >= 1
    else:
        reqs = [eng.submit(p, 6) for p in _prompts(6, (9, 14, 5))]
        eng.run()
    assert all(r.done for r in reqs)
    assert _addresses(eng) == before


# -- counters across replays -------------------------------------------------

class _EmulatedGraph:
    """A CPU stand-in for a captured CUDA graph: ``replay()`` reruns the
    tick on the static buffers with its own counts and sink calls
    discarded, and writes the logits into the static output in place."""

    def __init__(self, tick):
        self.tick = tick

    def replay(self):
        with build.recording():
            out = self.tick.fn(**self.tick.buffers)
        self.tick.logits.copy_(out)


def _emulated_capture(self):
    """What a capture records, taken from a run on the warm-up's inputs
    (no chunk token valid, so it writes no row the replay does not)."""
    warm = {name: b.clone() for name, b in self.buffers.items()}
    for name in self.warm_zero:
        warm[name].zero_()
    with build.recording() as rec:
        self.logits = self.fn(**warm)
    self.graph, self._recorded = _EmulatedGraph(self), rec


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_replays_reapply_recorded_counts(expmul_models, cell, monkeypatch):
    m = expmul_models
    kw = dict(ENGINE, **CELLS[cell], device="cpu")
    prompts = _prompts(7)
    plain = "paged_" if kw["kv_layout"] == "paged" else ""
    pair = {f"{plain}prefill_plain", f"{plain}decode_plain"}

    def serve(graphed):
        eng = ServeEngine(m.params, m.cfg, **kw)
        if graphed:
            monkeypatch.setattr(graphs.TickGraph, "_capture",
                                _emulated_capture)
            for g in (eng._prefill_graph, eng._decode_graph):
                g.capture = True
        build.reset_counts()
        reqs = [eng.submit(p, 8) for p in prompts]
        eng.run()
        counts = {k: v for k, v in build.COUNTS.items() if v}
        dispatch = {k: v for k, v in
                    eng.metrics.snapshot()["counters"].items()
                    if k.startswith("attention_dispatch_total")}
        return eng, [r.out for r in reqs], counts, dispatch

    _, out, counts, dispatch = serve(False)
    eng, gout, gcounts, gdispatch = serve(True)
    assert gout == out
    assert set(counts) == pair
    assert gcounts == counts and gdispatch == dispatch
    assert sum(gdispatch.values()) == eng.ticks * eng.cfg.num_layers
    st = eng.graph_stats()
    for kind in ("prefill", "decode"):
        per = st[kind]["launches_per_replay"]
        assert st[kind]["replays"] == getattr(eng, f"{kind}_steps")
        assert per == {f"{plain}{kind}_plain": eng.cfg.num_layers}


def test_capture_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA"):
        graphs.TickGraph(lambda tokens: tokens, {"tokens": (2,)}, "cpu",
                         capture=True)


def test_recording_leaves_counts_and_sink_as_they_were():
    calls = []
    build.set_dispatch_sink(lambda *a, **k: calls.append(a))
    try:
        build.COUNTS["test_kernel"] += 1
        before = dict(build.COUNTS)
        with build.recording() as rec:
            build.COUNTS["test_kernel"] += 2
            build.DISPATCH_SINK("decode", batch=1)
        assert dict(build.COUNTS) == before and not calls
        rec.replay()
        rec.replay()
        assert build.COUNTS["test_kernel"] == before["test_kernel"] + 4
        assert calls == [("decode",), ("decode",)]
    finally:
        build.set_dispatch_sink(None)
        del build.COUNTS["test_kernel"]

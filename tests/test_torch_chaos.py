"""The port's chaos matrix (DESIGN.md §13) against the assertions of
``tests/test_chaos.py``, and against ``repro``'s engine.

Every injection point is driven against a fault-free baseline on the port's
engine (smoke qwen2-0.5b, float32, ExpMul, ``device="cpu"``, the
reference's sizes): delay faults change no stream, corruption faults fail
exactly their victim, and the pool's accounting is leak-free after every
run. Each run is also run by ``repro``'s engine (``attention_impl=
"pallas"``, the same converted weights) under the same schedule, and the
two must leave the same outcome: every request's finish reason and temp-0
tokens, the terminal-state counts, the quarantine count, the block pool's
``dump_state()`` and the injector's fires and opportunities (the port
counts opportunities at the reference's places, in its order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_serving as ts  # noqa: E402
from repro_torch.serve.faults import (  # noqa: E402
    ChaosInjector,
    current_fault_injector,
    install_fault_injector,
)

ENGINE = dict(slots=2, max_len=64, chunk_size=8, kv_layout="paged",
              page_size=4, pool_blocks=24)


def _prompts(n=4, seed=1):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 200, size=12))) for _ in range(n)]


def _run(m, injector_kw=None, jax_side=False, **kw):
    inj = ts.install(injector_kw, jax_side)
    try:
        eng = ts.engine(m, jax_side, **ENGINE, **kw)
        reqs = [eng.submit(p, 8) for p in _prompts()]
        eng.run(max_steps=500)
    finally:
        ts.uninstall()
    # leak-free accounting after every chaos run: refcounts rebuilt from
    # the tables, residency tiers disjoint and exhaustive, index <-> key
    # bijection, no index entry naming a free block
    eng.pool.check_consistency()
    assert eng.pool.used_blocks == 0, "drained engine still pins blocks"
    return eng, reqs, inj


@pytest.fixture(autouse=True)
def _no_leftover_injector():
    yield
    ts.uninstall()


@pytest.fixture(scope="module")
def m():
    return ts.models()


@pytest.fixture(scope="module")
def reference(m):
    """``repro``'s engine under a schedule of this file, each run once."""
    cache = {}

    def run(key, injector_kw=None, **kw):
        if key not in cache:
            eng, reqs, inj = _run(m, injector_kw, jax_side=True, **kw)
            cache[key] = ts.outcome(eng, reqs, inj)
        return cache[key]
    return run


@pytest.fixture(scope="module")
def baseline(m, reference):
    eng, reqs, _ = _run(m)
    assert ts.outcome(eng, reqs) == reference("baseline")
    return {r.rid: list(r.out) for r in reqs}


def _same_as_reference(reference, key, injector_kw, eng, reqs, inj, **kw):
    got = ts.outcome(eng, reqs, inj)
    ref = reference(key, injector_kw, **kw)
    for field in ref:
        assert got[field] == ref[field], f"{key}: {field} differs from repro"


# -- delay-only faults: every stream bit-identical ---------------------------

@pytest.mark.parametrize("point", ["pool_alloc", "admission", "preempt"])
def test_delay_faults_leave_all_streams_bit_identical(point, m, baseline,
                                                      reference):
    kw = dict(at={point: [1, 3, 5]})
    eng, reqs, inj = _run(m, kw)
    assert inj.fired(point) == 3
    for r in reqs:
        assert r.finish_reason == "length"
        assert list(r.out) == baseline[r.rid], (
            f"{point} chaos changed request {r.rid}'s temp-0 stream")
    assert eng.metrics_snapshot()["quarantined"] == 0
    _same_as_reference(reference, point, kw, eng, reqs, inj)


# -- corruption faults: exactly the victim quarantined -----------------------

@pytest.mark.parametrize("point", ["logits", "kv_corrupt"])
def test_corruption_faults_quarantine_only_the_victim(point, m, baseline,
                                                      reference):
    kw = dict(at={point: [4]}, rids={point: {2}})
    eng, reqs, inj = _run(m, kw)
    assert inj.fired(point) == 1
    victim = next(r for r in reqs if r.rid == 2)
    assert victim.finish_reason == "failed"
    for r in reqs:
        if r.rid == 2:
            continue
        assert r.finish_reason == "length"
        assert list(r.out) == baseline[r.rid], (
            f"{point} chaos leaked into co-resident request {r.rid}")
    snap = eng.metrics_snapshot()
    assert snap["quarantined"] == 1
    assert snap["finish_reasons"]["failed"] == 1
    _same_as_reference(reference, point, kw, eng, reqs, inj)


def _quarantine_then_retry(m, jax_side):
    ts.install(dict(at={"kv_corrupt": [4]}, rids={"kv_corrupt": {2}}),
               jax_side)
    eng = ts.engine(m, jax_side, **ENGINE)
    reqs = [eng.submit(p, 8) for p in _prompts()]
    eng.run(max_steps=500)
    ts.uninstall()
    victim = next(r for r in reqs if r.rid == 2)
    eng.pool.check_consistency()
    dump = eng.pool.dump_state()
    retry = eng.submit(list(victim.prompt), 8)
    eng.run(max_steps=500)
    eng.pool.check_consistency()
    return victim, retry, dump, eng


def test_quarantined_pages_never_splice_reused(m, baseline):
    """After a kv_corrupt quarantine, resubmitting the victim's prompt
    misses the prefix cache for the de-indexed pages and produces the
    fault-free stream; the scrubbed, freed pool is ``repro``'s."""
    victim, retry, dump, eng = _quarantine_then_retry(m, False)
    assert victim.finish_reason == "failed"
    assert retry.finish_reason == "length"
    assert list(retry.out) == baseline[2], "retry after quarantine diverged"
    # the quarantined pages were zeroed before they rejoined the free list:
    # no NaN is left in any pool
    for cache in eng.state["caches"]:
        for leaf in cache.values():
            assert bool(torch.isfinite(leaf.float()).all())
    jvictim, jretry, jdump, _ = _quarantine_then_retry(m, True)
    assert dump == jdump
    assert (list(jvictim.out), list(jretry.out), jretry.prefix_hit) == (
        list(victim.out), list(retry.out), retry.prefix_hit)


# -- bounded storm across every point ----------------------------------------

def test_bounded_multi_point_storm_terminates_cleanly(m, reference):
    kw = dict(seed=7, rates={p: 0.1 for p in ChaosInjector.POINTS},
              limit={p: 2 for p in ChaosInjector.POINTS})
    eng, reqs, inj = _run(m, kw, max_preemptions=4)
    assert all(r.done for r in reqs)
    assert all(r.finish_reason is not None for r in reqs)
    total = sum(inj.fired(p) for p in ChaosInjector.POINTS)
    assert total <= 2 * len(ChaosInjector.POINTS)
    # the seeded draws land on the same opportunities in both engines
    _same_as_reference(reference, "storm", kw, eng, reqs, inj,
                       max_preemptions=4)


# -- injector unit semantics -------------------------------------------------

def test_injector_is_deterministic_per_seed():
    def drive(seed):
        inj = ChaosInjector(seed=seed, rates={"preempt": 0.5})
        return [inj.fire("preempt", slot=0) for _ in range(50)]

    assert drive(3) == drive(3)
    assert drive(3) != drive(4)


def test_injector_draws_equal_the_references():
    """One schedule of rates fires at the same opportunities in both
    packages' injectors (both draw from ``numpy.random.default_rng``)."""
    from repro.serve.faults import ChaosInjector as JaxChaosInjector
    kw = dict(seed=5, rates={"preempt": 0.3, "logits": 0.2},
              at={"admission": [2, 3]}, rids={"logits": {1, 4}},
              limit={"preempt": 6})
    a, b = ChaosInjector(**kw), JaxChaosInjector(**kw)
    calls = [(p, r) for r in range(6) for p in ChaosInjector.POINTS] * 4
    assert ([a.fire(p, rid=r) for p, r in calls]
            == [b.fire(p, rid=r) for p, r in calls])
    assert a.injected == b.injected


def test_injector_limit_caps_fires():
    inj = ChaosInjector(rates={"logits": 1.0}, limit={"logits": 2})
    fires = [inj.fire("logits", slot=0) for _ in range(10)]
    assert sum(fires) == 2 and fires[:2] == [True, True]
    assert inj.opportunities("logits") == 10


def test_injector_rid_filter_gates_opportunity_counting():
    inj = ChaosInjector(at={"logits": [0]}, rids={"logits": {3}})
    # rid-filtered calls are skipped and NOT counted as opportunities
    assert inj.fire("logits", rid=1) is False
    assert inj.fire("logits", rid=2) is False
    assert inj.opportunities("logits") == 0
    # "the first time rid 3 is eligible"
    assert inj.fire("logits", rid=3) is True
    assert inj.fire("logits", rid=3) is False


def test_injector_rejects_unknown_points():
    with pytest.raises(ValueError, match="unknown fault point"):
        ChaosInjector(rates={"gamma_rays": 1.0})
    inj = ChaosInjector()
    with pytest.raises(ValueError, match="unknown fault point"):
        inj.fire("gamma_rays")


def test_from_spec_parses_cli_strings():
    inj = ChaosInjector.from_spec("preempt=0.05, logits=0.01", limit_each=3)
    assert inj.rates == {"preempt": 0.05, "logits": 0.01}
    assert inj.limit == {"preempt": 3, "logits": 3}
    with pytest.raises(ValueError, match="point=rate"):
        ChaosInjector.from_spec("preempt")


def test_install_is_last_wins_and_none_uninstalls():
    a, b = ChaosInjector(), ChaosInjector()
    install_fault_injector(a)
    install_fault_injector(b)
    assert current_fault_injector() is b
    install_fault_injector(None)
    assert current_fault_injector() is None

"""The port's fault-tolerant serving (DESIGN.md §13) against the assertions
of ``tests/test_fault_serving.py``, and against ``repro``'s engine: loud
argument validation, deadlines, cancellation at every lifecycle stage,
NaN quarantine modes, preemption limits and the deadline watchdog.

Each engine run (smoke qwen2-0.5b, float32, ExpMul, ``device="cpu"``, the
reference's sizes) is also run by ``repro``'s engine (``attention_impl=
"pallas"``, the same converted weights) under the same schedule, and the
two must leave the same outcome: every request's finish reason and temp-0
tokens, the terminal-state and quarantine counts, and the block pool's
``dump_state()``.

``test_train_fault_names_are_reexported_shims`` is not re-asserted: it
tests ``repro.distributed.fault``, a module of shims the port does not
carry (its trainer imports ``repro_torch.reliability`` directly); its last
assertion, that the engine's watchdog is the reliability module's class,
is ``test_engine_watchdog_is_the_reliability_class``.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_serving as ts  # noqa: E402
from repro.serve.engine import (  # noqa: E402
    NonFiniteLogitsError as JaxNonFiniteLogitsError,
)
from repro_torch.reliability import DeadlineWatchdog  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    FINISH_REASONS,
    NonFiniteLogitsError,
    ServeEngine,
)


def _prompts(n, length=12, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 200, size=length)))
            for _ in range(n)]


@pytest.fixture(autouse=True)
def _no_leftover_injector():
    yield
    ts.uninstall()


_MODELS = {}


@pytest.fixture(scope="module")
def m():
    return _models("expmul")


def _models(variant):
    if variant not in _MODELS:
        _MODELS[variant] = ts.models(variant)
    return _MODELS[variant]


@pytest.fixture(scope="module")
def reference():
    """``repro``'s engine through a scenario of this file, each run once.
    A scenario is a function (engine factory, jax_side) -> (engine,
    requests, injector)."""
    cache = {}

    def run(scenario, m):
        key = (scenario, id(m))
        if key not in cache:
            try:
                cache[key] = ts.outcome(
                    *scenario(lambda **kw: ts.engine(m, True, **kw), True))
            finally:
                ts.uninstall()
        return cache[key]
    return run


def _check(reference, m, scenario):
    """Run ``scenario`` on the port's engine; its outcome must be
    ``repro``'s. Returns (engine, requests, injector)."""
    try:
        eng, reqs, inj = scenario(lambda **kw: ts.engine(m, False, **kw),
                                  False)
    finally:
        ts.uninstall()
    got, ref = ts.outcome(eng, reqs, inj), reference(scenario, m)
    for field in ref:
        assert got[field] == ref[field], f"{field} differs from repro"
    return eng, reqs, inj


def _paged(make, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("chunk_size", 8)
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("page_size", 4)
    return make(**kw)


# -- loud validation ---------------------------------------------------------

def test_submit_validation_raises_value_error(m):
    eng = ts.engine(m, slots=2, max_len=32)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([], 4)
    with pytest.raises(ValueError, match="max_len - 1"):
        eng.submit(list(range(1, 33)), 4)
    with pytest.raises(ValueError, match="max_new"):
        eng.submit([1, 2, 3], 0)
    with pytest.raises(ValueError, match="deadline_steps"):
        eng.submit([1, 2, 3], 4, deadline_steps=0)
    with pytest.raises(ValueError, match="deadline_s"):
        eng.submit([1, 2, 3], 4, deadline_s=-1.0)


def test_duplicate_rid_rejected_and_auto_rids_never_collide(m):
    eng = ts.engine(m, slots=2, max_len=32)
    eng.submit([1, 2], 1, rid=7)
    with pytest.raises(ValueError, match="duplicate rid 7"):
        eng.submit([3, 4], 1, rid=7)
    # auto-assignment skips past every explicit rid ever seen
    auto = eng.submit([5, 6], 1)
    assert auto.rid == 8
    eng.run()
    # rids stay burned after the requests finish
    with pytest.raises(ValueError, match="duplicate rid 8"):
        eng.submit([1, 2], 1, rid=8)


def test_engine_constructor_validation(m):
    for kwargs, match in [
        (dict(kv_layout="sparse"), "kv_layout"),
        (dict(nan_guard="maybe"), "nan_guard"),
        (dict(slots=0), "slots"),
        (dict(max_len=1), "max_len"),
        (dict(chunk_size=0), "chunk_size"),
        (dict(max_preemptions=-1), "max_preemptions"),
    ]:
        with pytest.raises(ValueError, match=match):
            ServeEngine(m.params, m.cfg, device="cpu", **kwargs)


# -- finish reasons ----------------------------------------------------------

def _three_to_length(make, jax_side):
    eng = make(slots=2, max_len=64, chunk_size=8, kv_layout="paged",
               page_size=4)
    reqs = [eng.submit(p, 6) for p in _prompts(3)]
    eng.run()
    return eng, reqs, None


def test_every_request_gets_a_finish_reason(m, reference):
    eng, reqs, _ = _check(reference, m, _three_to_length)
    assert all(r.finish_reason == "length" for r in reqs)
    snap = eng.metrics_snapshot()
    assert set(snap["finish_reasons"]) == set(FINISH_REASONS)
    assert snap["finish_reasons"]["length"] == 3
    assert snap["quarantined"] == 0


# -- deadlines ---------------------------------------------------------------

def _slow_and_fast(make, jax_side):
    eng = make(slots=1, max_len=64, chunk_size=8, kv_layout="paged",
               page_size=4)
    slow = eng.submit(_prompts(1)[0], 40, deadline_steps=4)
    fast = eng.submit(_prompts(1, seed=1)[0], 3)
    eng.run()
    return eng, [slow, fast], None


def test_deadline_steps_expires_with_partial_output(m, reference):
    eng, (slow, fast), _ = _check(reference, m, _slow_and_fast)
    assert slow.finish_reason == "deadline"
    assert 0 < len(slow.out) < 40  # kept what it produced in budget
    assert fast.finish_reason == "length" and len(fast.out) == 3
    # no leak: everything freed once the run drains
    eng.pool.check_consistency()
    assert eng.pool.used_blocks == 0
    assert len(eng.deadlines) == 0


def _queued_expires(make, jax_side):
    eng = make(slots=1, max_len=64, chunk_size=8)
    running = eng.submit(_prompts(1)[0], 8)
    # the queued request's wall budget starts at submit, so it can expire
    # without ever being admitted
    queued = eng.submit(_prompts(1, seed=2)[0], 8, deadline_s=1e-4)
    time.sleep(0.01)
    eng.run()
    return eng, [running, queued], None


def test_wall_clock_deadline_expires_queued_request(m, reference):
    _, (running, queued), _ = _check(reference, m, _queued_expires)
    assert running.finish_reason == "length"
    assert queued.finish_reason == "deadline"
    assert queued.out == [] and queued.admit_step is None


def _default_deadline(make, jax_side):
    eng = make(slots=2, max_len=64, chunk_size=8, deadline_steps=3)
    reqs = [eng.submit(p, 50) for p in _prompts(2)]
    eng.run()
    return eng, reqs, None


def test_engine_default_deadline_applies_to_all_submits(m, reference):
    _, reqs, _ = _check(reference, m, _default_deadline)
    assert all(r.finish_reason == "deadline" for r in reqs)


# -- cancellation ------------------------------------------------------------

def _cancel_queued(make, jax_side):
    eng = _paged(make, slots=1)
    a = eng.submit(_prompts(1)[0], 4)
    b = eng.submit(_prompts(1, seed=1)[0], 4)
    assert eng.cancel(b.rid) is True      # still queued: plain dequeue
    assert b.finish_reason == "cancelled" and b.done
    assert eng.cancel(12345) is False     # unknown rid
    eng.run()
    assert eng.cancel(a.rid) is False     # already finished
    return eng, [a, b], None


def test_cancel_queued_and_unknown(m, reference):
    _, (a, b), _ = _check(reference, m, _cancel_queued)
    assert a.finish_reason == "length"
    assert b.finish_reason == "cancelled"


def _cancel_scenario(stage):
    def scenario(make, jax_side):
        eng = _paged(make, pool_blocks=24)
        reqs = [eng.submit(p, 8) for p in _prompts(3, length=14)]
        victim = reqs[0]
        # tick until the victim is in the requested lifecycle stage
        for _ in range(200):
            in_slot = any(r is victim for r in eng.requests)
            if stage == "mid_prefill":
                if in_slot and 0 < victim.pos < len(victim.prefill_toks):
                    break
            elif in_slot and len(victim.out) >= 2:
                break
            eng.tick()
        else:
            pytest.fail(f"never reached {stage}")
        assert eng.cancel(victim.rid) is True
        eng.run()
        return eng, reqs, None
    return scenario


_CANCEL = {stage: _cancel_scenario(stage)
           for stage in ("mid_prefill", "mid_decode")}


def _cancel_baseline(make, jax_side):
    eng = _paged(make, pool_blocks=24)
    reqs = [eng.submit(p, 8) for p in _prompts(3, length=14)]
    eng.run()
    return eng, reqs, None


@pytest.mark.parametrize("variant", ["expmul", "exact"])
@pytest.mark.parametrize("stage", ["mid_prefill", "mid_decode"])
def test_cancel_active_slot_survivors_bit_identical(stage, variant,
                                                    reference):
    """Cancelling an in-slot request mid-prefill or mid-decode does not
    perturb co-resident temp-0 streams, and leaks no pool block or radix
    key, under prefix caching and a tight pool.

    Under ExpMul, the mid-prefill cancel changes which ticks are prefill
    ticks, so a survivor's token is computed by a decode tick where the
    baseline rode it along a prefill tick as a 1-valid chunk: the two
    paged tile walks split the scores differently, ExpMul rounds each
    tile's weights, and one survivor's stream moves. ``repro``'s engine
    at ``attention_impl="pallas"`` moves it alike (its outcome is held
    equal here); its own test runs at ``flash_jnp``, whose one tile covers
    these sequences whole. So that case holds the survivors to the
    baseline under the exact variant, and to ``repro`` under ExpMul."""
    m = _models(variant)
    _, base_reqs, _ = _check(reference, m, _cancel_baseline)
    baseline = {r.rid: list(r.out) for r in base_reqs}
    eng, reqs, _ = _check(reference, m, _CANCEL[stage])
    victim = reqs[0]
    assert victim.finish_reason == "cancelled"
    eng.pool.check_consistency()
    assert eng.pool.used_blocks == 0
    if (stage, variant) != ("mid_prefill", "expmul"):
        for r in reqs[1:]:
            assert list(r.out) == baseline[r.rid], "survivor stream changed"
    if stage == "mid_decode":
        # the cancelled stream matches the baseline prefix: valid work kept
        assert baseline[victim.rid][:len(victim.out)] == list(victim.out)


def _cancel_preempted(make, jax_side):
    ts.install(dict(at={"preempt": [0]}), jax_side)
    eng = _paged(make, pool_blocks=24)
    reqs = [eng.submit(p, 8) for p in _prompts(3, length=14)]
    victim = None
    for _ in range(200):
        eng.tick()
        preempted = [r for r in eng.queue if r.preemptions > 0]
        if preempted:
            victim = preempted[0]
            break
    assert victim is not None, "forced preemption never landed"
    ts.uninstall()
    assert eng.cancel(victim.rid) is True
    eng.run()
    return eng, reqs, None


def test_cancel_while_preempted(m, reference):
    """Cancel a request sitting requeued after an eviction: it leaves the
    queue, stays terminal, and never comes back when capacity frees."""
    eng, reqs, _ = _check(reference, m, _cancel_preempted)
    victim = next(r for r in reqs if r.preemptions > 0)
    assert victim.finish_reason == "cancelled"
    assert victim not in eng.queue and all(r is not victim
                                           for r in eng.requests)
    for r in reqs:
        if r is not victim:
            assert r.finish_reason == "length"
    eng.pool.check_consistency()
    assert eng.pool.used_blocks == 0


# -- preemption limit --------------------------------------------------------

def _preempt_limit(make, jax_side):
    inj = ts.install(dict(at={"preempt": [0, 1]}), jax_side)
    eng = _paged(make, max_preemptions=0)
    reqs = [eng.submit(p, 6) for p in _prompts(2)]
    eng.run(max_steps=300)
    return eng, reqs, inj


def test_preempt_limit_finishes_instead_of_thrashing(m, reference):
    eng, reqs, _ = _check(reference, m, _preempt_limit)
    reasons = sorted(r.finish_reason for r in reqs)
    assert "preempt_limit" in reasons
    assert all(r.done for r in reqs)
    eng.pool.check_consistency()
    assert eng.pool.used_blocks == 0


# -- NaN guard modes ---------------------------------------------------------

def _strict_raises(m, jax_side, error):
    ts.install(dict(at={"logits": [2]}), jax_side)
    eng = ts.engine(m, jax_side, slots=2, max_len=64, chunk_size=8,
                    kv_layout="paged", page_size=4, nan_guard="strict")
    for p in _prompts(2):
        eng.submit(p, 6)
    with pytest.raises(error, match="non-finite logits") as e:
        eng.run(max_steps=300)
    return str(e.value)


def test_strict_mode_raises_on_injected_nan(m):
    msg = _strict_raises(m, False, NonFiniteLogitsError)
    # the same request, slot and engine step as repro's
    assert msg == _strict_raises(m, True, JaxNonFiniteLogitsError)


def _guard_off(make, jax_side):
    inj = ts.install(dict(at={"logits": [2]}), jax_side)
    eng = _paged(make, nan_guard="off")
    reqs = [eng.submit(p, 6) for p in _prompts(2)]
    eng.run(max_steps=300)
    return eng, reqs, inj


def test_nan_guard_off_skips_the_sentinel(m, reference):
    eng, reqs, inj = _check(reference, m, _guard_off)
    assert inj.fired("logits") == 1
    # no quarantine happened; the faulted stream just carried garbage
    assert eng.metrics_snapshot()["quarantined"] == 0
    assert all(r.finish_reason == "length" for r in reqs)


# -- the deadline watchdog ---------------------------------------------------

def test_deadline_watchdog_step_and_wall_budgets():
    dw = DeadlineWatchdog()
    dw.arm("a", step_budget=5, step_base=10)
    dw.arm("b", wall_budget=1.0, wall_base=100.0)
    assert dw.expired(14, 100.5) == []
    assert dw.expired(15, 100.5) == ["a"]          # step budget exhausted
    assert sorted(dw.expired(15, 101.5)) == ["a", "b"]
    dw.disarm("a")
    assert dw.expired(99, 100.0) == []
    assert dw.budgets("b") == (None, 1.0)
    assert dw.budgets("missing") == (None, None)


def test_deadline_watchdog_arm_merges_budgets():
    dw = DeadlineWatchdog()
    dw.arm("r", wall_budget=2.0, wall_base=50.0)   # at submit
    dw.arm("r", step_budget=3, step_base=7)        # at first admission
    assert dw.budgets("r") == (3, 2.0)
    assert dw.expired(10, 51.0) == ["r"]


def test_engine_watchdog_is_the_reliability_class(m):
    eng = ts.engine(m, slots=1, max_len=16)
    assert isinstance(eng.deadlines, DeadlineWatchdog)

"""The port's crash-consistent snapshot and restore (DESIGN.md §13) against
the assertions of ``tests/test_snapshot.py``, and against ``repro``'s
engine: mid-flight temp-0 (and temp>0) streams continue exactly in a
restored engine, the cached prefix tier survives the restart, and a
snapshot of another architecture is refused loudly.

The engines run the smoke qwen2-0.5b in float32 (ExpMul,
``device="cpu"``, the reference's sizes). The restored temp-0 streams are
also held equal to ``repro``'s engine's (``attention_impl="pallas"``, the
same converted weights) on the same requests, the saved pool dump to
``repro``'s at the same step, and the snapshot's device leaves round-trip
bit for bit, bfloat16 ones included. A snapshot of this engine is not
read by ``repro`` nor the other way round (``serve/snapshot.py``), so no
test crosses them.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_serving as ts  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.snapshot import (  # noqa: E402
    restore_engine,
    save_snapshot,
)


def _prompts(n=3, seed=0, length=12):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 200, size=length)))
            for _ in range(n)]


def _live_requests(eng):
    return [r for r in eng.requests if r is not None] + list(eng.queue)


PAGED = dict(kv_layout="paged", page_size=4, pool_blocks=32)


@pytest.fixture(scope="module")
def m():
    return ts.models()


def _engine(m, jax_side=False, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("chunk_size", 8)
    return ts.engine(m, jax_side, **kw)


def _restore(m, path, **kw):
    return restore_engine(path, m.params, m.cfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def reference(m):
    """``repro``'s engine on each layout of this file, run once: its
    streams over ``_prompts()`` and its pool dump after 3 ticks."""
    out = {}
    for name, kw in (("paged", PAGED), ("contiguous", {})):
        eng = _engine(m, True, **kw)
        reqs = [eng.submit(p, 8) for p in _prompts()]
        for _ in range(3):
            eng.tick()
        dump = eng.pool.dump_state() if eng.paged else None
        eng.run()
        out[name] = ({r.rid: list(r.out) for r in reqs}, dump)
    return out


@pytest.mark.parametrize("layout_kw", [PAGED, {}],
                         ids=["paged", "contiguous"])
def test_midflight_restore_is_bit_identical(tmp_path, layout_kw, m,
                                            reference):
    prompts = _prompts()
    ref_streams, ref_dump = reference["paged" if layout_kw else "contiguous"]

    oracle_eng = _engine(m, **layout_kw)
    oracle = [oracle_eng.submit(p, 8) for p in prompts]
    oracle_eng.run()
    expect = {r.rid: list(r.out) for r in oracle}
    assert expect == ref_streams, "the port's streams differ from repro's"

    eng = _engine(m, **layout_kw)
    reqs = [eng.submit(p, 8) for p in prompts]
    for _ in range(3):
        eng.tick()
    assert any(r.out for r in reqs), "snapshot point should be mid-flight"
    if eng.paged:
        assert eng.pool.dump_state() == ref_dump
    path = str(tmp_path / "engine.npz")
    meta = eng.save_snapshot(path)
    assert meta["n_leaves"] > 0 and os.path.exists(path)
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f], (
        "atomic write must not leave tmp files")

    restored = _restore(m, path)
    carried = _live_requests(restored)
    assert len(carried) == len([r for r in reqs if not r.done])
    restored.run()
    assert restored.ticks == eng.ticks + (oracle_eng.ticks - eng.ticks), (
        "restored engine-step clock must continue, not restart")
    for r in carried:
        assert r.finish_reason == "length"
        assert list(r.out) == expect[r.rid], (
            f"request {r.rid} diverged across snapshot/restore")
    if restored.paged:
        restored.pool.check_consistency()
        assert restored.pool.used_blocks == 0


def test_restore_continues_temperature_sampling_streams(tmp_path, m):
    """temp>0: a row's sampling seed is (seed, admit_order, len(out)) —
    all serialized — so stochastic streams also continue exactly (the
    port's draws are not ``repro``'s, so these are held to the port's own
    uninterrupted run)."""
    prompts = _prompts(2)

    oracle_eng = _engine(m, temperature=0.8, **PAGED)
    oracle = [oracle_eng.submit(p, 8) for p in prompts]
    oracle_eng.run()
    expect = {r.rid: list(r.out) for r in oracle}

    eng = _engine(m, temperature=0.8, **PAGED)
    reqs = [eng.submit(p, 8) for p in prompts]
    for _ in range(4):
        eng.tick()
    path = str(tmp_path / "warm.npz")
    save_snapshot(eng, path)
    restored = _restore(m, path)
    carried = _live_requests(restored)
    restored.run()
    for r in carried:
        assert list(r.out) == expect[r.rid]
    assert all(expect[r.rid][:len(r.out)] == list(r.out) for r in reqs)


def test_prefix_tier_survives_restart(tmp_path, m):
    """The headline restart guarantee: pages cached by a finished request
    splice for the same prompt in the *restored* engine — warm prefill
    skips survive the crash."""
    prompt = _prompts(1, length=24)[0]

    eng = _engine(m, **PAGED)
    cold = eng.submit(prompt, 8)
    eng.run()
    assert cold.prefix_hit == 0
    cold_prefill_steps = eng.prefill_steps
    assert eng.pool.cached_block_count > 0, "no pages were cached"
    path = str(tmp_path / "tier.npz")
    eng.save_snapshot(path)

    restored = _restore(m, path)
    assert restored.pool.cached_block_count == eng.pool.cached_block_count
    assert restored.pool.dump_state() == eng.pool.dump_state()
    warm = restored.submit(prompt, 8)
    restored.run()
    assert warm.prefix_hit > 0, "restored radix index produced no splice"
    assert list(warm.out) == list(cold.out), "warm stream diverged"
    warm_prefill_steps = restored.prefill_steps - cold_prefill_steps
    assert warm_prefill_steps < cold_prefill_steps, (
        "warm prefill should need fewer chunked steps than cold")
    restored.pool.check_consistency()
    # the cold stream is repro's
    jeng = _engine(m, True, **PAGED)
    jcold = jeng.submit(prompt, 8)
    jeng.run()
    assert list(jcold.out) == list(cold.out)


def test_metrics_and_rid_allocator_continuity(tmp_path, m):
    eng = _engine(m, **PAGED)
    r0 = eng.submit(_prompts(1)[0], 4, rid=11)
    eng.run()
    path = str(tmp_path / "m.npz")
    eng.save_snapshot(path)

    restored = _restore(m, path)
    snap = restored.metrics_snapshot()
    assert restored.ticks == eng.ticks
    assert snap["finish_reasons"]["length"] == 1
    assert restored.tokens_generated == eng.tokens_generated
    assert restored.metrics.dump_values() == eng.metrics.dump_values()
    # rid uniqueness survives the restart
    with pytest.raises(ValueError, match="duplicate rid 11"):
        restored.submit([1, 2, 3], 2, rid=11)
    nxt = restored.submit([1, 2, 3], 2)
    assert nxt.rid == 12
    assert r0.rid == 11  # original handle untouched


def test_restore_rejects_architecture_mismatch(tmp_path, m):
    eng = _engine(m, **PAGED)
    eng.submit(_prompts(1)[0], 4)
    eng.run()
    path = str(tmp_path / "arch.npz")
    eng.save_snapshot(path)

    # the port carries one architecture: another config name, and the same
    # name over other state shapes, are both refused
    with pytest.raises(ValueError, match="was taken from config"):
        restore_engine(path, m.params, m.cfg.replace(name="qwen1.5-0.5b"),
                       device="cpu")
    with pytest.raises(ValueError, match="config/checkpoint mismatch"):
        restore_engine(path, m.params,
                       m.cfg.replace(num_kv_heads=m.cfg.num_heads),
                       device="cpu")


def test_restored_deadlines_still_enforced(tmp_path, m):
    eng = _engine(m, slots=1, **PAGED)
    slow = eng.submit(_prompts(1)[0], 50, deadline_steps=6)
    for _ in range(2):
        eng.tick()
    path = str(tmp_path / "dl.npz")
    eng.save_snapshot(path)

    restored = _restore(m, path)
    carried = _live_requests(restored)[0]
    assert carried.rid == slow.rid
    restored.run()
    assert carried.finish_reason == "deadline"
    assert len(carried.out) < 50
    restored.pool.check_consistency()
    # the expiry lands on the engine step an uninterrupted run's does
    eng.run()
    assert (eng.ticks, list(slow.out)) == (restored.ticks,
                                           list(carried.out))


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_snapshot_leaves_round_trip_bit_for_bit(tmp_path, kv_dtype):
    """Device leaves go out as raw bytes, so a bfloat16 pool (and int8
    codes with float32 scale rows) come back bit for bit, copied into the
    restored engine's own tensors."""
    params, cfg = ts.torch_models()
    cfg = cfg.replace(dtype="bfloat16")
    eng = ServeEngine(params, cfg, slots=2, max_len=32, chunk_size=8,
                      kv_layout="paged", page_size=4, kv_dtype=kv_dtype,
                      device="cpu")
    gen = torch.Generator().manual_seed(3)
    for cache in eng.state["caches"]:
        for leaf in cache.values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen) * 50)
    path = str(tmp_path / "bf16.npz")
    meta = eng.save_snapshot(path)
    assert "bfloat16" in {d["dtype"] for d in meta["leaves"]} or (
        kv_dtype == "int8")
    restored = restore_engine(path, params, cfg, device="cpu")
    for a, b in zip(eng.state["caches"], restored.state["caches"]):
        for name in a:
            assert b[name].dtype == a[name].dtype
            assert torch.equal(b[name].view(torch.uint8),
                               a[name].view(torch.uint8)), name

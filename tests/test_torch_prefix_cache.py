"""The port's shared-prefix KV cache (DESIGN.md §11) against the assertions
of ``tests/test_prefix_cache.py``, and against ``repro``'s engine.

* The host-side ``BlockPool``: the chain-keyed index, refcounts (the
  double-free regression), the used/cached/free residency split,
  cached-LRU reclaim before any allocation fails, the de-index cascade and
  copy-on-write bookkeeping.
* The engine on its plain versions (CPU, smoke config, float32): warm
  temp-0 streams equal cold ones over ``PREFIX_CACHE_CELLS``, copy-on-write
  on a tail divergence with a live donor, preemption never frees a shared
  block, a full-prompt resubmission, scheduling-invariant temp > 0
  sampling, the rejections and the auto default.
* Parity with ``repro``: one shared-prefix workload on a pool tight enough
  to reclaim cached blocks, copy on write and preempt, through both
  engines tick by tick ({exact, expmul} x {fp32, int8}, ``repro`` at
  ``attention_impl="pallas"``): equal streams, block tables and refcounts
  after every tick, index keys and prefix counters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from cells import PREFIX_CACHE_CELLS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.api import init_model as jax_init_model  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.api import init_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.paged import BlockPool  # noqa: E402


def _setup(variant="exact"):
    cfg = get_config("qwen2-0.5b", smoke=True, dtype="float32",
                     param_dtype="float32", attention_variant=variant)
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    return params, cfg


def _engine(params, cfg, **kw):
    return ServeEngine(params, cfg, device="cpu", **kw)


def _prompts(shared_len=40, tail=7, n=4, seed=0, vocab=200):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, shared_len).tolist()
    return [shared + rng.integers(1, vocab, tail).tolist() for _ in range(n)]


# ---------------------------------------------------------------------------
# host-side pool: index, refcounts, residency tiers
# ---------------------------------------------------------------------------
def _pool(**kw):
    kw.setdefault("pool_blocks", 8)
    kw.setdefault("page_size", 4)
    kw.setdefault("slots", 3)
    kw.setdefault("max_blocks_per_seq", 6)
    kw.setdefault("prefix_cache", True)
    return BlockPool(**kw)


def test_register_match_and_splice():
    pool = _pool()
    assert pool.alloc(0, 8)
    b0, b1 = int(pool.tables[0, 0]), int(pool.tables[0, 1])
    pool.register_block(b0, -1, [1, 2, 3, 4])
    pool.register_block(b1, b0, [5, 6, 7, 8])
    assert pool.match_prefix([1, 2, 3, 4, 5, 6, 7, 8, 9]) == [b0, b1]
    assert pool.match_prefix([1, 2, 3, 4, 9, 9, 9, 9]) == [b0]
    assert pool.match_prefix([9, 2, 3, 4]) == []
    free_before = pool.free_block_count
    pool.splice(1, [b0, b1])
    assert pool.free_block_count == free_before
    assert int(pool.refcount[b0]) == 2 and int(pool.refcount[b1]) == 2
    assert pool.stats.hit_blocks == 2


def test_refcounted_free_is_not_double_free():
    pool = _pool(prefix_cache=False)
    assert pool.alloc(0, 8)
    blocks = [int(b) for b in pool.tables[0, :2]]
    pool.splice(1, blocks)
    assert pool.free_slot(0) == 2
    assert all(b not in pool.free_blocks for b in blocks)
    assert pool.used_blocks == 2
    assert pool.free_slot(1) == 2
    assert pool.used_blocks == 0
    assert sorted(pool.free_blocks) == list(range(pool.pool_blocks))
    assert len(set(pool.free_blocks)) == pool.pool_blocks


def test_cached_tier_and_residency_split():
    pool = _pool()
    assert pool.alloc(0, 8)
    b0, b1 = int(pool.tables[0, 0]), int(pool.tables[0, 1])
    pool.register_block(b0, -1, [1, 2, 3, 4])
    pool.register_block(b1, b0, [5, 6, 7, 8])
    pool.free_slot(0)
    assert pool.used_blocks == 0 and pool.cached_block_count == 2
    assert pool.free_block_count == pool.pool_blocks - 2
    assert pool.stats.used_blocks == 0 and pool.stats.cached_blocks == 2
    assert pool.stats.free_blocks == pool.pool_blocks - 2
    # the cached tier counts as capacity: reclaimable without preemption
    assert pool.can_fit(2, 4 * pool.pool_blocks)
    assert not pool.can_fit(2, 4 * pool.pool_blocks + 1)
    hit = pool.match_prefix([1, 2, 3, 4, 5, 6, 7, 8])
    pool.splice(1, hit)
    assert pool.used_blocks == 2 and pool.cached_block_count == 0


def test_cached_lru_evicted_before_any_allocation_fails():
    pool = _pool(pool_blocks=4, page_size=4)
    assert pool.alloc(0, 8)
    b0, b1 = int(pool.tables[0, 0]), int(pool.tables[0, 1])
    pool.register_block(b0, -1, [1, 2, 3, 4])
    pool.register_block(b1, b0, [5, 6, 7, 8])
    pool.free_slot(0)
    assert pool.cached_block_count == 2
    assert pool.alloc(1, 16)
    assert pool.cached_block_count == 0
    assert pool.stats.cached_evictions >= 1
    assert pool.match_prefix([1, 2, 3, 4]) == []


def test_deindex_cascades_to_descendants():
    pool = _pool(pool_blocks=4, page_size=4)
    assert pool.alloc(0, 16)
    ids = [int(b) for b in pool.tables[0, :4]]
    toks = list(range(1, 17))
    parent = -1
    for i, b in enumerate(ids):
        pool.register_block(b, parent, toks[i * 4:(i + 1) * 4])
        parent = b
    pool.free_slot(0)
    assert pool.alloc(1, 4)
    hit = pool.match_prefix(toks)
    assert len(hit) <= 3
    assert hit == ids[:len(hit)]
    pool.check_consistency()


def test_cow_block_keeps_original_for_other_holders():
    pool = _pool()
    assert pool.alloc(0, 4)
    b0 = int(pool.tables[0, 0])
    pool.register_block(b0, -1, [1, 2, 3, 4])
    pool.splice(1, [b0])
    assert pool.is_shared(b0)
    src, dst = pool.cow_block(1, 0)
    assert src == b0 and dst != b0
    assert int(pool.tables[1, 0]) == dst and int(pool.tables[0, 0]) == b0
    assert int(pool.refcount[b0]) == 1 and int(pool.refcount[dst]) == 1
    assert pool.stats.cow_copies == 1
    assert pool.match_prefix([1, 2, 3, 4]) == [b0]


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_copy_paged_block_copies_one_page_in_every_leaf(kv_dtype):
    """The device half of a copy on write: page ``src`` lands on page
    ``dst`` in every leaf of every layer (codes and scale rows too), and no
    other row moves."""
    from repro_torch.models.api import copy_paged_block, init_paged_state

    cfg = get_config("qwen2-0.5b", smoke=True, dtype="float32",
                     param_dtype="float32", kv_dtype=kv_dtype)
    ps = 4
    state = init_paged_state(cfg, 2, 6, ps, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for cache in state["caches"]:
        for leaf in cache.values():
            leaf.copy_(torch.randint(-100, 100, leaf.shape,
                                     generator=gen).to(leaf.dtype))
    before = [{k: v.clone() for k, v in c.items()} for c in state["caches"]]
    assert copy_paged_block(state, cfg, 1, 4, page_size=ps) is state
    n_leaves = 0
    for old, cache in zip(before, state["caches"]):
        for name, leaf in cache.items():
            want = old[name].clone()
            want[4 * ps:5 * ps] = old[name][1 * ps:2 * ps]
            assert torch.equal(leaf, want), name
            n_leaves += 1
    assert n_leaves == cfg.num_layers * (4 if kv_dtype == "int8" else 2)


# ---------------------------------------------------------------------------
# the port's engine on its plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant,kv_dtype", PREFIX_CACHE_CELLS,
                         ids=lambda p: str(p))
def test_warm_streams_bit_identical_to_cold(variant, kv_dtype):
    params, cfg = _setup(variant)
    prompts = _prompts()

    def run(warm):
        eng = _engine(params, cfg, slots=2, max_len=96, chunk_size=8,
                      kv_layout="paged", page_size=4, kv_dtype=kv_dtype)
        assert eng.prefix_cache  # auto-on for paged attention-only configs
        if warm:
            eng.submit(prompts[0][:43], 4, rid=-1)  # seed the cache
            eng.run()
        reqs = [eng.submit(p, 6, rid=i) for i, p in enumerate(prompts)]
        eng.run()
        eng.pool.check_consistency()
        return eng, [r.out for r in reqs]

    cold_eng, cold = run(False)
    warm_eng, warm = run(True)
    assert cold == warm
    ws = warm_eng.memory_stats()
    assert ws["cache_hits"] >= len(prompts)
    assert ws["prefix_hit_tokens"] >= len(prompts) * 40
    assert ws["prefill_flops_skipped"] > 0
    assert warm_eng.prompt_tokens - 43 - 4 < cold_eng.prompt_tokens


def test_cow_on_tail_divergence_with_live_donor():
    params, cfg = _setup()
    rng = np.random.default_rng(1)
    shared = rng.integers(1, 200, 24).tolist()   # page 8, chunk 5
    pA = shared + rng.integers(1, 200, 6).tolist()
    pB = shared + rng.integers(1, 200, 6).tolist()

    def run(prefix_cache):
        eng = _engine(params, cfg, slots=2, max_len=96, chunk_size=5,
                      kv_layout="paged", page_size=8,
                      prefix_cache=prefix_cache)
        outs = []
        for p in (pA, pB, pA):           # third = identical resubmission
            r = eng.submit(p, 5)
            eng.run()
            outs.append(r.out)
        return eng, outs

    off_eng, off = run(False)
    on_eng, on = run(True)
    assert off == on
    st = on_eng.memory_stats()
    assert st["cow_copies"] >= 1
    assert st["cache_hits"] >= 2
    assert off_eng.memory_stats()["kv_cached_blocks"] == 0


def test_preemption_never_frees_blocks_shared_with_live_slot():
    params, cfg = _setup()
    rng = np.random.default_rng(2)
    shared = rng.integers(1, 200, 16).tolist()
    prompts = [shared + rng.integers(1, 200, n).tolist()
               for n in (5, 9, 7, 11, 6)]

    ref = _engine(params, cfg, slots=3, max_len=64, chunk_size=8)
    rr = [ref.submit(p, 6, rid=i) for i, p in enumerate(prompts)]
    ref.run()

    tight = _engine(params, cfg, slots=3, max_len=64, chunk_size=8,
                    kv_layout="paged", page_size=4, pool_blocks=14)
    tr = [tight.submit(p, 6, rid=i) for i, p in enumerate(prompts)]
    tight.run()

    assert all(r.done for r in tr)
    assert [r.out for r in rr] == [r.out for r in tr]
    pool = tight.pool
    assert pool.used_blocks == 0
    assert pool.free_block_count + pool.cached_block_count == pool.pool_blocks
    assert (pool.refcount == 0).all()
    pool.check_consistency()


def test_full_prompt_resubmission_hits_and_matches():
    params, cfg = _setup("expmul")
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, 200, 32).tolist()   # multiple of page & chunk

    eng = _engine(params, cfg, slots=2, max_len=96, chunk_size=8,
                  kv_layout="paged", page_size=8)
    first = eng.submit(prompt, 6)
    eng.run()
    again = eng.submit(prompt, 6)
    eng.run()
    assert first.out == again.out
    assert again.prefix_hit >= 24        # cursor = align(31) = 24 of 32
    assert eng.memory_stats()["cache_hits"] >= 1


def test_temperature_sampling_is_scheduling_invariant():
    params, cfg = _setup()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 200, n).tolist() for n in (9, 14, 6, 11)]

    def run(slots):
        eng = _engine(params, cfg, slots=slots, max_len=64, chunk_size=8,
                      temperature=0.8, seed=7)
        reqs = [eng.submit(p, 6, rid=i) for i, p in enumerate(prompts)]
        eng.run()
        return [r.out for r in reqs]

    assert run(4) == run(2) == run(1)


def test_prefix_cache_rejections_and_auto_default():
    params, cfg = _setup()
    with pytest.raises(ValueError, match="paged"):
        _engine(params, cfg, kv_layout="contiguous", prefix_cache=True)
    # auto default: on for the paged layout (every block of the port's
    # configs is attention), off for the contiguous one
    assert _engine(params, cfg, kv_layout="paged").prefix_cache
    assert not _engine(params, cfg).prefix_cache
    # and off stays off: no lookups, no cached blocks
    eng = _engine(params, cfg, kv_layout="paged", prefix_cache=False)
    eng.submit([1, 2, 3, 4, 5, 6, 7, 8], 4)
    eng.run()
    st = eng.memory_stats()
    assert not st["prefix_cache"] and st["kv_cached_blocks"] == 0
    assert eng.pool.stats.cache_lookups == 0


def test_qwen2_paged_engine_caches_prefixes_by_default():
    """The full-width config, as the reference's engine has it: a paged
    engine caches shared prefixes unless told not to (the engine is built
    on the meta device: no weights, no pools are materialized)."""
    cfg = get_config("qwen2-0.5b")
    jcfg = jax_get_config("qwen2-0.5b")
    assert set(jcfg.block_pattern) == {"attn"}
    eng = ServeEngine({}, cfg, kv_layout="paged", slots=8, max_len=2048,
                      device="meta")
    assert eng.prefix_cache and eng.pool.prefix_cache


# ---------------------------------------------------------------------------
# parity with repro's engine, tick by tick
# ---------------------------------------------------------------------------
# pool budgets (unquantized-equivalent blocks) that give 14 fp32 and 12 int8
# blocks of 4 tokens: both runs reclaim cached blocks and preempt
PARITY_POOL = {"fp32": 14, "int8": 4}
PREFIX_COUNTERS = ("cache_lookups", "cache_hits", "hit_blocks",
                   "prefix_hit_tokens", "cow_copies", "kv_cached_blocks",
                   "cached_evictions", "prefill_flops_skipped", "evictions",
                   "preemptions", "recompute_tokens")


def parity_models(variant):
    over = dict(dtype="float32", param_dtype="float32",
                attention_variant=variant)
    jcfg = jax_get_config("qwen2-0.5b", smoke=True, **over)
    params = jax_init_model(jax.random.PRNGKey(0), jcfg)
    tcfg = get_config("qwen2-0.5b", smoke=True, **over)
    return jcfg, params, tcfg, params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, device="cpu")


def parity_workload(jeng, teng):
    """A seed request, then five prompts sharing its first 22 tokens (five
    full pages of 4, so the chunk-6 grid puts the cursor at 18, inside the
    fifth page), submitted to both engines."""
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 200, 22).tolist()
    prompts = [shared + rng.integers(1, 200, n).tolist()
               for n in (5, 9, 3, 11, 6)]
    reqs = []
    for eng in (jeng, teng):
        eng.submit(shared + [7], 2, rid=100)
        reqs.append([eng.submit(p, 5, rid=i) for i, p in enumerate(prompts)])
    return reqs


@pytest.mark.parametrize("variant,kv_dtype", PREFIX_CACHE_CELLS,
                         ids=lambda p: str(p))
def test_prefix_cache_matches_repro_engine_tick_by_tick(variant, kv_dtype):
    jcfg, params, tcfg, tparams = parity_models(variant)
    kw = dict(slots=3, max_len=48, chunk_size=6, kv_layout="paged",
              page_size=4, pool_blocks=PARITY_POOL[kv_dtype],
              kv_dtype=kv_dtype, prefix_cache=True)
    jeng = JaxServeEngine(params, jcfg, attention_impl="pallas", **kw)
    teng = ServeEngine(tparams, tcfg, device="cpu", **kw)
    jreqs, treqs = parity_workload(jeng, teng)
    while True:
        busy = jeng.tick()
        assert teng.tick() == busy
        np.testing.assert_array_equal(teng.pool.tables, jeng.pool.tables)
        np.testing.assert_array_equal(teng.pool.refcount, jeng.pool.refcount)
        np.testing.assert_array_equal(teng.lengths, jeng.lengths)
        if not (busy or jeng.queue):
            break
    assert not teng.queue
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done and len(r.out) == 5 for r in treqs)
    assert set(teng.pool._index) == set(jeng.pool._index)
    assert teng.pool._cached == jeng.pool._cached
    tst, jst = teng.memory_stats(), jeng.memory_stats()
    assert {k: tst[k] for k in PREFIX_COUNTERS} == \
        {k: jst[k] for k in PREFIX_COUNTERS}
    # the workload exercises every path it is meant to
    assert tst["cow_copies"] > 0 and tst["cached_evictions"] > 0
    assert tst["preemptions"] > 0 and tst["prefix_hit_tokens"] > 0
    teng.pool.check_consistency()

"""Host-side paged KV-cache management: a block pool, per-slot block
tables and the shared-prefix index (the port of ``repro/serve/paged.py``,
DESIGN.md §7, §11 and §13).

Device caches are flat pools of ``pool_blocks * page_size`` physical token
rows; this module owns the allocation state on the host:

  * a LIFO free list of physical block ids (block 0 first, so allocation
    is deterministic);
  * one block table per engine slot, holding physical block ids in logical
    order and the sentinel ``pool_blocks`` past them, so every row derived
    from an unallocated entry is out of range on the device. One table per
    slot serves every layer;
  * with ``prefix_cache=True``, a per-block reference count and a flat-dict
    radix index: every full page a sequence completes is registered under
    ``(parent_block_id, page_tokens)``, so a key covers the block's whole
    prefix and a dict walk from the root is a trie descent. KV content is
    a function of the token prefix, so a match means the resident block
    holds the KV a fresh prefill would write, and a new sequence shares it
    (refcount + 1) instead of recomputing it.

Block states: **used** (referenced by some table), **cached** (refcount 0
but indexed, retained for future hits, LRU-stamped) and **free**. Without
the prefix cache refcount 0 goes straight to the free list.

Eviction is tiered: ``alloc`` takes the free list, then reclaims cached
blocks LRU-first among leaves (a reclaimed block is de-indexed with its
whole indexed subtree before it is handed out, so no later walk can match
a child against the wrong prefix), and only then does the engine preempt
a live request. A slot that must write into a shared or indexed block
(the partial tail of a prefix hit) first gets a private copy via
``cow_block``; the engine copies the page on the device.

Fault tolerance (§13): ``alloc`` is the ``pool_alloc`` chaos point (a
forced failure exercises the reclaim -> preemption ladder);
``quarantine_slot`` releases a failed slot's blocks de-indexed, so a
suspect page is never spliced again; ``dump_state`` / ``load_state`` carry
the allocator through an engine snapshot.

Every counter lives in the ``MetricsRegistry`` the pool is given (the
engine's): ``stats`` is a read-through ``PoolStats`` view.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.numerics.quant import QUANT_KV_DTYPES, kv_code_bytes
from repro_torch.serve.faults import fault_point
from repro_torch.serve.metrics import MetricsRegistry


def blocks_for(n_tokens: int, page_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` logical tokens."""
    return -(-int(n_tokens) // page_size)


def kv_token_bytes(cfg, kv_dtype: str | None = None) -> int:
    """KV bytes per resident token over every attention layer (a recurrent
    layer holds no KV and counts 0; so does a pattern with no attention
    layer): K and V rows of ``Hkv * hd``
    elements, or for MLA one ``kv_lat`` row of ``kv_lora_rank`` and one
    ``k_rope`` row of ``qk_rope_dim`` elements, plus one float32 scale per
    row when quantized."""
    kv_dtype = kv_dtype if kv_dtype is not None else cfg.kv_dtype
    quant = kv_dtype in QUANT_KV_DTYPES
    elem = (kv_code_bytes(kv_dtype) if quant
            else getattr(torch, cfg.dtype).itemsize)
    if cfg.mla is not None:
        rows = 2
        feats = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
    else:
        rows = 2 * cfg.num_kv_heads
        feats = rows * cfg.resolved_head_dim()
    per_layer = feats * elem + (rows * 4 if quant else 0)
    return per_layer * cfg.pattern_for().count("attn")


@dataclasses.dataclass
class PoolStats:
    """Allocator statistics.

    This is a *view* (DESIGN.md §12): the metrics registry owns every
    counter (single-ownership contract — the pool increments registry
    instruments directly and ``BlockPool.stats`` materializes a PoolStats
    from them on each access), so ``memory_stats()`` and
    ``metrics_snapshot()`` can never disagree. Mutating a returned
    instance changes nothing.

    The ``used_blocks`` / ``cached_blocks`` / ``free_blocks`` triple is a
    live residency snapshot (refreshed on every pool mutation) splitting
    the pool into referenced, retained-for-reuse, and free blocks — so
    ``ServeEngine.memory_stats()`` reports cache residency instead of
    lumping cached blocks into used bytes (DESIGN.md §11). The rest are
    cumulative counters.
    """
    allocs: int = 0            # physical blocks handed out
    frees: int = 0             # physical blocks whose refcount dropped to 0
    evictions: int = 0         # slots whose blocks were freed by preemption
    alloc_failures: int = 0    # reservations that did not fit
    peak_used_blocks: int = 0  # high-water mark of referenced blocks
    # residency snapshot: used (refcount >= 1) / cached (refcount == 0 but
    # indexed, retained) / free — always sums to pool_blocks
    used_blocks: int = 0
    cached_blocks: int = 0
    free_blocks: int = 0
    # prefix cache (DESIGN.md §11)
    cache_lookups: int = 0     # match_prefix calls
    cache_hits: int = 0        # lookups matching >= 1 block
    hit_blocks: int = 0        # blocks spliced from the index into tables
    cached_evictions: int = 0  # cached blocks reclaimed under pressure
    cow_copies: int = 0        # copy-on-write page copies


class BlockPool:
    """Fixed pool of KV-cache blocks with per-slot block tables and an
    optional shared-prefix index (DESIGN.md §7/§11).

    ``sentinel`` (== pool_blocks) marks unallocated table entries. All
    methods are O(blocks touched) host work; the engine copies the tables
    to the device once per step as a plain int32 array.
    """

    def __init__(self, pool_blocks: int, page_size: int, slots: int,
                 max_blocks_per_seq: int, token_bytes: int = 0,
                 prefix_cache: bool = False,
                 metrics: MetricsRegistry | None = None):
        if pool_blocks <= 0 or page_size <= 0:
            raise ValueError(f"pool_blocks and page_size must be positive, "
                             f"got {pool_blocks}, {page_size}")
        self.pool_blocks = pool_blocks
        self.page_size = page_size
        self.slots = slots
        self.max_blocks_per_seq = max_blocks_per_seq
        # bytes per resident token across all attention layers, including
        # the parallel scale pool for quantized kv_dtypes (kv_token_bytes);
        # 0 = unknown, byte properties report 0
        self.token_bytes = token_bytes
        self.prefix_cache = prefix_cache
        self.sentinel = pool_blocks
        # LIFO free list: lowest ids at the end so fresh allocations are
        # deterministic (block 0 first) — handy for tests and reproducibility
        self.free_blocks = list(range(pool_blocks - 1, -1, -1))
        self.tables = np.full((slots, max_blocks_per_seq), self.sentinel,
                              np.int32)
        self.n_blocks = np.zeros((slots,), np.int32)  # allocated per slot
        self.refcount = np.zeros((pool_blocks,), np.int32)
        # prefix index (the flat-dict radix trie, §11): key is
        # (parent_block_id, tuple(page tokens)) — parent -1 at the root —
        # so a key transitively pins the block's whole token prefix
        self._index: dict = {}        # key -> block id
        self._block_key: dict = {}    # block id -> key (indexed blocks only)
        self._children: dict = {}     # block id -> set of indexed child ids
        self._cached: dict = {}       # block id -> LRU tick (refcount == 0)
        self._tick = 0                # monotonic LRU clock
        # observability (DESIGN.md §12): the registry is the single owner
        # of the allocator counters; ``stats`` rebuilds the legacy
        # PoolStats view from it on demand. The engine passes its own
        # registry in so pool and engine share one metric namespace.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._c_allocs = m.counter("pool_allocs_total")
        self._c_frees = m.counter("pool_frees_total")
        self._c_evictions = m.counter("pool_evictions_total")
        self._c_alloc_failures = m.counter("pool_alloc_failures_total")
        self._c_lookups = m.counter("pool_cache_lookups_total")
        self._c_hits = m.counter("pool_cache_hits_total")
        self._c_hit_blocks = m.counter("pool_hit_blocks_total")
        self._c_cached_evictions = m.counter("pool_cached_evictions_total")
        self._c_cow = m.counter("pool_cow_copies_total")
        self._g_used = m.gauge("pool_used_blocks")
        self._g_cached = m.gauge("pool_cached_blocks")
        self._g_free = m.gauge("pool_free_blocks")
        self._g_peak_used = m.gauge("pool_peak_used_blocks")
        self._sync_residency()

    @property
    def stats(self) -> PoolStats:
        """The legacy PoolStats surface, materialized from the registry."""
        return PoolStats(
            allocs=self._c_allocs.value,
            frees=self._c_frees.value,
            evictions=self._c_evictions.value,
            alloc_failures=self._c_alloc_failures.value,
            peak_used_blocks=self._g_peak_used.value,
            used_blocks=self._g_used.value,
            cached_blocks=self._g_cached.value,
            free_blocks=self._g_free.value,
            cache_lookups=self._c_lookups.value,
            cache_hits=self._c_hits.value,
            hit_blocks=self._c_hit_blocks.value,
            cached_evictions=self._c_cached_evictions.value,
            cow_copies=self._c_cow.value,
        )

    # -- capacity queries ---------------------------------------------------
    @property
    def used_blocks(self) -> int:
        """Blocks referenced by at least one slot's table (excludes the
        cached tier — those are reclaimable, DESIGN.md §11)."""
        return (self.pool_blocks - len(self.free_blocks)
                - len(self._cached))

    @property
    def cached_block_count(self) -> int:
        """Unreferenced-but-retained blocks (prefix cache residency)."""
        return len(self._cached)

    @property
    def free_block_count(self) -> int:
        return len(self.free_blocks)

    @property
    def cached_bytes(self) -> int:
        """Real bytes retained in the cached tier."""
        return self.cached_block_count * self.page_size * self.token_bytes

    def _sync_residency(self):
        self._g_used.set(self.used_blocks)
        self._g_cached.set(len(self._cached))
        self._g_free.set(len(self.free_blocks))

    def _available(self) -> int:
        """Blocks obtainable without preempting anyone: free + cached."""
        return len(self.free_blocks) + len(self._cached)

    def can_fit(self, slot: int, n_tokens: int) -> bool:
        need = blocks_for(n_tokens, self.page_size) - int(self.n_blocks[slot])
        return need <= self._available()

    def can_admit(self, hit_blocks: list, n_tokens: int) -> bool:
        """Would a fresh slot holding ``hit_blocks`` spliced from the index
        fit ``n_tokens``? Hit blocks sitting in the cached tier stop being
        reclaimable the moment they are spliced, so they don't count as
        available."""
        need = blocks_for(n_tokens, self.page_size) - len(hit_blocks)
        avail = self._available() - sum(1 for b in hit_blocks
                                        if b in self._cached)
        return need <= avail

    # -- refcount plumbing --------------------------------------------------
    def _incref(self, b: int):
        self.refcount[b] += 1
        self._cached.pop(b, None)   # cached -> used

    def _decref(self, b: int):
        self.refcount[b] -= 1
        assert self.refcount[b] >= 0, b
        if self.refcount[b] > 0:
            return 0
        # last reference gone: retain if indexed (cached tier), else free
        if self.prefix_cache and b in self._block_key:
            self._cached[b] = self._tick
            self._tick += 1
        else:
            self.free_blocks.append(b)
        self._c_frees.inc()
        return 1

    def is_shared(self, b: int) -> bool:
        """True when writing into ``b`` needs copy-on-write first: another
        table references it, or the prefix index maps to its content."""
        return int(self.refcount[b]) > 1 or b in self._block_key

    # -- prefix index (DESIGN.md §11) ---------------------------------------
    def _deindex(self, b: int):
        """Drop ``b`` and its whole indexed subtree from the prefix index.

        Descendants must go too: their keys name ``b`` as parent, and if
        ``b``'s storage is reused for different content a later walk could
        match a stale child against the wrong prefix. Unreferenced
        descendants have no reason to stay resident once unindexed — they
        move straight to the free list."""
        key = self._block_key.pop(b, None)
        if key is None:
            return
        del self._index[key]
        parent = key[0]
        if parent >= 0 and parent in self._children:
            self._children[parent].discard(b)
        for child in list(self._children.pop(b, ())):
            self._deindex(child)
            if child in self._cached:
                del self._cached[child]
                self.free_blocks.append(child)

    def register_block(self, b: int, parent: int, tokens) -> None:
        """Index a freshly completed full page for future prefix hits.

        No-op when: caching is off; ``b`` is already indexed (a spliced hit
        block); the parent is not indexed (the chain to the root is broken,
        so the entry would be unreachable — and dangerous if the parent id
        is ever reused); or the key already maps to another block (two
        slots prefilled the same prefix concurrently — the first
        registration stays canonical, the duplicate block remains private).
        """
        if not self.prefix_cache or b in self._block_key:
            return
        if parent >= 0 and parent not in self._block_key:
            return
        key = (parent, tuple(int(t) for t in tokens))
        if key in self._index:
            return
        self._index[key] = b
        self._block_key[b] = key
        if parent >= 0:
            self._children.setdefault(parent, set()).add(b)

    def match_prefix(self, tokens) -> list:
        """Longest chain of indexed full pages covering a prefix of
        ``tokens`` — the radix-trie descent, one dict lookup per page.
        Matched blocks may be cached *or* live (shared with a running
        sequence); cached matches get their LRU refreshed."""
        self._c_lookups.inc()
        ps = self.page_size
        out = []
        parent = -1
        for i in range(len(tokens) // ps):
            key = (parent, tuple(int(t) for t in tokens[i * ps:(i + 1) * ps]))
            b = self._index.get(key)
            if b is None:
                break
            out.append(b)
            parent = b
        if out:
            self._c_hits.inc()
            for b in out:
                if b in self._cached:
                    self._cached[b] = self._tick
                    self._tick += 1
        return out

    def splice(self, slot: int, blocks: list) -> None:
        """Seed a fresh slot's table with shared blocks from a prefix hit
        (refcount++ each; cached blocks return to the used tier)."""
        assert int(self.n_blocks[slot]) == 0, "splice targets a fresh slot"
        for i, b in enumerate(blocks):
            self.tables[slot, i] = b
            self._incref(b)
        self.n_blocks[slot] = len(blocks)
        self._c_hit_blocks.inc(len(blocks))
        self._g_peak_used.set_max(self.used_blocks)
        self._sync_residency()

    def _reclaim(self, k: int) -> int:
        """Move up to ``k`` cached blocks to the free list, LRU first among
        leaves (indexed children keep their parents pinned until the leaves
        go — evicting a parent would orphan a still-reachable subtree).
        Returns the number of blocks actually freed (cascades included)."""
        before = len(self.free_blocks)
        while len(self.free_blocks) - before < k and self._cached:
            leaves = [b for b in self._cached if not self._children.get(b)]
            pick_from = leaves or list(self._cached)
            victim = min(pick_from, key=lambda b: self._cached[b])
            del self._cached[victim]
            self._deindex(victim)
            self.free_blocks.append(victim)
            self._c_cached_evictions.inc()
        return len(self.free_blocks) - before

    # -- alloc / free -------------------------------------------------------
    def alloc(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s table to cover ``n_tokens`` logical tokens.

        All-or-nothing: returns False (allocating nothing) when free +
        reclaimable-cached blocks cannot cover the growth, so a failed
        reservation leaves the pool untouched and the engine can pick a
        *live* victim to preempt (cached-LRU reclaim always comes first,
        §11 eviction ordering)."""
        want = blocks_for(n_tokens, self.page_size)
        if want > self.max_blocks_per_seq:
            raise ValueError(f"{n_tokens} tokens need {want} blocks, more "
                             f"than a table holds ({self.max_blocks_per_seq})")
        have = int(self.n_blocks[slot])
        need = want - have
        if need <= 0:
            return True
        if need > self._available() or fault_point(
                "pool_alloc", slot=slot, need=need):
            # the chaos injector forces a failure here to exercise the
            # reclaim -> preemption ladder; the engine retries after
            # evicting a victim, so each retry is a new opportunity
            self._c_alloc_failures.inc()
            return False
        if need > len(self.free_blocks):
            self._reclaim(need - len(self.free_blocks))
        for i in range(have, want):
            b = self.free_blocks.pop()
            self.tables[slot, i] = b
            self.refcount[b] = 1
        self.n_blocks[slot] = want
        self._c_allocs.inc(need)
        self._g_peak_used.set_max(self.used_blocks)
        self._sync_residency()
        return True

    def cow_block(self, slot: int, idx: int):
        """Copy-on-write: give ``slot`` a private replacement for the shared
        block at table position ``idx`` before it writes there (§11).

        Returns ``(src, dst)`` physical ids — the *caller* owns the device
        page copy — or None when no block is obtainable (the engine then
        preempts a victim and retries). The original keeps its index entry
        and its other references; if this slot held its last reference it
        simply returns to the cached tier, content intact."""
        src = int(self.tables[slot, idx])
        if not self.free_blocks:
            self._reclaim(1)
        if not self.free_blocks:
            self._c_alloc_failures.inc()
            return None
        dst = self.free_blocks.pop()
        self.tables[slot, idx] = dst
        self.refcount[dst] = 1
        self._decref(src)
        self._c_cow.inc()
        self._g_peak_used.set_max(self.used_blocks)
        self._sync_residency()
        return src, dst

    def free_slot(self, slot: int) -> int:
        """Release every block of ``slot`` (refcount--; last holder sends a
        block to the cached tier if indexed, else to the free list); reset
        its table to sentinels. Returns the number of blocks released."""
        n = int(self.n_blocks[slot])
        for i in range(n):
            self._decref(int(self.tables[slot, i]))
        self.tables[slot, :n] = self.sentinel
        self.n_blocks[slot] = 0
        self._sync_residency()
        return n

    def evict_slot(self, slot: int) -> int:
        """free_slot + eviction accounting (the preemption path)."""
        n = self.free_slot(slot)
        self._c_evictions.inc()
        return n

    def quarantine_slot(self, slot: int) -> int:
        """Release ``slot``'s blocks as *suspect* (NaN quarantine, §13).

        Every block the slot references is de-indexed from the prefix
        cache first, with its indexed descendants, so a page that may hold
        corrupted KV can never be splice-reused; only then is the
        reference dropped. A de-indexed block whose last reference this
        was goes straight to the free list (the engine zeroes its content
        first). Blocks still referenced by another live slot stay used but
        unindexed. Returns the number of blocks released by this slot."""
        n = int(self.n_blocks[slot])
        for i in range(n):
            b = int(self.tables[slot, i])
            self._deindex(b)
            self._decref(b)
        self.tables[slot, :n] = self.sentinel
        self.n_blocks[slot] = 0
        self._sync_residency()
        return n

    # -- invariants -----------------------------------------------------------
    def check_consistency(self):
        """Assert the pool's full accounting invariant set; raises
        AssertionError with a specific message on any violation.

        No sequence of allocations, splices, copies on write, frees and
        preemptions may leak a block (used + cached + free == pool_blocks,
        with the tiers disjoint), skew a refcount away from the tables
        that define it, or leave a dangling radix key (an index entry
        whose block is on the free list, or whose parent chain is
        broken)."""
        refs = np.zeros((self.pool_blocks,), np.int64)
        for s in range(self.slots):
            n = int(self.n_blocks[s])
            for i in range(n):
                b = int(self.tables[s, i])
                assert 0 <= b < self.pool_blocks, \
                    f"slot {s} table[{i}] = {b} out of range"
                refs[b] += 1
            assert (self.tables[s, n:] == self.sentinel).all(), \
                f"slot {s} has non-sentinel entries beyond n_blocks={n}"
        assert (refs == self.refcount).all(), (
            f"refcounts diverged from tables: "
            f"{np.flatnonzero(refs != self.refcount).tolist()}")
        free = set(self.free_blocks)
        cached = set(self._cached)
        used = {b for b in range(self.pool_blocks) if refs[b] > 0}
        assert len(free) == len(self.free_blocks), "duplicate free blocks"
        assert not (free & used), f"free∩used: {sorted(free & used)}"
        assert not (free & cached), f"free∩cached: {sorted(free & cached)}"
        assert not (cached & used), f"cached∩used: {sorted(cached & used)}"
        assert len(used) + len(cached) + len(free) == self.pool_blocks, (
            f"leak: used {len(used)} + cached {len(cached)} + free "
            f"{len(free)} != pool {self.pool_blocks}")
        # radix index integrity: bijective with _block_key, no entry naming
        # a freed block, parent chains unbroken, child links symmetric
        assert len(self._index) == len(self._block_key)
        for key, b in self._index.items():
            assert self._block_key.get(b) == key, f"index/block_key skew @{b}"
            assert b not in free, f"dangling radix key: block {b} is free"
            parent = key[0]
            if parent >= 0:
                assert parent in self._block_key, (
                    f"block {b} indexed under unindexed parent {parent}")
                assert b in self._children.get(parent, ()), (
                    f"missing child link {parent}->{b}")
        for parent, kids in self._children.items():
            for b in kids:
                assert self._block_key.get(b, (None,))[0] == parent, (
                    f"stale child link {parent}->{b}")
        for b in cached:
            assert b in self._block_key, \
                f"cached block {b} is not indexed (unreclaimable)"

    # -- snapshot/restore (DESIGN.md §13) ------------------------------------
    def dump_state(self) -> dict:
        """JSON-able allocator state: tables, refcounts, free list, and the
        full radix index (keys flattened to [parent, tokens, block] rows,
        JSON having no tuple keys). Counters are not included: the engine
        snapshot serializes the whole metrics registry."""
        return {
            "pool_blocks": self.pool_blocks,
            "page_size": self.page_size,
            "tables": self.tables.tolist(),
            "n_blocks": self.n_blocks.tolist(),
            "refcount": self.refcount.tolist(),
            "free_blocks": [int(b) for b in self.free_blocks],
            "index": [[int(parent), [int(t) for t in tokens], int(b)]
                      for (parent, tokens), b in self._index.items()],
            "cached": [[int(b), int(t)] for b, t in self._cached.items()],
            "tick": self._tick,
        }

    def load_state(self, dump: dict) -> None:
        """Restore allocator state from ``dump_state()`` output into a pool
        constructed with the same geometry."""
        if (dump["pool_blocks"] != self.pool_blocks
                or dump["page_size"] != self.page_size):
            raise ValueError(
                f"snapshot pool geometry ({dump['pool_blocks']} blocks x "
                f"{dump['page_size']} tokens) does not match this pool "
                f"({self.pool_blocks} x {self.page_size})")
        self.tables = np.asarray(dump["tables"], np.int32)
        self.n_blocks = np.asarray(dump["n_blocks"], np.int32)
        self.refcount = np.asarray(dump["refcount"], np.int32)
        self.free_blocks = [int(b) for b in dump["free_blocks"]]
        self._index = {(int(p), tuple(int(t) for t in toks)): int(b)
                       for p, toks, b in dump["index"]}
        self._block_key = {b: key for key, b in self._index.items()}
        self._children = {}
        for (parent, _), b in self._index.items():
            if parent >= 0:
                self._children.setdefault(parent, set()).add(b)
        self._cached = {int(b): int(t) for b, t in dump["cached"]}
        self._tick = int(dump["tick"])
        self._sync_residency()
        self.check_consistency()

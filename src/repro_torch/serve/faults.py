"""Deterministic chaos injection for the serving stack (a copy of
``repro/serve/faults.py``, DESIGN.md §13, on numpy alone).

The serving engine and the paged ``BlockPool`` call ``fault_point(name,
**ctx)`` at the places where real deployments fail; with no injector
installed every call is a single ``is None`` check returning False, so
production runs pay nothing. Tests, the CLI's ``--chaos`` and
``chip_smoke.py`` install a ``ChaosInjector`` with the process-global
``install_fault_injector`` (one slot, last install wins, ``None``
uninstalls).

Injection points (all fire *before* the faulty behavior, returning True
to inject):

  ``pool_alloc``   a ``BlockPool.alloc`` reservation is forced to fail —
                   exercises the cached-LRU-reclaim -> live-preemption
                   eviction ladder without shrinking the pool.
  ``admission``    the engine skips admitting the queue head this tick
                   (the request stays queued and is retried).
  ``preempt``      the engine forcibly preempts an active slot (a
                   preemption storm; recompute resumption keeps temp-0
                   streams unchanged).
  ``logits``       the engine overwrites one active slot's logits row
                   with NaN on the device before sampling — the NaN
                   quarantine sentinel must fail *only* that request.
  ``kv_corrupt``   the engine poisons the physical KV page an active slot
                   last wrote (``models.api.poison_paged_block``); the
                   corruption surfaces as non-finite logits for that slot
                   and quarantine must free *and de-index* its pages.

Determinism contract: whether opportunity ``n`` of a point fires is a
pure function of the injector's construction arguments — an explicit
``at`` schedule of opportunity indices, or a seeded per-point Bernoulli
``rate`` drawn from ``numpy.random.default_rng(seed)`` — never of wall
clock or object identity. The engines of ``repro`` and of this port
count opportunities at the same places in the same order, so one
schedule fires at the same opportunities in both. Opportunities are
counted *after* the optional ``rids`` filter, so ``at={"logits": [0]},
rids={"logits": {3}}`` means "the first time request 3's logits are
eligible".
"""
from __future__ import annotations

import numpy as np

# the process-global injector slot
_INJECTOR = None


def install_fault_injector(injector) -> None:
    """Point the global ``fault_point`` hook at ``injector`` (None
    uninstalls). Last install wins."""
    global _INJECTOR
    _INJECTOR = injector


def current_fault_injector():
    return _INJECTOR


def fault_point(point: str, **ctx) -> bool:
    """Fire one injection opportunity. False (never inject) when no
    injector is installed — the production fast path."""
    if _INJECTOR is None:
        return False
    return _INJECTOR.fire(point, **ctx)


class ChaosInjector:
    """Seedable, schedulable fault injector for the serving stack.

    Parameters
    ----------
    seed : int
        Seeds the per-point Bernoulli draws (only consulted for points
        with a ``rate``).
    rates : dict[str, float]
        Per-point injection probability per opportunity.
    at : dict[str, iterable[int]]
        Explicit opportunity indices (0-based, post-filter) at which a
        point fires — the precise scheduling used by the chaos tests.
    rids : dict[str, set[int]]
        Optional per-point request-id filter: opportunities whose ctx
        carries a ``rid`` outside the set are skipped (and not counted).
    limit : dict[str, int]
        Hard cap on fires per point (bounds chaos so the engine's
        no-victim-left error paths aren't spuriously tripped: a forced
        alloc failure is retried after a preemption, so an unbounded
        ``pool_alloc`` rate of 1.0 would starve the retry loop).

    ``injected`` records every fire as ``(point, opportunity_index,
    ctx)``; ``fired(point)`` and ``opportunities(point)`` are the test
    conveniences.
    """

    POINTS = ("pool_alloc", "admission", "preempt", "logits", "kv_corrupt")

    def __init__(self, *, seed: int = 0, rates: dict | None = None,
                 at: dict | None = None, rids: dict | None = None,
                 limit: dict | None = None):
        rates = dict(rates or {})
        at = {k: frozenset(int(i) for i in v)
              for k, v in (at or {}).items()}
        for d in (rates, at, rids or {}, limit or {}):
            unknown = set(d) - set(self.POINTS)
            if unknown:
                raise ValueError(
                    f"unknown fault point(s) {sorted(unknown)}; "
                    f"choose from {self.POINTS}")
        self.rates = rates
        self.at = at
        self.rids = {k: set(v) for k, v in (rids or {}).items()}
        self.limit = dict(limit or {})
        self._rng = np.random.default_rng(seed)
        self._opportunities = {p: 0 for p in self.POINTS}
        self._fired = {p: 0 for p in self.POINTS}
        self.injected: list = []

    @classmethod
    def from_spec(cls, spec: str, *, seed: int = 0,
                  limit_each: int = 4) -> "ChaosInjector":
        """Parse a CLI chaos spec: ``"point=rate,point=rate,..."`` (e.g.
        ``"preempt=0.05,logits=0.01"``). Each point gets a hard fire
        limit of ``limit_each`` so a CLI-driven storm always stays
        bounded."""
        rates = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"bad --chaos entry {part!r}: expected point=rate")
            point, rate = part.split("=", 1)
            rates[point.strip()] = float(rate)
        return cls(seed=seed, rates=rates,
                   limit={p: limit_each for p in rates})

    def fired(self, point: str) -> int:
        return self._fired[point]

    def opportunities(self, point: str) -> int:
        return self._opportunities[point]

    def fire(self, point: str, **ctx) -> bool:
        if point not in self._opportunities:
            raise ValueError(f"unknown fault point {point!r}")
        only = self.rids.get(point)
        if only is not None and ctx.get("rid") not in only:
            return False
        n = self._opportunities[point]
        self._opportunities[point] = n + 1
        cap = self.limit.get(point)
        if cap is not None and self._fired[point] >= cap:
            return False
        hit = n in self.at.get(point, ())
        rate = self.rates.get(point, 0.0)
        if not hit and rate > 0.0:
            hit = bool(self._rng.random() < rate)
        if hit:
            self._fired[point] += 1
            self.injected.append((point, n, ctx))
        return hit

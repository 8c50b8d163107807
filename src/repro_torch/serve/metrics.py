"""Engine-wide observability: a dependency-free metrics registry plus a
monotonic-clock span recorder (the port of ``repro/serve/metrics.py``,
DESIGN.md §12, with the snapshot half ``dump_values``/``load_values`` of
§13).

  * ``Counter`` / ``Gauge`` / ``Histogram`` — plain host-side numbers.
    Histograms use **fixed upper-edge buckets** (Prometheus form) and
    report p50/p90/p99 as the smallest bucket edge whose cumulative count
    reaches the quantile — exact for integer-valued data on unit edges
    (``numpy.percentile(..., method="inverted_cdf")``), one-bucket-width
    conservative otherwise. TTFT/TPOT are recorded in *engine steps* and
    in milliseconds (host wall clock).
  * ``MetricsRegistry`` — owns the instruments keyed by
    ``name{label=value,...}`` plus one span/event recorder. It is the
    **single owner** of every serving counter: ``ServeEngine`` and
    ``BlockPool`` hold references to its instruments, and
    ``memory_stats()`` / ``PoolStats`` are *views* over them.
  * spans/events — ``span()`` (complete "X" events), ``begin()``/``end()``
    pairs and ``instant()`` markers, stamped with
    ``time.perf_counter_ns()`` on the host only: no device sync is issued
    for observability. ``chrome_trace()`` exports the timeline as
    Chrome-trace/Perfetto JSON.

With tracing **off** (the default) the hot path pays integer counter
increments and one check per record site: no span dicts, no timestamps
beyond the one the engine takes a tick, no device synchronization.

Kernel-level cost accounting has two layers:

  * **dispatch counters** — ``install_dispatch_counters(registry)`` puts a
    sink in ``kernels.build``'s single slot, so every call of an attention
    wrapper (``kernels/flash/ops.py``, ``kernels/decode/ops.py``)
    increments ``attention_dispatch_total{kind,impl,...}`` and adds the
    call's shape-level analytic bytes and FLOPs (``kernels.costs``). The
    wrappers are eager, so the count is one per call. ``impl`` is
    ``"kernel"`` or ``"plain"``.
  * **executed-cost ledger** — ``ServeEngine`` prices every step it runs
    (host-side lengths x the same analytic helpers) into
    ``attention_exec_*`` counters.

At import this module loads nothing but the standard library.
"""
from __future__ import annotations

import json
import time


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _format_labels(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    """Monotonic counter. ``inc`` accepts any non-negative number."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n


class Gauge:
    """Last-value (or max-tracked) instantaneous measurement."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v):
        self.value = v

    def set_max(self, v):
        if v > self.value:
            self.value = v


# default bucket upper edges for engine-step histograms: exact unit
# buckets through 128 steps (every TTFT/TPOT the smoke configs produce is
# an exact integer there), then doubling to bound memory for long runs
STEP_BUCKETS = tuple(range(1, 129)) + tuple(
    128 * 2 ** i for i in range(1, 9))
# wall-clock milliseconds: log-ish spacing from 10us to ~2 minutes
MS_BUCKETS = tuple(
    round(m * 10 ** e, 6)
    for e in range(-2, 5)
    for m in (1.0, 1.6, 2.5, 4.0, 6.3)
) + (10.0 ** 5,)


class Histogram:
    """Fixed-bucket histogram with quantiles (Prometheus exposition form).

    ``buckets`` are ascending finite upper edges; an implicit +inf bucket
    catches overflow. ``quantile(q)`` returns the smallest edge whose
    cumulative count reaches ``q * count`` — for samples lying exactly on
    edges this equals ``numpy.percentile(data, 100q,
    method="inverted_cdf")``; otherwise it is conservative by at most one
    bucket width. Values above the last edge report the last finite edge
    (the histogram's representable ceiling).
    """

    __slots__ = ("buckets", "counts", "overflow", "count", "total")

    def __init__(self, buckets=STEP_BUCKETS):
        assert len(buckets) > 0
        assert all(a < b for a, b in zip(buckets, buckets[1:])), buckets
        self.buckets = tuple(buckets)
        self.counts = [0] * len(self.buckets)
        self.overflow = 0
        self.count = 0
        self.total = 0.0

    def record(self, v):
        self.count += 1
        self.total += v
        lo, hi = 0, len(self.buckets)
        if v > self.buckets[-1]:
            self.overflow += 1
            return
        while lo < hi:  # first edge >= v
            mid = (lo + hi) // 2
            if self.buckets[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1

    def quantile(self, q) -> float:
        if self.count == 0:
            return float("nan")
        need = q * self.count
        cum = 0
        for edge, c in zip(self.buckets, self.counts):
            cum += c
            if cum >= need and c:
                return float(edge)
        return float(self.buckets[-1])

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.mean,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


_NS_PER_US = 1000.0


class _Span:
    """Context manager emitting one complete ("X") trace event."""

    __slots__ = ("reg", "name", "pid", "tid", "args", "t0")

    def __init__(self, reg, name, pid, tid, args):
        self.reg, self.name = reg, name
        self.pid, self.tid, self.args = pid, tid, args

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.reg._events.append({
            "name": self.name, "ph": "X", "pid": self.pid, "tid": self.tid,
            "ts": self.t0 / _NS_PER_US, "dur": (t1 - self.t0) / _NS_PER_US,
            "args": self.args,
        })
        return False


class _NullSpan:
    """Shared no-op span: tracing-off records allocate nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

# Chrome-trace track ids (pid = process row, tid = thread row). The
# engine's step timeline lives on one track; each request gets its own
# thread row under the "requests" process so lifecycles stack visually.
PID_ENGINE = 1
PID_REQUESTS = 2


class MetricsRegistry:
    """Counters, gauges, histograms, and a span recorder under one roof.

    Instruments are keyed by ``(name, sorted(labels))`` and created on
    first touch; holding the returned instrument object skips the dict
    lookup on hot paths. ``trace`` gates span/event recording only —
    counters and histograms are always live (they are the cheap part and
    ``metrics_snapshot()`` must stay well-formed with tracing off).
    """

    def __init__(self, *, trace: bool = False):
        self.trace = bool(trace)
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}
        self._events: list = []
        self._track_names: dict = {}  # (pid, tid) -> name (trace metadata)

    # -- instruments --------------------------------------------------------
    def counter(self, name: str, **labels) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, buckets=STEP_BUCKETS, **labels) -> Histogram:
        key = (name, _label_key(labels))
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram(buckets)
        return h

    def counter_value(self, name: str, **labels):
        c = self._counters.get((name, _label_key(labels)))
        return c.value if c is not None else 0

    # -- spans / events (host-side timestamps only) --------------------------
    def name_track(self, pid: int, tid: int, name: str):
        self._track_names[(pid, tid)] = name

    def span(self, name: str, *, pid: int = PID_ENGINE, tid: int = 0,
             **args):
        """``with reg.span("decode_step", active=3): ...`` — a complete
        X event when tracing, the shared no-op otherwise."""
        if not self.trace:
            return _NULL_SPAN
        return _Span(self, name, pid, tid, args)

    def begin(self, name: str, *, pid: int = PID_ENGINE, tid: int = 0,
              **args):
        if self.trace:
            self._events.append({
                "name": name, "ph": "B", "pid": pid, "tid": tid,
                "ts": time.perf_counter_ns() / _NS_PER_US, "args": args,
            })

    def end(self, name: str, *, pid: int = PID_ENGINE, tid: int = 0, **args):
        if self.trace:
            self._events.append({
                "name": name, "ph": "E", "pid": pid, "tid": tid,
                "ts": time.perf_counter_ns() / _NS_PER_US, "args": args,
            })

    def instant(self, name: str, *, pid: int = PID_ENGINE, tid: int = 0,
                **args):
        if self.trace:
            self._events.append({
                "name": name, "ph": "i", "s": "t", "pid": pid, "tid": tid,
                "ts": time.perf_counter_ns() / _NS_PER_US, "args": args,
            })

    @property
    def events(self) -> list:
        return self._events

    # -- snapshot/restore (DESIGN.md §13) ------------------------------------
    def dump_values(self) -> dict:
        """JSON-able dump of every instrument's *values* (labels kept as
        [key, value] pair lists) — the engine snapshot's metrics half, so
        counters, TTFT/TPOT histograms, and Prometheus exposition survive
        a crash-consistent restore. Trace events are deliberately not
        serialized: a restored process has a fresh monotonic clock, so old
        span timestamps would be meaningless."""
        return {
            "counters": [[name, [list(kv) for kv in labels], c.value]
                         for (name, labels), c in self._counters.items()],
            "gauges": [[name, [list(kv) for kv in labels], g.value]
                       for (name, labels), g in self._gauges.items()],
            "histograms": [
                [name, [list(kv) for kv in labels],
                 {"buckets": list(h.buckets), "counts": list(h.counts),
                  "overflow": h.overflow, "count": h.count,
                  "total": h.total}]
                for (name, labels), h in self._histograms.items()],
        }

    def load_values(self, dump: dict) -> None:
        """Restore instrument values from ``dump_values()`` output.
        Instruments are created (or updated in place) through the normal
        accessors, so references already held by an engine keep observing
        the restored values."""
        for name, labels, value in dump["counters"]:
            self.counter(name, **dict(tuple(kv) for kv in labels)).value = \
                value
        for name, labels, value in dump["gauges"]:
            self.gauge(name, **dict(tuple(kv) for kv in labels)).value = \
                value
        for name, labels, hv in dump["histograms"]:
            h = self.histogram(name, buckets=tuple(hv["buckets"]),
                               **dict(tuple(kv) for kv in labels))
            if h.buckets != tuple(hv["buckets"]):
                raise ValueError(f"histogram {name!r} bucket mismatch")
            h.counts = list(hv["counts"])
            h.overflow = hv["overflow"]
            h.count = hv["count"]
            h.total = hv["total"]

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        """One JSON-able dict of everything the registry holds."""
        out = {"counters": {}, "gauges": {}, "histograms": {},
               "trace_events": len(self._events)}
        for (name, labels), c in sorted(self._counters.items()):
            out["counters"][name + _format_labels(labels)] = c.value
        for (name, labels), g in sorted(self._gauges.items()):
            out["gauges"][name + _format_labels(labels)] = g.value
        for (name, labels), h in sorted(self._histograms.items()):
            out["histograms"][name + _format_labels(labels)] = h.snapshot()
        return out

    def prometheus_text(self) -> str:
        """Prometheus-style text exposition of every instrument."""
        lines = []
        seen = set()
        for (name, labels), c in sorted(self._counters.items()):
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} counter")
            lines.append(f"{name}{_format_labels(labels)} {c.value}")
        for (name, labels), g in sorted(self._gauges.items()):
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{_format_labels(labels)} {g.value}")
        for (name, labels), h in sorted(self._histograms.items()):
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} histogram")
            cum = 0
            for edge, c in zip(h.buckets, h.counts):
                cum += c
                le = labels + (("le", edge),)
                lines.append(f"{name}_bucket{_format_labels(le)} {cum}")
            inf = labels + (("le", "+Inf"),)
            lines.append(f"{name}_bucket{_format_labels(inf)} {h.count}")
            lines.append(f"{name}_sum{_format_labels(labels)} {h.total}")
            lines.append(f"{name}_count{_format_labels(labels)} {h.count}")
        return "\n".join(lines) + "\n"

    def chrome_trace(self) -> dict:
        """The span timeline as a Chrome-trace/Perfetto JSON object.

        Track-name metadata ("M" events) precede the timeline so Perfetto
        labels the engine and per-request rows; every recorded event keeps
        its original phase ("X" complete spans, matched "B"/"E" pairs,
        "i" instants).
        """
        meta = []
        pids = set()
        for (pid, tid), name in sorted(self._track_names.items()):
            if pid not in pids:
                pids.add(pid)
                meta.append({
                    "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                    "args": {"name": {PID_ENGINE: "engine",
                                      PID_REQUESTS: "requests"}.get(
                                          pid, f"pid{pid}")},
                })
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": name}})
        return {"traceEvents": meta + list(self._events),
                "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


# -- kernel dispatch counters (DESIGN.md §12) --------------------------------

def make_dispatch_sink(registry: MetricsRegistry):
    """The attention wrappers' dispatch hook for ``registry``.

    The sink runs once per wrapper call. Costs are **shape-level**: priced
    at the operands' capacity (a cache's S slots, a block table's width in
    tokens), through ``kernels.costs``.
    """
    from repro_torch.kernels import costs

    def sink(kind: str, *, impl: str, variant: str, kv_dtype: str,
             batch: int, heads: int, heads_kv: int, d_qk: int, d_v: int,
             kv_tokens: int, q_tokens: int, page_size: int = 0):
        layout = "paged" if kind.startswith("paged") else "contiguous"
        labels = {"kind": kind, "impl": impl, "variant": variant,
                  "kv_dtype": kv_dtype, "layout": layout}
        path = costs.impl_path(impl)
        registry.counter("attention_dispatch_total", **labels).inc()
        if kind in ("decode", "paged_decode"):
            per_tok = costs.analytic_bytes_per_ctx_token(
                layout, kv_dtype, path, Hkv=heads_kv, D=d_qk, Dv=d_v,
                page_size=page_size or 1)
            bytes_ = per_tok * kv_tokens * batch
        else:
            per_tok = costs.analytic_bytes_per_chunk_token(
                layout, kv_dtype, path, Hkv=heads_kv, D=d_qk, Dv=d_v,
                ctx=kv_tokens, chunk=max(1, q_tokens),
                page_size=page_size or 1)
            bytes_ = per_tok * max(1, q_tokens) * batch
        flops = costs.analytic_attention_flops(
            max(1, q_tokens), kv_tokens + (q_tokens if "prefill" in kind
                                           or kind == "full" else 0),
            heads=heads, d_qk=d_qk, d_v=d_v) * batch
        registry.counter("attention_dispatch_analytic_bytes",
                         **labels).inc(int(bytes_))
        registry.counter("attention_dispatch_analytic_flops",
                         **labels).inc(int(flops))

    return sink


def install_dispatch_counters(registry: MetricsRegistry | None):
    """Point the attention wrappers' hook at ``registry`` (None uninstalls).

    Process-global and last-install-wins: the hook is a single slot in
    ``kernels.build``, so the disabled check stays one ``is not None``.
    ``ServeEngine`` installs its own sink for the length of each tick and
    puts back the one it found.
    """
    from repro_torch.kernels import build

    build.set_dispatch_sink(
        make_dispatch_sink(registry) if registry is not None else None)

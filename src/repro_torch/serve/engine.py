"""Slot-based serving engine: chunked prefill plus continuous decode
batching over per-slot (contiguous) caches or a paged KV pool, with the
shared-prefix cache, the metrics layer and fault tolerance (the
decoder-only path of ``repro/serve/engine.py``, DESIGN.md §6-§8 and
§11-§13).

A fixed set of ``slots`` shares two model calls:

  prefill tick   every slot contributes up to ``chunk_size`` tokens: the
                 rest of its prompt while prefilling, its current token when
                 decode-ready (a decode is a 1-valid chunk), nothing when
                 idle. The tick that consumes a prompt's last token also
                 samples its first generated token.
  decode tick    when no slot is prefilling, one token for every active
                 slot (with ``chunk_size=1`` it also teacher-forces prompts).

``kv_layout="contiguous"`` (the default, as in ``repro``) gives each slot
its own cache of ``max_len`` slots, or a rolling buffer of
``min(max_len, window)`` for a windowed config; a slot reused by a new
request is masked by its length, never cleared. There is no pool, so no
preemption. ``kv_layout="paged"``: the host-side ``BlockPool`` grows each
slot's block table before the tick, oldest request first. When the pool
cannot cover a growth, the youngest active request is preempted: its
blocks are freed and it is requeued with prompt + generated tokens as its
new prompt (recompute resumption, which leaves temperature-0 streams
unchanged). An explicit ``pool_blocks`` is a byte budget counted in
unquantized blocks: a quantized pool spends the same bytes on
proportionally more blocks. Windowed configs keep absolute positions in
the pool and mask by the window. An encoder-decoder config is refused on
both layouts, as ``repro``'s engine cannot be built for one either: it
serves through ``models.api.encode_for_decode`` and ``decode_step``.

``prefix_cache`` (paged and attention-only; default None = on for the
paged layout of an attention-only pattern, off otherwise: a recurrent
layer's per-slot state cannot be rebuilt from spliced KV pages) indexes
full pages by their whole token prefix as
they are written. Admission splices the longest indexed prefix of a new
prompt into the slot's block table and starts the prefill cursor past it,
trimmed down to the chunk grid, so the remaining chunks tile as a cold
run's would and warm temp-0 streams equal cold ones under ExpMul too. A
write into a shared page (the page straddling a mid-page cursor) copies
it first (``models.api.copy_paged_block``), before the tick's writes.
The pools are updated in place, so a reclaimed cached page is de-indexed,
with its descendants, before it is handed out and rewritten.

Observability (DESIGN.md §12): one ``MetricsRegistry``, shared with the
pool, owns every counter; the engine's counter attributes (``ticks``,
``prompt_tokens``, ...) and ``memory_stats()`` read through it. TTFT/TPOT
are histograms in engine steps, with host-clock ms twins taken from one
timestamp a tick. ``trace=True`` records the request lifecycle (B/E per
request, ``first_token``/``prefix_splice``/``preempt``/``resume``/
``cow_copy`` instants) and one X span per tick, for
``metrics.write_chrome_trace``. Every step is priced through
``kernels.costs`` into ``attention_ledger()``. Tracing off records no
event, and no mode adds a device sync: the one sync a tick is the sampled
tokens' copy to the host. ``dispatch_sink`` is installed as the attention
wrappers' observer (``kernels.build.DISPATCH_SINK``) for the length of each
``tick()`` only, and the one it replaced is put back, so calls made
between ticks, or by another engine, are not counted here.

Fault tolerance (DESIGN.md §13): every request ends with a
``finish_reason`` in ``FINISH_REASONS`` ("length", "deadline",
"cancelled", "failed", "preempt_limit"), counted per reason in
``metrics_snapshot()``. Requests carry optional budgets, ``deadline_steps``
(engine steps from first admission) and ``deadline_s`` (wall clock from
submit), swept by a ``reliability.DeadlineWatchdog`` at the top of every
tick; ``cancel(rid)`` unwinds a request at any stage (queued, mid-prefill,
mid-decode, requeued after a preemption); ``max_preemptions`` finishes a
request evicted that often with "preempt_limit". A sentinel checks each
tick's logits for non-finite values, the flags coming back in the same
host transfer as the sampled tokens: ``nan_guard="quarantine"`` (the
default) fails only the offending request, its pages zeroed, freed and
de-indexed so a corrupted page is never spliced again, while co-resident
temp-0 streams stay those of a fault-free run; ``"strict"`` raises
``NonFiniteLogitsError``; ``"off"`` skips the check. The chaos harness
(``serve/faults.py``) fires at the reference's points in the reference's
order, so one schedule hits the same opportunities in both engines;
``save_snapshot`` / ``serve.snapshot.restore_engine`` carry a mid-flight
engine across a restart.

Compiled ticks (``serve/graphs.py``, the port of ``repro``'s ``jax.jit``
over its tick functions): on a CUDA device each tick function, prefill
and decode, runs as a CUDA graph captured at its first call, over static
input buffers at the engine's fixed ``slots``, ``chunk_size`` and block
table width, its logits a static output. Sampling, the chaos points, the
NaN sentinel, admission, reservation, preemption, copies on write and the
prefix index stay on the host, outside the graphs, as they stay outside
``repro``'s ``jit``. ``eager_ticks=True`` runs the ticks eagerly on the
same buffers (the counterpart of ``jax.disable_jit()``); the CPU always
does. The ``plain`` route reads the longest length on the host, which a
capture cannot take, so an engine whose ticks run it needs
``eager_ticks`` on the card; every other route (the kernels, the gather
routes, the reference's one-pass XLA routes) reads no host value and is
captured.

Attention routes: the engine resolves its ``kernels.registry.
AttentionSpec`` once, checks every name it will dispatch, and logs the
non-obvious rows of ``resolved_backends`` once at start (a declared
fallback, ``pallas`` -> ``kernel``, or the plain versions a kernel route
runs without a card). The ``attention_exec_*`` ledger is keyed by the
route of each tick kind (the paged table's on the paged layout, else the
prefill and decode tables'), labelled as the dispatch counters label it:
"kernel" or "plain" for the port's own routes.
Every path keeps the addresses the graphs hold: the state is updated in
place, and a restore copies into it.
"""
from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from repro_torch.configs.base import ATTENTION_IMPLS
from repro_torch.kernels import build
from repro_torch.kernels.costs import (
    analytic_attention_flops,
    analytic_bytes_per_chunk_token,
    analytic_bytes_per_ctx_token,
    attn_kv_geometry,
    impl_path,
)
from repro_torch.kernels.registry import (
    AttentionSpec,
    check_spec,
    resolved_backends,
    route_label,
)
from repro_torch.models.api import (
    copy_paged_block,
    decode_step,
    decode_step_paged,
    init_decode_state,
    init_paged_state,
    poison_paged_block,
    prefill,
    prefill_paged,
    resolve_device,
)
from repro_torch.numerics.quant import KV_DTYPES
from repro_torch.reliability import DeadlineWatchdog
from repro_torch.serve.faults import fault_point
from repro_torch.serve.metrics import (
    MS_BUCKETS,
    PID_ENGINE,
    PID_REQUESTS,
    MetricsRegistry,
    make_dispatch_sink,
)
from repro_torch.serve.graphs import TickGraph
from repro_torch.serve.paged import BlockPool, blocks_for, kv_token_bytes
from repro_torch.serve.sampling import row_seed, sample_tokens

logger = logging.getLogger("repro_torch.serve")

# terminal request states (DESIGN.md §13): every finished request carries
# exactly one, and metrics_snapshot()["finish_reasons"] counts each
FINISH_REASONS = ("length", "deadline", "cancelled", "failed",
                  "preempt_limit")

# nan_guard modes: quarantine the offending request (default), raise on
# the first fault, or skip the sentinel
NAN_GUARDS = ("quarantine", "strict", "off")


class NonFiniteLogitsError(RuntimeError):
    """Raised by ``nan_guard="strict"`` when a tick produces non-finite
    logits (or an out-of-range sampled token) for an active request."""


# the backend-resolution lines logged in this process (once a distinct
# line, not once an engine)
_LOGGED_BACKENDS: set[str] = set()


def _log_resolved_backends(spec, paged: bool):
    """One line at start for each table whose route is not what it says:
    a declared fallback (``pallas`` runs ``kernel``) or a note (no card:
    a kernel route runs its plain version on CPU tensors)."""
    for row in resolved_backends(spec, paged=paged):
        if not (row["fallback"] or row["note"]):
            continue
        msg = f"attention {row['kind']}: requested {row['requested']!r}"
        if row["fallback"]:
            msg += f" -> runs {row['resolved']!r}"
        if row["note"]:
            msg += f" [{row['note']}]"
        if msg not in _LOGGED_BACKENDS:
            _LOGGED_BACKENDS.add(msg)
            logger.info(msg)


def stream_match_rate(ref_streams, streams) -> float:
    """Token-level exact-match rate across paired temp-0 streams (the
    quantized-KV fidelity metric, DESIGN.md §8): the mean over pairs of
    the share of positions where the two agree (1.0 for an empty
    stream), as ``repro``'s."""
    return float(np.mean([
        np.mean([a == b for a, b in zip(x, y)]) if len(x) else 1.0
        for x, y in zip(ref_streams, streams)
    ]))


def analytic_prefill_flops(cfg, start: int, end: int) -> int:
    """Analytic decoder FLOPs to prefill positions [start, end) on top of a
    resident ``start``-token prefix: 2·params per token for the linear path
    (the active parameters: ``top_k`` experts of an MoE layer, as ``repro``
    prices them)
    plus 4·H·hd per (query, key) causal pair and attention layer for
    scores + weighted sum —
    what a prefix-cache hit skips (``prefill_flops_skipped``). An MLA
    config's pair is priced as ``repro`` prices it, at hd =
    ``resolved_head_dim()`` (64 for minicpm3-4b), not at its qk 96 + v 64,
    so that the two ledgers agree (ROADMAP C)."""
    n = max(0, end - start)
    if n == 0:
        return 0
    flops = 2 * cfg.active_param_count() * n
    span = (end * (end + 1) - start * (start + 1)) // 2
    flops += (4 * cfg.num_heads * cfg.resolved_head_dim()
              * cfg.pattern_for().count("attn") * span)
    return int(flops)


def validate_kv_dtype(cfg, kv_dtype: str | None = None) -> str:
    """The KV dtype to serve ``cfg`` at (``cfg.kv_dtype`` when None). A
    quantized dtype needs an attention-only decoder: a recurrent layer's
    state is not a KV cache, nor are an encoder-decoder's cross K/V, and
    either would bypass quantization silently, so both are refused, as
    ``repro`` refuses them."""
    kv_dtype = kv_dtype or cfg.kv_dtype
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}; choose one of "
                         f"{KV_DTYPES}")
    rec = sorted(set(cfg.block_pattern) - {"attn"})
    if kv_dtype != "fp32" and rec:
        raise ValueError(
            f"kv_dtype={kv_dtype!r} requires an attention-only block "
            f"pattern, but {cfg.name!r} mixes in {rec} blocks whose "
            f"recurrent state is not a KV cache and would silently bypass "
            f"quantization; serve this arch with kv_dtype='fp32'")
    if kv_dtype != "fp32" and cfg.encoder_layers:
        raise ValueError(
            f"kv_dtype={kv_dtype!r} targets decoder-only configs; "
            f"{cfg.name!r} is encoder-decoder and its cross-attention K/V "
            f"are recomputed activations, not a cache — serve it with "
            f"kv_dtype='fp32'")
    return kv_dtype


def _recurrent_state(state, cfg) -> list:
    """The per-slot state tensors of the recurrent layers (RG-LRU's ``h``,
    ``conv``; mLSTM's ``C``, ``n``, ``m``; sLSTM's ``c``, ``n``, ``h``,
    ``m``), first axis the slot."""
    return [leaf for cache, kind in zip(state["caches"], cfg.pattern_for())
            if kind != "attn" for leaf in cache.values()]


def _tick_fns(params, state, cfg, page_size):
    """The (prefill, decode) tick functions a ``TickGraph`` runs, on the
    paged pools when ``page_size`` is given: logits only, the state being
    updated in place. They hold the tensors, not the engine, so an engine
    dropped by its caller frees its graphs and caches at once."""
    if page_size is None:
        return (lambda tokens, lengths, n_valid: prefill(
                    params, state, tokens, lengths, n_valid, cfg)[0],
                lambda tokens, lengths: decode_step(
                    params, state, tokens, lengths, cfg)[0])
    return (lambda tokens, lengths, n_valid, tables: prefill_paged(
                params, state, tokens, lengths, n_valid, tables, cfg,
                page_size=page_size)[0],
            lambda tokens, lengths, tables: decode_step_paged(
                params, state, tokens, lengths, tables, cfg,
                page_size=page_size)[0])


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: str | None = None   # one of FINISH_REASONS once done
    deadline_steps: int | None = None  # engine-step budget from admission
    deadline_s: float | None = None    # wall-clock budget from submit
    submit_time: float | None = None       # host clock at submit()
    first_token_time: float | None = None  # host clock when out[0] arrived
    pos: int = 0            # prefill cursor into ``prefill_toks``
    first_token_step: int | None = None  # engine step that produced out[0]
    preemptions: int = 0    # times this request was evicted and requeued
    admit_order: int = -1   # admission sequence number (victim selection)
    # teacher-forced prefix: the prompt, extended with already-generated
    # tokens after a preemption (recompute resumption)
    prefill_toks: list = dataclasses.field(default_factory=list)
    admit_step: int | None = None  # engine step of first admission (TTFT base)
    admit_time: float | None = None   # tick timestamp of first admission
    last_token_step: int | None = None  # engine step of latest sample (TPOT)
    last_token_time: float | None = None
    prefix_hit: int = 0     # tokens skipped via prefix-cache hits (cumulative)
    registered_blocks: int = 0  # full pages of this slot already indexed


class ServeEngine:
    def __init__(self, params, cfg, *, slots: int = 8, max_len: int = 512,
                 chunk_size: int = 64, temperature: float = 0.0,
                 seed: int = 0, kv_layout: str = "contiguous",
                 page_size: int | None = None,
                 pool_blocks: int | None = None,
                 kv_dtype: str | None = None,
                 attention_impl: str | None = None,
                 prefix_cache: bool | None = None,
                 metrics: MetricsRegistry | None = None,
                 trace: bool = False,
                 nan_guard: str = "quarantine",
                 deadline_steps: int | None = None,
                 deadline_s: float | None = None,
                 max_preemptions: int | None = None,
                 eager_ticks: bool = False,
                 device="cuda"):
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"kv_layout must be 'contiguous' or 'paged', "
                             f"got {kv_layout!r}")
        if nan_guard not in NAN_GUARDS:
            raise ValueError(f"nan_guard must be one of {NAN_GUARDS}, "
                             f"got {nan_guard!r}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2 (one prompt token plus "
                             f"one generated), got {max_len}")
        if int(chunk_size) < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if max_preemptions is not None and max_preemptions < 0:
            raise ValueError(
                f"max_preemptions must be >= 0, got {max_preemptions}")
        # the registry owns every serving counter; ``trace`` gates span and
        # event recording only
        self.metrics = metrics if metrics is not None else MetricsRegistry(
            trace=trace)
        kv_dtype = validate_kv_dtype(cfg, kv_dtype)
        self.kv_dtype = kv_dtype
        cfg = cfg.replace(kv_dtype=kv_dtype)
        if attention_impl is not None:
            cfg = cfg.replace(attention_impl=attention_impl)
        if cfg.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of "
                             f"{ATTENTION_IMPLS}, got {cfg.attention_impl!r}")
        self.attention_impl = cfg.attention_impl
        paged = kv_layout == "paged"
        spec = AttentionSpec.from_config(cfg)
        check_spec(spec, paged=paged)
        _log_resolved_backends(spec, paged)
        self.device = resolve_device(device)
        self.eager_ticks = bool(eager_ticks) or self.device.type != "cuda"
        plain = [row["kind"] for row in resolved_backends(spec, paged=paged)
                 if row["kind"] != "full-sequence"
                 and row["resolved"].removesuffix("_q") == "plain"]
        if not self.eager_ticks and plain:
            raise ValueError(
                f"attention_impl='plain' reads the longest length on the "
                f"host, which a CUDA graph cannot capture (the {plain} "
                f"tables run it): pass eager_ticks=True to serve it on the "
                f"card")
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.chunk_size = int(chunk_size)
        self.temperature = temperature
        self.seed = seed
        self.kv_layout = kv_layout
        self.paged = kv_layout == "paged"
        # shared-prefix caching needs paged physical blocks to splice, and
        # an attention-only pattern: a hit would skip the prefill a
        # recurrent layer's per-slot state still needs
        attn_only = (set(cfg.block_pattern) == {"attn"}
                     and not cfg.encoder_layers)
        if prefix_cache:
            if not self.paged:
                raise ValueError(
                    "prefix_cache=True requires kv_layout='paged': the "
                    "contiguous layout has no shared physical blocks to "
                    "dedupe — serve with kv_layout='paged' or drop the flag")
            if not attn_only:
                rec = sorted(set(cfg.block_pattern) - {"attn"})
                raise ValueError(
                    f"prefix_cache=True requires an attention-only block "
                    f"pattern, but {cfg.name!r} mixes in {rec} blocks whose "
                    f"recurrent state cannot be reconstructed from spliced "
                    f"KV pages; serve this arch with prefix_cache=False")
        self.prefix_cache = (bool(prefix_cache) if prefix_cache is not None
                             else self.paged and attn_only)
        if cfg.encoder_layers:
            # repro's engine fails here too (its contiguous state needs an
            # enc_len, its paged state refuses an encoder-decoder)
            raise NotImplementedError(
                f"ServeEngine serves decoder-only configs; {cfg.name!r} is "
                f"encoder-decoder: serve it through init_decode_state("
                f"enc_len=), encode_for_decode and decode_step")
        # bytes per resident token over every layer (codes + scale rows for
        # quantized dtypes): the unit of every *_bytes stat
        self.token_bytes = kv_token_bytes(cfg)
        if self.paged:
            ps = int(page_size or cfg.page_size)
            max_blocks = blocks_for(max_len, ps)
            requested = int(pool_blocks or cfg.pool_blocks or 0)
            if requested:
                # an unquantized-equivalent byte budget (DESIGN.md §8)
                n_pool = max(1, requested * kv_token_bytes(cfg, "fp32")
                             // self.token_bytes)
            else:
                n_pool = slots * max_blocks  # fully provisioned
            self.page_size = ps
            self.pool = BlockPool(n_pool, ps, slots, max_blocks,
                                  token_bytes=self.token_bytes,
                                  prefix_cache=self.prefix_cache,
                                  metrics=self.metrics)
            self.state = init_paged_state(cfg, slots, n_pool, ps,
                                          device=self.device)
        else:
            self.page_size = 0
            self.pool = None
            self.state = init_decode_state(cfg, slots, max_len,
                                           device=self.device)
        self.lengths = np.zeros((slots,), np.int32)
        self.cur_tok = np.zeros((slots,), np.int32)
        # the tick functions over static input buffers (serve/graphs.py)
        capture = not self.eager_ticks
        gpool = torch.cuda.graph_pool_handle() if capture else None
        tables = ({"tables": self.pool.tables.shape} if self.paged else {})
        # a recurrent layer's per-slot state, which every admission zeroes
        # and a capture's warm-up must not advance
        self._recurrent = _recurrent_state(self.state, cfg)
        prefill_fn, decode_fn = _tick_fns(
            params, self.state, cfg, self.page_size if self.paged else None)
        self._prefill_graph = TickGraph(
            prefill_fn, {"tokens": (slots, self.chunk_size),
                         "lengths": (slots,), "n_valid": (slots,), **tables},
            self.device, capture=capture, pool=gpool, warm_zero=("n_valid",),
            keep=self._recurrent)
        self._decode_graph = TickGraph(
            decode_fn, {"tokens": (slots,), "lengths": (slots,), **tables},
            self.device, capture=capture, pool=gpool, keep=self._recurrent)
        self.requests: list[Request | None] = [None] * slots
        self.queue: list[Request] = []
        self._admit_seq = 0
        self._next_rid = 0
        self._rids: set = set()
        # per-request budgets, swept at the top of every tick; the defaults
        # apply to submits that do not give their own
        self.nan_guard = nan_guard
        self.default_deadline_steps = deadline_steps
        self.default_deadline_s = deadline_s
        self.max_preemptions = max_preemptions
        self.deadlines = DeadlineWatchdog()
        m = self.metrics
        self._c_ticks = m.counter("serve_steps_total")
        self._c_prefill_steps = m.counter("serve_prefill_steps_total")
        self._c_decode_steps = m.counter("serve_decode_steps_total")
        self._c_prompt_tokens = m.counter("serve_prompt_tokens_total")
        self._c_recompute = m.counter("serve_recompute_tokens_total")
        self._c_generated = m.counter("serve_tokens_generated_total")
        self._c_preemptions = m.counter("serve_preemptions_total")
        self._c_hit_tokens = m.counter("serve_prefix_hit_tokens_total")
        self._c_flops_skipped = m.counter("serve_prefill_flops_skipped_total")
        self._c_submitted = m.counter("serve_requests_submitted_total")
        self._c_finished = m.counter("serve_requests_finished_total")
        self._c_reason = {
            reason: m.counter("serve_finish_reasons_total", reason=reason)
            for reason in FINISH_REASONS
        }
        self._c_quarantined = m.counter("serve_requests_quarantined_total")
        self._g_peak_active = m.gauge("serve_peak_active_tokens")
        self._g_peak_kv = m.gauge("serve_peak_kv_used_tokens")
        self._g_queue = m.gauge("serve_queue_depth")
        # TTFT/TPOT in engine steps (exact), with host-clock ms twins
        self._h_ttft_steps = m.histogram("serve_ttft_steps")
        self._h_tpot_steps = m.histogram("serve_tpot_steps")
        self._h_ttft_ms = m.histogram("serve_ttft_ms", buckets=MS_BUCKETS)
        self._h_tpot_ms = m.histogram("serve_tpot_ms", buckets=MS_BUCKETS)
        self._now = 0.0  # host timestamp taken once per tick
        m.name_track(PID_ENGINE, 0, "engine steps")
        # executed-cost ledger: each step priced at its actual host-side
        # lengths, keyed by the route each tick kind dispatches
        self._geom = g = attn_kv_geometry(cfg)
        layout = "paged" if self.paged else "contiguous"
        self._exec = {}
        for kind in ("prefill", "decode"):
            if self.paged:
                table, name = f"paged {kind}", spec.resolved_paged_impl()
            else:
                table = kind
                name = getattr(spec, f"resolved_{kind}_impl")()
            impl = route_label(table, name)
            labels = {"kind": kind, "impl": impl,
                      "variant": cfg.attention_variant,
                      "kv_dtype": self.kv_dtype, "layout": layout}
            self._exec[kind] = {
                "impl": impl,
                "path": impl_path(impl),
                "calls": m.counter("attention_exec_calls_total", **labels),
                "steps": m.counter("attention_exec_steps_total", **labels),
                "tokens": m.counter("attention_exec_kv_tokens_total",
                                    **labels),
                "bytes": m.counter("attention_exec_analytic_bytes",
                                   **labels),
                "flops": m.counter("attention_exec_analytic_flops",
                                   **labels),
            }
        self._decode_bytes_per_ctx_token = analytic_bytes_per_ctx_token(
            layout, self.kv_dtype, self._exec["decode"]["path"],
            Hkv=g["Hkv"], D=g["D"], Dv=g["Dv"],
            page_size=self.page_size or 1)
        # the attention wrappers' observer while this engine ticks (None:
        # the wrappers count nothing)
        self.dispatch_sink = make_dispatch_sink(self.metrics)
        # the constructor's record: serve/snapshot.py rebuilds an engine of
        # the same shape from exactly these arguments
        self._ctor = {
            "slots": slots, "max_len": max_len,
            "chunk_size": self.chunk_size, "temperature": temperature,
            "seed": seed, "kv_layout": kv_layout,
            "page_size": page_size, "pool_blocks": pool_blocks,
            "kv_dtype": self.kv_dtype, "attention_impl": attention_impl,
            "prefix_cache": self.prefix_cache, "nan_guard": nan_guard,
            "deadline_steps": deadline_steps, "deadline_s": deadline_s,
            "max_preemptions": max_preemptions,
        }

    # -- request lifecycle --------------------------------------------------
    def submit(self, prompt, max_new: int, rid: int | None = None, *,
               deadline_steps: int | None = None,
               deadline_s: float | None = None) -> Request:
        """Queue a request; raises ValueError on an empty or oversized
        prompt, ``max_new < 1``, a budget below its floor or a duplicate
        ``rid``. ``deadline_steps`` bounds engine steps from first
        admission, ``deadline_s`` wall-clock seconds from this call (None
        takes the engine's default); an expired request finishes with
        ``finish_reason="deadline"`` and the tokens it produced."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt: a request needs at least one "
                             "token to produce logits")
        if len(prompt) > self.max_len - 1:
            raise ValueError(f"prompt length {len(prompt)} exceeds max_len "
                             f"- 1 = {self.max_len - 1}")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        deadline_steps = (deadline_steps if deadline_steps is not None
                          else self.default_deadline_steps)
        deadline_s = (deadline_s if deadline_s is not None
                      else self.default_deadline_s)
        if deadline_steps is not None and deadline_steps < 1:
            raise ValueError(
                f"deadline_steps must be >= 1, got {deadline_steps}")
        if deadline_s is not None and deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
        if rid is None:
            rid = self._next_rid
        elif rid in self._rids:
            raise ValueError(f"duplicate rid {rid}")
        self._rids.add(rid)
        self._next_rid = max(self._next_rid, rid + 1)
        req = Request(rid, prompt, max_new, prefill_toks=list(prompt),
                      deadline_steps=deadline_steps, deadline_s=deadline_s,
                      submit_time=time.perf_counter())
        if deadline_s is not None:
            self.deadlines.arm(rid, wall_budget=deadline_s,
                               wall_base=req.submit_time)
        self.queue.append(req)
        self._c_submitted.inc()
        self._g_queue.set(len(self.queue))
        return req

    def cancel(self, rid: int) -> bool:
        """Cancel a request wherever it is: queued, mid-prefill, mid-decode,
        or requeued after a preemption. An active slot is unwound through
        the refcounted pool (its completed full pages are indexed first:
        their content is valid). Returns False when ``rid`` is not live
        (unknown, or already finished)."""
        return self._terminate(rid, "cancelled")

    def _terminate(self, rid: int, reason: str) -> bool:
        """Move a live request to a terminal state (cancel / deadline)."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                self.queue.pop(i)
                self._g_queue.set(len(self.queue))
                self._finalize_request(req, reason)
                if self.metrics.trace and req.admit_step is not None:
                    self.metrics.end(f"req {req.rid}", pid=PID_REQUESTS,
                                     tid=req.rid, step=self.ticks,
                                     tokens=len(req.out), reason=reason)
                return True
        for s in range(self.slots):
            req = self.requests[s]
            if req is not None and req.rid == rid:
                self._release_slot(s, reason)
                return True
        return False

    def _finalize_request(self, req: Request, reason: str):
        """Terminal-state bookkeeping shared by every finish path."""
        req.done = True
        req.finish_reason = reason
        self.deadlines.disarm(req.rid)
        self._c_finished.inc()
        self._c_reason[reason].inc()

    def _release_slot(self, s: int, reason: str):
        """Finish the request in slot ``s`` with ``reason`` and free the
        slot. A valid terminal state indexes the slot's completed full
        pages first (their KV is valid, a cancelled or expired request
        still did real work); a quarantine (``"failed"``) zeroes the pages
        the slot alone holds, then de-indexes and frees every one, so
        suspect content is never spliced again."""
        req = self.requests[s]
        self._finalize_request(req, reason)
        self.requests[s] = None
        if self.metrics.trace:
            self.metrics.end(f"req {req.rid}", pid=PID_REQUESTS,
                             tid=req.rid, step=self.ticks,
                             tokens=len(req.out),
                             preemptions=req.preemptions, reason=reason)
        if self.paged:
            if reason == "failed":
                self._c_quarantined.inc()
                self._scrub_slot(s)
                self.pool.quarantine_slot(s)
            else:
                if self.prefix_cache:
                    self._register_full_pages(s, req)
                self.pool.free_slot(s)

    def _expire_deadlines(self):
        """Sweep the deadline watchdog (top of every tick): expired
        requests finish with ``finish_reason="deadline"`` and their slots
        free at once, so an over-budget request never pins pool blocks or a
        batch slot."""
        for rid in self.deadlines.expired(self.ticks, self._now):
            self._terminate(rid, "deadline")

    # -- counter attributes: read-through registry views ---------------------
    @property
    def ticks(self) -> int:
        """Total engine steps (prefill + decode)."""
        return self._c_ticks.value

    @property
    def prefill_steps(self) -> int:
        return self._c_prefill_steps.value

    @property
    def decode_steps(self) -> int:
        return self._c_decode_steps.value

    @property
    def prompt_tokens(self) -> int:
        """Prompt tokens absorbed by prefill."""
        return self._c_prompt_tokens.value

    @property
    def recompute_tokens(self) -> int:
        """Generated tokens re-prefilled after a preemption."""
        return self._c_recompute.value

    @property
    def tokens_generated(self) -> int:
        return self._c_generated.value

    @property
    def preemptions(self) -> int:
        return self._c_preemptions.value

    @property
    def prefix_hit_tokens(self) -> int:
        """Prompt tokens skipped via prefix-cache hits."""
        return self._c_hit_tokens.value

    @property
    def prefill_flops_skipped(self) -> int:
        """Analytic FLOPs those hit tokens would have cost."""
        return self._c_flops_skipped.value

    @property
    def peak_active_tokens(self) -> int:
        """Max over ticks of sum(active lengths)."""
        return self._g_peak_active.value

    @property
    def peak_kv_used_tokens(self) -> int:
        """Max over ticks of resident KV tokens."""
        return self._g_peak_kv.value

    def _prefix_hit(self, req: Request):
        """Longest indexed full-page prefix of the teacher-forced tokens,
        trimmed to the chunk grid (DESIGN.md §11).

        Every prefill starts at position 0 and absorbs ``chunk_size``
        tokens a tick, so a cold run's chunks lie on one grid; aligning the
        cursor down to it keeps the warm chunks, and the tiles the kernels
        walk over them, those of the cold run. The cursor is also capped at
        len-1 so one position remains to produce the first sampled token's
        logits. The kept blocks are those covering the cursor: a block
        straddling it stays spliced (its head rows are live context) and is
        copied on its first write.

        Returns (blocks_to_splice, cursor_tokens).
        """
        blocks = self.pool.match_prefix(req.prefill_toks)
        if not blocks:
            return [], 0
        grid = self.chunk_size if self.chunk_size > 1 else 1
        cursor = min(len(blocks) * self.page_size, len(req.prefill_toks) - 1)
        cursor = cursor // grid * grid
        if cursor <= 0:
            return [], 0
        return blocks[:blocks_for(cursor, self.page_size)], cursor

    def _admit(self):
        for s in range(self.slots):
            if self.requests[s] is not None or not self.queue:
                continue
            req = self.queue[0]
            if fault_point("admission", rid=req.rid, slot=s):
                # a dropped admission (chaos): the head stays queued and is
                # retried next tick, which delays it and changes nothing
                # else (sampling seeds do not depend on the schedule)
                break
            hit_blocks, cursor = ([], 0)
            if self.prefix_cache:
                hit_blocks, cursor = self._prefix_hit(req)
            take = (min(self.chunk_size, len(req.prefill_toks) - cursor)
                    if self.chunk_size > 1 else 1)
            if self.paged and not self.pool.can_admit(hit_blocks,
                                                      cursor + take):
                if self.pool.used_blocks == 0 and not any(
                        r is not None for r in self.requests):
                    raise RuntimeError(
                        f"KV pool too small: request {req.rid} needs "
                        f"{cursor + take} tokens for its first chunk but the "
                        f"whole pool holds "
                        f"{self.pool.pool_blocks * self.page_size}; raise "
                        f"pool_blocks")
                break  # pool too tight right now; retry as blocks free
            self.queue.pop(0)
            if req.admit_order < 0:
                # seniority survives preemption, so two requests that do not
                # fit together cannot evict each other forever
                req.admit_order = self._admit_seq
                self._admit_seq += 1
            self.requests[s] = req
            if req.admit_step is None:
                req.admit_step = self.ticks
                req.admit_time = self._now
                if req.deadline_steps is not None:
                    # the step budget starts at first admission (the wall
                    # budget, armed at submit, covers the queue wait)
                    self.deadlines.arm(req.rid,
                                       step_budget=req.deadline_steps,
                                       step_base=self.ticks)
                if self.metrics.trace:
                    self.metrics.name_track(PID_REQUESTS, req.rid,
                                            f"req {req.rid}")
                    self.metrics.begin(
                        f"req {req.rid}", pid=PID_REQUESTS, tid=req.rid,
                        step=self.ticks, prompt=len(req.prompt),
                        max_new=req.max_new)
            elif self.metrics.trace:
                self.metrics.instant(
                    "resume", pid=PID_REQUESTS, tid=req.rid, step=self.ticks,
                    recompute=len(req.prefill_toks) - len(req.prompt))
            if hit_blocks:
                self.pool.splice(s, hit_blocks)
                req.prefix_hit += cursor
                self._c_hit_tokens.inc(cursor)
                self._c_flops_skipped.inc(
                    analytic_prefill_flops(self.cfg, 0, cursor))
                if self.metrics.trace:
                    self.metrics.instant(
                        "prefix_splice", pid=PID_REQUESTS, tid=req.rid,
                        step=self.ticks, hit_tokens=cursor,
                        blocks=len(hit_blocks))
            req.registered_blocks = len(hit_blocks)
            req.pos = cursor
            self.lengths[s] = cursor
            self.cur_tok[s] = req.prefill_toks[cursor]
            # attention caches are masked by the length; recurrent state
            # needs a true reset
            self._reset_slot_state(s)

    def _reset_slot_state(self, s):
        """Zero slot ``s`` of every recurrent layer's state, in place: the
        graphs read these very tensors. The xLSTM stabilizers ``m`` are
        zeroed too, not put back to a fresh state's -1e30, as
        ``repro``'s reset (``repro/serve/engine.py:770-783``) does: the
        stabilizer cancels except in the clamps ``max(|n.q|, 1)`` and
        ``max(n, 1)``, so an admitted request's stream follows the
        reference engine's, not greedy decoding by ``forward``."""
        for leaf in self._recurrent:
            leaf[s].zero_()

    def _finish_or_continue(self, s, tok):
        """Record a sampled token for slot s; free the slot when done.

        TTFT in engine steps is first_token_step - admit_step + 1; TPOT is
        the step gap between consecutive samples of one request (the gap
        after a preemption spans the requeue). The ms twins reuse the tick's
        one host timestamp."""
        req = self.requests[s]
        if req.first_token_step is None:
            req.first_token_step = self.ticks
            req.first_token_time = time.perf_counter()
            self._h_ttft_steps.record(req.first_token_step
                                      - req.admit_step + 1)
            if req.admit_time is not None:   # None across a restore
                self._h_ttft_ms.record((self._now - req.admit_time) * 1e3)
            if self.metrics.trace:
                self.metrics.instant("first_token", pid=PID_REQUESTS,
                                     tid=req.rid, step=self.ticks)
        else:
            self._h_tpot_steps.record(self.ticks - req.last_token_step)
            if req.last_token_time is not None:
                self._h_tpot_ms.record(
                    (self._now - req.last_token_time) * 1e3)
        req.last_token_step = self.ticks
        req.last_token_time = self._now
        req.out.append(tok)
        self.cur_tok[s] = tok
        self._c_generated.inc()
        if len(req.out) >= req.max_new or self.lengths[s] >= self.max_len - 1:
            self._release_slot(s, "length")

    # -- paged capacity management ------------------------------------------
    def _preempt(self, s):
        """Evict slot s and requeue its request for recompute resumption.
        Its completed pages are indexed first: they land in the cached
        tier, so unless the preemptor reclaims them the victim resumes
        through a prefix hit. With ``max_preemptions`` set, a request
        already evicted that many times finishes with
        ``finish_reason="preempt_limit"`` instead; its blocks free all the
        same, so the caller's capacity retry proceeds."""
        req = self.requests[s]
        if (self.max_preemptions is not None
                and req.preemptions >= self.max_preemptions):
            self._release_slot(s, "preempt_limit")
            return
        if self.prefix_cache:
            self._register_full_pages(s, req)
        self.pool.evict_slot(s)
        self.requests[s] = None
        self.lengths[s] = 0
        req.prefill_toks = list(req.prompt) + list(req.out)
        req.pos = 0
        req.preemptions += 1
        self._c_preemptions.inc()
        if self.metrics.trace:
            self.metrics.instant("preempt", pid=PID_REQUESTS, tid=req.rid,
                                 step=self.ticks,
                                 tokens=len(req.prefill_toks))
        self.queue.insert(0, req)  # resumes as soon as space frees up
        self._g_queue.set(len(self.queue))

    def _pick_victim(self, exclude):
        """Youngest active request (latest admitted) other than ``exclude``."""
        best = None
        for s in range(self.slots):
            if s == exclude or self.requests[s] is None:
                continue
            if best is None or (self.requests[s].admit_order
                                > self.requests[best].admit_order):
                best = s
        return best

    def _take_for(self, s) -> int:
        req = self.requests[s]
        if self.chunk_size > 1 and req.pos < len(req.prefill_toks):
            return min(self.chunk_size, len(req.prefill_toks) - req.pos)
        return 1

    def _cow_shared_tail(self, s):
        """Copy-on-write before this tick's writes to slot ``s``.

        Writes append at ``lengths[s]``; the only block that can be both
        shared and written is the one straddling a mid-page cursor, a
        spliced hit block whose tail rows this slot is about to overwrite
        (fresh blocks are private, and a block this slot registered is
        full and never written again). The pool hands out a private
        replacement and the page is copied on the device here, in place,
        before the tick builds its write plan; the original keeps its
        index entry and its other references."""
        off = int(self.lengths[s])
        if off % self.page_size == 0:
            return
        idx = off // self.page_size
        if not self.pool.is_shared(int(self.pool.tables[s, idx])):
            return
        while True:
            pair = self.pool.cow_block(s, idx)
            if pair is not None:
                break
            victim = self._pick_victim(exclude=s)
            if victim is None:
                raise RuntimeError(
                    f"KV pool exhausted: slot {s} needs a copy-on-write "
                    f"block (pool={self.pool.pool_blocks}) with no one "
                    f"left to evict; raise pool_blocks")
            self._preempt(victim)
        src, dst = pair
        copy_paged_block(self.state, self.cfg, src, dst,
                         page_size=self.page_size)
        if self.metrics.trace:
            self.metrics.instant("cow_copy", pid=PID_REQUESTS,
                                 tid=self.requests[s].rid, step=self.ticks,
                                 src=src, dst=dst)

    def _reserve(self, active):
        """Grow block tables for this tick's writes, oldest request first;
        preempt youngest-first when the pool is exhausted (the pool itself
        reclaims cached blocks LRU-first before that). Returns the
        surviving active slots."""
        for s in sorted(active, key=lambda s: self.requests[s].admit_order):
            if self.requests[s] is None:
                continue  # preempted by an older request's reservation
            if self.prefix_cache:
                self._cow_shared_tail(s)
            if self.requests[s] is None:
                continue
            target = int(self.lengths[s]) + self._take_for(s)
            while not self.pool.alloc(s, target):
                victim = self._pick_victim(exclude=s)
                if victim is None:
                    raise RuntimeError(
                        f"KV pool exhausted: slot {s} needs {target} tokens "
                        f"({blocks_for(target, self.page_size)} blocks, "
                        f"pool={self.pool.pool_blocks}) with no one left "
                        f"to evict; raise pool_blocks")
                self._preempt(victim)
        return [s for s in range(self.slots) if self.requests[s] is not None]

    def _register_full_pages(self, s, req: Request):
        """Index newly completed full pages of slot ``s`` for future prefix
        hits. Page i's key is (physical id of page i-1, its tokens), so it
        covers the whole prefix the page's KV depends on. The token at
        position p is (prompt + out)[p]: after a preemption
        ``prefill_toks`` is prompt + out-so-far and sampling keeps
        appending to ``out``."""
        ps = self.page_size
        full = int(self.lengths[s]) // ps
        if full <= req.registered_blocks:
            return
        seq = req.prompt + req.out
        for i in range(req.registered_blocks, full):
            parent = int(self.pool.tables[s, i - 1]) if i else -1
            self.pool.register_block(int(self.pool.tables[s, i]), parent,
                                     seq[i * ps:(i + 1) * ps])
        req.registered_blocks = full

    def _register_active_pages(self):
        for s in range(self.slots):
            if self.requests[s] is not None:
                self._register_full_pages(s, self.requests[s])

    # -- engine steps -------------------------------------------------------
    def _tables(self) -> dict:
        return {"tables": self.pool.tables} if self.paged else {}

    def graph_stats(self) -> dict:
        """Per tick kind: whether its graph was captured, its replays, the
        warm-up and capture wall ms, the bytes its capture added to the
        engine's graph pool and its launches a replay."""
        return {"prefill": self._prefill_graph.stats(),
                "decode": self._decode_graph.stats()}

    def _sample(self, logits):
        """(tokens, finite) on the host: the sampled token of every slot and
        whether its logits row is all finite, brought back in one transfer
        (the tick's one sync). A non-finite row samples from zeros
        instead at temperature > 0, as a NaN probability has no draw; its
        token is discarded by the sentinel (or kept under
        ``nan_guard="off"``)."""
        seeds = [self.seed if r is None else
                 row_seed(self.seed, r.admit_order, len(r.out))
                 for r in self.requests]
        finite = torch.isfinite(logits).all(dim=-1)
        if self.temperature > 0.0:
            logits = torch.where(finite[:, None], logits,
                                 torch.zeros_like(logits))
        nxt = sample_tokens(seeds, logits, temperature=self.temperature)
        host = torch.stack([nxt, finite.to(nxt.dtype)]).cpu().numpy()
        return host[0], host[1].astype(bool)

    # -- fault paths (DESIGN.md §13) -----------------------------------------
    def _corrupt_kv(self, s):
        """kv_corrupt chaos: poison the last physical page holding slot
        ``s``'s resident KV (``models.api.poison_paged_block``). The slot's
        next attention reads the page, and its rows past the length reach
        the output too (weight 0 times NaN is NaN in the value product), so
        the slot's logits go non-finite, which the sentinel must catch."""
        idx = max(0, (int(self.lengths[s]) - 1) // self.page_size)
        poison_paged_block(self.state, self.cfg, int(self.pool.tables[s, idx]),
                           page_size=self.page_size)

    def _scrub_slot(self, s):
        """Zero the physical pages a quarantined slot alone holds before
        they rejoin the free list. Stale *finite* rows in a freed page are
        harmless (masked rows get weight 0), but a NaN row survives the
        mask, so a recycled poisoned page would corrupt its next owner.
        Shared pages (refcount > 1) are skipped: another live reference
        holds valid content there, and this slot never wrote them."""
        for i in range(int(self.pool.n_blocks[s])):
            b = int(self.pool.tables[s, i])
            if int(self.pool.refcount[b]) == 1:
                poison_paged_block(self.state, self.cfg, b,
                                   page_size=self.page_size, value=0)

    def _chaos_logits(self, active, logits):
        """logits chaos: overwrite an injected slot's logits row with NaN on
        the device before sampling (a device-side numerical fault), in
        place: in a graph's static logits the next replay writes them
        anew."""
        for s in active:
            if fault_point("logits", slot=s, rid=self.requests[s].rid):
                logits[s] = float("nan")
        return logits

    def _guard_nonfinite(self, active, finite, nxt):
        """The NaN/Inf sentinel: the tick's per-row finiteness flags (from
        ``_sample``'s one transfer) and a range check on the sampled tokens
        (``argmax`` of a NaN row is the NaN's index, in range, so the flags
        decide). Only *active* slots are judged. Faulted requests are
        quarantined (``"failed"``) or, under ``nan_guard="strict"``, raise
        ``NonFiniteLogitsError``. Returns the surviving active slots."""
        if self.nan_guard == "off":
            return active
        vocab = self.cfg.vocab_size
        survivors = []
        for s in active:
            tok = int(nxt[s])
            if bool(finite[s]) and 0 <= tok < vocab:
                survivors.append(s)
                continue
            req = self.requests[s]
            if self.nan_guard == "strict":
                raise NonFiniteLogitsError(
                    f"non-finite logits for request {req.rid} (slot {s}) "
                    f"at engine step {self.ticks}")
            logger.warning(
                "quarantining request %d (slot %d): non-finite logits at "
                "engine step %d after %d generated tokens", req.rid, s,
                self.ticks, len(req.out))
            self._release_slot(s, "failed")
        return survivors

    def _prefill_tick(self, active):
        """One chunked step: prefilling slots absorb up to chunk_size prompt
        tokens; decode-ready slots ride along as 1-valid chunks."""
        C = self.chunk_size
        toks = np.zeros((self.slots, C), np.int32)
        nv = np.zeros((self.slots,), np.int32)
        for s in active:
            req = self.requests[s]
            if req.pos < len(req.prefill_toks):
                take = min(C, len(req.prefill_toks) - req.pos)
                toks[s, :take] = req.prefill_toks[req.pos:req.pos + take]
            else:
                take = 1
                toks[s, 0] = self.cur_tok[s]
            nv[s] = take
        logits = self._prefill_graph(tokens=toks, lengths=self.lengths,
                                     n_valid=nv, **self._tables())
        nxt, finite = self._sample(self._chaos_logits(active, logits))
        self._c_ticks.inc()
        self._c_prefill_steps.inc()
        self._price_prefill(active, nv)
        # the sentinel before the bookkeeping: a quarantined slot takes no
        # length or token update, so survivors see a fault-free schedule
        active = self._guard_nonfinite(active, finite, nxt)
        for s in active:
            req = self.requests[s]
            take = int(nv[s])
            self.lengths[s] += take
            if req.pos < len(req.prefill_toks):  # was prefilling this step
                recompute = max(0, min(req.pos + take, len(req.prefill_toks))
                                - max(req.pos, len(req.prompt)))
                req.pos += take
                self._c_prompt_tokens.inc(take - recompute)
                self._c_recompute.inc(recompute)
                if req.pos < len(req.prefill_toks):
                    continue                    # still mid-prompt: no sample
            self._finish_or_continue(s, int(nxt[s]))

    def _decode_tick(self, active):
        """Single-token step; with chunk_size=1 it also teacher-forces
        prompts."""
        logits = self._decode_graph(tokens=self.cur_tok, lengths=self.lengths,
                                    **self._tables())
        nxt, finite = self._sample(self._chaos_logits(active, logits))
        self._c_ticks.inc()
        self._c_decode_steps.inc()
        self._price_decode(active)
        active = self._guard_nonfinite(active, finite, nxt)
        for s in active:
            req = self.requests[s]
            if self.lengths[s] < len(req.prefill_toks):
                # the token written this tick was a prompt token (counted
                # before the increment, so prompt[0] is included)
                if self.lengths[s] < len(req.prompt):
                    self._c_prompt_tokens.inc()
                else:
                    self._c_recompute.inc()
            self.lengths[s] += 1
            req.pos = max(req.pos, int(self.lengths[s]))
            pos = int(self.lengths[s])
            if pos < len(req.prefill_toks):     # teacher-forcing (chunk=1)
                self.cur_tok[s] = req.prefill_toks[pos]
            else:
                self._finish_or_continue(s, int(nxt[s]))

    # -- executed-cost ledger (DESIGN.md §12) --------------------------------
    def _price_prefill(self, active, nv):
        """Ledger entry for one chunked-prefill step: each slot's chunk
        priced at its actual (resident history, chunk), x attention layers.
        Called before the lengths grow, so ``lengths[s]`` is the history
        the chunk attended over."""
        ex = self._exec["prefill"]
        g = self._geom
        layout = "paged" if self.paged else "contiguous"
        bytes_ = 0.0
        flops = 0
        kv = 0
        for s in active:
            chunk = int(nv[s])
            ctx = int(self.lengths[s])
            bytes_ += analytic_bytes_per_chunk_token(
                layout, self.kv_dtype, ex["path"], Hkv=g["Hkv"], D=g["D"],
                Dv=g["Dv"], ctx=ctx, chunk=chunk,
                page_size=self.page_size or 1) * chunk
            flops += analytic_attention_flops(
                chunk, ctx + chunk, heads=g["heads"], d_qk=g["d_qk"],
                d_v=g["d_v"])
            kv += ctx + chunk
        ex["calls"].inc(len(active))
        ex["steps"].inc()
        ex["tokens"].inc(kv)
        ex["bytes"].inc(int(bytes_) * g["layers"])
        ex["flops"].inc(flops * g["layers"])

    def _price_decode(self, active):
        """Ledger entry for one decode tick: every active slot reads its
        resident history + the row written this tick."""
        ex = self._exec["decode"]
        g = self._geom
        kv = 0
        flops = 0
        for s in active:
            ctx = int(self.lengths[s]) + 1
            kv += ctx
            flops += analytic_attention_flops(
                1, ctx, heads=g["heads"], d_qk=g["d_qk"], d_v=g["d_v"])
        ex["calls"].inc(len(active))
        ex["steps"].inc()
        ex["tokens"].inc(kv)
        ex["bytes"].inc(int(self._decode_bytes_per_ctx_token * kv)
                        * g["layers"])
        ex["flops"].inc(flops * g["layers"])

    def _track_memory(self, active):
        self._g_peak_active.set_max(
            int(sum(self.lengths[s] for s in active)))
        used = (self.pool.used_blocks * self.page_size if self.paged
                else self.slots * self.max_len)
        self._g_peak_kv.set_max(int(used))

    def tick(self) -> bool:
        """Advance the engine by one step (prefill or decode), with
        ``dispatch_sink`` observing the attention wrappers meanwhile."""
        prev = build.DISPATCH_SINK
        build.set_dispatch_sink(self.dispatch_sink)
        try:
            return self._tick()
        finally:
            build.set_dispatch_sink(prev)

    def _tick(self) -> bool:
        self._now = time.perf_counter()
        # the deadline sweep first: an expired request is not admitted,
        # reserved for or stepped this tick
        self._expire_deadlines()
        self._admit()
        self._g_queue.set(len(self.queue))
        active = [s for s in range(self.slots) if self.requests[s] is not None]
        if not active:
            return False
        if self.paged:
            # forced-preemption chaos: recompute resumption keeps every
            # temp-0 stream unchanged, only slower
            for s in active:
                if (self.requests[s] is not None and fault_point(
                        "preempt", slot=s, rid=self.requests[s].rid)):
                    self._preempt(s)
            active = [s for s in active if self.requests[s] is not None]
            active = self._reserve(active)
            if not active:
                return bool(self.queue)
            # kv corruption after the reservation, so the poisoned page is
            # one this tick attends over
            for s in active:
                if fault_point("kv_corrupt", slot=s,
                               rid=self.requests[s].rid):
                    self._corrupt_kv(s)
        prefilling = self.chunk_size > 1 and any(
            self.requests[s].pos < len(self.requests[s].prefill_toks)
            for s in active)
        step = self._prefill_tick if prefilling else self._decode_tick
        if self.metrics.trace:
            name = "prefill_step" if prefilling else "decode_step"
            with self.metrics.span(name, step=self.ticks + 1,
                                   active=len(active)):
                step(active)
        else:
            step(active)
        if self.prefix_cache:
            # index the pages this tick's writes completed (finished slots
            # registered theirs in _release_slot)
            self._register_active_pages()
        self._track_memory(
            [s for s in range(self.slots) if self.requests[s] is not None])
        return True

    def run(self, max_steps: int | None = None):
        """Tick until every request reaches a terminal state. ``max_steps``
        bounds the loop (a chaos run that drops every admission could
        otherwise spin on an unadmittable queue); the per-request safety
        net is ``deadline_steps`` / ``deadline_s``."""
        steps = 0
        while self.tick() or self.queue:
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break

    def save_snapshot(self, path: str) -> dict:
        """Crash-consistent snapshot of the whole engine (device state,
        pool and prefix index, live and queued requests, deadline budgets,
        metrics), written atomically; call between ticks.
        ``serve.snapshot.restore_engine(path, params, cfg)`` rebuilds it."""
        from repro_torch.serve.snapshot import save_snapshot
        return save_snapshot(self, path)

    # -- observability surfaces (DESIGN.md §12) ------------------------------
    def attention_ledger(self) -> dict:
        """Per-kind executed-cost rows: what the engine's steps were
        designed to move and compute at their actual lengths."""
        return {
            kind: {
                "impl": ex["impl"],
                "path": ex["path"],
                "calls": ex["calls"].value,
                "steps": ex["steps"].value,
                "kv_tokens": ex["tokens"].value,
                "analytic_bytes": ex["bytes"].value,
                "analytic_flops": ex["flops"].value,
            }
            for kind, ex in self._exec.items()
        }

    def metrics_snapshot(self) -> dict:
        """Everything observable about this engine as one JSON-able dict:
        the registry dump (the ``attention_dispatch_*`` and
        ``attention_exec_*`` families included), TTFT/TPOT quantiles in
        engine steps, the attention ledger, ``memory_stats()`` and the
        finish reasons."""
        snap = self.metrics.snapshot()
        snap["ttft_steps_p50"] = self._h_ttft_steps.quantile(0.50)
        snap["ttft_steps_p99"] = self._h_ttft_steps.quantile(0.99)
        snap["tpot_steps_p50"] = self._h_tpot_steps.quantile(0.50)
        snap["tpot_steps_p99"] = self._h_tpot_steps.quantile(0.99)
        snap["attention"] = self.attention_ledger()
        snap["memory"] = self.memory_stats()
        # every finished request counted under exactly one reason;
        # quarantines called out apart
        snap["finish_reasons"] = {
            reason: c.value for reason, c in self._c_reason.items()}
        snap["quarantined"] = self._c_quarantined.value
        return snap

    def prometheus_text(self) -> str:
        """The registry in Prometheus text exposition form."""
        return self.metrics.prometheus_text()

    # -- memory accounting ---------------------------------------------------
    def kv_reserved_tokens(self) -> int:
        """KV token rows reserved up front (per layer)."""
        if self.paged:
            return self.pool.pool_blocks * self.page_size
        return self.slots * self.max_len

    def memory_stats(self) -> dict:
        st = {
            "kv_layout": self.kv_layout,
            "kv_dtype": self.kv_dtype,
            "kv_token_bytes": int(self.token_bytes),
            "kv_reserved_tokens": int(self.kv_reserved_tokens()),
            "kv_peak_used_tokens": int(self.peak_kv_used_tokens),
            "kv_peak_active_tokens": int(self.peak_active_tokens),
            "kv_tokens_per_active_token": (
                self.peak_kv_used_tokens / self.peak_active_tokens
                if self.peak_active_tokens else 0.0),
            # real bytes (codes + scale pools): the cross-dtype comparison
            "kv_reserved_bytes": int(self.kv_reserved_tokens()
                                     * self.token_bytes),
            "kv_peak_used_bytes": int(self.peak_kv_used_tokens
                                      * self.token_bytes),
            "kv_bytes_per_active_token": (
                self.peak_kv_used_tokens * self.token_bytes
                / self.peak_active_tokens
                if self.peak_active_tokens else 0.0),
            "preemptions": int(self.preemptions),
            "recompute_tokens": int(self.recompute_tokens),
        }
        if self.paged:
            st["page_size"] = self.page_size
            st["pool_blocks"] = self.pool.pool_blocks
            st["evictions"] = self.pool.stats.evictions
            st["alloc_failures"] = self.pool.stats.alloc_failures
            # residency: used = referenced by a live slot, cached =
            # unreferenced but retained prefix pages, free = blank
            st["prefix_cache"] = self.prefix_cache
            st["kv_used_blocks"] = int(self.pool.used_blocks)
            st["kv_cached_blocks"] = int(self.pool.cached_block_count)
            st["kv_free_blocks"] = int(self.pool.free_block_count)
            st["kv_cached_tokens"] = int(self.pool.cached_block_count
                                         * self.page_size)
            st["kv_cached_bytes"] = int(self.pool.cached_bytes)
            if self.prefix_cache:
                ps = self.pool.stats
                st["cache_lookups"] = ps.cache_lookups
                st["cache_hits"] = ps.cache_hits
                st["hit_blocks"] = ps.hit_blocks
                st["cow_copies"] = ps.cow_copies
                st["cached_evictions"] = ps.cached_evictions
                st["prefix_hit_tokens"] = int(self.prefix_hit_tokens)
                st["prefill_flops_skipped"] = int(self.prefill_flops_skipped)
        return st

"""The serving ticks as CUDA graphs: the port of the ``jax.jit`` wrapping
of ``decode_step[_paged]`` and ``prefill[_paged]`` in
``repro/serve/engine.py``.

A ``TickGraph`` runs one tick function (token ids, lengths, ``n_valid``
and block tables in; logits out) over static int32 input buffers, packed
into one host buffer (pinned on the card) and one device buffer, so a
tick's inputs cost one copy from the host. On a CUDA device it captures
the function in a ``torch.cuda.CUDAGraph`` at its first call and replays
the graph at every call, the first one included: the ~70 small launches a
layer that Python dispatched one by one become one launch of the tick.
Elsewhere, or with ``capture=False`` (the counterpart of
``jax.disable_jit()``), it calls the function eagerly on the same buffers;
the CPU tests drive that path.

What a capture needs of the function: fixed shapes and no read of a
tensor's value on the host (no ``nonzero``, ``item`` or ``int(t)``; the
KV writes of ``kernels/paged.py`` and ``layers/attention_layer.py`` are
built so), and tensors whose addresses stay: the parameters, the
engine's caches and pools (updated in place by every path), the input
buffers. The kernels take their 16-byte alignment flags from the pointers
at capture, so no pool may ever be reallocated.

The capture: first a warm-up call on a side stream, with the tick's own
inputs but no chunk token valid (``warm_zero``; a prefill warm-up then
writes no cache row, and a decode warm-up writes the rows the replay
rewrites before it reads them; the tensors named in ``keep``, an RG-LRU
layer's per-slot state that a decode step advances, are put back as they
were after it), so the kernels' first-use build, their
one-time ``cudaFuncSetAttribute`` calls and cuBLAS's workspace happen
outside the capture; then the capture on that stream. The side stream is
one per device for the whole process: cuBLAS keeps a workspace for every
stream it has run on, so a stream per engine would hold one more
workspace for each engine ever built. No garbage collection runs inside
a capture: a dead reference cycle that holds a CUDA event or graph (an
engine dropped by its caller while something it owns points back at it)
is destroyed by whichever collection reaches it, and a destroy call
during a capture invalidates the capture; so the garbage is collected
before the warm-up, and collection is off until the capture ends. A
capture that fails raises: nothing falls back to eager ticks.

Counters: the kernel wrappers count launches (``kernels.build.COUNTS``)
and report to the dispatch sink in Python, so they fire at capture only.
The capture records them (``build.recording``) and each replay
re-applies them once, so they read as under eager ticks. The warm-up is
not a tick: what it launched is not counted.

The logits a capture returned are the graph's static output: every replay
overwrites them. The engine's graphs share one memory pool, which holds
as long as each graph's logits are read before another graph replays (the
engine samples every tick before the next).
"""
from __future__ import annotations

import gc
import math
import time

import torch

from repro_torch.kernels import build

_CAPTURE_STREAMS: dict = {}     # device index -> the side stream of captures


def capture_stream(device) -> "torch.cuda.Stream":
    """The one side stream every capture on ``device`` warms up and
    captures on."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


class TickGraph:
    """One tick function over static int32 input buffers, captured and
    replayed on a CUDA device when ``capture`` is set.

    ``inputs`` maps each keyword argument of ``fn`` to its shape;
    ``warm_zero`` names the inputs the warm-up before a capture zeroes;
    ``keep`` lists tensors whose values the warm-up must leave as it found
    them; ``pool`` is the graph memory pool
    (``torch.cuda.graph_pool_handle()``) that the engine's graphs share."""

    def __init__(self, fn, inputs: dict, device, *, capture: bool,
                 pool=None, warm_zero=(), keep=()):
        device = torch.device(device)
        if capture and device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        self.fn = fn
        self.device = device
        self.capture = capture
        self.pool = pool
        self.warm_zero = tuple(warm_zero)
        self.keep = tuple(keep)
        total = sum(math.prod(shape) for shape in inputs.values())
        on_card = device.type == "cuda"
        self._host = torch.zeros(total, dtype=torch.int32, pin_memory=on_card)
        self._dev = (torch.zeros(total, dtype=torch.int32, device=device)
                     if on_card else self._host)
        self.buffers, self._host_views = {}, {}
        off = 0
        for name, shape in inputs.items():
            n = math.prod(shape)
            self.buffers[name] = self._dev[off:off + n].view(shape)
            self._host_views[name] = self._host[off:off + n].view(shape).numpy()
            off += n
        self._copied = None     # the event after the last host-to-device copy
        self.graph = None
        self.logits = None
        self._recorded = None
        self.replays = 0
        self.warmup_ms = self.capture_ms = None
        self.pool_bytes = 0

    def __call__(self, **arrays) -> torch.Tensor:
        """Copy the host arrays (one per input) into the buffers, then run
        the tick: (slots, vocab) logits, the static output under a graph."""
        if self._copied is not None:
            self._copied.synchronize()      # the buffer is free to refill
        for name, view in self._host_views.items():
            view[...] = arrays[name]
        if self._dev is not self._host:
            self._dev.copy_(self._host, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()
        if not self.capture:
            return self.fn(**self.buffers)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self._recorded.replay()
        self.replays += 1
        return self.logits

    def _capture(self):
        gc.collect()          # dead cycles' CUDA objects go now, not inside
        current = torch.cuda.current_stream(self.device)
        warm = {name: b.clone() for name, b in self.buffers.items()}
        for name in self.warm_zero:
            warm[name].zero_()
        kept = [t.clone() for t in self.keep]
        side = capture_stream(self.device)
        side.wait_stream(current)
        t0 = time.perf_counter()
        with torch.cuda.stream(side), build.recording():
            self.fn(**warm)
        side.synchronize()
        for t, old in zip(self.keep, kept):
            t.copy_(old)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        kw = {} if self.pool is None else {"pool": self.pool}
        collecting = gc.isenabled()
        gc.disable()
        try:
            with build.recording() as rec:
                with torch.cuda.graph(graph, stream=side, **kw):
                    reserved = torch.cuda.memory_reserved(self.device)
                    logits = self.fn(**self.buffers)
        finally:
            if collecting:
                gc.enable()
        current.wait_stream(side)
        self.warmup_ms = (t1 - t0) * 1e3
        self.capture_ms = (time.perf_counter() - t1) * 1e3
        # what the capture added to the shared pool (nothing else
        # allocates while it runs)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph, self.logits, self._recorded = graph, logits, rec

    def stats(self) -> dict:
        return {"captured": self.graph is not None, "replays": self.replays,
                "warmup_ms": self.warmup_ms, "capture_ms": self.capture_ms,
                "pool_bytes": self.pool_bytes,
                "launches_per_replay": (dict(self._recorded.counts)
                                        if self._recorded else {})}

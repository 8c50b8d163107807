"""Per-device op counts of a PyTorch program (the port's counterpart of
``repro/launch/hlo_costs.py``, which parses compiled HLO: there is no HLO
here, so the ops are counted as they run).

``OpCounter`` is a ``TorchDispatchMode``. It counts **per device**: on a
DTensor an op first goes through DTensor's dispatch, which redistributes
the operands and calls the op on each rank's local tensors; the counter
returns ``NotImplemented`` to DTensor ops and counts those local calls,
and the functional collectives DTensor issues, instead. The ops DTensor
runs on global fake tensors to propagate shapes are not counted. Under
the fake process group every rank is rank 0, so the counts are rank 0's.

It counts:

  * ``flops`` — the matmul family (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, ...), by ``torch.utils.flop_counter``'s formulas, plus
    the analytic FLOPs each attention call reports
    (``kernels/costs.py:report_call``: a CUDA launch, or a ``meta`` call
    that stands for one, neither of which this mode can see); summed by
    type too in ``flops_by_type``, for the roofline to price each at its
    peak: a product by its first operand's dtype (``flop_type``; float32
    as "tf32" where ``torch.backends.cuda.matmul.allow_tf32`` is set at
    the call), an attention call as the type it reports;
  * ``bytes`` — every op reads its tensor inputs once and writes its
    outputs once (views and allocations move nothing), plus what each
    attention call reports. XLA counts after fusion; this is an unfused
    upper bound of the HBM traffic;
  * ``transcendental_elems`` — output elements of ``exp``, ``exp2``,
    ``log``, ``tanh``, ``sigmoid``, ``rsqrt``, ``erf`` and of the ops that
    compute one such function an element (softmax and log-softmax, SiLU,
    GELU, log-sigmoid, softplus, ``logaddexp``);
  * every functional collective (``_c10d_functional.all_gather_into_tensor``,
    ``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single``,
    DTensor's ``shard_dim_alltoall``, and any permute) with its group
    size, priced as ring wire bytes (``roofline.wire_bytes``) in ``coll``
    and ``coll_breakdown``.

Inside ``looped`` (one step of a loop of n identical steps, on ``meta``
tensors) every count of the step is multiplied by n, forward and
backward, as ``hlo_costs`` multiplies a while body's cost by its trip
count.

It also keeps the bytes of the tensors the counted ops allocated that are
still alive (``live``; a view or an in-place result allocates nothing)
and their peak (``peak_live``): an estimate of a rank's temporaries from
tensor sizes, no allocator's measurement.

``totals()`` returns ``analyze_text``'s keys (``flops``, ``bytes``,
``coll``, ``coll_breakdown``, ``transcendental_elems``), plus
``flops_by_type``, ``attention_calls`` ({kernel name: calls}) and ``collectives`` (one
(kind, result bytes, group size) a call).

The mode calls every op as it was called, so it moves no number.
"""
from __future__ import annotations

import collections
import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import costs
from repro_torch.launch.roofline import wire_bytes

_TRANSCENDENTAL = {"exp", "exp2", "log", "tanh", "sigmoid", "rsqrt", "erf",
                   "_softmax", "_log_softmax", "silu", "gelu",
                   "log_sigmoid_forward", "softplus", "logaddexp"}
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "resize_",
         "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd"}
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce",
                "all_to_all_single": "all-to-all",
                "shard_dim_alltoall": "all-to-all"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def flop_type(dtype) -> str:
    """The roofline's FLOP type (``roofline.PEAK_FLOPS``) of a product of
    ``dtype`` operands."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.int8:
        return "int8"
    if dtype.is_floating_point and dtype.itemsize == 1:
        return "fp8"
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return "float32"


def _group_size(name, args) -> int:
    """The group size of a functional collective: its own argument where
    it has one, else its group's (resolved from the group's name)."""
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[-1]).size()


# the trip count of the loop a counted op runs in: ``looped`` runs one
# step of a loop of identical steps and the counters multiply what the
# step does by it, as the reference's HLO counter multiplies a while
# body's cost by its trip count
TRIP = [1]


@contextlib.contextmanager
def trip_count(n: int):
    TRIP.append(TRIP[-1] * int(n))
    try:
        yield
    finally:
        TRIP.pop()


class _Looped(torch.autograd.Function):
    """``step(*args)`` run once in the forward and its gradient once in the
    backward, each under ``trip_count(n)``."""

    @staticmethod
    def forward(ctx, n, step, *args):
        # the step's own graph keeps its tensors: under a checkpoint's
        # hooks its backward would recompute the whole checkpointed layer
        # inside trip_count(n)
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                lambda t: t, lambda t: t):
            ins = [a.detach().requires_grad_(a.requires_grad) for a in args]
            with trip_count(n):
                outs = step(*ins)
        ctx.n, ctx.ins, ctx.outs = n, ins, outs
        ctx.set_materialize_grads(False)
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        need = [a for a in ctx.ins if a.requires_grad]
        pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                 if g is not None and o.requires_grad]
        got = iter(())
        if need and pairs:
            with trip_count(ctx.n):
                got = iter(torch.autograd.grad(
                    [o for o, _ in pairs], need, [g for _, g in pairs],
                    allow_unused=True))
        return (None, None) + tuple(next(got, None) if a.requires_grad
                                    else None for a in ctx.ins)


def looped(step, n: int, *args):
    """One step of a loop of ``n`` identical steps on ``meta`` tensors (the
    dry run): ``step(*args)`` -> a tuple of tensors, run once forward and
    once backward, each counted ``n`` times by the active counters. Every
    tensor the step differentiates through (weights too) must be one of
    ``args``. Its values are the one step's: the caller uses it where only
    shapes matter."""
    return _Looped.apply(n, step, *args)


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: ...`` then ``c.totals()``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0.0
        self.flops_by_type: dict = collections.defaultdict(float)
        self.bytes = 0.0
        self.transcendental_elems = 0.0
        self.coll = 0.0
        self.coll_breakdown: dict = collections.defaultdict(float)
        self.collectives: list = []
        self.attention_calls: collections.Counter = collections.Counter()
        self.live = 0
        self.peak_live = 0

    def _attention(self, name, *, flops, bytes, flop_type):
        n = TRIP[-1]
        self.attention_calls[name] += n
        self.flops += n * flops
        self.flops_by_type[flop_type] += n * flops
        self.bytes += n * bytes

    def __enter__(self):
        costs.COST_SINKS.append(self._attention)
        return super().__enter__()

    def __exit__(self, *exc):
        costs.COST_SINKS.remove(self._attention)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # count DTensor's local calls
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs):
            return out                  # DTensor's shape propagation
        self._count(func, args, kwargs, out, outs)
        return out

    def _free(self, nbytes):
        self.live -= nbytes

    def _allocated(self, outs, inputs):
        """Add the outputs that are new tensors to the live bytes."""
        seen = {id(t) for t in inputs}
        for t in outs:
            if id(t) in seen:
                continue
            nbytes = t.numel() * t.element_size()
            self.live += nbytes
            weakref.finalize(t, self._free, nbytes)
        self.peak_live = max(self.peak_live, self.live)

    def _count(self, func, args, kwargs, out, outs):
        name = func._schema.name.split("::")[-1]
        if func.is_view or name in _FREE:
            return
        self._allocated(outs, _tensors(args) + _tensors(kwargs))
        n = TRIP[-1]
        if func.namespace in ("_c10d_functional", "_dtensor") and (
                name in _COLLECTIVES or "permute" in name):
            kind = _COLLECTIVES.get(name, "collective-permute")
            g = _group_size(name, args)
            result = _nbytes(outs)
            wire = n * wire_bytes(kind, result, g)
            self.coll += wire
            self.coll_breakdown[kind] += wire
            self.collectives.extend([(kind, result, g)] * n)
            self.bytes += n * (_nbytes(_tensors(args)) + result)
            return
        packet = func.overloadpacket
        if packet in self._flop_registry:
            f = n * self._flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.flops_by_type[flop_type(_tensors(args)[0].dtype)] += f
        self.bytes += n * (_nbytes(_tensors(args) + _tensors(kwargs))
                           + _nbytes(outs))
        if name.rstrip("_") in _TRANSCENDENTAL:
            self.transcendental_elems += n * sum(t.numel() for t in outs)

    def totals(self) -> dict:
        return {"flops": self.flops,
                "flops_by_type": dict(self.flops_by_type),
                "bytes": self.bytes,
                "coll": self.coll,
                "coll_breakdown": dict(self.coll_breakdown),
                "transcendental_elems": self.transcendental_elems,
                "attention_calls": dict(self.attention_calls),
                "collectives": list(self.collectives)}

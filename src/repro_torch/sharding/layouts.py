"""Fixed layout rules for the ops whose layout DTensor would choose.

DTensor propagates a layout through each op by its own cost model, and
that model changes between torch versions: for the same cell one version
gathers a product's weights and splits its rows over every rank where
another keeps a partial sum and scatters it afterwards, and one version
refuses a view that another expresses as a strided shard. A plan counted
on one version would then not be the plan of another.

``FixedLayouts`` is a dispatch mode above DTensor that takes those
choices itself, by the rules below, and redistributes the operands
explicitly before the op, so DTensor is left only the layout that moves
nothing, or runs the op on each rank's shards itself. The
redistributions are collectives the op counter sees, below it; the mode
counts the ops it redistributed for (``resharded``). It checks that
DTensor laid a view out as the rule predicts, and raises if not, so a
torch whose views propagate otherwise fails instead of counting another
plan.

* **Views** (``view``, ``_unsafe_view``, ``reshape``). A dim split over
  mesh axes stays split when the view keeps the elements before it (the
  product of the sizes before the dim is one of the out shape's) and the
  out dim there is a multiple of the split; the split then moves to that
  out dim. Any other split is gathered (a flatten of two split dims keeps
  the first's). A partial sum stays partial.
* **Products** (``mm`` and ``bmm``; ``matmul`` and ``einsum`` reach
  them). Each mesh axis is decided alone, from the two operands' layout
  on it: a split of the batch, of the rows (x) or of the columns (w) is
  kept and gives the output's; both split on the contracted dim give a
  partial sum; a replicated operand is sliced (no collective) to match
  the other's batch or contracted split. Where the two conflict (each
  split on another dim, or a partial sum beside a split), the operand
  with fewer elements is gathered first; a partial sum beside a split is
  reduced first. The product runs on each rank's shards.
* **Element-wise ops** with several DTensor operands (``torch.Tag.
  pointwise``). On each mesh axis the operands take the layout of the
  first of the largest operands that is split there, or else of the
  first that is not a partial sum (broadcast dims replicated); where all
  the largest are partial sums, ``add`` and ``sub`` of partial sums keep
  them and anything else reduces them.
* **A partial sum into any other element-wise op** (of one DTensor
  operand) is reduced first, but for a product or quotient by a
  scalar.
* **Flips** (a cumulative sum's gradient; torch 2.11 has no DTensor
  rule for them) run on each rank's shard, the flipped dims gathered
  whole first.
* **Scatters and gathers along a dim** (``scatter``, ``scatter_add``,
  ``gather``; a sort's gradient) run on each rank's shards: on each mesh
  axis every operand takes the first split among theirs of a dim other
  than the scattered one that all their sizes share (a replicated buffer
  is sliced to its source's rows), else they are replicated.

Under the fake process group every rank is rank 0: its shard is the one
simulated.
"""
from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.sharding.regions import is_dtensor

_VIEWS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
          torch.ops.aten.reshape.default)
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)
_SCATTERS = (torch.ops.aten.scatter.src, torch.ops.aten.scatter_add.default,
             torch.ops.aten.gather.default)
_LINEAR_SUMS = (torch.ops.aten.add.Tensor, torch.ops.aten.sub.Tensor)
# element-wise ops linear in their one tensor operand: a partial sum
# passes through them
_LINEAR_ONE = (torch.ops.aten.mul.Scalar, torch.ops.aten.div.Scalar)


class FixedLayouts(TorchDispatchMode):
    """``with FixedLayouts():`` lays out views, products, flips, scatters
    and element-wise ops over DTensors by fixed rules (the module
    docstring)."""

    def __init__(self):
        super().__init__()
        self.resharded = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(is_dtensor(a) for a in args):
            return func(*args, **kwargs)
        if func in _VIEWS:
            return self._view(func, args, kwargs)
        if func in _PRODUCTS:
            return self._product(func, *args)
        if func is torch.ops.aten.flip.default:
            return self._flip(*args)
        if func in _SCATTERS:
            return self._scatter(func, args, kwargs)
        if torch.Tag.pointwise in func.tags:
            return self._pointwise(func, args, kwargs)
        return NotImplemented

    def _moved(self, tensors, wants):
        """The tensors redistributed to ``wants`` (one placements tuple a
        tensor), counting one op if any moved."""
        out, moved = [], False
        for t, want in zip(tensors, wants):
            if tuple(want) != tuple(t.placements):
                t, moved = _redistribute(t, want), True
            out.append(t)
        self.resharded += moved
        return out

    # ---- views -----------------------------------------------------------
    def _view(self, func, args, kwargs):
        x, shape = args[0], list(args[1])
        if -1 in shape:
            i = shape.index(-1)
            shape[i] = x.numel() // max(1, math.prod(
                s for j, s in enumerate(shape) if j != i))
        want, out_pl = view_layout(x, tuple(shape))
        (x,) = self._moved([x], [want])
        out = func(x, *args[1:], **kwargs)
        _expect(out, out_pl, func)
        return out

    # ---- products --------------------------------------------------------
    def _product(self, func, x, w):
        mesh = _mesh(x, w)
        x, w = (a if is_dtensor(a) else _wrap(a, mesh, _replicate(mesh),
                                              a.shape)
                for a in (x, w))
        px, pw, out_pl = product_layout(x, w)
        x, w = self._moved([x, w], [px, pw])
        local = func(x._local_tensor, w._local_tensor)
        return _wrap(local, mesh, out_pl, x.shape[:-1] + w.shape[-1:])

    # ---- flips (a cumulative sum's gradient) ----------------------------
    def _flip(self, x, dims):
        from torch.distributed.tensor import Replicate

        dims = {d % x.dim() for d in dims}
        want = tuple(Replicate() if p.is_shard() and p.dim in dims else p
                     for p in x.placements)
        (x,) = self._moved([x], [want])
        return _wrap(torch.flip(x._local_tensor, list(dims)), x.device_mesh,
                     x.placements, x.shape)

    # ---- scatters and gathers along a dim (a sort's gradient) -----------
    def _scatter(self, func, args, kwargs):
        # a plain operand (a gradient's zeros, made by a factory) is
        # replicated, as DTensor takes it
        mesh = _mesh(*args)
        args = [_wrap(a, mesh, _replicate(mesh), a.shape)
                if isinstance(a, torch.Tensor) and not is_dtensor(a) else a
                for a in args]
        ts = [a for a in args if is_dtensor(a)]
        want = scatter_layout(ts, args[1] % ts[0].dim())
        moved = iter(self._moved(ts, [want] * len(ts)))
        args = [next(moved) if is_dtensor(a) else a for a in args]
        local = func(*[a._local_tensor if is_dtensor(a) else a
                       for a in args], **kwargs)
        shape = (args[2] if func is torch.ops.aten.gather.default
                 else args[0]).shape
        return _wrap(local, args[0].device_mesh, want, shape)

    # ---- element-wise ----------------------------------------------------
    def _pointwise(self, func, args, kwargs):
        ts = [a for a in args if is_dtensor(a)]
        if len(ts) == 1:
            t = ts[0]
            if func in _LINEAR_ONE or not any(p.is_partial()
                                              for p in t.placements):
                return func(*args, **kwargs)
            want = tuple(_reduced(p) for p in t.placements)
            (t,) = self._moved([t], [want])
            return func(*[t if is_dtensor(a) else a for a in args], **kwargs)
        wants = pointwise_layout(func, ts)
        moved = iter(self._moved(ts, wants))
        return func(*[next(moved) if is_dtensor(a) else a for a in args],
                    **kwargs)


# ---------------------------------------------------------------------------
# the rules, as functions of shapes and placements
# ---------------------------------------------------------------------------
def view_layout(x, shape):
    """(the placements x takes before its view to ``shape``, the
    placements of the view)."""
    from torch.distributed.tensor import Replicate, Shard

    src = tuple(x.shape)
    split = {}                       # tensor dim -> the product of its split
    for m, p in enumerate(x.placements):
        if p.is_shard():
            split[p.dim] = split.get(p.dim, 1) * x.device_mesh.size(m)
    target = {}
    for d, n in split.items():
        lead = math.prod(src[:d])
        e = next((e for e in range(len(shape))
                  if math.prod(shape[:e]) == lead and shape[e] != 1), None)
        if e is not None and src[d] % n == 0 and shape[e] % n == 0:
            target[d] = e
    want = tuple(p if not p.is_shard() or p.dim in target else Replicate()
                 for p in x.placements)
    out = tuple(Shard(target[p.dim]) if p.is_shard() else p for p in want)
    return want, out


def product_layout(x, w):
    """(x's placements, w's, the output's) of ``x @ w``: (M, K) @ (K, N)
    or (B, M, K) @ (B, K, N)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    b = x.dim() - 2                  # 1 with a batch dim, else 0
    xs = {0: "B", 1: "M", 2: "K"} if b else {0: "M", 1: "K"}
    ws = {0: "B", 1: "K", 2: "N"} if b else {0: "K", 1: "N"}
    x_dim = {r: d for d, r in xs.items()}
    w_dim = {r: d for d, r in ws.items()}
    out_dim = {"B": 0, "M": b, "N": b + 1}
    x_small = x.numel() < w.numel()
    px, pw, po = [], [], []
    for m in range(len(x.placements)):
        a, c = _resolve(_role(x.placements[m], xs),
                        _role(w.placements[m], ws), x_small)
        px.append(_placement(a, x_dim))
        pw.append(_placement(c, w_dim))
        if "P" in (a, c) or a == "K":
            po.append(Partial())
        elif a in ("B", "M") or c == "N":
            po.append(Shard(out_dim[a if a != "R" else c]))
        else:
            po.append(Replicate())
    return tuple(px), tuple(pw), tuple(po)


def _resolve(a, c, x_small):
    """The roles of x and w on one mesh axis ("R" replicated, "P" a
    partial sum, else the dim split: "B", "M", "K" of x; "B", "K", "N" of
    w) that the product takes: a partial sum beside a split is reduced,
    then of two splits that do not pair the smaller operand is gathered,
    and a replicated operand is sliced to its partner's B or K split."""
    while not ("R" in (a, c) or (a, c) in (("B", "B"), ("K", "K"))):
        if a == "P" and (c != "P" or x_small):
            a = "R"
        elif c == "P":
            c = "R"
        elif x_small:
            a = "R"
        else:
            c = "R"
    if a == "R" and c in ("B", "K"):
        a = c
    if c == "R" and a in ("B", "K"):
        c = a
    return a, c


def _placement(role, dims):
    from torch.distributed.tensor import Partial, Replicate, Shard

    if role == "R":
        return Replicate()
    return Partial() if role == "P" else Shard(dims[role])


def pointwise_layout(func, ts):
    """The placements each DTensor operand of an element-wise ``func``
    takes (the module docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    most = max(t.numel() for t in ts)
    big = [t for t in ts if t.numel() == most]
    wants = [[] for _ in ts]
    for m in range(len(ts[0].placements)):
        lead = next((t for t in big if t.placements[m].is_shard()),
                    next((t for t in big if not t.placements[m].is_partial()),
                         None))
        if lead is None:             # every largest operand a partial sum
            keep = func in _LINEAR_SUMS and all(
                t.placements[m].is_partial() for t in ts)
            for i in range(len(ts)):
                wants[i].append(Partial() if keep else Replicate())
            continue
        p = lead.placements[m]
        for i, t in enumerate(ts):
            d = p.dim - (lead.dim() - t.dim()) if p.is_shard() else -1
            wants[i].append(Shard(d) if d >= 0 and t.shape[d] != 1
                            else Replicate())
    return [tuple(w) for w in wants]


def scatter_layout(ts, dim):
    """The placements every operand of a scatter or gather along ``dim``
    takes: on each mesh axis the first split among the operands' of a dim
    other than ``dim`` that all their sizes share, else replicated."""
    from torch.distributed.tensor import Replicate

    def kept(p):
        return p.is_shard() and p.dim != dim and len(
            {t.shape[p.dim] for t in ts}) == 1

    return tuple(next((t.placements[m] for t in ts if kept(t.placements[m])),
                      Replicate()) for m in range(len(ts[0].placements)))


def _role(p, roles):
    if p.is_partial():
        return "P"
    if p.is_shard():
        return roles[p.dim]
    return "R"


def _reduced(p):
    from torch.distributed.tensor import Replicate

    return Replicate() if p.is_partial() else p


def _mesh(*ts):
    return next(t.device_mesh for t in ts if is_dtensor(t))


def _replicate(mesh):
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


# Below autograd (inside the mode) a DTensor is taken apart and made
# again from its spec: ``DTensor.redistribute`` and ``from_local`` are
# autograd functions, which torch 2.11 cannot run there.
def _wrap(local, mesh, placements, shape):
    """The DTensor of global ``shape`` (contiguous) whose rank's shard is
    ``local``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta

    shape = torch.Size(shape)
    spec = DTensorSpec(mesh, tuple(placements), tensor_meta=TensorMeta(
        shape, _contiguous(shape), local.dtype))
    return DTensor(local, spec, requires_grad=False)


def _redistribute(t, placements):
    """``t.redistribute(t.device_mesh, placements)``, below autograd."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._redistribute import (
        redistribute_local_tensor,
    )

    spec = DTensorSpec(t.device_mesh, tuple(placements),
                       tensor_meta=t._spec.tensor_meta)
    return DTensor(redistribute_local_tensor(t._local_tensor, t._spec, spec),
                   spec, requires_grad=False)


def _contiguous(shape):
    stride, n = [], 1
    for s in reversed(shape):
        stride.append(n)
        n *= s
    return tuple(reversed(stride))


def _expect(out, placements, func):
    if tuple(out.placements) != tuple(placements):
        raise RuntimeError(f"{func}: DTensor laid the result out as "
                           f"{tuple(out.placements)}, not as the fixed rule "
                           f"{tuple(placements)}")

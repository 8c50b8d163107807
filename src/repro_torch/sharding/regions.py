"""Per-shard regions over DTensors: the port's counterpart of the
reference's ``shard_map`` and of what GSPMD does for its attention and
cache writes.

An attention kernel takes plain tensors, so over DTensors each call runs
per shard: ``run_local`` redistributes its operands to the placements the
call needs (the collective the op counter sees), runs the wrapper on each
rank's local tensors and wraps the outputs back; both conversions are
differentiable, so a train step's backward runs per shard too. An operand
replicated over a mesh axis on which the outputs are split is used
differently by each rank there, so its gradient leaves the region as a
partial sum over that axis (``to_local(grad_placements=...)``), which
the redistribution's backward reduces: the reference's ``shard_map``
transposes an unmapped input so.

* ``sharded_attention`` (the full-sequence flash call) shards the batch
  over the DP axes and, as the reference's ``flash_jnp`` does, the first
  of (kv-heads, head group, queries) that the 'model' axis divides: with
  the kv-heads q and K/V split together; with the group q's heads split
  and each rank reads the one KV head its heads share; with the queries
  q's rows split against the whole K/V, each rank's call at the query
  offset of its first row (``q_offset``), so a causal mask is the whole
  call's.
* ``sharded_decode`` (the contiguous decode call) follows the cache's
  layout (``sharding/rules.py:decode_state_shardings``): kv-heads over
  'model' split q's heads with them; a sequence-split (SP) cache runs the
  kernel on each rank's slots and combines the partial outputs by their
  log-sum-exp (split-K flash-decode, three small all-reduces over
  'model'). The decode kernels return no log-sum-exp, so that combine runs
  on ``meta`` only (the dry run).
* ``write_slot`` writes one token's row into each rank's shard of a
  per-slot cache (the reference's ``dynamic_update_slice``): every rank
  writes its rows' slot, clamped into its shard (on an SP cache only the
  owner's write is the token's; on ``meta`` each rank's write is priced).
* ``pad_rows`` pads a DTensor's rows (dim 0) with zeros to a total, each
  rank its own shard to its share, its rows kept at their global index
  modulo a period (the MoE ``balanced`` dispatch buffer: each copy meets
  the expert it meets off a mesh; DTensor would gather the rows whole to
  pad them, and torch 2.11 cannot pad a DTensor at all), ``unpad_rows``
  takes them back, and ``scatter_rows`` is
  ``buf[index] = rows`` on DTensors, the small operands gathered and each
  rank writing its copy (torch 2.11 has no strategy for the index-put).
* ``pad``, ``take_rows`` and ``cummax`` run ``F.pad``, ``src[index]``
  and ``torch.cummax`` per shard, after gathering explicitly the dims
  they need whole (the padded dims, ``src``, the scanned dim): torch 2.11
  has no DTensor strategy for the three (2.13 gathers alike).
* ``gather_last`` is ``torch.gather`` along the last dim of a DTensor
  whose last dim may be split over 'model' (the vocab of the logits),
  and ``vocab_lookup`` the embedding rows of a vocab-split table: each
  rank takes the ids its shard holds and zeros the rest, the result a
  partial sum over 'model' (DTensor's own masked gather builds a
  global-size gradient buffer in its backward, and its masked partial
  does not survive autograd).

Every helper takes plain tensors too and then runs the plain op itself
(``sharded_attention`` and ``sharded_decode`` call ``run`` on their
operands), so the layers call them on any tensor and a CPU or card path
is unchanged bit for bit.

Under the fake process group every rank is rank 0: its shard is the one
simulated; over a real process group (``launch/train.py`` on a mesh) each
rank runs its own.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import mesh_axes
from repro_torch.sharding.rules import placements


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _dp(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))


def _fit(mesh, size, axes):
    """``axes`` (a name or a tuple) when their size divides ``size``."""
    sizes = mesh_axes(mesh)
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= sizes[a]
    return axes if axes and size % n == 0 else None


def _coord(mesh, axis) -> int:
    return mesh.get_local_rank(axis)


def to_local(x, varying):
    """The DTensor ``x``'s local tensor inside a region whose outputs are
    split over the mesh dims ``varying``: its gradient is a partial sum
    over those of them it is replicated on."""
    from torch.distributed.tensor import Partial

    grad = tuple(Partial() if m in varying and p.is_replicate() else p
                 for m, p in enumerate(x.placements))
    return x.to_local(grad_placements=grad)


def _axis_names(spec):
    """Every axis name in a spec, or in a tuple of specs."""
    if isinstance(spec, str):
        yield spec
    elif isinstance(spec, tuple):
        for s in spec:
            yield from _axis_names(s)


def run_local(fn, args, in_specs, out_specs, mesh):
    """``fn`` on each rank's shards of ``args`` (each DTensor redistributed
    to its spec, a plain tensor passed as it is) -> DTensors of
    ``out_specs`` (one spec, or a tuple of them for a tuple of outputs)."""
    from torch.distributed.tensor import DTensor

    names = list(mesh.mesh_dim_names)
    varying = {names.index(a) for a in _axis_names(out_specs)}
    local = []
    for a, spec in zip(args, in_specs):
        if is_dtensor(a):
            want = placements(spec, mesh)
            if tuple(a.placements) != want:
                a = a.redistribute(mesh, want)
            a = to_local(a, varying)
        local.append(a)
    out = fn(*local)

    def wrap(o, spec):
        return DTensor.from_local(o, mesh, placements(spec, mesh),
                                  run_check=False)

    if isinstance(out, tuple):
        return tuple(wrap(o, s) for o, s in zip(out, out_specs))
    return wrap(out, out_specs)


def sharded_attention(q, k, v, run):
    """``run(q, k, v)`` (the flash call on plain tensors) over DTensors q
    (B, H, Sq, D), k and v (B, Hkv, Sk, D)."""
    if not is_dtensor(q):
        return run(q, k, v)
    mesh = q.device_mesh
    msize = mesh_axes(mesh).get("model", 0)
    B, H, Sq, _ = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    ba = _fit(mesh, B, _dp(mesh))
    tp = next((name for name, dim in (("heads", Hkv), ("group", G),
                                      ("queries", Sq))
               if msize and dim % msize == 0), None)
    q_spec = (ba, "model" if tp in ("heads", "group") else None,
              "model" if tp == "queries" else None, None)
    kv_spec = (ba, "model" if tp == "heads" else None, None, None)

    def local(ql, kl, vl):
        if tp == "group":     # this rank's heads share one KV head
            kv0 = _coord(mesh, "model") * ql.shape[1] // G
            kl, vl = kl[:, kv0:kv0 + 1], vl[:, kv0:kv0 + 1]
        if tp == "queries":   # this rank's rows start at its offset
            return run(ql, kl, vl,
                       q_offset=_coord(mesh, "model") * ql.shape[2])
        return run(ql, kl, vl)

    return run_local(local, (q, k, v), (q_spec, kv_spec, kv_spec), q_spec,
                     mesh)


def _model_dim(t):
    """The tensor dim a DTensor has split over 'model', or None."""
    names = list(t.device_mesh.mesh_dim_names)
    if "model" not in names:
        return None
    p = t.placements[names.index("model")]
    return p.dim if p.is_shard() else None


def sharded_decode(q, caches, lengths, run):
    """``run(q, *caches, lengths)`` (the contiguous decode call on plain
    tensors) over DTensors q (B, H, D) and ``caches`` (B, Hkv, S, ...;
    values, or codes and scale rows), the caches as their layout has
    them."""
    if not is_dtensor(q):
        return run(q, *caches, lengths)
    mesh = q.device_mesh
    ba = _fit(mesh, q.shape[0], _dp(mesh))
    split = _model_dim(caches[0])

    def spec_of(t):
        dims = [ba] + [None] * (t.dim() - 1)
        if split is not None:
            dims[split] = "model"
        return tuple(dims)

    c_specs = tuple(spec_of(c) for c in caches)
    l_spec = (ba,)
    if split != 2:           # kv-heads over 'model', or not split
        q_spec = (ba, "model" if split == 1 else None, None)
        return run_local(run, (q, *caches, lengths),
                         (q_spec, *c_specs, l_spec), q_spec, mesh)
    S_l = caches[0].shape[2] // mesh_axes(mesh)["model"]
    q_spec = (ba, None, None)

    def local(ql, *rest):
        *cl, ll = rest
        if ql.device.type != "meta":
            raise NotImplementedError(
                "a sequence-split decode combines its partial outputs by "
                "their log-sum-exp, which the decode kernels do not return; "
                "it runs on meta only")
        off = _coord(mesh, "model") * S_l
        ll = torch.clamp(ll - off, 0, S_l).to(torch.int32)
        o = run(ql, *cl, ll)
        lse = torch.empty(o.shape[:2], dtype=torch.float32, device=o.device)
        return o[None], lse[None]

    o, lse = run_local(local, (q, *caches, lengths),
                       (q_spec, *c_specs, l_spec),
                       (("model", ba, None, None), ("model", ba, None)),
                       mesh)
    w = torch.exp(lse - torch.amax(lse, dim=0, keepdim=True))
    num = torch.sum(o.to(torch.float32) * w[..., None], dim=0)
    den = torch.sum(w, dim=0)
    out = num / den[..., None]
    want = placements((ba, None, None), mesh)
    return out.redistribute(mesh, want).to(q.dtype) \
        if tuple(out.placements) != want else out.to(q.dtype)


def gather_last(x, index):
    """``torch.gather(x, -1, index)`` over a DTensor ``x`` (index the same
    rank, last dim 1), per shard of ``x``'s last dim."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not is_dtensor(x):
        return torch.gather(x, -1, index)
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    last = x.dim() - 1
    split = [i for i, p in enumerate(x.placements)
             if p.is_shard() and p.dim == last]
    idx_pl = tuple(Replicate() if i in split or p.is_partial() else p
                   for i, p in enumerate(x.placements))
    il = index.redistribute(mesh, idx_pl).to_local()
    xl = x.to_local()
    off = 0
    for i in split:     # this rank's first vocab id (one split axis)
        off = _coord(mesh, names[i]) * xl.shape[-1]
    j = il.to(torch.int64) - off
    inside = (j >= 0) & (j < xl.shape[-1])
    g = torch.gather(xl, -1, torch.clamp(j, 0, xl.shape[-1] - 1))
    g = torch.where(inside, g, torch.zeros((), dtype=g.dtype,
                                           device=g.device))
    # partial where x's shard holds only some ids, or x itself is partial
    out_pl = tuple(Partial() if i in split else
                   x.placements[i] if x.placements[i].is_partial() else p
                   for i, p in enumerate(idx_pl))
    return DTensor.from_local(g, mesh, out_pl, run_check=False)


def vocab_lookup(table, tokens):
    """``table[tokens]`` over a DTensor ``table`` (V, d) whose vocab may
    be split over mesh axes, summed over them; each rank indexes its shard
    as a plain table is indexed, so the gradient accumulates in the same
    order (``F.embedding``'s backward sums its rows in another)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not is_dtensor(table):
        return table[tokens.to(torch.int64)]
    mesh = table.device_mesh
    names = list(mesh.mesh_dim_names)
    split = [i for i, p in enumerate(table.placements)
             if p.is_shard() and p.dim == 0]
    tok_pl = tuple(Replicate() if i in split else p
                   for i, p in enumerate(tokens.placements))
    tl = to_local(table, {i for i, p in enumerate(tok_pl) if p.is_shard()})
    j = tokens.redistribute(mesh, tok_pl).to_local().to(torch.int64)
    for i in split:     # this rank's first vocab id (one split axis)
        j = j - _coord(mesh, names[i]) * tl.shape[0]
    inside = (j >= 0) & (j < tl.shape[0])
    rows = tl[torch.clamp(j, 0, tl.shape[0] - 1)]
    rows = torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    out = DTensor.from_local(rows, mesh, tuple(
        Partial() if i in split else p for i, p in enumerate(tok_pl)),
        run_check=False)
    return out.redistribute(mesh, tok_pl)


def _row_split(x):
    """(shards, this rank's index among them) of a DTensor's dim 0, the
    split's mesh dims major first."""
    mesh = x.device_mesh
    sizes = mesh_axes(mesh)
    n, i = 1, 0
    for name, p in zip(mesh.mesh_dim_names, x.placements):
        if p.is_shard() and p.dim == 0:
            n, i = n * sizes[name], i * sizes[name] + _coord(mesh, name)
    return n, i


def _shift(i, rows, per, period):
    """The zero rows before shard ``i``'s ``rows`` rows in its padded
    share of ``per`` rows, so that its row j, global row ``i * rows + j``
    unpadded, lands on global row ``i * per + shift + j`` of the same
    residue modulo ``period``."""
    return i * (rows - per) % period


def pad_rows(x, total, period=1):
    """``x`` (R, ...) with zero rows after it, so that the rows number
    ``total``. On a DTensor split on its rows each rank pads its own shard
    to its share of ``total``, with zero rows before its rows too where
    that keeps every row's global index modulo ``period`` (the MoE
    ``balanced`` dispatch: copy i goes to expert i % E, as off a mesh),
    whether or not a share is a multiple of ``period``; no rank moves a
    row (DTensor would gather them whole, and torch 2.11 cannot pad a
    DTensor at all)."""
    from torch.distributed.tensor import DTensor

    if not is_dtensor(x):
        return torch.nn.functional.pad(
            x, (0, 0) * (x.dim() - 1) + (0, total - x.shape[0]))
    n, i = _row_split(x)
    if total % n or x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} or {total} rows do not split over "
                         f"{n} shards")
    rows, per = x.shape[0] // n, total // n
    shift = _shift(i, rows, per, period)
    if shift + rows > per:
        raise ValueError(f"a shard of {per} rows cannot hold {rows} rows "
                         f"after {shift} zero rows")
    xl = torch.nn.functional.pad(x.to_local(), (0, 0) * (x.dim() - 1)
                                 + (shift, per - shift - rows))
    return DTensor.from_local(xl, x.device_mesh, x.placements,
                              run_check=False)


def unpad_rows(y, rows, period=1):
    """The inverse of ``pad_rows``: the ``rows`` rows of ``y`` that
    ``pad_rows(x, y.shape[0], period)`` took from an ``x`` of ``rows``
    rows split as ``y`` is."""
    from torch.distributed.tensor import DTensor

    if not is_dtensor(y):
        return y[:rows]
    n, i = _row_split(y)
    shift = _shift(i, rows // n, y.shape[0] // n, period)
    return DTensor.from_local(y.to_local()[shift:shift + rows // n],
                              y.device_mesh, y.placements, run_check=False)


def scatter_rows(buf, index, rows):
    """``buf[index] = rows``, returning the written buffer: ``buf`` itself
    on a plain tensor; on a DTensor ``buf`` a new one, ``index`` and
    ``rows`` gathered whole and each rank writing its copy out of place,
    so that the rows' gradient flows through it."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(buf):
        buf[index] = rows
        return buf
    mesh = buf.device_mesh
    whole = tuple(Replicate() for _ in buf.placements)
    if tuple(buf.placements) != whole:
        raise ValueError("scatter_rows writes a replicated buffer")
    il, rl = (t.redistribute(mesh, whole).to_local() for t in (index, rows))
    out = buf.to_local().index_put((il,), rl.to(buf.dtype))
    return DTensor.from_local(out, mesh, whole, run_check=False)


def _whole(x, dims):
    """x with its ``dims`` gathered whole (other splits kept)."""
    from torch.distributed.tensor import Replicate

    dims = {d % x.dim() for d in dims}
    want = tuple(Replicate() if p.is_shard() and p.dim in dims else p
                 for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)


def _per_shard(fn, x, dims):
    """``fn`` on each rank's shard of x, its ``dims`` gathered whole; the
    result split as x is."""
    from torch.distributed.tensor import DTensor

    x = _whole(x, dims)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False)


def pad(x, pads, value=0.0):
    """``F.pad(x, pads, value=value)``; per shard on a DTensor."""
    if not is_dtensor(x):
        return torch.nn.functional.pad(x, pads, value=value)
    dims = [x.dim() - 1 - i // 2 for i, p in enumerate(pads) if p]
    return _per_shard(lambda t: torch.nn.functional.pad(t, pads,
                                                        value=value), x, dims)


def cummax(x, dim):
    """``torch.cummax(x, dim).values``; per shard on a DTensor."""
    if not is_dtensor(x):
        return torch.cummax(x, dim=dim).values
    return _per_shard(lambda t: torch.cummax(t, dim=dim).values, x, [dim])


def take_rows(src, index):
    """``src[index]`` on a DTensor ``src`` gathered whole, each rank taking
    the rows of its shard of ``index`` (all of a plain ``index``)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(src):
        return src[index]
    whole = tuple(Replicate() for _ in src.placements)
    src = src.redistribute(src.device_mesh, whole)
    if not is_dtensor(index):
        index = DTensor.from_local(index, src.device_mesh, whole,
                                   run_check=False)
    rows = to_local(src, {i for i, p in enumerate(index.placements)
                          if p.is_shard()})[index.to_local()]
    return DTensor.from_local(rows, src.device_mesh, index.placements,
                              run_check=False)


def write_slot(buf, val, slot, seq_dim):
    """``buf[b, ..., slot[b]] = val[b]`` in place on each rank's shard:
    ``buf`` a DTensor cache (B, ..., S, ...) with its slots on dim
    ``seq_dim``, ``val`` its rows (``buf``'s shape without that dim),
    ``slot`` (B,) int64, clamped into the shard. Returns ``buf``."""
    if not is_dtensor(buf):
        return _write_slot_local(buf, val, slot, seq_dim, 0)
    mesh = buf.device_mesh
    B = buf.shape[0]
    ba = _fit(mesh, B, _dp(mesh))
    split = _model_dim(buf)
    dims = [ba] + [None] * (buf.dim() - 1)
    if split is not None:
        dims[split] = "model"
    b_spec = tuple(dims)
    v_dims = dims[:seq_dim] + dims[seq_dim + 1:]
    S_l = buf.to_local().shape[seq_dim]

    def local(bl, vl, sl):
        off = _coord(mesh, "model") * S_l if split == seq_dim else 0
        return _write_slot_local(bl, vl, sl, seq_dim, off)

    run_local(local, (buf, val, slot), (b_spec, tuple(v_dims), (ba,)),
              b_spec, mesh)
    return buf


def _write_slot_local(bl, vl, sl, seq_dim, off):
    """``write_slot`` on a plain tensor whose first slot is ``off``."""
    s = torch.clamp(sl - off, 0, bl.shape[seq_dim] - 1)
    b = torch.arange(bl.shape[0], device=bl.device)
    bl.movedim(seq_dim, 1).index_put_((b, s), vl.to(bl.dtype))
    return bl

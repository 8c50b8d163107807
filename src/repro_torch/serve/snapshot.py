"""Crash-consistent engine snapshot and restore (the port of
``repro/serve/snapshot.py``, DESIGN.md §13).

``save_snapshot(engine, path)`` serializes a ``ServeEngine`` between
ticks — the device KV state, the paged ``BlockPool`` (tables, refcounts,
free list, prefix index, cached tier), every live request (in its slot or
queued, in order), per-request deadline budgets, the admission sequence
and rid allocator, and the whole metrics registry — into one ``.npz``
written atomically (a temporary file, then ``os.replace``), so a crash
mid-save leaves the old file or the new one, never half of one.

``restore_engine(path, params, cfg, device=...)`` builds an engine of the
same shape from the snapshot's recorded constructor arguments, then copies
the saved state into it: the device leaves are copied into the fresh
engine's tensors in place (the pools the kernels' block tables index are
not reallocated), on the engine's device. The guarantees:

  * mid-flight temperature-0 requests continue exactly as in an engine
    that never stopped: the resumption state (``pos``, ``prefill_toks``,
    ``out``), the device caches and the block tables round-trip exactly;
    temperature > 0 streams too, since a row's sampling seed is a function
    of (engine seed, ``admit_order``, ``len(out)``), all serialized;
  * the cached prefix tier survives: a prompt re-submitted after restore
    splices its prefix instead of prefilling it again;
  * counters, gauges and histograms resume from their saved values (the
    engine-step clock with them, which keeps step deadlines valid).
    Wall-clock quantities do not cross processes: request timestamps
    restore as None (the ms histograms skip them) and wall-clock deadline
    budgets re-arm in full against the restoring process's clock.

Weights are not serialized: ``params`` and ``cfg`` come from the caller,
and a snapshot of another architecture (config name, state leaves'
shapes and dtypes) is refused with a ValueError. Device leaves are stored
as raw bytes (``t.view(torch.uint8)``), with dtype and shape in the JSON
header (schema version 1), so bfloat16 leaves never pass through numpy's
float types.

The format is this package's own: a snapshot of ``repro``'s engine does
not restore here, nor one of this engine into ``repro`` (that engine
keeps a JAX PRNG key, this one integer seeds).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

SNAPSHOT_VERSION = 1

# Request fields that are host clock readings: perf_counter bases mean
# nothing in another process, so they restore as None
_TIME_FIELDS = ("submit_time", "admit_time", "last_token_time",
                "first_token_time")


def _np_default(o):
    """JSON fallback for numpy scalars (token lists may carry np.int64
    elements straight from a caller's generator)."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


def _leaves(state):
    """The state's tensors in a fixed order, with their names."""
    return [(f"{i}/{name}", leaf)
            for i, cache in enumerate(state["caches"])
            for name, leaf in cache.items()]


def _request_to_json(req) -> dict:
    d = dataclasses.asdict(req)
    for f in _TIME_FIELDS:
        d[f] = None
    return d


def _request_from_json(d):
    from repro_torch.serve.engine import Request
    return Request(**d)


def save_snapshot(engine, path: str) -> dict:
    """Write a crash-consistent snapshot of ``engine`` to ``path``; call it
    between ticks. Returns the JSON header (for logging)."""
    leaves = _leaves(engine.state)
    live = []
    for s, req in enumerate(engine.requests):
        if req is not None:
            ent = _request_to_json(req)
            ent["_slot"] = s
            live.append(ent)
    deadlines = {}
    for req in list(engine.requests) + list(engine.queue):
        if req is None:
            continue
        ent = engine.deadlines._armed.get(req.rid)
        if ent is not None:
            # [step_budget, step_base, wall_budget]: the step base stays
            # absolute (the step counter round-trips with the metrics);
            # the wall budget re-arms in full at restore
            deadlines[str(req.rid)] = [ent[0], ent[1], ent[2]]
    meta = {
        "version": SNAPSHOT_VERSION,
        "cfg_name": engine.cfg.name,
        "ctor": dict(engine._ctor),
        "n_leaves": len(leaves),
        "leaves": [{"name": name, "dtype": str(t.dtype).split(".")[-1],
                    "shape": list(t.shape)} for name, t in leaves],
        "paged": engine.paged,
        "requests": live,
        "queue": [_request_to_json(r) for r in engine.queue],
        "deadlines": deadlines,
        "admit_seq": engine._admit_seq,
        "next_rid": engine._next_rid,
        "rids": sorted(engine._rids),
        "pool": engine.pool.dump_state() if engine.paged else None,
        "metrics": engine.metrics.dump_values(),
    }
    entries = {"meta": np.asarray(json.dumps(meta, default=_np_default))}
    for i, (_, t) in enumerate(leaves):
        entries[f"leaf_{i}"] = (t.detach().contiguous().reshape(-1)
                                .view(torch.uint8).cpu().numpy())
    entries["lengths"] = np.asarray(engine.lengths)
    entries["cur_tok"] = np.asarray(engine.cur_tok)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **entries)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic on POSIX: the old file or the new
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return meta


def restore_engine(path: str, params, cfg, *, metrics=None, trace=False,
                   eager_ticks=False, device="cuda"):
    """Rebuild a ``ServeEngine`` on ``device`` from a snapshot written by
    ``save_snapshot``. ``params`` and ``cfg`` must be those the saving
    engine served: a snapshot of another architecture raises ValueError
    (a cache read under the wrong shapes would be wrong, not restarted).
    ``eager_ticks`` is the engine's own (how it ticks, not what it holds,
    so the snapshot does not record it)."""
    from repro_torch.serve.engine import ServeEngine

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"][()]))
        if meta.get("version") != SNAPSHOT_VERSION:
            raise ValueError(
                f"snapshot {path!r} has version {meta.get('version')!r}; "
                f"this build reads version {SNAPSHOT_VERSION}")
        if meta["cfg_name"] != cfg.name:
            raise ValueError(
                f"snapshot {path!r} was taken from config "
                f"{meta['cfg_name']!r} but restore got {cfg.name!r}; "
                f"pass the matching checkpoint")
        raw = [np.asarray(z[f"leaf_{i}"]) for i in range(meta["n_leaves"])]
        lengths = np.asarray(z["lengths"])
        cur_tok = np.asarray(z["cur_tok"])

    engine = ServeEngine(params, cfg, metrics=metrics, trace=trace,
                         eager_ticks=eager_ticks, device=device,
                         **meta["ctor"])
    fresh = _leaves(engine.state)
    if len(fresh) != meta["n_leaves"]:
        raise ValueError(
            f"snapshot {path!r} carries {meta['n_leaves']} state leaves "
            f"but {cfg.name!r} builds {len(fresh)}; config/checkpoint "
            f"mismatch")
    for (name, ref), spec in zip(fresh, meta["leaves"]):
        dtype = str(ref.dtype).split(".")[-1]
        if (spec["name"] != name or spec["dtype"] != dtype
                or list(ref.shape) != spec["shape"]):
            raise ValueError(
                f"snapshot leaf {spec['name']} is {spec['dtype']}"
                f"{spec['shape']} but the rebuilt engine's {name} is "
                f"{dtype}{list(ref.shape)}; config/checkpoint mismatch")
    for (_, ref), r in zip(fresh, raw):
        got = torch.from_numpy(r).view(ref.dtype).reshape(ref.shape)
        ref.copy_(got)
    engine.lengths[:] = lengths
    engine.cur_tok[:] = cur_tok
    if meta["paged"]:
        engine.pool.load_state(meta["pool"])
    engine.metrics.load_values(meta["metrics"])
    engine._admit_seq = int(meta["admit_seq"])
    engine._next_rid = int(meta["next_rid"])
    engine._rids = set(meta["rids"])
    for ent in meta["requests"]:
        s = ent.pop("_slot")
        engine.requests[s] = _request_from_json(ent)
    engine.queue = [_request_from_json(d) for d in meta["queue"]]
    now = time.perf_counter()
    for rid_s, (sb, s0, wb) in meta["deadlines"].items():
        rid = int(rid_s)
        if sb is not None:
            engine.deadlines.arm(rid, step_budget=sb, step_base=s0)
        if wb is not None:
            # a wall budget restarts in full on this process's clock:
            # generous, but the time spent in a dead process is not known,
            # and a tighter guess would expire requests that were inside
            # their budget at the crash
            engine.deadlines.arm(rid, wall_budget=wb, wall_base=now)
    return engine

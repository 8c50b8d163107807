"""Multi-device dry run: run one (arch x shape) cell of the production mesh
over a fake process group, count its per-device ops and write the
reference's roofline JSON (the port of ``repro/launch/dryrun.py``).

``lower_cell`` initialises a fake process group of 256 ranks (16 x 16)
or 512 (2 x 16 x 16) in this one process, builds the mesh on it, makes
the cell's state on the ``meta`` device (nothing is drawn or allocated)
and distributes it as DTensors by ``sharding/rules.py``, then runs, under
``launch/op_costs.py``'s counter, one train step (AdamW at the config's
``opt_state_dtype``), one ``forward`` to the last position's logits, or
one ``decode_step`` on a contiguous decode state. DTensor propagates every
op and issues the collectives a rank needs; each rank's local ops run on
``meta`` tensors, the attention calls through the kernel wrappers' meta
routes, which report their analytic cost. Nothing needs a card, and
importing this module initialises nothing.

An MoE cell dispatches ``balanced`` for train and prefill and ``scatter``
for decode, as the reference's does; ``balanced`` runs the expert GEMMs in
the expert-parallel region (``layers/moe.py:_expert_ffn_ep``), the
reference's ``shard_map``.

The JSON has the reference's keys. ``compile_s`` is 0: nothing compiles.
``lower_s`` is the seconds the cell took to build and run. Its
``bytes_per_device`` is reckoned from the meta tensors of rank 0:
``arguments`` the exact bytes of the local shards of the inputs,
``outputs`` those of the outputs, ``aliased`` the outputs that are inputs
updated in place (a decode state), ``temps`` the peak of the bytes the
program's ops allocated and still held (``OpCounter``'s live bytes) less
the outputs, and ``peak_estimate`` arguments + outputs + temps - aliased:
an estimate from tensor sizes, no allocator's measurement.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
      --shape train_4k [--multi-pod] [--variant expmul] [--out out.json]

Exit code 0 == the cell ran on the mesh and its JSON was written.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time

from repro_torch.configs import SHAPES, SUBQUADRATIC_ARCHS, get_config
from repro_torch.launch.mesh import (
    make_debug_mesh,
    make_production_mesh,
    production_shape,
    set_mesh,
)
from repro_torch.launch.op_costs import OpCounter
from repro_torch.launch.roofline import analyze, model_flops_per_device
from repro_torch.models.inputs import input_specs
from repro_torch.sharding.layouts import FixedLayouts
from repro_torch.sharding.rules import (
    batch_shardings,
    decode_state_shardings,
    distribute,
    param_shardings,
    state_shardings,
)
from repro_torch.tree import tree_leaves


def _local(leaf):
    """Rank 0's shard of a DTensor (the tensor itself otherwise)."""
    from torch.distributed.tensor import DTensor

    return leaf._local_tensor if isinstance(leaf, DTensor) else leaf


def _local_bytes(leaves) -> int:
    return sum(_local(t).numel() * _local(t).element_size() for t in leaves)


def fake_process_group(world_size: int):
    """Initialise the fake process group of ``world_size`` ranks (this
    process is rank 0); the caller destroys it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _run(cfg, shape, kind, mesh, moe_impl):
    """Build rank 0's meta state for the cell, run it under the counter;
    returns (counter, the ops resharded for, arguments, outputs)."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.api import (
        decode_step,
        forward,
        init_decode_state,
        init_model,
    )
    from repro_torch.optim.adamw import adamw
    from repro_torch.train.step import build_train_step, make_train_state_specs

    B, S = shape.global_batch, shape.seq_len
    batch = input_specs(cfg, seq_len=S, global_batch=B, kind=kind)
    batch = distribute(batch, batch_shardings(batch, mesh), mesh)
    counter, layouts = OpCounter(), FixedLayouts()
    with set_mesh(mesh), implicit_replication():
        if kind == "train":
            opt = adamw(3e-4, moment_dtype=cfg.opt_state_dtype)
            state = make_train_state_specs(cfg, opt)
            state = distribute(state, state_shardings(state, mesh), mesh)
            step = build_train_step(cfg, opt, moe_impl=moe_impl)
            args = (state, batch)
            with counter, layouts:
                out = step(state, batch)
        else:
            params = init_model(cfg, device="meta")
            params = distribute(params, param_shardings(params, mesh), mesh)
            if kind == "prefill":
                args = (params, batch)
                with counter, layouts, torch.no_grad():
                    out = forward(params, batch, cfg,
                                  moe_impl=moe_impl)[:, -1, :]
            else:
                kw = ({"enc_len": cfg.frontend_tokens}
                      if cfg.encoder_layers else {})
                state = init_decode_state(cfg, B, S, device="meta", **kw)
                state = distribute(
                    state, decode_state_shardings(state, mesh, cfg), mesh)
                args = (params, state, batch)
                with counter, layouts, torch.no_grad():
                    out = decode_step(params, state, batch["tokens1"],
                                      batch["lengths"], cfg)
    return counter, layouts.resharded, args, out


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               variant: str | None = None, moe_impl: str | None = None,
               extra_overrides: dict | None = None, smoke: bool = False,
               shape=None, debug_mesh: tuple | None = None):
    """Run one cell on the mesh; returns (counts, meta dict). ``shape``
    (a ``ShapeSpec``) replaces ``SHAPES[shape_name]`` and ``debug_mesh``
    (n_data, n_model) the production mesh, for small runs."""
    import torch.distributed as dist

    shape = shape or SHAPES[shape_name]
    overrides = dict(extra_overrides or {})
    if variant:
        overrides["attention_variant"] = variant
    cfg = get_config(arch, smoke=smoke, **overrides)
    if moe_impl is None:
        moe_impl = "balanced" if (cfg.moe and shape.kind != "decode") \
            else "scatter"
    if debug_mesh:
        mesh_name = "x".join(str(n) for n in debug_mesh)
        n_dev = debug_mesh[0] * debug_mesh[1]
    else:
        dims, _ = production_shape(multi_pod)
        mesh_name = "x".join(str(n) for n in dims)
        n_dev = 1
        for n in dims:
            n_dev *= n
    # DTensor warns of each two-step reduction (Partial on two mesh axes):
    # a cost the counter sees, not a fault
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    t0 = time.time()
    fake_process_group(n_dev)
    try:
        mesh = (make_debug_mesh(*debug_mesh) if debug_mesh
                else make_production_mesh(multi_pod=multi_pod))
        counter, resharded, args, out = _run(cfg, shape, shape.kind, mesh,
                                             moe_impl)
        lower_s = time.time() - t0
        counts = dict(counter.totals(), resharded_ops=resharded)
        ins = tree_leaves(args)
        outs = tree_leaves(out)
        arguments, outputs = _local_bytes(ins), _local_bytes(outs)
        held = {id(_local(t)) for t in ins}
        aliased = _local_bytes([t for t in outs if id(_local(t)) in held])
    finally:
        dist.destroy_process_group()
    temps = max(0, counter.peak_live - outputs)
    rf = analyze(counts, model_flops_per_device=model_flops_per_device(
        cfg, shape, n_dev))
    meta = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": mesh_name,
        "n_devices": n_dev,
        "variant": cfg.attention_variant,
        "moe_impl": moe_impl,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "lower_s": round(lower_s, 1),
        "compile_s": 0.0,
        "bytes_per_device": {
            "arguments": arguments,
            "outputs": outputs,
            "temps": temps,
            "aliased": aliased,
            "peak_estimate": arguments + outputs + temps - aliased,
        },
        "roofline": rf.to_dict(),
    }
    return counts, meta


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default=None,
                    choices=[None, "exact", "expmul"])
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, "scatter", "balanced"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides key=value "
                    "(e.g. attention_block_k=1024)")
    args = ap.parse_args(argv)

    if args.shape == "long_500k" and args.arch not in SUBQUADRATIC_ARCHS:
        print(f"SKIP {args.arch} x long_500k: full-attention arch")
        return 0

    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    counts, meta = lower_cell(
        args.arch, args.shape, multi_pod=args.multi_pod,
        variant=args.variant, moe_impl=args.moe_impl,
        extra_overrides=overrides,
    )
    print(json.dumps(meta, indent=2))
    print("attention calls:", counts["attention_calls"],
          "ops resharded for:", counts["resharded_ops"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(meta, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())

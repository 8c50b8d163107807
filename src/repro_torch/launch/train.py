"""Training launcher: config, synthetic data on one device, the train step
(microbatching, gradient compression), async checkpoints, straggler
watchdog and restart on failure.

  python -m repro_torch.launch.train --arch gemma-7b --smoke \
      --steps 100 --batch 8 --seq 128 [--ckpt-dir DIR --ckpt-every 50] \
      [--variant exact|expmul] [--compress-grads] [--inject-fault-at N] \
      [--device cuda|cpu]

(with ``src`` on ``PYTHONPATH``). Every arch of the registry trains. The
flags and their defaults are those of ``repro.launch.train``, as is what
they do: the model runs in float32 with random weights from seed 0, the
optimizer is ``adamw(cosine_schedule(lr, 20, steps))`` with its moments in
``cfg.opt_state_dtype`` (bfloat16 for arctic-480b and kimi-k2-1t-a32b),
the data ``SyntheticLMDataset(vocab, seq, seed=0)``, and a config with a
frontend (llava-next-34b, seamless-m4t-medium) gets zero
``frontend_embeds`` of ``(batch, frontend_tokens, frontend_dim)`` in
``cfg.dtype``. ``--compress-grads`` runs each step's gradients through
``error_feedback_int8`` before the clip, its residuals (from
``init_residuals``) carried from step to step and not checkpointed. A
checkpoint in ``--ckpt-dir`` is resumed. ``--device`` defaults to ``cuda``
and fails without a card; ``--device cpu`` runs the attention kernels'
plain versions (use ``--smoke`` there). ``main`` returns the loss of
every step run.

On a mesh: run under torchrun (``WORLD_SIZE`` set), as the reference
runs per host,

  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
      --smoke --device cpu

and the launcher initialises the process group (NCCL for ``--device
cuda`` on ``cuda:{LOCAL_RANK}``, one card a rank; gloo for ``--device
cpu``), builds ``make_mesh_for_host()`` ((world / 2, 2) from 4 ranks up,
else (world, 1)), draws the same weights on every rank and keeps each
rank's shards of the state by ``sharding/rules.py:state_shardings``,
loads each step's rows through ``ShardedLoader``, runs each step under
the mesh (``set_mesh``: the activation constraints and FSDP's gather on
use; ``sharding/layouts.py``'s fixed layouts, as the dry run counts
them), checkpoints each rank's shards and resumes onto the mesh it runs
on, whatever mesh wrote the step. Rank 0 logs. The process group is
destroyed on exit. Without ``WORLD_SIZE`` it is the one-device launcher.
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import os

import numpy as np
import torch

from repro_torch.checkpoint.restore import latest_step, restore_checkpoint
from repro_torch.checkpoint.save import AsyncCheckpointer
from repro_torch.configs import get_config
from repro_torch.data.sharded_loader import ShardedLoader
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.distributed.compression import (
    error_feedback_int8,
    init_residuals,
)
from repro_torch.launch.mesh import make_mesh_for_host, set_mesh
from repro_torch.models.api import init_model, resolve_device
from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.reliability import (
    FaultInjector,
    RestartSupervisor,
    StragglerWatchdog,
)
from repro_torch.sharding.regions import is_dtensor
from repro_torch.sharding.rules import (
    batch_shardings,
    shard_local,
    state_shardings,
)
from repro_torch.train.step import build_train_step, make_train_state
from repro_torch.tree import tree_leaves, tree_unflatten_like

log = logging.getLogger("repro_torch.train")


def init_distributed(device):
    """Under torchrun: initialise the process group (NCCL on
    ``cuda:{LOCAL_RANK}``, gloo on the CPU) and return (this rank's
    device, ``make_mesh_for_host()``); without ``WORLD_SIZE``, (device,
    None)."""
    if "WORLD_SIZE" not in os.environ:
        return device, None
    import torch.distributed as dist

    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device, make_mesh_for_host(device_type=device.type)


def _shard(tree, shardings, mesh):
    """Each rank's shards of ``tree`` (whole on every rank) by the
    ``Sharding`` tree ``shardings``."""
    return tree_unflatten_like(tree, [
        shard_local(leaf, sh.spec, mesh)
        for leaf, sh in zip(tree_leaves(tree), tree_leaves(shardings))])


def _value(t) -> float:
    return float(t.full_tensor() if is_dtensor(t) else t)


def _on_mesh(mesh):
    """The context a step runs in on ``mesh``: the current mesh, plain
    tensors taken as replicated, the fixed layouts; nothing off a mesh."""
    stack = contextlib.ExitStack()
    if mesh is not None:
        from torch.distributed.tensor.experimental import (
            implicit_replication,
        )

        from repro_torch.sharding.layouts import FixedLayouts

        stack.enter_context(set_mesh(mesh))
        stack.enter_context(implicit_replication())
        stack.enter_context(FixedLayouts())
    return stack


def main(argv=None, cfg_override=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--variant", default=None, choices=[None, "exact", "expmul"])
    ap.add_argument("--inject-fault-at", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "attention kernels' plain versions)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"{e} (--device cpu)")
    try:
        device, mesh = init_distributed(device)
        return _main(args, cfg_override, device, mesh)
    finally:
        import torch.distributed as dist

        if "WORLD_SIZE" in os.environ and dist.is_initialized():
            dist.destroy_process_group()


def _main(args, cfg_override, device, mesh):
    import torch.distributed as dist

    lead = mesh is None or dist.get_rank() == 0
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if not lead:     # rank 0 logs
        log.setLevel(logging.WARNING)
        logging.getLogger("repro_torch.reliability").setLevel(
            logging.WARNING)
    overrides = {"dtype": "float32", "param_dtype": "float32"}
    if args.variant:
        overrides["attention_variant"] = args.variant
    if cfg_override is not None:
        cfg = cfg_override.replace(**overrides)
    else:
        cfg = get_config(args.arch, smoke=args.smoke, **overrides)
    opt = adamw(cosine_schedule(args.lr, 20, args.steps),
                moment_dtype=cfg.opt_state_dtype)
    data = ShardedLoader(SyntheticLMDataset(cfg.vocab_size, args.seq,
                                            seed=0), mesh, device=device)
    residuals = {}

    def grad_transform(grads):
        compressed, residuals["res"] = error_feedback_int8(grads,
                                                           residuals["res"])
        return compressed

    train_step = build_train_step(
        cfg, opt, microbatches=args.microbatches,
        grad_transform=grad_transform if args.compress_grads else None)

    params = init_model(cfg, torch.Generator(device=device).manual_seed(0),
                        device=device)
    state = make_train_state(params, opt)
    del params
    if mesh is not None:
        state = _shard(state, state_shardings(state, mesh), mesh)
    if args.compress_grads:
        residuals["res"] = init_residuals(state["params"])
    start = 0
    ckpt = AsyncCheckpointer(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, start = restore_checkpoint(state, args.ckpt_dir)
        log.info("resumed from step %d", start)

    losses = []

    def step_fn(state, step):
        batch = {"tokens": data.load(step, args.batch)}
        if cfg.frontend:
            batch["frontend_embeds"] = torch.zeros(
                (args.batch, cfg.frontend_tokens, cfg.frontend_dim),
                dtype=getattr(torch, cfg.dtype), device=device)
            if mesh is not None:
                fe = {"fe": batch["frontend_embeds"]}
                batch["frontend_embeds"] = _shard(
                    fe, batch_shardings(fe, mesh), mesh)["fe"]
        with _on_mesh(mesh):
            state, metrics = train_step(state, batch)
        loss = _value(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0:
            log.info("step %d loss %.4f grad_norm %.3f", step, loss,
                     _value(metrics["grad_norm"]))
        return state, {"loss": loss}

    if ckpt:
        def restore():
            st, s = restore_checkpoint(state, args.ckpt_dir)
            log.info("restarted from checkpoint step %d", s)
            return st, s

        sup = RestartSupervisor(
            step_fn, ckpt, restore, ckpt_every=args.ckpt_every,
            watchdog=StragglerWatchdog(),
            fault_injector=FaultInjector(
                [args.inject_fault_at] if args.inject_fault_at else []),
        )
        state, end = sup.run(state, start, args.steps - start)
        log.info("done at step %d; restarts=%d stragglers=%d",
                 end, sup.restarts, len(sup.watchdog.flagged))
    else:
        for s in range(start, args.steps):
            state, _ = step_fn(state, s)

    n = max(1, len(losses) // 10)
    if losses:
        log.info("loss first10 %.4f -> last10 %.4f",
                 float(np.mean(losses[:n])), float(np.mean(losses[-n:])))
    return losses


if __name__ == "__main__":
    main()

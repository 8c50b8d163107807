"""Training launcher: config, synthetic data on one device, the train step
(microbatching), async checkpoints, straggler watchdog and restart on
failure.

  python -m repro_torch.launch.train --arch qwen2-0.5b --smoke \
      --steps 100 --batch 8 --seq 128 [--ckpt-dir DIR --ckpt-every 50] \
      [--variant exact|expmul] [--inject-fault-at N] [--device cuda|cpu]

(with ``src`` on ``PYTHONPATH``). The flags and their defaults are those
of ``repro.launch.train`` that the port supports; ``--compress-grads``
waits for the port's ``distributed/compression.py``. As there, the model
runs in float32 with random weights from seed 0, the optimizer is
``adamw(cosine_schedule(lr, 20, steps))`` and the data
``SyntheticLMDataset(vocab, seq, seed=0)``; a checkpoint in ``--ckpt-dir``
is resumed. ``--device`` defaults to ``cuda`` and fails without a card;
``--device cpu`` runs the attention kernels' plain versions (use
``--smoke`` there). ``main`` returns the loss of every step run.
"""
from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from repro_torch.checkpoint.restore import latest_step, restore_checkpoint
from repro_torch.checkpoint.save import AsyncCheckpointer
from repro_torch.configs import get_config
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.models.api import init_model, resolve_device
from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.reliability import (
    FaultInjector,
    RestartSupervisor,
    StragglerWatchdog,
)
from repro_torch.train.step import build_train_step, make_train_state

log = logging.getLogger("repro_torch.train")


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
    ap.add_argument("--variant", default=None, choices=[None, "exact", "expmul"])
    ap.add_argument("--inject-fault-at", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "attention kernels' plain versions)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"{e} (--device cpu)")
    overrides = {"dtype": "float32", "param_dtype": "float32"}
    if args.variant:
        overrides["attention_variant"] = args.variant
    if cfg_override is not None:
        cfg = cfg_override.replace(**overrides)
    else:
        cfg = get_config(args.arch, smoke=args.smoke, **overrides)
    opt = adamw(cosine_schedule(args.lr, 20, args.steps))
    data = SyntheticLMDataset(cfg.vocab_size, args.seq, seed=0)
    train_step = build_train_step(cfg, opt, microbatches=args.microbatches)

    params = init_model(cfg, torch.Generator(device=device).manual_seed(0),
                        device=device)
    state = make_train_state(params, opt)
    del params
    start = 0
    ckpt = AsyncCheckpointer(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, start = restore_checkpoint(state, args.ckpt_dir)
        log.info("resumed from step %d", start)

    losses = []

    def step_fn(state, step):
        tokens = torch.from_numpy(data.batch(step, args.batch)).to(device)
        state, metrics = train_step(state, {"tokens": tokens})
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0:
            log.info("step %d loss %.4f grad_norm %.3f", step, loss,
                     float(metrics["grad_norm"]))
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

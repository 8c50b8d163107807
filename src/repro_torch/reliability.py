"""Fault-tolerance primitives of the trainer (a copy of the train-side
pieces of ``repro.reliability``):

  * ``StragglerWatchdog`` — EWMA-based slow-step detector.
  * ``FaultInjector`` — step-keyed deterministic fault injection for
    restart drills (raise at step N).
  * ``RestartSupervisor`` — run a step function with checkpoint/restart
    semantics (the single-process analogue of a multi-host restart
    controller), the reference's ``distributed.fault.TrainSupervisor``.

The serving engine's ``DeadlineWatchdog`` is not ported yet.
"""
from __future__ import annotations

import logging
import time

log = logging.getLogger("repro_torch.reliability")


class StragglerWatchdog:
    """Flags steps slower than ``threshold`` x the EWMA of past steps.
    Flagged steps do not poison the moving baseline."""

    def __init__(self, *, alpha: float = 0.1, threshold: float = 2.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma = None
        self.n = 0
        self.flagged = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.n += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_slow = self.n > self.warmup and dt > self.threshold * self.ewma
        if is_slow:
            self.flagged.append((step, dt, self.ewma))
            log.warning("straggler: step %d took %.3fs (ewma %.3fs)",
                        step, dt, self.ewma)
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_slow


class FaultInjector:
    """Deterministic step-keyed failure injection for tests/drills."""

    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.injected = []

    def maybe_fail(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.injected.append(step)
            raise RuntimeError(f"injected fault at step {step}")


class RestartSupervisor:
    """Run a step function with checkpoint/restart semantics.

    ``run(state, start, steps)`` executes ``step_fn(state, step) ->
    (state, metrics)``, checkpointing every ``ckpt_every`` steps and
    restarting from the latest checkpoint (``restore_fn() -> (state,
    step)``) after any failure, up to ``max_restarts``.
    """

    def __init__(self, step_fn, checkpointer, restore_fn, *,
                 ckpt_every: int = 50, max_restarts: int = 3,
                 watchdog: StragglerWatchdog | None = None,
                 fault_injector: FaultInjector | None = None):
        self.step_fn = step_fn
        self.checkpointer = checkpointer
        self.restore_fn = restore_fn
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.watchdog = watchdog or StragglerWatchdog()
        self.fault_injector = fault_injector
        self.restarts = 0
        self.history = []

    def run(self, state, start_step: int, num_steps: int):
        step = start_step
        end = start_step + num_steps
        while step < end:
            try:
                t0 = time.time()
                if self.fault_injector is not None:
                    self.fault_injector.maybe_fail(step)
                state, metrics = self.step_fn(state, step)
                dt = time.time() - t0
                self.watchdog.observe(step, dt)
                self.history.append((step, metrics))
                step += 1
                if step % self.ckpt_every == 0:
                    self.checkpointer.save(state, step)
            except Exception as e:  # noqa: BLE001 — restart controller
                self.restarts += 1
                log.error("step %d failed (%s); restart %d/%d",
                          step, e, self.restarts, self.max_restarts)
                if self.restarts > self.max_restarts:
                    raise
                self.checkpointer.wait()
                state, step = self.restore_fn()
        self.checkpointer.wait()
        return state, step

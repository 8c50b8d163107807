"""Fault-tolerance primitives of the trainer and the serving engine (a
copy of ``repro.reliability``):

  * ``StragglerWatchdog`` — EWMA-based slow-step detector.
  * ``FaultInjector`` — step-keyed deterministic fault injection for
    restart drills (raise at step N).
  * ``RestartSupervisor`` — run a step function with checkpoint/restart
    semantics (the single-process analogue of a multi-host restart
    controller), the reference's ``distributed.fault.TrainSupervisor``.
  * ``DeadlineWatchdog`` — per-key step and wall-clock budgets with an
    ``expired()`` sweep; the serving engine arms one entry per request
    (engine-step budget from admission, wall-clock budget from submit).
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


class DeadlineWatchdog:
    """Per-key step and wall-clock budgets with an expiry sweep.

    ``arm(key, ...)`` registers a key's budgets; a later ``arm`` for the
    same key merges (each budget given replaces that budget and its base),
    so the serving engine can arm the wall-clock budget at submit and the
    step budget at first admission. ``expired(step, now)`` returns every
    armed key whose step budget (``step - step_base >= step_budget``) or
    wall budget (``now - wall_base > wall_budget``) is exhausted; callers
    decide what expiry means (the engine finishes the request with
    ``finish_reason="deadline"``). Keys must be ``disarm``-ed when their
    work completes.
    """

    def __init__(self):
        self._armed: dict = {}  # key -> [step_budget, step_base,
        #                                wall_budget, wall_base]

    def __len__(self) -> int:
        return len(self._armed)

    def arm(self, key, *, step_budget=None, step_base=0,
            wall_budget=None, wall_base=0.0):
        ent = self._armed.get(key)
        if ent is None:
            self._armed[key] = [step_budget, step_base,
                                wall_budget, wall_base]
            return
        if step_budget is not None:
            ent[0], ent[1] = step_budget, step_base
        if wall_budget is not None:
            ent[2], ent[3] = wall_budget, wall_base

    def disarm(self, key):
        self._armed.pop(key, None)

    def budgets(self, key):
        """The (step_budget, wall_budget) pair for ``key`` (None, None when
        unarmed)."""
        ent = self._armed.get(key)
        return (None, None) if ent is None else (ent[0], ent[2])

    def expired(self, step: int, now: float | None = None) -> list:
        now = time.perf_counter() if now is None else now
        out = []
        for key, (sb, s0, wb, w0) in self._armed.items():
            if sb is not None and step - s0 >= sb:
                out.append(key)
            elif wb is not None and now - w0 > wb:
                out.append(key)
        return out

"""Train-side fault tolerance under the reference's names (a copy of
``repro/distributed/fault.py``): the primitives live in
``repro_torch.reliability``, shared with the serving engine's deadline
watchdog, and this module keeps the train-side names importable.

``TrainSupervisor`` wraps the train loop: periodic async checkpoints,
failure detection (any exception or injected fault), and restart from the
latest checkpoint. ``StragglerWatchdog`` flags steps slower than
``threshold`` x the EWMA of past steps. ``FaultInjector`` raises at
scheduled steps for restart drills.
"""
from __future__ import annotations

from repro_torch.reliability import (
    DeadlineWatchdog,
    FaultInjector,
    RestartSupervisor,
    StragglerWatchdog,
)

# the train loop's restart controller is the generic one
TrainSupervisor = RestartSupervisor

__all__ = ["DeadlineWatchdog", "FaultInjector", "RestartSupervisor",
           "StragglerWatchdog", "TrainSupervisor"]

"""Minimal optimizer interface (optax-style), as ``repro.optim.interface``:
init(params) -> state; update(grads, state, params) -> (updates, state).
Updates are ADDED to params by the caller."""
from __future__ import annotations

from typing import Callable, NamedTuple


class Optimizer(NamedTuple):
    init: Callable
    update: Callable

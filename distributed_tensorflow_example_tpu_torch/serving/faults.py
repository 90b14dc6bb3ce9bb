"""Deterministic fault injection for the serving stack — pure Python.

The port's own copy of ``InjectedFault`` and ``FaultPlan`` from the JAX
package's ``serving/faults.py``.  A ``FaultPlan`` is a frozen, seedable
description of WHICH faults fire WHEN, on two deterministic clocks:

- **allocation calls** — ``BlockAllocator.alloc`` numbers its calls
  0, 1, 2, ...; ``alloc_fail_calls`` makes those calls return None
  (what pool exhaustion looks like to admission);
- **tick boundaries** — ``crash_at_ticks`` raises ``InjectedFault`` out
  of the engine's ``step()``, ``stall_at_ticks`` sleeps ``stall_s``
  before executing the tick, ``delay_s`` sleeps before every tick.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


class InjectedFault(RuntimeError):
    """Raised by an armed FaultPlan at a crash tick (a distinct type,
    so an injected death can be told from an organic one)."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One deterministic chaos schedule; every field defaults to
    "never", so ``FaultPlan()`` injects nothing."""

    alloc_fail_calls: Tuple[int, ...] = ()
    crash_at_ticks: Tuple[int, ...] = ()
    stall_at_ticks: Tuple[int, ...] = ()
    stall_s: float = 0.0
    delay_s: float = 0.0

    def __post_init__(self):
        if self.stall_s < 0 or self.delay_s < 0:
            raise ValueError("stall_s and delay_s must be >= 0")
        if self.stall_at_ticks and self.stall_s == 0.0:
            raise ValueError("stall_at_ticks without stall_s is a "
                             "no-op; set stall_s > 0")

    def fail_alloc(self, call_index: int) -> bool:
        return call_index in self.alloc_fail_calls

    def crash(self, tick: int) -> bool:
        return tick in self.crash_at_ticks

    def stall(self, tick: int) -> float:
        return self.stall_s if tick in self.stall_at_ticks else 0.0

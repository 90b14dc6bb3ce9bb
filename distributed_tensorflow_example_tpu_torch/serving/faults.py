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

``simulate_degraded`` replays a request set through a scheduler under
admission control (a bounded queue sheds, deadlines expire) and counts
each request's typed terminal: the pure-Python degraded-mode simulator.
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


@dataclasses.dataclass(frozen=True)
class DegradedSimResult:
    """Closed-form accounting for one degraded replay: every
    submitted request lands in exactly one terminal bucket (the
    terminates-typed invariant, counted) — ``completed`` + ``shed`` +
    ``timed_out`` == requests submitted."""

    completed: int
    shed: int
    timed_out: int
    ticks: int
    completed_frac: float
    terminals: dict    # rid -> "result" | "shed" | "timeout"


def simulate_degraded(scheduler, requests, max_queue: int = 0) -> DegradedSimResult:
    """Replay ``requests`` (``(rid, prompt_len, max_new_tokens,
    arrival[, deadline])`` — deadline in ticks, absolute) through a
    scheduler under admission control: arrivals are fed at their tick,
    a full queue (``max_queue`` > 0 waiting slots) sheds on arrival,
    and the scheduler's own deadline machinery retires expirations.
    Pure Python — the deterministic half of ``bench_serving_degraded``
    and the closed-form oracle the chaos tests pin engine counters
    against."""
    pending = sorted(
        ((tuple(r) + (None,) * (5 - len(r))) for r in requests),
        key=lambda r: (r[3] or 0.0, r[0]))
    total = len(pending)
    terminals = {}
    t = 0.0
    guard = 0
    while pending or not scheduler.idle:
        # feed arrivals due by now; shed on a full waiting queue
        while pending and (pending[0][3] or 0.0) <= t:
            rid, p, n, arrival, deadline = pending.pop(0)
            if max_queue and len(scheduler.waiting) >= max_queue:
                terminals[rid] = "shed"
                continue
            scheduler.submit(rid, p, n, arrival=arrival or 0.0,
                             deadline=deadline)
        plan = scheduler.plan_tick(now=t)
        for rid, _reason in scheduler.take_expired():
            terminals[rid] = "timeout"
        t += 1.0
        if plan is None:
            if not pending and scheduler.idle:
                break
            guard += 1
            if guard > 10_000_000:
                raise RuntimeError("degraded simulation did not "
                                   "converge")
            continue
        for rid in plan.prefills:
            scheduler.record_prefill(rid, now=t)
        scheduler.record_decode(
            [r for r in plan.decodes
             if not scheduler._seq(r).done], now=t)
        guard += 1
        if guard > 10_000_000:
            raise RuntimeError("degraded simulation did not converge")
    for rid in scheduler.finished:
        terminals.setdefault(rid, "result")
    completed = sum(1 for v in terminals.values() if v == "result")
    shed = sum(1 for v in terminals.values() if v == "shed")
    timed_out = sum(1 for v in terminals.values() if v == "timeout")
    if completed + shed + timed_out != total:
        raise AssertionError(
            f"terminates-typed invariant violated in simulation: "
            f"{completed}+{shed}+{timed_out} != {total} requests")
    return DegradedSimResult(
        completed=completed, shed=shed, timed_out=timed_out,
        ticks=scheduler.ticks,
        completed_frac=round(completed / max(1, total), 6),
        terminals=terminals)

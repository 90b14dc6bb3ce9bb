"""Elastic restart: dead-process detection -> bounded retry -> mesh
reform at a smaller width, and the restart timeline — the port's copy of
the JAX package's ``resilience/restart.py``.

``RestartPolicy`` is the pure decision core: fed the heartbeat picture
(``obs/heartbeat.py``), it detects dead processes, retries with
exponential backoff up to a budget and, once retries at the full width
are exhausted and peers are confirmed dead, reforms at the surviving
width.  ``Supervisor`` is the chief-side control loop around an injected
``launch`` callable.  ``backoff_s`` is the one backoff closed form; the
serving engine's supervised restart backs off with it too.

Every decision is narrated: ``RestartNarrator`` appends ``kind:
"restart"`` rows to ``<logs_path>/restarts.jsonl``, the timeline
``obs/aggregate.py`` folds into the run report.  The serving engine
narrates each supervised loop restart there as ``engine_restart``.  The
event vocabulary is ``obs/buckets.RESTART_EVENTS`` and the row contract
``obs/schema.RESTART_EVENT``.

Pure Python: no torch, no numpy.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs.buckets import RESTART_EVENTS
from ..obs.schema import SCHEMA_VERSION


def dead_procs(heartbeats: Dict[int, Tuple[int, float]],
               now: Optional[float] = None,
               dead_after_s: float = 30.0,
               since: Optional[float] = None) -> List[int]:
    """Processes whose newest heartbeat trails the FLEET's newest
    beat by more than ``dead_after_s`` — the straggler report's age
    signal hardened into a liveness verdict. The reference point is
    the front-runner's beat, not the wall clock: heartbeats are
    touched at window boundaries, so a fleet whose windows all take
    minutes must not read as collectively dead — death is a peer the
    REST of the fleet has beaten past. (``now`` caps the reference
    for a degenerate single-beat picture.) ``since`` drops beats
    written before this attempt started (a --resume relaunch
    deliberately keeps the preempted attempt's heartbeat files —
    without the fence every live peer still compiling would read as
    dead; the straggler_report ``since=`` discipline)."""
    now = time.time() if now is None else now
    if since is not None:
        heartbeats = {p: (s, t) for p, (s, t) in heartbeats.items()
                      if t >= since}
    if not heartbeats:
        return []
    reference = min(now, max(t for _s, t in heartbeats.values()))
    return sorted(p for p, (_s, t) in heartbeats.items()
                  if reference - t > dead_after_s)


def backoff_s(attempt: int, base_s: float = 1.0, factor: float = 2.0,
              cap_s: float = 60.0) -> float:
    """Exponential backoff closed form: min(base * factor**attempt,
    cap); attempt counts completed retries (0 -> base)."""
    if attempt < 0:
        raise ValueError(f"attempt={attempt} must be >= 0")
    return min(float(base_s) * float(factor) ** int(attempt),
               float(cap_s))


@dataclasses.dataclass(frozen=True)
class RestartDecision:
    """One policy verdict. ``action``: "retry" (relaunch at the same
    width after ``wait_s``), "reform" (relaunch at ``dp`` — the
    surviving width), or "give_up" (budget exhausted / below
    min_dp)."""

    action: str
    wait_s: float
    dp: int
    attempt: int
    reason: str
    dead: Tuple[int, ...] = ()


class RestartPolicy:
    """Bounded-retry-then-reform. Stateless across calls — the caller
    (Supervisor) tracks the attempt counter, so the decision table is
    a pure function and the tests enumerate it."""

    def __init__(self, max_retries: int = 3, backoff_base_s: float = 1.0,
                 backoff_factor: float = 2.0, backoff_max_s: float = 60.0,
                 dead_after_s: float = 30.0, min_dp: int = 1):
        if max_retries < 0:
            raise ValueError(f"max_retries={max_retries} must be >= 0")
        if min_dp < 1:
            raise ValueError(f"min_dp={min_dp} must be >= 1")
        if backoff_base_s < 0 or backoff_max_s < 0:
            raise ValueError("backoff bounds must be >= 0")
        if backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor={backoff_factor} must be >= 1")
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_factor = float(backoff_factor)
        self.backoff_max_s = float(backoff_max_s)
        self.dead_after_s = float(dead_after_s)
        self.min_dp = int(min_dp)

    def backoff(self, attempt: int) -> float:
        return backoff_s(attempt, self.backoff_base_s,
                         self.backoff_factor, self.backoff_max_s)

    def decide(self, attempt: int, alive: int, dp: int,
               dead: Tuple[int, ...] = ()) -> RestartDecision:
        """Verdict after a failed attempt. ``attempt``: how many
        retries at the CURRENT width already ran (0 = first failure);
        ``alive``: surviving process count; ``dp``: the width the
        failed attempt ran at."""
        if attempt < self.max_retries:
            # inside the retry budget: the failure may be transient
            # (the dead peer may come back) — same width, backed off
            return RestartDecision(
                action="retry", wait_s=self.backoff(attempt), dp=dp,
                attempt=attempt + 1, dead=tuple(dead),
                reason=f"retry {attempt + 1}/{self.max_retries} at "
                       f"dp={dp}")
        if alive < dp and alive >= self.min_dp:
            # budget exhausted and peers confirmed dead: reform at the
            # surviving width and reset the retry budget for it
            return RestartDecision(
                action="reform", wait_s=self.backoff(attempt), dp=alive,
                attempt=0, dead=tuple(dead),
                reason=f"retries exhausted at dp={dp}; reforming at "
                       f"dp={alive} ({len(dead)} dead)")
        return RestartDecision(
            action="give_up", wait_s=0.0, dp=dp, attempt=attempt,
            dead=tuple(dead),
            reason=(f"alive={alive} below min_dp={self.min_dp}"
                    if alive < self.min_dp else
                    f"retries exhausted at dp={dp} with no dead peer "
                    f"to shed"))


RESTARTS_FILE = "restarts.jsonl"


class RestartNarrator:
    """Append-only restart-timeline stream
    (``<logs_path>/restarts.jsonl``). Best-effort like the metrics
    stream (a full volume must not kill the run), thread-safe (the
    writer thread's snapshot events interleave with the main
    thread's), and survives restarts — run-start hygiene deliberately
    spares it (obs.heartbeat.clear_stale_signals), because the
    timeline's whole point is spanning the restart."""

    def __init__(self, logs_path: str, process_index: int = 0):
        os.makedirs(logs_path, exist_ok=True)
        self.process_index = int(process_index)
        self.path = os.path.join(logs_path, RESTARTS_FILE)
        self._lock = threading.Lock()

    def emit(self, event: str, **fields) -> Dict[str, Any]:
        if event not in RESTART_EVENTS:
            raise ValueError(
                f"unknown restart event {event!r}: expected one of "
                f"{RESTART_EVENTS}")
        row = {"kind": "restart", "v": SCHEMA_VERSION, "t": time.time(),
               "proc": self.process_index, "event": event, **fields}
        try:
            with self._lock, open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")
        except (OSError, ValueError):
            pass
        return row


def read_restarts(logs_path: str) -> List[Dict[str, Any]]:
    """Parse restarts.jsonl back (torn lines skipped — a killed
    writer mid-append must not void the timeline)."""
    path = os.path.join(logs_path, RESTARTS_FILE)
    rows: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if isinstance(row, dict):
                    rows.append(row)
    except OSError:
        return []
    return rows


class Supervisor:
    """The chief-side restart loop: launch -> on failure consult the
    policy -> back off -> relaunch (possibly reformed) -> give up.

    ``launch(plan)`` runs ONE attempt to completion and returns its
    exit code; ``plan`` is {"attempt", "dp", "total"}. ``health()``
    reports the post-failure liveness picture as {"alive": count,
    "dead": [proc ids]} (wrap ``dead_procs`` over the heartbeat
    files; defaults to every process alive). ``sleep`` is injectable
    so the backoff schedule is testable without wall-clock."""

    def __init__(self, policy: RestartPolicy,
                 narrator: Optional[RestartNarrator] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.policy = policy
        self.narrator = narrator
        self.sleep = sleep

    def _emit(self, event: str, **fields) -> None:
        if self.narrator is not None:
            self.narrator.emit(event, **fields)

    def run(self, launch: Callable[[Dict[str, Any]], int], dp: int,
            total: Optional[int] = None,
            health: Optional[Callable[[], Dict[str, Any]]] = None
            ) -> Dict[str, Any]:
        """Drive attempts until success or give-up. Returns
        {"completed", "attempts", "dp", "exit_code", "decisions"}."""
        total = dp if total is None else total
        attempt = 0
        launches = 0
        decisions: List[RestartDecision] = []
        while True:
            plan = {"attempt": attempt, "dp": dp, "total": total}
            self._emit("attempt_start", attempt=attempt, dp=dp)
            code = launch(plan)
            launches += 1
            self._emit("attempt_exit", attempt=attempt, dp=dp,
                       exit_code=int(code))
            if code == 0:
                return {"completed": True, "attempts": launches,
                        "dp": dp, "exit_code": 0,
                        "decisions": decisions}
            picture = health() if health is not None else {}
            alive = int(picture.get("alive", total))
            dead = tuple(sorted(picture.get("dead") or ()))
            if dead:
                self._emit("dead_proc", attempt=attempt,
                           dead=list(dead))
            d = self.policy.decide(attempt, alive, dp, dead=dead)
            decisions.append(d)
            if d.action == "give_up":
                self._emit("give_up", attempt=attempt, dp=dp,
                           reason=d.reason)
                return {"completed": False, "attempts": launches,
                        "dp": dp, "exit_code": int(code),
                        "decisions": decisions}
            self._emit(d.action, attempt=attempt, dp=d.dp,
                       wait_s=d.wait_s, reason=d.reason,
                       dead=list(d.dead))
            if d.wait_s > 0:
                self.sleep(d.wait_s)
            attempt = d.attempt
            if d.action == "reform":
                dp = d.dp
                total = alive

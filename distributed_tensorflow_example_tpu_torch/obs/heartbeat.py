"""Multi-process heartbeats and the chief's straggler report — the
port's copy of the JAX package's ``obs/heartbeat.py``.

Each process touches ``<logs_path>/heartbeat.<proc>`` at window
boundaries with its current step and wall time (write-then-rename, so a
reader never sees a torn file).  ``read_heartbeats`` is what the status
server's ``/status`` and the run report read; ``straggler_report`` folds
the files into the chief's max step lag, slowest process and oldest
heartbeat age.  The port's trainer does not touch heartbeats yet
(ROADMAP.md Queue A), so over a serving logs dir the readers find none.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, Optional, Tuple


class Heartbeat:
    """Writer side: ``touch(step)`` at window boundaries."""

    def __init__(self, logs_path: str, process_index: int = 0):
        os.makedirs(logs_path, exist_ok=True)
        self.process_index = int(process_index)
        self.path = os.path.join(logs_path,
                                 f"heartbeat.{self.process_index}")
        # a dead run's file for THIS index must not leak into the new
        # run's report (each process clears only its own file — no
        # cross-process race); peers from a previous wider run are
        # excluded by straggler_report's `since` filter
        try:
            os.remove(self.path)
        except OSError:
            pass

    def touch(self, step: int) -> None:
        # best-effort like the metrics stream: a full volume must not
        # kill the run the heartbeat is monitoring
        try:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"proc": self.process_index, "step": int(step),
                           "t": time.time()}, f)
            os.replace(tmp, self.path)  # atomic on POSIX
        except OSError:
            pass


# flight-dump reasons a RESUMING run must keep: a preemption dump is
# the restart's forensic evidence — clearing it at relaunch would
# erase the very event the restart timeline exists to show
_PRESERVED_FLIGHT_REASONS = ("sigterm", "preempt")


def clear_stale_signals(logs_path: str, resuming: bool = False) -> int:
    """Run-start hygiene, chief-only: remove a previous run's leftover
    per-process signal files from a reused ``logs_path`` — every
    ``heartbeat.*`` (a dead run's peers would otherwise fabricate
    stragglers beyond what ``straggler_report(since=...)`` fences) and
    every ``flight/*.json`` incl. ``report.json`` (a stale dump would
    collate into THIS run's post-mortem and dtx-obs report would mix
    runs). The metrics jsonl streams are append-only history and stay,
    as does the restart timeline (``restarts.jsonl``) — its whole
    point is spanning restarts.

    ``resuming`` (a ``--resume`` relaunch continuing the SAME run):
    the cleanup must not assume a fresh run — it spares every
    ``heartbeat.*`` (the chief's dead-process detection needs the
    preempted attempt's beats to tell a dead peer from a
    never-started one; this run's straggler stats still fence them
    out via ``since``) and every flight dump whose recorded reason is
    a preemption (``sigterm``/``preempt`` — the restart's evidence;
    crash/anomaly dumps from older runs still clear).

    Best-effort (a locked file must not kill the run); returns the
    number of files removed. A live peer's heartbeat written in the
    start-up race is re-touched at its next window boundary, so a
    spurious removal only delays that beat one window."""
    removed = 0
    if not resuming:
        for path in glob.glob(os.path.join(logs_path, "heartbeat.*")):
            try:
                os.remove(path)
                removed += 1
            except OSError:
                pass
    for path in glob.glob(os.path.join(logs_path, "flight", "*.json")):
        if resuming:
            try:
                with open(path) as f:
                    reason = json.load(f).get("reason")
            except (OSError, ValueError):
                reason = None  # torn dump: clear it
            if reason in _PRESERVED_FLIGHT_REASONS:
                continue
        try:
            os.remove(path)
            removed += 1
        except OSError:
            pass
    return removed


def read_heartbeats(logs_path: str) -> Dict[int, Tuple[int, float]]:
    """{proc: (step, wall_time)} for every heartbeat file present.
    A torn/absent file is skipped (its process simply looks stale)."""
    out: Dict[int, Tuple[int, float]] = {}
    for path in glob.glob(os.path.join(logs_path, "heartbeat.*")):
        if path.endswith(".tmp"):
            continue
        try:
            with open(path) as f:
                row = json.load(f)
            out[int(row["proc"])] = (int(row["step"]), float(row["t"]))
        except (OSError, ValueError, KeyError):
            continue
    return out


def straggler_report(logs_path: str,
                     now: Optional[float] = None,
                     since: Optional[float] = None) -> Dict[str, object]:
    """Fold the heartbeat files into the chief's straggler summary:
    ``max_step_lag`` (front-runner step minus laggard step),
    ``slowest_proc`` (the laggard; ties break to the lowest index),
    ``oldest_heartbeat_age_s`` and the participating process count.
    ``since`` drops beats written before this run started (stale
    files from a previous, wider run sharing the logs_path would
    otherwise fabricate phantom stragglers)."""
    beats = read_heartbeats(logs_path)
    if since is not None:
        beats = {p: (s, t) for p, (s, t) in beats.items() if t >= since}
    if not beats:
        return {"procs": 0, "max_step_lag": None, "slowest_proc": None,
                "oldest_heartbeat_age_s": None}
    now = time.time() if now is None else now
    steps = {p: s for p, (s, _t) in beats.items()}
    lead = max(steps.values())
    slowest = min(sorted(steps), key=lambda p: steps[p])
    oldest = min(t for _s, t in beats.values())
    return {
        "procs": len(beats),
        "max_step_lag": lead - steps[slowest],
        "slowest_proc": slowest,
        "oldest_heartbeat_age_s": round(max(0.0, now - oldest), 3),
    }

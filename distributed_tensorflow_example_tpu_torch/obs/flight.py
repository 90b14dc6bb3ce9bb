"""The crash flight recorder: the last K steps survive the crash — the
port's copy of the JAX package's ``obs/flight.py``.

A bounded ring of the last ``K`` step records (step id, loss, timing,
batch index: whatever the loop had on hand, all host-side, no device
traffic) plus an environment snapshot, dumped to
``<logs_path>/flight/<proc>.json``:

- on **crash**: ``sys.excepthook`` chaining AND the train loop's own
  except clause (pytest and embedded callers never reach the
  excepthook);
- on **anomaly**: the ``--on_anomaly=dump`` policy (``obs/anomaly.py``);
- on **SIGUSR1**: on demand from a live run (``kill -USR1 <pid>``), with
  a ``faulthandler`` all-thread stack dump beside it
  (``flight/<proc>.stacks.txt``) — the "is it hung or slow?" probe.

The SIGUSR1 handler is installed through the same chaining helper as
the trainer's SIGTERM/SIGINT handler (``resilience/signals.py``): each
keeps the handler it found and calls it, and each restores it on
uninstall, so neither drops the other.

Dumps are atomic (write-then-rename), best-effort (a full volume must
never mask the original failure) and strict JSON (non-finite floats are
stringified).  ``collate`` is the chief's post-mortem: it folds every
process's dump into ``flight/report.json`` — last step per process, the
step spread (the laggard is usually the culprit), and all anomalies
merged.
"""

from __future__ import annotations

import collections
import faulthandler
import json
import math
import os
import signal
import sys
import time
import traceback
from typing import Any, Dict, List, Optional

from ..resilience.signals import install_chained, restore_handler
from .schema import SCHEMA_VERSION

# the dump's "version" IS the obs schema version (one number for the
# whole package — obs/schema.py documents the history)
FORMAT_VERSION = SCHEMA_VERSION


def _jsonable(x):
    """Strict-JSON-safe copy: NaN/Inf -> strings, unknown types ->
    repr. A forensics dump that a standards-compliant parser rejects
    is a forensics dump that gets lost."""
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, bool) or x is None or isinstance(x, (int, str)):
        return x
    if isinstance(x, float):
        return x if math.isfinite(x) else repr(x)
    try:  # numpy scalars
        import numpy as np

        if isinstance(x, np.integer):
            return int(x)
        if isinstance(x, np.floating):
            return _jsonable(float(x))
        if isinstance(x, np.ndarray):
            return _jsonable(x.tolist())
    except Exception:
        pass
    return repr(x)


def _card_snapshot() -> Dict[str, Any]:
    """The card's name and power limit (``nvidia-smi``, as the chip runs
    record them) and the CUDA build; empty without a card."""
    import subprocess

    import torch

    snap: Dict[str, Any] = {"torch": torch.__version__,
                            "cuda": torch.version.cuda}
    if not torch.cuda.is_available():
        return snap
    idx = torch.cuda.current_device()
    snap["device_count"] = torch.cuda.device_count()
    snap["device_name"] = torch.cuda.get_device_name(idx)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(idx)],
            capture_output=True, text=True, timeout=10, check=True)
        snap["nvidia_smi"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return snap


def env_snapshot(config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One-time environment capture: versions (Python, torch, CUDA), the
    card's name and power limit, the process topology, the operator
    environment variables and (when given) the full run config —
    everything a post-mortem needs to reproduce the context."""
    import platform
    import socket

    snap: Dict[str, Any] = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "env": {k: v for k, v in os.environ.items()
                if k.startswith(("DTX_", "CUDA_", "TORCH_", "NCCL_",
                                 "PYTORCH_"))},
    }
    try:
        snap.update(_card_snapshot())
    except Exception:
        pass
    try:
        from .. import cluster

        snap["process_index"] = cluster.process_index()
        snap["process_count"] = cluster.process_count()
    except Exception:
        pass
    try:
        from .metrics import rss_bytes

        snap["rss_bytes"] = rss_bytes()
    except Exception:
        pass
    if config is not None:
        snap["config"] = _jsonable(config)
    return snap


class FlightRecorder:
    """Bounded ring of step records + dump-on-demand."""

    def __init__(self, logs_path: str, process_index: int = 0,
                 capacity: int = 64, config: Optional[Dict[str, Any]] = None,
                 anomaly_capacity: int = 32, window_capacity: int = 16):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        self.process_index = int(process_index)
        self.dir = os.path.join(logs_path, "flight")
        self.path = os.path.join(self.dir, f"{self.process_index}.json")
        self.stacks_path = os.path.join(
            self.dir, f"{self.process_index}.stacks.txt")
        self.capacity = int(capacity)
        self.records: collections.deque = collections.deque(maxlen=capacity)
        # enriched window records (loss/timing/norms) live in their OWN
        # ring: the bare per-step appends must not evict the few
        # records that actually carry post-mortem signal
        self.windows: collections.deque = collections.deque(
            maxlen=window_capacity)
        self.anomalies: collections.deque = collections.deque(
            maxlen=anomaly_capacity)
        self.env = env_snapshot(config)
        self.dumps = 0
        self.last_reason: Optional[str] = None
        self._prev_excepthook = None
        self._prev_sigusr1 = None
        self._installed = False

    # -- recording (hot path: one deque append, no I/O) --------------------

    def record_step(self, step: int, **fields) -> None:
        self.records.append({"step": int(step), "t": time.time(), **fields})

    def record_window(self, step: int, **fields) -> None:
        """One enriched record per logging window (loss, timing split,
        norms) — its own ring, never evicted by per-step appends."""
        self.windows.append({"step": int(step), "t": time.time(),
                             **fields})

    def attach_loss(self, step: int, loss) -> None:
        """Backfill the fetched loss onto an already-appended step
        record (the anomaly drain learns the loss a few steps after
        dispatch). Right-to-left scan of a <=capacity-long deque —
        cheap, and only runs when --on_anomaly is fetching anyway."""
        for rec in reversed(self.records):
            if rec["step"] == step:
                rec["loss"] = loss
                return
            if rec["step"] < step:
                return

    def record_anomaly(self, step: int, **fields) -> None:
        self.anomalies.append({"step": int(step), "t": time.time(),
                               **fields})

    # -- dumping -----------------------------------------------------------

    def dump(self, reason: str, exc: Optional[BaseException] = None) -> Optional[str]:
        """Write the dump atomically; returns the path, or None on
        failure. NEVER raises — the recorder must not mask the
        failure it is recording."""
        try:
            doc = {
                "version": FORMAT_VERSION,
                "proc": self.process_index,
                "reason": str(reason),
                "t": time.time(),
                "last_step": (self.records[-1]["step"]
                              if self.records else None),
                "steps": _jsonable(list(self.records)),
                "windows": _jsonable(list(self.windows)),
                "anomalies": _jsonable(list(self.anomalies)),
                "env": _jsonable(self.env),
            }
            if exc is not None:
                doc["exception"] = {
                    "type": type(exc).__name__,
                    "message": str(exc)[:2000],
                    "traceback": traceback.format_exception(
                        type(exc), exc, exc.__traceback__)[-30:],
                }
            os.makedirs(self.dir, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, allow_nan=False, indent=1)
            os.replace(tmp, self.path)  # atomic on POSIX
            self.dumps += 1
            self.last_reason = str(reason)
            return self.path
        except Exception as e:
            try:
                print(f"NOTE: flight dump failed: {e}")
            except Exception:
                pass
            return None

    def dump_stacks(self) -> Optional[str]:
        """faulthandler all-thread stack dump next to the flight dump
        (the SIGUSR1 'where is it stuck?' answer)."""
        try:
            os.makedirs(self.dir, exist_ok=True)
            with open(self.stacks_path, "w") as f:
                f.write(f"# proc {self.process_index} stacks @ "
                        f"{time.time()}\n")
                faulthandler.dump_traceback(file=f, all_threads=True)
            return self.stacks_path
        except Exception:
            return None

    # -- hooks -------------------------------------------------------------

    def install(self) -> None:
        """Chain into sys.excepthook and (main thread only) SIGUSR1.
        The train loop ALSO dumps from its own except clause — callers
        that swallow exceptions (pytest, embedding) bypass the
        excepthook entirely."""
        if self._installed:
            return
        self._prev_excepthook = sys.excepthook

        def _hook(tp, val, tb, _prev=sys.excepthook):
            self.dump("crash", exc=val)
            _prev(tp, val, tb)

        sys.excepthook = _hook

        def _on_sigusr1(signum, frame):
            self.dump("sigusr1")
            self.dump_stacks()
            if callable(self._prev_sigusr1):
                self._prev_sigusr1(signum, frame)

        # non-main thread, or a platform without SIGUSR1 -> None
        self._prev_sigusr1 = install_chained(signal.SIGUSR1, _on_sigusr1)
        self._installed = True

    def uninstall(self) -> None:
        if not self._installed:
            return
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        restore_handler(signal.SIGUSR1, self._prev_sigusr1)
        self._prev_sigusr1 = None
        self._installed = False


# -- post-mortem ------------------------------------------------------------


def read_flight(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def collate(logs_path: str, write: bool = True) -> Dict[str, Any]:
    """Chief-side collator: fold every ``flight/<proc>.json`` into one
    post-mortem report (written to ``flight/report.json``). The step
    spread across processes is the blast-radius signal — the process
    whose last step trails the fleet is where to look first."""
    fdir = os.path.join(logs_path, "flight")
    dumps: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(fdir))
    except OSError:
        names = []
    for name in names:
        if not name.endswith(".json") or name == "report.json":
            continue
        try:
            dumps.append(read_flight(os.path.join(fdir, name)))
        except (OSError, ValueError):
            continue  # a torn dump still leaves the others readable
    procs = {}
    anomalies: List[Dict[str, Any]] = []
    for d in dumps:
        procs[str(d.get("proc"))] = {
            "reason": d.get("reason"),
            "last_step": d.get("last_step"),
            "t": d.get("t"),
            "exception": (d.get("exception") or {}).get("type"),
        }
        anomalies.extend(d.get("anomalies") or [])
    steps = [p["last_step"] for p in procs.values()
             if p["last_step"] is not None]
    anomalies.sort(key=lambda a: (a.get("step") or 0))
    report = {
        "version": FORMAT_VERSION,
        "t": time.time(),
        "procs": procs,
        "proc_count": len(procs),
        "min_last_step": (min(steps) if steps else None),
        "max_last_step": (max(steps) if steps else None),
        "step_spread": (max(steps) - min(steps) if steps else None),
        "slowest_proc": (min(
            (p for p in procs if procs[p]["last_step"] is not None),
            key=lambda p: procs[p]["last_step"], default=None)
            if steps else None),
        "anomalies": anomalies,
    }
    if write and dumps:
        try:
            tmp = os.path.join(fdir, "report.json.tmp")
            with open(tmp, "w") as f:
                json.dump(_jsonable(report), f, allow_nan=False, indent=1)
            os.replace(tmp, os.path.join(fdir, "report.json"))
        except OSError:
            pass
    return report


if __name__ == "__main__":  # post-mortem CLI: python -m ...obs.flight LOGS
    print(json.dumps(_jsonable(
        collate(sys.argv[1] if len(sys.argv) > 1 else ".")), indent=1))

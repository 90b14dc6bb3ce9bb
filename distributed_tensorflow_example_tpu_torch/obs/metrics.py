"""The structured metrics stream: one JSON object per logging window —
the port's copy of the JAX package's ``obs/metrics.py``.

``MetricsLogger`` appends newline-delimited JSON to
``<logs_path>/metrics.<proc>.jsonl`` (one file per process, so several
processes never interleave writes).  Two row kinds:

- ``window``: the per-``--log_every``-steps training telemetry —
  step-time p50/p95/max over the window, the host loop's data-wait /
  h2d / dispatch / device-wait / ckpt split, examples/sec, tokens/sec,
  analytic MFU (``obs/flops.py``), process RSS and the card's memory
  counters;
- ``event``: point events (the compile, stragglers, anomalies, run end).

``WindowTimer`` is the host loop's accumulator behind the window rows:
the loop charges each step's phases into named buckets (``data_wait`` =
blocking on the prefetcher, ``h2d`` = committing batches to the card,
``dispatch`` = the step call, ``device_wait`` = blocking fetches and
event waits, ``ckpt`` = the snapshot submit) and records per-step wall
times for the percentiles.  Everything not charged is the ``host``
residual.  The timer adds no device traffic: it only wraps host-side
waits the loop already performs.

``read_metrics`` parses a file back (tests, tooling).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List

import torch

from .buckets import HOST_BUCKET, WINDOW_BUCKETS
from .schema import SCHEMA_VERSION


def rss_bytes():
    """Resident set size of this process via /proc; None where /proc is
    unavailable."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


def device_memory_stats(device=None):
    """The card's memory counters under the JAX package's keys:
    ``bytes_in_use`` and ``peak_bytes_in_use`` from the caching
    allocator (``torch.cuda.memory_stats``), ``bytes_limit`` the card's
    total memory (``get_device_properties``).  ``largest_alloc_size``
    has no torch counterpart and is left out, as JAX's ``keep`` loop
    leaves out a key its backend lacks.  None on the CPU."""
    try:
        if device is None:
            if not torch.cuda.is_available():
                return None
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(device)
        props = torch.cuda.get_device_properties(device)
    except (RuntimeError, AssertionError):
        return None
    out = {}
    for key, src in (("bytes_in_use", "allocated_bytes.all.current"),
                     ("peak_bytes_in_use", "allocated_bytes.all.peak")):
        if src in stats:
            out[key] = int(stats[src])
    out["bytes_limit"] = int(props.total_memory)
    return out


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted list."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, max(0, int(round(
        q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class WindowTimer:
    """Accumulates one logging window's per-step host-loop timing."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.step_times: List[float] = []
        self.buckets: Dict[str, float] = {}
        self._t_start = time.perf_counter()
        self._t_last = self._t_start

    @property
    def steps(self) -> int:
        return len(self.step_times)

    def charge(self, bucket: str, seconds: float) -> None:
        if bucket not in WINDOW_BUCKETS:
            # one registry (obs/buckets.py) names every bucket; an
            # unknown name would silently vanish from the window row
            raise ValueError(f"unknown window bucket {bucket!r}: "
                             f"expected one of {WINDOW_BUCKETS}")
        self.buckets[bucket] = self.buckets.get(bucket, 0.0) + seconds

    def step_done(self) -> None:
        now = time.perf_counter()
        self.step_times.append(now - self._t_last)
        self._t_last = now

    def window_row(self) -> Dict[str, Any]:
        """Timing fields for the closing window; the caller adds the
        identity (step/epoch/cost) and throughput fields, then
        resets."""
        wall = time.perf_counter() - self._t_start
        st = sorted(self.step_times)
        row = {
            "steps": len(st),
            "window_wall_s": round(wall, 6),
            "step_time_p50_ms": round(_percentile(st, 50) * 1e3, 4),
            "step_time_p95_ms": round(_percentile(st, 95) * 1e3, 4),
            "step_time_max_ms": round((st[-1] if st else float("nan"))
                                      * 1e3, 4),
        }
        charged = 0.0
        for bucket in WINDOW_BUCKETS:
            v = self.buckets.get(bucket, 0.0)
            charged += v
            row[f"{bucket}_s"] = round(v, 6)
        row[f"{HOST_BUCKET}_s"] = round(max(0.0, wall - charged), 6)
        return row


def _scrub_nonfinite(row):
    """Strict-JSON-safe copy: NaN/Inf floats stringify ("nan"/"inf"),
    unknown types fall back to repr.  The stream's consumers are
    standards parsers, and a NaN cost is routine under
    ``--on_anomaly=skip``.  One sanitizer for the package: the flight
    recorder's ``_jsonable``."""
    from .flight import _jsonable

    return _jsonable(row)


class MetricsLogger:
    """Append-only JSONL metrics stream, one file per process.
    ``device``: whose memory counters the window rows carry (None: the
    current card, if any)."""

    def __init__(self, logs_path: str, process_index: int = 0,
                 device=None):
        os.makedirs(logs_path, exist_ok=True)
        self.process_index = int(process_index)
        self.device = device
        self.path = os.path.join(logs_path,
                                 f"metrics.{self.process_index}.jsonl")
        self._f = open(self.path, "a", buffering=1)  # line-buffered

    def _emit(self, row: Dict[str, Any]) -> None:
        # telemetry must degrade, never kill the run it observes: a bad
        # fd or a full volume disables the stream instead of raising
        if self._f is None:
            return
        try:
            self._f.write(json.dumps(_scrub_nonfinite(row),
                                     allow_nan=False) + "\n")
        except (OSError, ValueError):
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    def log_window(self, **fields) -> None:
        self._emit({"kind": "window", "v": SCHEMA_VERSION,
                    "t": time.time(),
                    "proc": self.process_index, **fields,
                    "rss_bytes": rss_bytes(),
                    "device_memory": device_memory_stats(self.device)})

    def log_event(self, event: str, **fields) -> None:
        self._emit({"kind": "event", "v": SCHEMA_VERSION,
                    "event": event, "t": time.time(),
                    "proc": self.process_index, **fields})

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is None:
            return
        try:
            self._f.flush()
        finally:
            self._f.close()
            self._f = None


def read_metrics(path: str) -> List[Dict[str, Any]]:
    """Parse a metrics.<proc>.jsonl back into row dicts."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows

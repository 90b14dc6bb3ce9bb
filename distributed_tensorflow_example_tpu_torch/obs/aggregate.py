"""Run-level analytics: the read side of the metrics telemetry — the
port's copy of the JAX package's ``obs/aggregate.py``.

``aggregate(logs_path)`` loads every ``metrics.<proc>.jsonl`` (each row
validated against ``obs/schema.py``), joins heartbeats, flight dumps and
the restart timeline (``restarts.jsonl``), and folds the run into one
report (``obs/schema.RUN_REPORT``): the goodput decomposition of the
wall into the ``obs/buckets.GOODPUT_BUCKETS``, step-time percentiles
across processes, a throughput summary, a subsampled trajectory, and an
anomaly/restart timeline.  It is what the status server's ``/report``
serves.  ``metrics_files`` and ``has_streams`` are the one definition of
a run dir's streams (the status server and the fleet collector reuse
them).  The port's trainer writes its streams (``--metrics``) in the
JAX package's row format, so the report reads either package's.

Everything here is a pure function over files: no torch.
"""

from __future__ import annotations

import glob
import json
import os
import re
import time
from typing import Any, Dict, List, Optional

from . import heartbeat as hb_lib
from . import schema as schema_lib
from .buckets import GOODPUT_BUCKETS

# bucket names, in presentation order; "train" is the goodput bucket,
# "eval"/"sample" are auxiliary useful work, the rest is badput
# ("h2d" = the host wall spent committing batches to their device
# layout — overlapped ahead of dispatch under --device_prefetch).
# The names live in the shared registry (obs/buckets.py).
BUCKETS = GOODPUT_BUCKETS

_METRICS_RE = re.compile(r"metrics\.(\d+)\.jsonl$")


def metrics_files(logs_path: str) -> List[tuple]:
    """[(proc_index, path)] for every metrics stream in a run dir —
    the ONE place the stream naming/discovery convention lives
    (obs/serve.py and the CLI reuse it)."""
    out = []
    for path in sorted(glob.glob(os.path.join(logs_path,
                                              "metrics.*.jsonl"))):
        m = _METRICS_RE.search(os.path.basename(path))
        if m:
            out.append((int(m.group(1)), path))
    return out


def has_streams(logs_path: str) -> bool:
    """True when ``logs_path`` looks like a run dir — it holds at
    least one metrics/span stream or a restart timeline.  The fleet
    collector (obs/collector.py) keys source discovery on this, so
    the definition of "a run dir" stays next to ``metrics_files``."""
    from .spans import span_files

    return bool(metrics_files(logs_path) or span_files(logs_path)
                or os.path.exists(os.path.join(logs_path,
                                               "restarts.jsonl")))


def _median(vals: List[float]) -> Optional[float]:
    if not vals:
        return None
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def load_run(logs_path: str, max_errors: int = 20) -> Dict[str, Any]:
    """Load one run's signals: per-process metrics rows (validated),
    heartbeats and flight dumps. Raises FileNotFoundError when there
    is no metrics stream at all; schema drift is collected into
    ``schema_errors`` (capped), not raised — a report over a slightly
    torn log beats no report."""
    procs: Dict[int, List[Dict[str, Any]]] = {}
    errors: List[str] = []
    n_errors = 0
    for pid, path in metrics_files(logs_path):
        rows: List[Dict[str, Any]] = []
        with open(path) as f:
            for i, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                where = f"{os.path.basename(path)}:{i}"
                try:
                    row = json.loads(line)
                except ValueError as e:
                    n_errors += 1
                    if len(errors) < max_errors:
                        errors.append(f"{where}: not JSON ({e})")
                    continue
                errs = schema_lib.validate_metrics_row(row, where=where)
                if errs:
                    n_errors += len(errs)
                    errors.extend(errs[:max(0, max_errors - len(errors))])
                rows.append(row)
        procs[pid] = rows
    if not procs:
        raise FileNotFoundError(
            f"no metrics.<proc>.jsonl under {logs_path!r} — was the run "
            f"started with --metrics (or DTX_METRICS=1)?")
    flights = []
    fdir = os.path.join(logs_path, "flight")
    for path in sorted(glob.glob(os.path.join(fdir, "*.json"))):
        if os.path.basename(path) == "report.json":
            continue
        try:
            with open(path) as f:
                flights.append(json.load(f))
        except (OSError, ValueError):
            n_errors += 1
            if len(errors) < max_errors:
                errors.append(f"{path}: unreadable flight dump")
    # restart timeline (resilience/restart.py RestartNarrator):
    # validated like the metrics rows, folded into the report timeline
    restarts = []
    from ..resilience.restart import read_restarts

    for i, row in enumerate(read_restarts(logs_path), 1):
        errs = schema_lib.validate_restart_row(
            row, where=f"restarts.jsonl:{i}")
        if errs:
            n_errors += len(errs)
            errors.extend(errs[:max(0, max_errors - len(errors))])
        restarts.append(row)
    return {
        "procs": procs,
        "heartbeats": hb_lib.read_heartbeats(logs_path),
        "flights": flights,
        "restarts": restarts,
        "schema_errors": errors,
        "schema_error_count": n_errors,
    }


def _goodput(windows: List[Dict[str, Any]], run_end: Optional[Dict],
             wall: float, lag_steps: int) -> Dict[str, Any]:
    """The decomposition. ``windows`` are the chief's window rows
    (their timing buckets are disjoint by construction: the
    WindowTimer charges waits the loop performs exactly once, and the
    loop excludes compile/eval from window walls)."""
    def wsum(key):
        return sum(float(w.get(key) or 0.0) for w in windows)

    data_wait = wsum("data_wait_s")
    h2d = wsum("h2d_s")
    ckpt = wsum("ckpt_s")
    train = wsum("dispatch_s") + wsum("device_wait_s")
    host = wsum("host_s")
    steps_obs = int(wsum("steps"))
    window_wall = wsum("window_wall_s")
    mean_step_s = (window_wall / steps_obs) if steps_obs else 0.0
    run_end = run_end or {}
    compile_s = float(run_end.get("compile_s") or 0.0)
    eval_s = float(run_end.get("eval_s") or 0.0)
    sample_s = float(run_end.get("sample_s") or 0.0)
    skipped = int(run_end.get("skipped_steps") or 0)
    # carve-outs: skipped steps and straggler idle are train time that
    # did NOT advance training — reclassified out of the train bucket
    anomaly_skipped = min(train, skipped * mean_step_s)
    train -= anomaly_skipped
    straggler_idle = min(train, max(0, lag_steps) * mean_step_s)
    train -= straggler_idle
    known = (train + compile_s + data_wait + h2d + ckpt + host + eval_s
             + sample_s + anomaly_skipped + straggler_idle)
    untracked = max(0.0, wall - known)
    buckets = {
        "train": train,
        "compile": compile_s,
        "data_wait": data_wait,
        "h2d": h2d,
        "ckpt": ckpt,
        "host": host,
        "eval": eval_s,
        "sample": sample_s,
        "anomaly_skipped": anomaly_skipped,
        "straggler_idle": straggler_idle,
        "untracked": untracked,
    }
    buckets = {k: round(v, 6) for k, v in buckets.items()}
    badput = (compile_s + data_wait + h2d + ckpt + host
              + anomaly_skipped + straggler_idle + untracked)
    out = {
        "wall_s": round(wall, 6),
        "buckets": buckets,
        "bucket_sum_s": round(sum(buckets.values()), 6),
        # a negative residual means double-counted buckets — surfaced,
        # never hidden (untracked is clamped at 0)
        "residual_s": round(wall - known, 6),
        "goodput_s": round(train, 6),
        "mean_step_s": round(mean_step_s, 6),
    }
    if wall > 0:
        out["goodput_frac"] = round(train / wall, 6)
        out["aux_frac"] = round((eval_s + sample_s) / wall, 6)
        out["badput_frac"] = round(badput / wall, 6)
    return out


def aggregate(logs_path: str, max_trajectory: int = 200,
              now: Optional[float] = None) -> Dict[str, Any]:
    """Fold one run's signals into the run report (see the module
    docstring for the shape; obs/schema.py RUN_REPORT pins the
    top-level contract)."""
    data = load_run(logs_path)
    procs = data["procs"]
    chief = min(procs)
    chief_rows = procs[chief]
    windows = [r for r in chief_rows if r.get("kind") == "window"]
    events = [r for r in chief_rows if r.get("kind") == "event"]
    run_end = next((r for r in reversed(events)
                    if r.get("event") == "run_end"), None)
    compile_events = [r for r in events if r.get("event") == "compile"]
    straggler_events = [r for r in events
                        if r.get("event") == "stragglers"]

    all_rows_t = [float(r["t"]) for rows in procs.values() for r in rows
                  if isinstance(r.get("t"), (int, float))]
    if run_end is not None and run_end.get("total_time_s") is not None:
        wall = float(run_end["total_time_s"])
        partial = False
    else:
        # live/crashed run: span of the observed rows
        wall = (max(all_rows_t) - min(all_rows_t)) if all_rows_t else 0.0
        partial = True
    # decomposition inputs: run_end when present; a pre-v2 or partial
    # (live/crashed) stream falls back to the compile events
    eff_end = dict(run_end or {})
    if eff_end.get("compile_s") is None:
        eff_end["compile_s"] = sum(
            float(r.get("dispatch_wall_s") or 0.0)
            for r in compile_events)

    # straggler idle: the chief's recorded per-epoch step lag (mean
    # over epochs — each epoch's laggard stalls the collectives for
    # ~lag steps), falling back to the final per-proc window spread
    lags = [int(r["max_step_lag"]) for r in straggler_events
            if isinstance(r.get("max_step_lag"), int)]
    if not lags and len(procs) > 1:
        last_steps = [int(s[-1].get("step") or 0) for s in (
            [r for r in rows if r.get("kind") == "window"]
            for rows in procs.values()) if s]
        if len(last_steps) > 1:
            lags = [int(max(last_steps) - min(last_steps))]
    lag_mean = int(round(sum(lags) / len(lags))) if lags else 0

    goodput = _goodput(windows, eff_end, wall, lag_mean)

    # step-time percentiles across every process's windows
    all_windows = [r for rows in procs.values() for r in rows
                   if r.get("kind") == "window"]

    def col(key):
        return [float(r[key]) for r in all_windows
                if isinstance(r.get(key), (int, float))]

    step_time = {
        "p50_ms": _median(col("step_time_p50_ms")),
        "p95_ms": max(col("step_time_p95_ms"), default=None),
        "max_ms": max(col("step_time_max_ms"), default=None),
        "windows": len(all_windows),
    }

    mfus = col("mfu")
    eps = col("examples_per_sec")
    throughput = {
        "examples_per_sec_mean": round(sum(eps) / len(eps), 3) if eps
        else None,
        "examples_per_sec_last": eps[-1] if eps else None,
        "mfu_mean": round(sum(mfus) / len(mfus), 6) if mfus else None,
        "mfu_best": max(mfus, default=None),
        "tokens_per_sec_last": (col("tokens_per_sec") or [None])[-1],
    }

    stride = max(1, -(-len(windows) // max_trajectory))  # ceil: cap holds
    trajectory = [{
        "step": w.get("step"), "t": w.get("t"), "cost": w.get("cost"),
        "examples_per_sec": w.get("examples_per_sec"),
        "mfu": w.get("mfu"),
        "step_time_p50_ms": w.get("step_time_p50_ms"),
    } for w in windows[::stride]]

    # anomaly/restart timeline: anomaly events + compile events (a
    # recompile mid-run marks a restart) + flight dumps, in time order
    timeline: List[Dict[str, Any]] = []
    for rows in procs.values():
        for r in rows:
            if r.get("kind") != "event":
                continue
            if r.get("event") == "anomaly":
                timeline.append({
                    "t": r.get("t"), "kind": "anomaly",
                    "proc": r.get("proc"), "step": r.get("step"),
                    "reasons": r.get("reasons"),
                    "policy": r.get("policy")})
            elif r.get("event") == "compile":
                timeline.append({
                    "t": r.get("t"), "kind": "compile",
                    "proc": r.get("proc"), "what": r.get("what"),
                    "dispatch_wall_s": r.get("dispatch_wall_s")})
    for d in data["flights"]:
        timeline.append({
            "t": d.get("t"), "kind": "flight_dump",
            "proc": d.get("proc"), "reason": d.get("reason"),
            "last_step": d.get("last_step"),
            "exception": (d.get("exception") or {}).get("type")})
    # the restart timeline (resilience narration): every preemption,
    # snapshot-on-signal, resume and chief-side retry/reform decision
    for r in data["restarts"]:
        entry = {"t": r.get("t"), "kind": "restart",
                 "proc": r.get("proc"), "event": r.get("event")}
        for k in ("step", "signal", "reason", "dp", "wait_s",
                  "attempt", "exit_code", "dead"):
            if r.get(k) is not None:
                entry[k] = r.get(k)
        timeline.append(entry)
    timeline.sort(key=lambda e: (e.get("t") or 0.0))

    rk = [r.get("event") for r in data["restarts"]]
    restarts_summary = {
        "events": len(rk),
        "preemptions": rk.count("preempt"),
        "snapshots": rk.count("snapshot"),
        "resumes": rk.count("resumed"),
        "dead_procs": rk.count("dead_proc"),
        "retries": rk.count("retry"),
        "reforms": rk.count("reform"),
        "gave_up": rk.count("give_up"),
        # the serving supervisor's entries: decode-engine
        # loop deaths restarted in place with in-flight re-queued
        "engine_restarts": rk.count("engine_restart"),
    }

    now = time.time() if now is None else now
    proc_summary = {}
    for pid, rows in procs.items():
        pw = [r for r in rows if r.get("kind") == "window"]
        hb = data["heartbeats"].get(pid)
        proc_summary[str(pid)] = {
            "windows": len(pw),
            "last_step": pw[-1].get("step") if pw else None,
            "heartbeat_step": hb[0] if hb else None,
            "heartbeat_age_s": (round(max(0.0, now - hb[1]), 3)
                                if hb else None),
        }

    report = {
        "v": schema_lib.SCHEMA_VERSION,
        "kind": "run_report",
        "logs_path": os.path.abspath(logs_path),
        "generated_t": now,
        "partial": partial,
        "procs": len(procs),
        "proc_summary": proc_summary,
        "steps": (int(run_end["steps"]) if run_end
                  and run_end.get("steps") is not None
                  else (windows[-1].get("step") if windows else None)),
        "wall_s": round(wall, 6),
        "test_accuracy": (run_end or {}).get("test_accuracy"),
        "goodput": goodput,
        "step_time": step_time,
        "throughput": throughput,
        "trajectory": trajectory,
        "stragglers": {
            "max_step_lag": (max(lags) if lags else None),
            "mean_step_lag": (lag_mean if lags else None),
            "reports": len(straggler_events),
        },
        "anomalies": {
            "count": int((run_end or {}).get("anomalies") or 0) or len(
                [e for e in timeline if e["kind"] == "anomaly"]),
            "skipped_steps": int((run_end or {}).get("skipped_steps")
                                 or 0),
            "flight_dumps": len(data["flights"]),
        },
        "restarts": restarts_summary,
        "timeline": timeline,
        "schema_errors": data["schema_errors"],
        "schema_error_count": data["schema_error_count"],
    }
    return report


def summary_line(report: Dict[str, Any]) -> str:
    """One human-scannable line of a run report (the JAX package's
    ``dtx-obs report`` prints it)."""
    g = report.get("goodput") or {}
    frac = g.get("goodput_frac")
    tp = report.get("throughput") or {}
    bits = [
        f"steps={report.get('steps')}",
        f"wall={report.get('wall_s')}s",
        f"goodput={frac * 100:.1f}%" if frac is not None else "goodput=?",
        f"compile={g.get('buckets', {}).get('compile', 0):.3g}s",
        f"data_wait={g.get('buckets', {}).get('data_wait', 0):.3g}s",
    ]
    if g.get("buckets", {}).get("h2d"):
        bits.append(f"h2d={g['buckets']['h2d']:.3g}s")
    if tp.get("mfu_mean") is not None:
        bits.append(f"mfu={tp['mfu_mean']}")
    if tp.get("examples_per_sec_last") is not None:
        bits.append(f"ex/s={tp['examples_per_sec_last']}")
    an = report.get("anomalies") or {}
    if an.get("count"):
        bits.append(f"anomalies={an['count']}"
                    + (f" skipped={an['skipped_steps']}"
                       if an.get("skipped_steps") else ""))
    rs = report.get("restarts") or {}
    if rs.get("events"):
        bits.append(
            f"restarts[preempt={rs.get('preemptions', 0)} "
            f"resume={rs.get('resumes', 0)} "
            f"reform={rs.get('reforms', 0)}]")
    if report.get("partial"):
        bits.append("PARTIAL")
    if report.get("schema_error_count"):
        bits.append(f"schema_errors={report['schema_error_count']}")
    return " ".join(bits)

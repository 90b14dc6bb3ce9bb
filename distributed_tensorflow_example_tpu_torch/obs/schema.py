"""The row and document contracts of the port's ``obs/`` and their
validators — the port's copy of the JAX package's ``obs/schema.py``:
the span rows, the metrics rows the status server and the run report
read, the engine's serving stats, the restart timeline, the bench
history records, the run report, the fleet report, the waterfall, the
drift report, the workload document and the trainer's metrics stream
and flight dumps.

``SCHEMA_VERSION`` is the JAX package's (10), so the two packages'
streams validate against each other.  Validators return a list of error
strings (empty = valid); the version is checked first, so an old stream
says which version wrote it instead of cascading missing-field errors.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from .buckets import HOST_BUCKET, WINDOW_BUCKETS

_NUM = (int, float)

# The one version number for everything obs/ writes, shared with the
# JAX package so the two packages' streams validate against each other:
# stamped as "v" into every metrics row and as "version" into every
# flight dump, and checked FIRST by the validators.  Bump it (in both
# packages) whenever a field is renamed/retyped/removed.
# History: v1 = unstamped metrics rows, flight "version": 1;
# v2 = the stamp itself + the run_end goodput fields
# (compile_s/eval_s/sample_s); v3 = the h2d_s window bucket (the
# batch device-commit wall) + the matching h2d goodput bucket;
# v4 = the serving request-lifecycle span stream (spans.<proc>.jsonl,
# SPAN_* contracts below), the bench history records
# (HISTORY_ENTRY) and the ttft_p99_ms serving-stats field;
# v5 = the resilience subsystem: the ckpt_s window/goodput bucket
# (async-checkpoint submit stall), the restart-timeline stream
# (restarts.jsonl, RESTART_EVENT below) and the run report's
# "restarts" section;
# v6 = fail-open serving: the typed-terminal span events
# (timeout/shed/failed) + the supervision records
# (requeue/engine_restart) in SPAN_FIELDS/SPAN_REQUIRED, the
# "engine_restart" restart-timeline event, and the SERVING_STATS
# shed/timeout/failed/requeue/restart/queue/brownout counters;
# v7 = fleet observability: trace-context propagation
# (trace_id/parent_id on every span, W3C traceparent at the serving
# edge), the training-side "phase" span event (phase/dur_ms), the
# collector's "source" stamp on merged rows, and the FLEET_REPORT
# document (obs/collector.py fleet timeline + federated SLO);
# v8 = latency attribution: the "tick_done" span event (the engine
# closes each tick with its execution-only dur_ms so stall time is
# separable), the WATERFALL document (obs/waterfall.py), the
# DRIFT_REPORT document (obs/drift.py), and the FLEET_REPORT's
# optional "queueing" section (obs/queueing.py);
# v9 = fleet serving: the router narration span events
# ("route"/"failover" with the per-replica "replica" field in
# SPAN_FIELDS/SPAN_REQUIRED) and the FLEET_REPORT's "failover"
# section (per-trace hop chains, intermediates excluded from the
# federated SLO so a failed-over request counts once);
# v10 = workload capture/replay: the WORKLOAD document (obs/workload.py
# distills a span dir into a portable request schedule), the
# "fingerprint" submit-span payload and the "replay_of" stamp (every
# row a serving/replay.py run writes names the source workload id).
SCHEMA_VERSION = 10

# every metrics row's envelope
METRICS_COMMON = {
    "kind": (str,),
    "t": _NUM,
    "proc": (int,),
    "v": (int,),
}

# kind == "window": the per-window training telemetry row
METRICS_WINDOW = {
    "step": (int,),
    "epoch": (int,),
    "cost": _NUM + (str,),  # non-finite costs stringify (strict JSON)
    "path": (str,),
    "steps": (int,),
    "window_wall_s": _NUM,
    "step_time_p50_ms": _NUM,
    "step_time_p95_ms": _NUM,
    "step_time_max_ms": _NUM,
    "data_wait_s": _NUM,
    "h2d_s": _NUM,
    "dispatch_s": _NUM,
    "device_wait_s": _NUM,
    "ckpt_s": _NUM,
    "host_s": _NUM,
    "examples_per_sec": _NUM + (type(None),),
    "tokens_per_sec": _NUM + (type(None),),
    "model_flops_per_step": _NUM,
    "tflops_per_sec": _NUM + (type(None),),
    "mfu": _NUM + (type(None),),
    "rss_bytes": (int, type(None)),
    "device_memory": (dict, type(None)),
}

# the per-bucket timing fields above are the bucket registry spelled
# out; the two must not drift
_BUCKET_FIELDS = {f"{b}_s" for b in WINDOW_BUCKETS + (HOST_BUCKET,)}
_SCHEMA_BUCKET_FIELDS = {k for k in METRICS_WINDOW
                         if k.endswith("_s") and k != "window_wall_s"}
if _SCHEMA_BUCKET_FIELDS != _BUCKET_FIELDS:
    raise AssertionError(
        f"METRICS_WINDOW bucket fields {sorted(_SCHEMA_BUCKET_FIELDS)} "
        f"out of sync with obs/buckets.py WINDOW_BUCKETS "
        f"{sorted(_BUCKET_FIELDS)}")

# kind == "event": point events; free-form payload beyond these
METRICS_EVENT = {
    "event": (str,),
}

# the trainer's flight recorder dump (obs/flight.py): flight/<proc>.json
FLIGHT_DUMP = {
    "version": (int,),
    "proc": (int,),
    "reason": (str,),
    "t": _NUM,
    "last_step": (int, type(None)),
    "steps": (list,),
    "windows": (list,),
    "anomalies": (list,),
    "env": (dict,),
}

# every record of a dump's steps and windows rings
FLIGHT_STEP_RECORD = {
    "step": (int,),
    "t": _NUM,
}

# every record of a dump's anomalies ring (obs/anomaly.py)
FLIGHT_ANOMALY_RECORD = {
    "step": (int,),
    "t": _NUM,
    "reasons": (list,),
    "policy": (str,),
}

# the envelope of every span row
SPAN_COMMON = {
    "kind": (str,),          # "span"
    "v": (int,),
    "t": _NUM,
    "proc": (int,),
    "event": (str,),
}

# every per-event payload field a span row may carry
SPAN_FIELDS = {
    "rid": (int,),
    "prompt_len": (int,),
    "max_new_tokens": (int,),
    "arrival": _NUM,
    "reason": (str,),
    "tick": (int,),
    "pages_held": (int,),
    "bucket": (int,),
    "pages_width": (int,),
    "ttft_ms": _NUM,
    "rids": (list,),
    "batch": (int,),
    "batch_bucket": (int,),
    "kv_pages": (int,),
    "occupancy": _NUM,
    "generated": (int,),
    "finish_t": _NUM,
    # fail-open payloads: deadline rides submit (optional), queued the
    # shed context, attempt(s) the supervision retry accounting,
    # restart the engine-restart ordinal, clamped the brownout marker
    "deadline": _NUM,
    "queued": (bool, int),
    "attempt": (int,),
    "attempts": (int,),
    "restart": (int,),
    "clamped": (bool,),
    # trace context: the 32-hex W3C trace id a request carries through
    # its whole lifecycle, the 16-hex parent span id of the caller's
    # traceparent, the collector's source stamp, the training phase
    "trace_id": (str,),
    "parent_id": (str,),
    "source": (str,),
    "phase": (str,),
    "dur_ms": _NUM,
    "replica": (str,),
    # the chained prompt-block hashes riding submit (optional), and the
    # replay stamp
    "fingerprint": (list,),
    "replay_of": (str,),
}

# the fields each event must carry
SPAN_REQUIRED = {
    "submit": ("rid", "prompt_len", "max_new_tokens", "arrival"),
    "blocked": ("rid", "reason", "tick"),
    "admit": ("rid", "pages_held", "tick"),
    "prefill": ("rid", "bucket", "pages_width"),
    "first_token": ("rid", "ttft_ms"),
    "tick": ("tick", "rids", "batch", "batch_bucket", "kv_pages",
             "occupancy"),
    # closes a tick: dur_ms is the execution wall only, so
    # (tick_done.t - tick.t) - dur_ms is the tick's stall
    "tick_done": ("tick", "dur_ms"),
    "retire": ("rid", "generated", "finish_t", "tick"),
    "error": ("rid", "reason"),
    "timeout": ("rid", "reason", "tick", "generated"),
    "shed": ("rid", "reason", "tick", "queued"),
    "requeue": ("rid", "attempt", "tick"),
    "engine_restart": ("restart", "reason", "rids", "tick"),
    "failed": ("rid", "reason", "attempts"),
    "phase": ("phase", "trace_id", "dur_ms"),
    "route": ("rid", "replica", "attempt"),
    "failover": ("rid", "replica", "attempt", "reason"),
}


def validate_span_row(row: Dict[str, Any], where: str = "row") -> List[str]:
    """Validate one spans.<proc>.jsonl row: version first, then the
    envelope, then the event's required payload fields."""
    if not isinstance(row, dict):
        return [f"{where}: not an object"]
    verrs = _version_errs(row, "v", where)
    if verrs:
        return verrs
    errs = _check(row, SPAN_COMMON, where)
    if row.get("kind") not in (None, "span"):
        errs.append(f"{where}: kind is {row.get('kind')!r}, expected "
                    f"'span'")
    event = row.get("event")
    if event is not None:
        required = SPAN_REQUIRED.get(event)
        if required is None:
            errs.append(f"{where}: unknown span event {event!r} "
                        f"(known: {sorted(SPAN_REQUIRED)})")
        else:
            errs += _check(row, {f: SPAN_FIELDS[f] for f in required},
                           where)
        if event == "phase" and isinstance(row.get("phase"), str):
            from .buckets import PHASE_SCOPES

            if row["phase"] not in PHASE_SCOPES:
                errs.append(f"{where}: unknown phase "
                            f"{row['phase']!r} (known: "
                            f"{sorted(PHASE_SCOPES)})")
    # the optional trace-context and capture payloads are typed
    # whenever present
    for f in ("trace_id", "parent_id", "source", "fingerprint",
              "replay_of"):
        if f in row:
            errs += _check(row, {f: SPAN_FIELDS[f]}, where)
    return errs


def validate_span_file(path: str) -> List[str]:
    """Validate every line of a spans.<proc>.jsonl file."""
    errs: List[str] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError as e:
                errs.append(f"line {i}: not JSON ({e})")
                continue
            errs += validate_span_row(row, where=f"line {i}")
    return errs


# one restart-timeline row (resilience/restart.RestartNarrator appends
# these to <logs_path>/restarts.jsonl); the event vocabulary is
# obs/buckets.RESTART_EVENTS and the payload beyond the envelope is
# free-form
RESTART_EVENT = {
    "kind": (str,),          # "restart"
    "v": (int,),
    "t": _NUM,
    "proc": (int,),
    "event": (str,),
}


def validate_restart_row(row: Dict[str, Any],
                         where: str = "row") -> List[str]:
    """Validate one restarts.jsonl row: version first, then the
    envelope, then the event vocabulary."""
    if not isinstance(row, dict):
        return [f"{where}: not an object"]
    verrs = _version_errs(row, "v", where)
    if verrs:
        return verrs
    errs = _check(row, RESTART_EVENT, where)
    if row.get("kind") != "restart":
        errs.append(f"{where}: kind is {row.get('kind')!r}, expected "
                    f"'restart'")
    event = row.get("event")
    if isinstance(event, str):
        from .buckets import RESTART_EVENTS

        if event not in RESTART_EVENTS:
            errs.append(f"{where}: unknown restart event {event!r} "
                        f"(known: {sorted(RESTART_EVENTS)})")
    return errs


def validate_restart_file(path: str) -> List[str]:
    """Validate every line of a restarts.jsonl file."""
    errs: List[str] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError as e:
                errs.append(f"line {i}: not JSON ({e})")
                continue
            errs += validate_restart_row(row, where=f"line {i}")
    return errs


# the engine's point-in-time counters (serving/engine.DecodeEngine.stats):
# the /status "serving" section and the dtx_generate_* gauges read
# exactly these fields; percentiles and throughput are null before the
# first completion.  requests_total counts accepted requests only (a
# shed request lands in shed_total); brownout_active is a 0/1 gauge
SERVING_STATS = {
    "requests_total": (int,),
    "completed_total": (int,),
    "inflight": (int,),
    "queued": (int,),
    "latency_p50_ms": _NUM + (type(None),),
    "latency_p99_ms": _NUM + (type(None),),
    "ttft_p50_ms": _NUM + (type(None),),
    "ttft_p99_ms": _NUM + (type(None),),
    "tokens_generated_total": (int,),
    "tokens_per_sec": _NUM + (type(None),),
    "page_occupancy_frac": _NUM,
    "decode_ticks_total": (int,),
    "prefills_total": (int,),
    "shed_total": (int,),
    "timeout_total": (int,),
    "failed_total": (int,),
    "requeued_total": (int,),
    "engine_restarts_total": (int,),
    "queue_limit": (int,),
    "queue_peak": (int,),
    "brownout_active": (int,),
    "brownout_clamped_total": (int,),
}


def validate_serving_stats(doc: Dict[str, Any],
                           where: str = "serving") -> List[str]:
    """Validate a DecodeEngine.stats() document (no version stamp: an
    in-process snapshot, never written to disk by obs/)."""
    return _check(doc, SERVING_STATS, where)


# one bench-history record (obs/history.py appends these to a
# history.jsonl): a comparison document reduced to its gate metrics
HISTORY_ENTRY = {
    "v": (int,),
    "kind": (str,),          # "bench_history"
    "t": _NUM,
    "label": (str,),
    "source": (str,),
    "metrics": (dict,),
}


def validate_history_entry(row: Dict[str, Any],
                           where: str = "row") -> List[str]:
    """Validate one history.jsonl record."""
    if not isinstance(row, dict):
        return [f"{where}: not an object"]
    verrs = _version_errs(row, "v", where)
    if verrs:
        return verrs
    errs = _check(row, HISTORY_ENTRY, where)
    if row.get("kind") != "bench_history":
        errs.append(f"{where}: kind is {row.get('kind')!r}, expected "
                    f"'bench_history'")
    return errs


def validate_history_file(path: str) -> List[str]:
    """Validate every line of a history.jsonl file."""
    errs: List[str] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError as e:
                errs.append(f"line {i}: not JSON ({e})")
                continue
            errs += validate_history_entry(row, where=f"line {i}")
    return errs


# the run report obs/aggregate.py produces (the status server's
# /report); top-level contract only, the goodput bucket names are
# aggregate.BUCKETS
RUN_REPORT = {
    "v": (int,),
    "kind": (str,),          # "run_report"
    "logs_path": (str,),
    "generated_t": _NUM,
    "partial": (bool,),
    "procs": (int,),
    "steps": (int, type(None)),
    "wall_s": _NUM,
    "test_accuracy": _NUM + (type(None),),
    "goodput": (dict,),
    "step_time": (dict,),
    "throughput": (dict,),
    "trajectory": (list,),
    "stragglers": (dict,),
    "anomalies": (dict,),
    "restarts": (dict,),
    "timeline": (list,),
    "schema_errors": (list,),
}


# the fleet report obs/collector.py produces (the status server's
# /fleet and the dtx_fleet_* gauges): N source dirs' streams merged into
# one timeline, with the fleet-wide exactly-once verdict, the federated
# SLO (obs/slo.fleet_evaluate), the queueing analytics
# (obs/queueing.py) and the failover chains the router produced
FLEET_REPORT = {
    "v": (int,),
    "kind": (str,),          # "fleet_report"
    "generated_t": _NUM,
    "sources": (list,),
    "rows": (int,),
    "requests": (int,),
    "exactly_once": (bool,),
    "errors": (list,),
    "restarts": (int,),
    "slo": (dict, type(None)),
    "queueing": (dict, type(None)),
    "failover": (dict, type(None)),
}


def validate_fleet_report(doc: Dict[str, Any],
                          where: str = "fleet") -> List[str]:
    """Validate a collector fleet report (top-level contract and the
    per-source entry shape)."""
    if not isinstance(doc, dict):
        return [f"{where}: not an object"]
    verrs = _version_errs(doc, "v", where)
    if verrs:
        return verrs
    errs = _check(doc, FLEET_REPORT, where)
    if doc.get("kind") != "fleet_report":
        errs.append(f"{where}: kind is {doc.get('kind')!r}, expected "
                    f"'fleet_report'")
    for i, src in enumerate(doc.get("sources") or []):
        errs += _check(src, {"source": (str,), "rows": (int,),
                             "skew_s": _NUM, "procs": (int,)},
                       f"{where}.sources[{i}]")
    return errs


# one per-request waterfall document (obs/waterfall.py): "segments"
# maps every obs/buckets.WATERFALL_SEGMENTS name to ms; "intervals"
# carries the absolute (t0, t1, segment) triples
WATERFALL = {
    "v": (int,),
    "kind": (str,),          # "waterfall"
    "proc": (int,),
    "rid": (int,),
    "terminal": (str, type(None)),
    "submit_t": _NUM,
    "terminal_t": _NUM,
    "wall_ms": _NUM,
    "segments": (dict,),
    "segment_sum_ms": _NUM,
    "residual_ms": _NUM,
    "decode_ticks": (int,),
    "requeues": (int,),
    "complete": (bool,),
    "intervals": (list,),
}


def validate_waterfall(doc: Dict[str, Any],
                       where: str = "waterfall") -> List[str]:
    """Validate one per-request waterfall document (top-level contract
    and the segment names against the obs/buckets.py registry)."""
    if not isinstance(doc, dict):
        return [f"{where}: not an object"]
    verrs = _version_errs(doc, "v", where)
    if verrs:
        return verrs
    errs = _check(doc, WATERFALL, where)
    if doc.get("kind") != "waterfall":
        errs.append(f"{where}: kind is {doc.get('kind')!r}, expected "
                    f"'waterfall'")
    segs = doc.get("segments")
    if isinstance(segs, dict):
        from .buckets import WATERFALL_SEGMENTS

        unknown = [s for s in segs if s not in WATERFALL_SEGMENTS]
        if unknown:
            errs.append(f"{where}: unknown segments {sorted(unknown)} "
                        f"(known: {list(WATERFALL_SEGMENTS)})")
        missing = [s for s in WATERFALL_SEGMENTS if s not in segs]
        if missing:
            errs.append(f"{where}: segments missing {missing}")
    return errs


def validate_metrics_row(row: Dict[str, Any],
                         where: str = "row") -> List[str]:
    """Validate one metrics JSONL row (window or event)."""
    if not isinstance(row, dict):
        return [f"{where}: not an object"]
    verrs = _version_errs(row, "v", where)
    if verrs:
        return verrs
    errs = _check(row, METRICS_COMMON, where)
    kind = row.get("kind")
    if kind == "window":
        errs += _check(row, METRICS_WINDOW, where)
    elif kind == "event":
        errs += _check(row, METRICS_EVENT, where)
    elif kind is not None:
        errs.append(f"{where}: unknown kind {kind!r}")
    return errs


def validate_metrics_file(path: str) -> List[str]:
    """Validate every line of a metrics.<proc>.jsonl file."""
    errs: List[str] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError as e:
                errs.append(f"line {i}: not JSON ({e})")
                continue
            errs += validate_metrics_row(row, where=f"line {i}")
    return errs


def validate_flight_dump(doc: Dict[str, Any],
                         where: str = "dump") -> List[str]:
    """Validate a flight/<proc>.json document, every step, window and
    anomaly record inside it included."""
    if not isinstance(doc, dict):
        return [f"{where}: not an object"]
    verrs = _version_errs(doc, "version", where)
    if verrs:
        return verrs
    errs = _check(doc, FLIGHT_DUMP, where)
    for i, rec in enumerate(doc.get("steps") or []):
        errs += _check(rec, FLIGHT_STEP_RECORD, f"{where}.steps[{i}]")
    for i, rec in enumerate(doc.get("windows") or []):
        errs += _check(rec, FLIGHT_STEP_RECORD, f"{where}.windows[{i}]")
    for i, rec in enumerate(doc.get("anomalies") or []):
        errs += _check(rec, FLIGHT_ANOMALY_RECORD,
                       f"{where}.anomalies[{i}]")
    exc = doc.get("exception")
    if exc is not None and not isinstance(exc, dict):
        errs.append(f"{where}: exception must be an object")
    return errs


def validate_flight_file(path: str) -> List[str]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable ({e})"]
    return validate_flight_dump(doc, where=path)


def validate_run_report(doc: Dict[str, Any],
                        where: str = "report") -> List[str]:
    """Validate an aggregate.py run report (its top-level contract and
    the goodput bucket names)."""
    if not isinstance(doc, dict):
        return [f"{where}: not an object"]
    verrs = _version_errs(doc, "v", where)
    if verrs:
        return verrs
    errs = _check(doc, RUN_REPORT, where)
    if doc.get("kind") != "run_report":
        errs.append(f"{where}: kind is {doc.get('kind')!r}, expected "
                    f"'run_report'")
    buckets = (doc.get("goodput") or {}).get("buckets")
    if isinstance(buckets, dict):
        from .buckets import GOODPUT_BUCKETS

        missing = [b for b in GOODPUT_BUCKETS if b not in buckets]
        if missing:
            errs.append(f"{where}: goodput.buckets missing {missing}")
    return errs


# the drift report obs/drift.py produces (dtx-obs drift prints it and
# exits 3 when "ok" is False): change-point detection over a history
# window; each "drifts" entry names the metric, the split and the first
# offending row label; "roofline" is the decode join of a capture
# (None without --capture)
DRIFT_REPORT = {
    "v": (int,),
    "kind": (str,),          # "drift_report"
    "generated_t": _NUM,
    "history_path": (str,),
    "entries": (int,),
    "window": (int,),
    "metrics": (list,),
    "drifts": (list,),
    "roofline": (dict, type(None)),
    "ok": (bool,),
}


def validate_drift_report(doc: Dict[str, Any],
                          where: str = "drift") -> List[str]:
    """Validate an obs/drift.py report (its top-level contract and each
    drift entry's shape)."""
    if not isinstance(doc, dict):
        return [f"{where}: not an object"]
    verrs = _version_errs(doc, "v", where)
    if verrs:
        return verrs
    errs = _check(doc, DRIFT_REPORT, where)
    if doc.get("kind") != "drift_report":
        errs.append(f"{where}: kind is {doc.get('kind')!r}, expected "
                    f"'drift_report'")
    for i, d in enumerate(doc.get("drifts") or []):
        errs += _check(d, {"metric": (str,), "first_offending": (str,),
                           "shift_frac": _NUM}, f"{where}.drifts[{i}]")
    return errs


# The portable workload document ``obs/workload.py`` distills from a
# span dir and ``serving/replay.py`` feeds back through an engine or a
# fleet: arrivals are offsets from the first submit (seconds),
# deadlines relative milliseconds, ``fingerprint`` the chained
# prompt-block hashes, ``workload_id`` a content hash of the schedule.
WORKLOAD = {
    "v": (int,),
    "kind": (str,),          # "workload"
    "workload_id": (str,),
    "source": (str,),
    "generated_t": _NUM,
    "n_requests": (int,),
    "duration_s": _NUM,
    "requests": (list,),
}

WORKLOAD_REQUEST = {
    "rid": (int,),
    "arrival_s": _NUM,
    "prompt_len": (int,),
    "max_new_tokens": (int,),
    "output_tokens": (int, type(None)),
    "deadline_ms": _NUM + (type(None),),
    "trace_id": (str, type(None)),
    "terminal": (str, type(None)),
    "fingerprint": (list,),
}


def validate_workload(doc: Dict[str, Any],
                      where: str = "workload") -> List[str]:
    """Validate a workload document: the top-level contract, every
    request entry's shape, and the schedule a replay relies on (rids
    dense from 0 in arrival order, offsets non-negative and
    non-decreasing)."""
    if not isinstance(doc, dict):
        return [f"{where}: not an object"]
    verrs = _version_errs(doc, "v", where)
    if verrs:
        return verrs
    errs = _check(doc, WORKLOAD, where)
    if doc.get("kind") != "workload":
        errs.append(f"{where}: kind is {doc.get('kind')!r}, expected "
                    f"'workload'")
    reqs = doc.get("requests")
    if isinstance(reqs, list):
        if isinstance(doc.get("n_requests"), int) \
                and doc["n_requests"] != len(reqs):
            errs.append(f"{where}: n_requests {doc['n_requests']} != "
                        f"len(requests) {len(reqs)}")
        prev = 0.0
        for i, req in enumerate(reqs):
            w = f"{where}.requests[{i}]"
            sub = _check(req, WORKLOAD_REQUEST, w)
            errs += sub
            if sub or not isinstance(req, dict):
                continue
            if req["rid"] != i:
                errs.append(f"{w}: rid {req['rid']} != index {i} "
                            f"(rids are dense in arrival order)")
            if req["arrival_s"] < prev:
                errs.append(f"{w}: arrival_s {req['arrival_s']} "
                            f"decreases (schedule must be sorted)")
            prev = float(req["arrival_s"])
            if req["prompt_len"] < 1 or req["max_new_tokens"] < 1:
                errs.append(f"{w}: prompt_len/max_new_tokens must be "
                            f">= 1")
    return errs


def validate_workload_file(path: str) -> List[str]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable ({e})"]
    return validate_workload(doc, where=path)


def validate_version(doc: Dict[str, Any], field: str = "v",
                     where: str = "doc") -> List[str]:
    """The version check alone, for documents whose body has no contract
    here (the chief's flight/report.json collate)."""
    if not isinstance(doc, dict):
        return [f"{where}: not an object"]
    return _version_errs(doc, field, where)


def _check(doc: Dict[str, Any], spec: Dict[str, tuple],
           where: str) -> List[str]:
    errs = []
    if not isinstance(doc, dict):
        return [f"{where}: not an object"]
    for field, types in spec.items():
        if field not in doc:
            errs.append(f"{where}: missing field {field!r}")
        elif not isinstance(doc[field], tuple(types)):
            errs.append(f"{where}: field {field!r} has type "
                        f"{type(doc[field]).__name__}, expected "
                        f"{'/'.join(t.__name__ for t in types)}")
        elif isinstance(doc[field], bool) and bool not in types:
            # bool is an int subclass: reject bool where int is expected
            errs.append(f"{where}: field {field!r} is bool, expected "
                        f"{'/'.join(t.__name__ for t in types)}")
    return errs


def _version_errs(doc: Dict[str, Any], field: str, where: str) -> List[str]:
    """The old-format diagnosis, checked before any field check."""
    v = doc.get(field)
    if v is None:
        return [f"{where}: no {field!r} stamp — written by a "
                f"pre-versioned build (schema v1); this tool reads "
                f"schema v{SCHEMA_VERSION}"]
    if isinstance(v, bool) or not isinstance(v, int):
        return [f"{where}: {field!r} is {type(v).__name__}, expected int"]
    if v != SCHEMA_VERSION:
        return [f"{where}: written by schema v{v}; this tool reads "
                f"schema v{SCHEMA_VERSION}"]
    return []


__all__ = ["SCHEMA_VERSION", "METRICS_COMMON", "METRICS_WINDOW",
           "METRICS_EVENT", "FLIGHT_DUMP", "FLIGHT_STEP_RECORD",
           "FLIGHT_ANOMALY_RECORD", "validate_metrics_file",
           "validate_flight_dump", "validate_flight_file", "SPAN_COMMON",
           "SPAN_FIELDS", "SPAN_REQUIRED",
           "RESTART_EVENT", "RUN_REPORT", "FLEET_REPORT", "WATERFALL",
           "validate_metrics_row", "validate_span_row",
           "validate_span_file", "validate_restart_row",
           "validate_restart_file", "validate_run_report",
           "validate_fleet_report", "validate_waterfall", "WORKLOAD",
           "WORKLOAD_REQUEST", "validate_workload", "SERVING_STATS",
           "validate_serving_stats", "HISTORY_ENTRY",
           "validate_history_entry", "validate_history_file",
           "DRIFT_REPORT", "validate_drift_report",
           "validate_workload_file", "validate_version"]

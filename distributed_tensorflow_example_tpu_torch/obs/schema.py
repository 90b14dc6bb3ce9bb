"""The row and document contracts of the port's ``obs/`` and their
validators — the port's copy of the parts of the JAX package's
``obs/schema.py`` that its serving stack reads and writes: the span
rows, the metrics rows the status server and the run report read, the
restart timeline, the run report, the fleet report and the waterfall.

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
           "METRICS_EVENT", "SPAN_COMMON", "SPAN_FIELDS", "SPAN_REQUIRED",
           "RESTART_EVENT", "RUN_REPORT", "FLEET_REPORT", "WATERFALL",
           "validate_metrics_row", "validate_span_row",
           "validate_span_file", "validate_restart_row",
           "validate_restart_file", "validate_run_report",
           "validate_fleet_report", "validate_waterfall"]

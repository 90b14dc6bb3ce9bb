"""Request-lifecycle spans for the serving stack — the port's copy of
the JAX package's ``obs/spans.py``.

- ``SpanRecorder`` appends one strict-JSON row per lifecycle event to
  ``<logs_path>/spans.<proc>.jsonl`` (line-buffered; non-finite floats
  stringified by ``_jsonable``; a bad fd degrades the stream to the
  ring instead of killing the engine) and keeps a bounded in-memory
  ring, so the live ``/trace``, ``/slo`` and ``/explain`` endpoints
  never re-read the file.  ``rotate_bytes`` bounds the file on disk:
  past it the live file cascades to ``.1`` … ``.<keep>``.
- The event vocabulary is ``obs/buckets.SPAN_EVENTS`` and the field
  contract ``obs/schema.py``.
- ``reconstruct(rows)`` folds a stream back into per-request lifecycle
  records and checks the exactly-once invariant on the way (each
  milestone at most once per rid, one typed terminal per request);
  violations land in each record's ``errors`` list.
- ``parse_traceparent`` / ``new_trace_id``: the W3C trace context every
  request carries through its lifecycle.

The scheduler emits through an injected recorder and never imports
this module; the engine threads one recorder through both.  Tracing is
host-side appends only: greedy outputs are token-identical with it on
or off.

Lifecycle (one accepted request)::

    submit ── blocked(reason)* ── admit ── prefill ── first_token
           ── [tick]* ── retire | timeout | failed

``shed`` is the one terminal without a submit; under supervision a
crash emits ``engine_restart`` and each surviving request a
``requeue``, whose admit/prefill/first_token milestones then repeat.
"""

from __future__ import annotations

import collections
import glob
import json
import math
import os
import re
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .buckets import SPAN_EVENTS
from .schema import SCHEMA_VERSION

# in-memory ring default: enough for the /trace view of a busy tail
# without growing per request forever
RING_CAPACITY = 8192

# the exactly-once milestones (per rid); blocked/tick/error repeat.
# admit/prefill/first_token RESET on a requeue event (a supervised
# engine restart re-runs them legitimately); the terminals never do.
MILESTONES = ("submit", "admit", "prefill", "first_token", "retire",
              "timeout", "shed", "failed")

# the typed terminal states: every accepted request reaches
# exactly one — "result" (a retire event), "timeout" (deadline or
# cancel), "shed" (bounded-queue rejection; the one terminal with no
# submit), "failed" (retry budget spent, or a legacy "error" row).
# reconstruct() classifies each record's ``terminal`` from these.
TERMINALS = ("result", "timeout", "shed", "failed")

_SPANS_RE = re.compile(r"spans\.(\d+)\.jsonl$")

# a W3C trace-context header: version-trace_id-parent_id-flags
# (https://www.w3.org/TR/trace-context/).  We accept any version byte
# but reject the all-zero ids the spec marks invalid.
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def _jsonable(x):
    """Strict-JSON-safe copy: NaN/Inf -> strings, numpy scalars and
    arrays -> Python values, unknown types -> repr."""
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, bool) or x is None or isinstance(x, (int, str)):
        return x
    if isinstance(x, float):
        return x if math.isfinite(x) else repr(x)
    try:
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


def new_trace_id() -> str:
    """A fresh 32-hex (128-bit) W3C trace id."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """A fresh 16-hex (64-bit) W3C span id (the serving edge's own id,
    returned to the caller in the response traceparent)."""
    return os.urandom(8).hex()


def parse_traceparent(header: Any) -> Optional[Tuple[str, str]]:
    """``(trace_id, parent_id)`` from a ``traceparent`` header value,
    or None when absent/malformed/all-zero — a bad header degrades to
    a fresh trace, never to a rejected request."""
    if not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    _ver, trace_id, parent_id, _flags = m.groups()
    if trace_id == "0" * 32 or parent_id == "0" * 16:
        return None
    return trace_id, parent_id


def format_traceparent(trace_id: str, span_id: str) -> str:
    """The response-header form: version 00, sampled flag set."""
    return f"00-{trace_id}-{span_id}-01"


def span_files(logs_path: str) -> List[Tuple[int, str]]:
    """[(proc_index, path)] for every span stream in a run dir — the
    one place the naming/discovery convention lives (the CLI, the
    status server and the SLO evaluator all reuse it)."""
    out = []
    for path in sorted(glob.glob(os.path.join(logs_path,
                                              "spans.*.jsonl"))):
        m = _SPANS_RE.search(os.path.basename(path))
        if m:
            out.append((int(m.group(1)), path))
    return out


class SpanRecorder:
    """Append-only span stream + bounded in-memory ring.

    ``emit`` validates the event name against the obs/buckets.py
    registry, stamps the schema version and writes one strict-JSON
    line.  Telemetry must degrade,
    never kill the engine it observes: a bad fd / full volume closes
    the stream and emission becomes ring-only.

    ``rotate_bytes`` > 0 bounds the stream on disk: when the live file would
    exceed the limit it cascades to ``spans.<proc>.jsonl.1`` …
    ``.<keep>`` (newest rotation = ``.1``, oldest dropped) and a fresh
    live file is opened.  ``read_spans`` stitches the segments back
    together."""

    def __init__(self, logs_path: str, process_index: int = 0,
                 ring: int = RING_CAPACITY, rotate_bytes: int = 0,
                 keep: int = 3,
                 extra: Optional[Dict[str, Any]] = None):
        os.makedirs(logs_path, exist_ok=True)
        # constant fields stamped onto every emitted row (event fields
        # win on collision)
        self.extra = dict(extra or {})
        self.process_index = int(process_index)
        self.rotate_bytes = int(rotate_bytes)
        self.keep = max(1, int(keep))
        self.path = os.path.join(
            logs_path, f"spans.{self.process_index}.jsonl")
        self._f = open(self.path, "a", buffering=1)  # line-buffered
        self._written = os.path.getsize(self.path)
        self.ring: collections.deque = collections.deque(maxlen=ring)
        # the engine emits under its lock, but /trace /slo readers are
        # HTTP handler threads: snapshot() must not race an append
        self._ring_lock = threading.Lock()

    def emit(self, event: str, **fields) -> None:
        if event not in SPAN_EVENTS:
            # one registry (obs/buckets.py) names every span event; an
            # unknown name would silently vanish from reconstruction
            raise ValueError(f"unknown span event {event!r}: expected "
                             f"one of {SPAN_EVENTS}")
        row = {"kind": "span", "v": SCHEMA_VERSION, "t": time.time(),
               "proc": self.process_index, "event": event,
               **self.extra, **_jsonable(fields)}
        with self._ring_lock:
            self.ring.append(row)
        if self._f is None:
            return
        try:
            line = json.dumps(row, allow_nan=False) + "\n"
            if (self.rotate_bytes > 0 and self._written > 0
                    and self._written + len(line) > self.rotate_bytes):
                self._rotate()
                if self._f is None:
                    return
            self._f.write(line)
            self._written += len(line)
        except (OSError, ValueError):
            try:
                self._f.close()
            except Exception:
                pass
            self._f = None

    def _rotate(self) -> None:
        """Cascade the live file to ``.1`` (``.keep`` dropped) and
        reopen.  A rotation failure degrades to ring-only, the same
        contract as a bad fd."""
        try:
            self._f.close()
        except Exception:
            pass
        try:
            last = f"{self.path}.{self.keep}"
            if os.path.exists(last):
                os.remove(last)
            for i in range(self.keep - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            os.replace(self.path, f"{self.path}.1")
            self._f = open(self.path, "a", buffering=1)
            self._written = 0
        except OSError:
            self._f = None

    def snapshot(self) -> List[Dict[str, Any]]:
        """A consistent copy of the ring (the live /trace and /slo
        data source — no file re-read while the engine is attached)."""
        with self._ring_lock:
            return list(self.ring)

    def rows_for(self, rid: int) -> List[Dict[str, Any]]:
        """Every ring row touching ``rid`` — its own events plus the
        shared decode ticks it was a member of (the /trace view)."""
        rid = int(rid)
        return [r for r in self.snapshot()
                if r.get("rid") == rid or rid in (r.get("rids") or ())]

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


def rotated_files(path: str) -> List[str]:
    """Every on-disk segment of one span stream, oldest first:
    ``<path>.<keep>`` … ``<path>.1`` then the live ``<path>`` (the
    SpanRecorder rotation convention).  A never-rotated stream is just
    ``[path]``."""
    segs = []
    for p in glob.glob(glob.escape(path) + ".*"):
        suffix = p[len(path) + 1:]
        if suffix.isdigit():
            segs.append((int(suffix), p))
    segs.sort(reverse=True)
    files = [p for _n, p in segs]
    if os.path.exists(path) or not files:
        files.append(path)
    return files


def read_spans(path: str,
               include_rotated: bool = True) -> List[Dict[str, Any]]:
    """Parse a spans.<proc>.jsonl back into rows (whole lines only —
    a torn trailing append is skipped, not half-parsed).  Rotated
    segments (``<path>.K`` … ``.1``) are stitched in front of the live
    file by default, so a bounded stream reconstructs identically to
    an unbounded one."""
    rows = []
    for p in (rotated_files(path) if include_rotated else [path]):
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except ValueError:
                    continue
    return rows


def load_spans(logs_path: str) -> List[Dict[str, Any]]:
    """All span rows under a run dir, time-ordered across processes."""
    rows: List[Dict[str, Any]] = []
    for _pid, path in span_files(logs_path):
        rows.extend(read_spans(path))
    rows.sort(key=lambda r: (r.get("t") or 0.0))
    return rows


def reconstruct(
        rows: Iterable[Dict[str, Any]]) -> Dict[tuple, Dict[str, Any]]:
    """Fold a span stream into per-request lifecycle records.

    Returns ``{(proc, rid): record}`` — keyed by the PAIR because
    every engine numbers its rids from 0, so streams merged across
    processes (``load_spans``) would otherwise conflate distinct
    requests into one corrupted record.  Each record carries the
    milestone timestamps/payloads, the blocked-reason counts, the
    decode-tick attribution and a ``complete`` verdict.  The
    exactly-once invariant is CHECKED here: a duplicate milestone, a
    milestone for a never-submitted rid, or a retire whose
    ``generated`` disagrees with ``max_new_tokens`` lands in that
    record's ``errors`` list — reconstruction never raises on a torn
    stream."""
    recs: Dict[tuple, Dict[str, Any]] = {}

    def rec_for(proc: int, rid: int) -> Dict[str, Any]:
        r = recs.get((proc, rid))
        if r is None:
            r = recs[(proc, rid)] = {
                "proc": proc, "rid": rid, "blocked": {},
                "decode_ticks": 0, "ticks": [], "errors": [],
            }
        return r

    for row in rows:
        event = row.get("event")
        proc = int(row.get("proc") or 0)
        if event in ("tick", "engine_restart"):
            # batch-shaped rows: attributed to every member rid
            for rid in (row.get("rids") or ()):
                r = rec_for(proc, int(rid))
                if event == "tick":
                    r["decode_ticks"] += 1
                    r["ticks"].append(row.get("tick"))
                else:
                    r["engine_restarts"] = \
                        r.get("engine_restarts", 0) + 1
            continue
        rid = row.get("rid")
        if rid is None:
            continue
        r = rec_for(proc, int(rid))
        # trace-context carry (v7): the id must be STABLE across the
        # whole lifecycle — a supervised restart requeues the request
        # under the same trace_id, and a change mid-stream means two
        # requests were conflated (or propagation broke).
        tid = row.get("trace_id")
        if isinstance(tid, str):
            if "trace_id" not in r:
                r["trace_id"] = tid
            elif r["trace_id"] != tid:
                r["errors"].append(
                    f"trace_id changed mid-lifecycle: "
                    f"{r['trace_id']} -> {tid}")
        if "parent_id" not in r and isinstance(row.get("parent_id"),
                                               str):
            r["parent_id"] = row["parent_id"]
        if "source" not in r and isinstance(row.get("source"), str):
            r["source"] = row["source"]
        if "replay_of" not in r and isinstance(row.get("replay_of"),
                                               str):
            r["replay_of"] = row["replay_of"]
        if event in MILESTONES:
            key = f"{event}_t"
            if key in r:
                r["errors"].append(f"duplicate {event}")
                continue
            r[key] = row.get("t")
        if event == "submit":
            r["prompt_len"] = row.get("prompt_len")
            r["max_new_tokens"] = row.get("max_new_tokens")
            r["arrival"] = row.get("arrival")
            if row.get("deadline") is not None:
                r["deadline"] = row.get("deadline")
            if row.get("fingerprint") is not None:
                # the v10 prompt-block hashes workload capture reads
                r["fingerprint"] = row.get("fingerprint")
        elif event == "blocked":
            reason = str(row.get("reason"))
            r["blocked"][reason] = r["blocked"].get(reason, 0) + 1
        elif event == "admit":
            r["pages_held"] = row.get("pages_held")
            r["admit_tick"] = row.get("tick")
            if row.get("clamped"):
                r["brownout_clamped"] = True
        elif event == "prefill":
            r["prefill_bucket"] = row.get("bucket")
        elif event == "first_token":
            r["ttft_ms"] = row.get("ttft_ms")
        elif event == "retire":
            r["generated"] = row.get("generated")
            r["finish_t"] = row.get("finish_t")
            r["retire_tick"] = row.get("tick")
        elif event == "error":
            r["error"] = str(row.get("reason"))
        elif event == "timeout":
            r["timeout_reason"] = str(row.get("reason"))
            r["timeout_tick"] = row.get("tick")
            r["generated"] = row.get("generated")
        elif event == "shed":
            r["shed_reason"] = str(row.get("reason"))
            r["shed_tick"] = row.get("tick")
        elif event == "failed":
            r["failed_reason"] = str(row.get("reason"))
            r["attempts"] = row.get("attempts")
        elif event in ("route", "failover"):
            # fleet-router narration (v9): WHERE the request went.
            # The lifecycle itself lives in a REPLICA's stream (under
            # that stream's own rid), so these rows create no
            # milestone expectations — a record holding only them is
            # narration, not a truncated lifecycle.
            key = "routes" if event == "route" else "failovers"
            r[key] = r.get(key, 0) + 1
            r["replica"] = row.get("replica")
            if row.get("attempt") is not None:
                r["attempt"] = row.get("attempt")
        elif event == "requeue":
            # a supervised re-admission legitimately re-runs the
            # admission/prefill milestones: reset their exactly-once
            # slate (the terminals stay armed) and count the retry.
            # The aborted attempt's measurements go too — a stale
            # ttft from discarded tokens must not feed the SLO fold
            # if the retry never produces a new first_token
            # (brownout_clamped stays sticky: the budget mutation
            # survives the requeue).
            r["requeues"] = r.get("requeues", 0) + 1
            r["attempt"] = row.get("attempt")
            for k in ("admit", "prefill", "first_token"):
                r.pop(f"{k}_t", None)
            for k in ("ttft_ms", "prefill_bucket", "pages_held",
                      "admit_tick"):
                r.pop(k, None)

    for _key, r in recs.items():
        # terminal classification: exactly one of the typed ends.
        # "error" (unsupervised loop death) types as failed too.
        ends = [t for t, k in (("result", "retire_t"),
                               ("timeout", "timeout_t"),
                               ("shed", "shed_t"),
                               ("failed", "failed_t"))
                if k in r]
        if "error" in r and not ends:
            ends = ["failed"]
        r["terminal"] = ends[0] if len(ends) == 1 else None
        if len(ends) > 1:
            r["errors"].append(
                f"multiple terminals: {'+'.join(ends)}")
        # router narration streams hold route/failover rows (and
        # nothing else) per fleet rid: mark them so consumers can
        # separate narration from lifecycles, and exempt them from
        # the lifecycle checks below
        r["narration"] = bool(
            (r.get("routes") or r.get("failovers"))
            and "submit_t" not in r and "shed_t" not in r
            and r.get("error") is None)
        # shed is the one terminal without a submit: the request was
        # never accepted, so the no-submit check exempts it (router
        # narration describes a lifecycle that lives elsewhere)
        if "submit_t" not in r and "shed_t" not in r \
                and not r["narration"]:
            r["errors"].append("no submit event")
        if "shed_t" in r and "submit_t" in r:
            r["errors"].append("shed after submit (shed requests are "
                               "never accepted)")
        for a, b in (("admit", "submit"), ("retire", "admit")):
            if f"{a}_t" in r and f"{b}_t" not in r:
                r["errors"].append(f"{a} without {b}")
        if ("retire_t" in r and "generated" in r
                and r.get("max_new_tokens") is not None
                and not r.get("brownout_clamped")
                and r["generated"] != r["max_new_tokens"]):
            # (a brownout-clamped admit legitimately retires short of
            # the submitted budget — the clamp IS the degradation)
            r["errors"].append(
                f"generated {r['generated']} != max_new_tokens "
                f"{r['max_new_tokens']}")
        if (r.get("arrival") is not None and r.get("finish_t")
                is not None):
            r["latency_ms"] = round(
                (r["finish_t"] - r["arrival"]) * 1e3, 3)
        # complete = reached exactly one TYPED terminal cleanly.  A
        # legacy "error" row (unsupervised loop death) types the
        # terminal as failed but stays incomplete: it marks a
        # truncated lifecycle, not a closed one.
        r["complete"] = (not r["errors"] and (
            (r["terminal"] == "result" and "admit_t" in r)
            or r["terminal"] in ("timeout", "shed")
            or (r["terminal"] == "failed" and "failed_t" in r)))
    return recs


def trace_record(rows: Iterable[Dict[str, Any]], rid: int,
                 proc: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """The /trace?rid=N payload: the reconstructed record plus the
    raw events touching ``rid`` (its own + shared ticks).  ``proc``
    disambiguates merged multi-process streams (every engine numbers
    rids from 0); unset, the lowest matching proc wins and the other
    candidates are listed in ``ambiguous_procs``."""
    rid = int(rid)
    rows = list(rows)
    recs = reconstruct(rows)
    procs = sorted(p for p, r in recs if r == rid
                   and (proc is None or p == proc))
    if not procs:
        return None
    pick = procs[0]
    events = [r for r in rows
              if int(r.get("proc") or 0) == pick
              and (r.get("rid") == rid or rid in (r.get("rids") or ()))]
    doc = {"rid": rid, "proc": pick,
           "record": recs[(pick, rid)], "events": events}
    if len(procs) > 1:
        doc["ambiguous_procs"] = procs
    return doc


__all__ = ["RING_CAPACITY", "MILESTONES", "TERMINALS", "new_trace_id",
           "new_span_id", "parse_traceparent", "format_traceparent",
           "span_files", "SpanRecorder", "rotated_files", "read_spans",
           "load_spans", "reconstruct", "trace_record"]

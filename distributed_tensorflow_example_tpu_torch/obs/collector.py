"""Fleet span collector: N run dirs -> one causally-ordered timeline —
the port's copy of the JAX package's ``obs/collector.py``.

- **discovery** mirrors ``aggregate.metrics_files``: each *source* is a
  run dir (one holding a ``spans.*.jsonl`` / ``metrics.*.jsonl`` /
  ``restarts.jsonl`` stream); a path argument may be a run dir itself
  or a parent whose immediate children are run dirs.
- **merge** stitches every source's span stream (rotated segments
  included), restart timeline and metrics events into one time-ordered
  list.  Each merged row gains a ``source`` stamp and a rewritten
  globally unique ``proc`` (one per (source, original proc) pair), so
  ``reconstruct()`` checks the terminates-exactly-once invariant
  fleet-wide with the fold that checks it per engine.
- **clock-skew alignment**: each source is shifted by a constant so its
  first row lands on the fleet's earliest first row; the offset is
  reported per source.
- **fleet report** (``fleet_report``): the ``FLEET_REPORT`` document —
  per-source accounting, the fleet-wide exactly-once verdict, the
  failover chains joined by trace id across sources, the federated SLO
  evaluation (``slo.fleet_evaluate``) and the queueing analytics.
- **Chrome export** (``chrome_trace``): the merged timeline as Chrome
  trace-event JSON, one process track per source.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import slo as slo_lib
from . import waterfall as wf_lib
from .aggregate import has_streams as _has_streams
from .aggregate import metrics_files
from .queueing import queueing_report
from .schema import SCHEMA_VERSION
from .spans import read_spans, reconstruct, span_files

# cap on the errors list a fleet report carries (the load_run
# max_errors discipline): a corrupt fleet should diagnose, not flood
MAX_REPORT_ERRORS = 50


def discover_sources(paths: Iterable[str]) -> List[Tuple[str, str]]:
    """``[(name, dir)]`` for every run dir reachable from ``paths``
    (each entry a run dir itself, or a parent whose immediate children
    are run dirs), sorted by name.  The name is the dir basename,
    suffixed with ``#N`` on collision — a source label must be unique
    because the federated SLO groups on it."""
    dirs: List[str] = []
    for p in paths:
        p = os.path.normpath(p)
        if os.path.isdir(p) and _has_streams(p):
            dirs.append(p)
            continue
        if os.path.isdir(p):
            for child in sorted(glob.glob(os.path.join(p, "*"))):
                if os.path.isdir(child) and _has_streams(child):
                    dirs.append(child)
    out: List[Tuple[str, str]] = []
    seen: Dict[str, int] = {}
    for d in sorted(dict.fromkeys(dirs),
                    key=lambda d: os.path.basename(d)):
        name = os.path.basename(d) or d
        n = seen.get(name, 0)
        seen[name] = n + 1
        out.append((name if n == 0 else f"{name}#{n}", d))
    return out


def _read_jsonl(path: str) -> List[Dict[str, Any]]:
    rows = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return rows


def collect(paths: Iterable[str],
            align: bool = True) -> Dict[str, Any]:
    """Merge every discovered source's streams into one timeline.

    Returns ``{"rows", "sources"}``: ``rows`` time-ordered across
    sources, each stamped with ``source`` and a globally unique
    ``proc``; ``sources`` the per-source accounting (name, dir, row
    count, proc count, applied ``skew_s``).  Raises FileNotFoundError
    when no source has any stream — same contract as
    ``aggregate.load_run`` on an empty dir."""
    found = discover_sources(paths)
    if not found:
        raise FileNotFoundError(
            f"no span/metrics/restart streams under {list(paths)}")
    per_src: List[Dict[str, Any]] = []
    for name, d in found:
        rows: List[Dict[str, Any]] = []
        for _pid, path in span_files(d):
            rows.extend(read_spans(path))   # stitches rotations
        rows.extend(_read_jsonl(os.path.join(d, "restarts.jsonl")))
        for _pid, path in metrics_files(d):
            # metrics "event" rows (run_start/run_end/...) are point
            # markers worth a place on the fleet timeline; window
            # rows are per-window aggregates, not events — skipped
            rows.extend(r for r in _read_jsonl(path)
                        if r.get("kind") == "event")
        rows.sort(key=lambda r: (r.get("t") or 0.0))
        per_src.append({"source": name, "dir": d, "raw": rows})

    # per-source monotonic skew alignment: shift every source by a
    # constant so its first row lands on the fleet's earliest first
    # row.  Constant per source => intra-source order is untouched.
    starts = [src["raw"][0].get("t") or 0.0
              for src in per_src if src["raw"]]
    ref0 = min(starts) if starts else 0.0
    merged: List[Dict[str, Any]] = []
    sources: List[Dict[str, Any]] = []
    proc_map: Dict[Tuple[str, int], int] = {}
    for src in per_src:
        raw = src["raw"]
        skew = ((raw[0].get("t") or 0.0) - ref0) if raw else 0.0
        offset = -skew if align else 0.0
        procs = set()
        for r in raw:
            row = dict(r)
            orig_proc = int(row.get("proc") or 0)
            procs.add(orig_proc)
            key = (src["source"], orig_proc)
            if key not in proc_map:
                proc_map[key] = len(proc_map)
            row["proc"] = proc_map[key]
            row["source"] = src["source"]
            if offset and row.get("t") is not None:
                row["t"] = row["t"] + offset
            merged.append(row)
        sources.append({
            "source": src["source"], "dir": src["dir"],
            "rows": len(raw), "procs": len(procs),
            "skew_s": round(skew if align else 0.0, 6),
        })
    merged.sort(key=lambda r: (r.get("t") or 0.0))
    return {"rows": merged, "sources": sources}


def fleet_report(paths: Iterable[str],
                 specs: Optional[List[slo_lib.SLOSpec]] = None,
                 align: bool = True) -> Dict[str, Any]:
    """The ``FLEET_REPORT`` document over merged streams: per-source
    accounting, the fleet-wide exactly-once verdict (every request
    reconstructed from the merged stream carries exactly one typed
    terminal and a clean errors list), restart count and the
    federated SLO evaluation."""
    col = collect(paths, align=align)
    span_rows = [r for r in col["rows"] if r.get("kind") == "span"]
    recs = reconstruct(span_rows)
    errors: List[str] = []
    exactly_once = True
    # router narration records (route/failover rows only) describe
    # placements, not lifecycles: they neither count as requests nor
    # enter the SLO fold
    lifecycles = {k: rec for k, rec in recs.items()
                  if not rec.get("narration")}
    for (proc, rid), rec in sorted(recs.items()):
        # a terminal-free record with a clean errors list is simply
        # still in flight — not a violation; anything in errors
        # (duplicate milestone, multiple terminals, broken trace
        # chain, …) breaks the fleet-wide exactly-once verdict
        if rec["errors"]:
            exactly_once = False
            src = rec.get("source") or f"proc{proc}"
            for e in rec["errors"]:
                errors.append(f"{src} rid {rid}: {e}")
    # cross-engine failover join (v9): a request the router moved
    # spans one lifecycle PER HOP, tied together by its stable
    # trace_id.  Fleet-wide exactly-once then means: every
    # intermediate hop closed with a typed "failed" (the replica's
    # budget verdict) or "shed" (refused at the door, placed
    # elsewhere), and exactly the LAST hop carries the
    # client-delivered terminal.  An intermediate "result"/"timeout"
    # would be a double answer — flagged.
    by_trace: Dict[str, List[tuple]] = {}
    for key, rec in lifecycles.items():
        tid = rec.get("trace_id")
        if isinstance(tid, str):
            by_trace.setdefault(tid, []).append((key, rec))
    chains = 0
    hops = 0
    chain_terminals: Dict[str, int] = {}
    intermediate: set = set()
    clean = True
    for tid, members in sorted(by_trace.items()):
        if len(members) < 2:
            continue
        members.sort(key=lambda kr: (
            kr[1].get("submit_t") or kr[1].get("shed_t") or 0.0))
        chains += 1
        hops += len(members) - 1
        for key, rec in members[:-1]:
            intermediate.add(key)
            term = rec.get("terminal")
            if term in ("result", "timeout"):
                clean = False
                exactly_once = False
                src = rec.get("source") or f"proc{key[0]}"
                errors.append(
                    f"{src} rid {key[1]}: intermediate failover hop "
                    f"ended {term!r} (trace {tid}) — double-delivered")
        last = members[-1][1].get("terminal")
        if last is not None:
            chain_terminals[last] = chain_terminals.get(last, 0) + 1
    failover_doc = ({"chains": chains, "hops": hops, "clean": clean,
                     "terminals": chain_terminals}
                    if chains else None)
    restarts = sum(1 for r in col["rows"]
                   if r.get("event") == "engine_restart")
    # the federated SLO counts a failed-over request ONCE, with its
    # final terminal: intermediate hops (and router narration) are
    # carved out of the record stream before the fold
    excluded = intermediate | {k for k in recs if k not in lifecycles}
    slo_rows = [r for r in span_rows
                if r.get("rid") is None
                or (int(r.get("proc") or 0),
                    int(r["rid"])) not in excluded]
    slo_records = slo_lib.records_from_spans(slo_rows)
    slo_doc = (slo_lib.fleet_evaluate(slo_records, specs)
               if slo_records else None)
    return {
        "v": SCHEMA_VERSION,
        "kind": "fleet_report",
        "generated_t": time.time(),
        "sources": [{k: v for k, v in s.items() if k != "dir"}
                    for s in col["sources"]],
        "rows": len(col["rows"]),
        "requests": len(lifecycles),
        "exactly_once": exactly_once,
        "errors": errors[:MAX_REPORT_ERRORS],
        "restarts": restarts,
        "slo": slo_doc,
        # queueing analytics (v8, obs/queueing.py): arrival rate,
        # per-bucket service, utilization + the Little's-law identity
        # over the merged stream — None when nothing was submitted
        "queueing": queueing_report(span_rows),
        # cross-engine failover accounting (v9): the per-trace hop
        # chains the router produced — None when no request spanned
        # more than one lifecycle
        "failover": failover_doc,
    }


def _us(t: Optional[float]) -> float:
    return round((t or 0.0) * 1e6, 1)


def chrome_trace(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The merged timeline as Chrome trace-event JSON (the Perfetto
    import format): one process track per source, one thread per
    request (the request's lifecycle phases nested inside its span —
    same tid + contained intervals is the format's nesting rule),
    training phase spans on a dedicated thread, restart rows and
    legacy error spans as instant events.  Timestamps are the merged
    (skew-aligned) ``t`` in microseconds."""
    sources: List[str] = []
    src_pid: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []

    def pid_for(row: Dict[str, Any]) -> int:
        src = str(row.get("source") or f"proc{row.get('proc', 0)}")
        if src not in src_pid:
            src_pid[src] = len(src_pid)
            sources.append(src)
            events.append({"ph": "M", "pid": src_pid[src], "tid": 0,
                           "name": "process_name",
                           "args": {"name": src}})
        return src_pid[src]

    span_rows = [r for r in rows if r.get("kind") == "span"]
    recs = reconstruct(span_rows)
    # per-request waterfall segments: the exact attribution
    # partition nests under the coarse lifecycle slices
    falls = {(d["proc"], d["rid"]): d
             for d in wf_lib.waterfalls(span_rows)}
    # stable tid per request within its source track (rid collisions
    # across sources are fine — they live on different pids)
    for (proc, rid), rec in sorted(recs.items()):
        probe = {"source": rec.get("source"), "proc": proc}
        pid = pid_for(probe)
        tid = rid + 1                      # tid 0 = the phase track
        t0 = rec.get("submit_t")
        t1 = (rec.get("retire_t") or rec.get("timeout_t")
              or rec.get("failed_t") or rec.get("shed_t"))
        if t0 is None:
            t0 = t1
        if t0 is None:
            continue
        args = {k: rec[k] for k in ("trace_id", "parent_id",
                                    "terminal", "generated",
                                    "ttft_ms", "latency_ms",
                                    "attempts")
                if rec.get(k) is not None}
        events.append({
            "ph": "X", "pid": pid, "tid": tid,
            "name": f"request {rid}",
            "cat": "request", "ts": _us(t0),
            "dur": max(1.0, _us(t1) - _us(t0)) if t1 else 1.0,
            "args": args,
        })
        # nested lifecycle phases (same tid, contained intervals)
        for name, a, b in (
                ("queued", rec.get("submit_t"), rec.get("admit_t")),
                ("prefill", rec.get("admit_t"),
                 rec.get("first_token_t")),
                ("decode", rec.get("first_token_t"),
                 rec.get("retire_t"))):
            if a is not None and b is not None and b >= a:
                events.append({
                    "ph": "X", "pid": pid, "tid": tid, "name": name,
                    "cat": "lifecycle", "ts": _us(a),
                    "dur": max(1.0, _us(b) - _us(a)),
                })
        # the waterfall's exact segment intervals (obs/waterfall.py):
        # finer than the lifecycle slices — decode splits into
        # active/stall, restarts show as requeue — skipping the
        # zero-width and defensive-untracked pieces
        fall = falls.get((proc, rid))
        for a, b, seg in (fall or {}).get("intervals", ()):
            if seg == "untracked" or b <= a:
                continue
            events.append({
                "ph": "X", "pid": pid, "tid": tid, "name": seg,
                "cat": "waterfall", "ts": _us(a),
                "dur": max(1.0, _us(b) - _us(a)),
            })
    for r in rows:
        kind, event = r.get("kind"), r.get("event")
        if kind == "span" and event == "phase":
            pid = pid_for(r)
            dur_ms = float(r.get("dur_ms") or 0.0)
            ts = _us(r.get("t")) - round(dur_ms * 1e3, 1)
            args = {k: r[k] for k in ("phase", "trace_id", "step",
                                      "round")
                    if r.get(k) is not None}
            events.append({"ph": "X", "pid": pid, "tid": 0,
                           "name": str(r.get("phase")),
                           "cat": "train", "ts": ts,
                           "dur": max(1.0, round(dur_ms * 1e3, 1)),
                           "args": args})
        elif kind == "span" and event in ("engine_restart", "error"):
            pid = pid_for(r)
            events.append({"ph": "i", "pid": pid, "tid": 0,
                           "name": str(event), "cat": "anomaly",
                           "ts": _us(r.get("t")), "s": "p",
                           "args": {"reason": str(r.get("reason"))}})
        elif kind == "restart":
            pid = pid_for(r)
            events.append({"ph": "i", "pid": pid, "tid": 0,
                           "name": f"restart:{r.get('event')}",
                           "cat": "restart", "ts": _us(r.get("t")),
                           "s": "p"})
    events.sort(key=lambda e: (e.get("ts") or 0.0,
                               0 if e["ph"] == "M" else 1))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema": f"dtx v{SCHEMA_VERSION}",
                          "sources": sources}}

"""``dtx-obs`` — the operator CLI over the obs/ telemetry; the port's
copy of the JAX package's ``obs/cli.py``, over the port's ``obs/``
modules and the streams either package writes (both stamp schema v10).
Run it as ``python -m distributed_tensorflow_example_tpu_torch.obs.cli``.

Subcommands (``dtx-obs <cmd> --help`` for flags):

- ``report LOGS``   — aggregate a run's logs into the run report
  (obs/aggregate.py): goodput decomposition, step-time percentiles,
  throughput/MFU, anomaly timeline. ``--summary`` prints the one-line
  form instead of JSON;
- ``compare BASE CAND`` — A/B two runs/reports/bench rows
  (obs/compare.py); exit 3 on regression — usable directly as a CI
  gate;
- ``tail LOGS``     — one line per metrics window (plus anomaly/
  run_end events), ``-f`` to follow a live run;
- ``serve LOGS``    — (re-)serve a run directory over HTTP: /status,
  /metrics (Prometheus), /report, /slo, /trace (obs/serve.py). Works
  identically on a finished run and alongside a live one;
- ``validate PATH...`` — run the obs/schema.py validators over
  metrics/span/history JSONL files / flight dumps / run reports /
  whole logs dirs; exit 1 on drift, 2 on unreadable input, with the
  precise schema-version diagnosis for old-format logs;
- ``slo LOGS``      — evaluate the obs/slo.py specs over the serving
  span stream; exit 3 on breach (the compare regression convention);
- ``trace LOGS RID`` — one request's reconstructed lifecycle from the
  span stream (submit → blocked/admit → prefill → first_token →
  decode ticks → retire), with the raw events; ``--export chrome``
  renders the WHOLE merged timeline as Chrome trace-event JSON
  (openable in ui.perfetto.dev) instead — RID optional there;
- ``collect PATH...`` — merge N run dirs' span/metrics/restart
  streams into one causally-ordered fleet timeline
  (obs/collector.py): skew-aligned, ``source``-stamped, printed as
  tail lines (or ``--json`` rows);
- ``fleet PATH...``  — the fleet report over merged streams:
  per-source accounting, the fleet-wide exactly-once verdict and the
  federated SLO evaluation; exit 3 on an SLO breach, a federated-
  identity violation or an exactly-once violation;
- ``history FILE``  — the rolling bench history (obs/history.py):
  trend table by default, ``--import`` backfills from BENCH
  captures, ``--append`` records any comparison document;
- ``explain LOGS`` — per-request latency waterfalls (obs/
  waterfall.py): disjoint segments that provably sum to submit ->
  terminal wall, ``--rid N`` / ``--trace ID`` to focus one request,
  ``--fleet`` for the queueing analytics (arrival rate, per-bucket
  service time, Little's-law check) instead;
- ``drift HISTORY`` — change-point detection over the bench history
  (obs/drift.py): names the metric, the window and the FIRST
  offending row; ``--capture`` joins the roofline closed forms; exit
  3 on confirmed drift (the compare regression convention);
- ``capture RUN`` — distill a run's span stream (single engine or a
  fleet parent dir) into a portable WORKLOAD document
  (obs/workload.py, schema v10): per-request arrival offsets, token
  counts, deadlines and prompt fingerprints — the input to ``dtx-serve
  --replay`` and ``capacity``;
- ``capacity WORKLOAD`` — closed-form capacity forecast
  (obs/capacity.py): sustainable QPS per replica and required
  replicas off the workload shape and a service rate;
  ``--measured-qps`` joins a replayed saturation knee and exits 3
  when measurement falls short of forecast beyond tolerance.

``tail``/``explain`` take ``--workload WID`` to isolate rows a replay
stamped with ``replay_of: WID``.

Exit codes: 0 ok; 1 validation failure; 2 bad input (missing files,
no metrics stream); 3 regression/SLO-breach/fleet-invariant/drift/
capacity verdict (compare, slo, fleet, drift, capacity).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from . import aggregate as agg_lib
from . import compare as cmp_lib
from . import schema as schema_lib
from . import serve as serve_lib


def _fmt(v, nd=4) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


def format_row(row: Dict[str, Any]) -> Optional[str]:
    """One terminal line per window row; anomaly/stragglers/run_end
    events and serving span rows ride along; other rows (compile
    etc.) map to None."""
    kind = row.get("kind")
    proc = row.get("proc", "?")
    if kind == "span":
        ev = row.get("event")
        if ev == "tick":
            return (f"[p{proc}] tick {_fmt(row.get('tick'))} "
                    f"batch {_fmt(row.get('batch'))}/"
                    f"{_fmt(row.get('batch_bucket'))} "
                    f"kv_pages {_fmt(row.get('kv_pages'))} "
                    f"occ {_fmt(row.get('occupancy'))}")
        if ev == "engine_restart":
            # batch-shaped like tick: no single rid
            return (f"[p{proc}] ENGINE RESTART "
                    f"{_fmt(row.get('restart'))} "
                    f"inflight {len(row.get('rids') or ())} "
                    f"({_fmt(row.get('reason'))})")
        if ev == "phase":
            # the training-side span: no rid, a registered phase name
            return (f"[p{proc}] phase {row.get('phase')} "
                    f"dur {_fmt(row.get('dur_ms'))}ms")
        if ev == "tick_done":
            # batch-shaped like tick: no rid, the execute duration
            return (f"[p{proc}] tick_done {_fmt(row.get('tick'))} "
                    f"dur {_fmt(row.get('dur_ms'))}ms")
        bits = [f"[p{proc}] rid {_fmt(row.get('rid'))} {ev}"]
        for key, label in (("reason", ""), ("pages_held", "pages="),
                           ("replay_of", "replay_of="),
                           ("bucket", "bucket="),
                           ("ttft_ms", "ttft_ms="),
                           ("generated", "generated="),
                           ("attempt", "attempt="),
                           ("attempts", "attempts="),
                           ("queued", "queued="),
                           ("tick", "tick=")):
            if row.get(key) is not None:
                bits.append(f"{label}{_fmt(row[key])}")
        return " ".join(bits)
    if kind == "window":
        return (f"[p{proc}] step {_fmt(row.get('step'))} "
                f"ep {_fmt(row.get('epoch'))} "
                f"cost {_fmt(row.get('cost'))} "
                f"p50 {_fmt(row.get('step_time_p50_ms'))}ms "
                f"p95 {_fmt(row.get('step_time_p95_ms'))}ms "
                f"ex/s {_fmt(row.get('examples_per_sec'))} "
                f"mfu {_fmt(row.get('mfu'))}")
    if kind == "event":
        ev = row.get("event")
        if ev == "anomaly":
            return (f"[p{proc}] ANOMALY step {_fmt(row.get('step'))} "
                    f"{','.join(row.get('reasons') or [])} "
                    f"policy={row.get('policy')}")
        if ev == "stragglers":
            return (f"[p{proc}] stragglers: lag "
                    f"{_fmt(row.get('max_step_lag'))} steps "
                    f"(slowest p{_fmt(row.get('slowest_proc'))})")
        if ev == "run_end":
            return (f"[p{proc}] run_end: steps {_fmt(row.get('steps'))} "
                    f"wall {_fmt(row.get('total_time_s'))}s "
                    f"acc {_fmt(row.get('test_accuracy'))}")
    return None


def _metrics_files(logs_path: str) -> List[str]:
    return [path for _pid, path in agg_lib.metrics_files(logs_path)]


def _stream_files(logs_path: str) -> List[str]:
    """Every JSONL stream tail/validate watch: the metrics streams
    plus the serving span streams (same whole-line discipline)."""
    from . import spans as spans_lib

    return _metrics_files(logs_path) + [
        path for _pid, path in spans_lib.span_files(logs_path)]


def cmd_report(args) -> int:
    try:
        report = agg_lib.aggregate(args.logs_path)
    except FileNotFoundError as e:
        print(f"dtx-obs report: {e}", file=sys.stderr)
        return 2
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
    if args.summary:
        print(agg_lib.summary_line(report))
    elif not args.out:
        print(json.dumps(report, indent=None if args.compact else 1))
    if report["schema_error_count"] and not args.summary:
        print(f"NOTE: {report['schema_error_count']} schema error(s) — "
              f"see report['schema_errors']", file=sys.stderr)
    return 0


def cmd_compare(args) -> int:
    try:
        base = cmp_lib.load_doc(args.base)
        cand = cmp_lib.load_doc(args.cand)
    except (OSError, ValueError) as e:
        print(f"dtx-obs compare: {e}", file=sys.stderr)
        return 2
    thresholds = {}
    for spec in (args.thresholds or "").split(","):
        if not spec.strip():
            continue
        name, _, val = spec.partition("=")
        if name.strip() not in cmp_lib.GATE_METRICS:
            print(f"dtx-obs compare: unknown metric {name.strip()!r} "
                  f"(known: {sorted(cmp_lib.GATE_METRICS)})",
                  file=sys.stderr)
            return 2
        try:
            thresholds[name.strip()] = float(val)
        except ValueError:
            print(f"dtx-obs compare: bad threshold {spec.strip()!r} "
                  f"(want NAME=REL, e.g. wall_s=0.1)", file=sys.stderr)
            return 2
    verdict = cmp_lib.compare(base, cand, thresholds=thresholds or None,
                              default_threshold=args.threshold)
    print(json.dumps(verdict, indent=None if args.compact else 1))
    if not verdict["compared"]:
        print("dtx-obs compare: no overlapping metrics between the two "
              "documents", file=sys.stderr)
        return 2
    return 0 if verdict["ok"] else 3


def poll_new_lines(path: str, state: Dict[str, tuple]) -> List[str]:
    """One follow-poll over ``path``: the newly appended WHOLE lines
    since the recorded position.  ``state`` maps path -> (inode,
    offset) and is updated in place.

    A stream that rotates (the file we were offset into was renamed away
    and a fresh one took its name: a new inode) or truncates (size <
    our offset) resets the offset to 0 and is re-read from its start;
    a stale offset would never pass the ``size > offset`` check again
    and the follow loop would go quiet.  Only whole lines are consumed:
    a poll landing mid-append leaves the torn tail for next time."""
    ino, off = state.get(path, (None, 0))
    try:
        st = os.stat(path)
        if ino is not None and (st.st_ino != ino or st.st_size < off):
            off = 0
        if st.st_size <= off:
            state[path] = (st.st_ino, off)
            return []
        with open(path, "rb") as f:
            f.seek(off)
            data = f.read()
    except OSError:
        return []
    nl = data.rfind(b"\n")
    if nl < 0:
        state[path] = (st.st_ino, off)
        return []
    state[path] = (st.st_ino, off + nl + 1)
    return data[:nl + 1].decode("utf-8",
                                errors="replace").splitlines()


def _tail_match(row: Dict[str, Any], rid: Optional[int],
                trace: Optional[str],
                workload: Optional[str] = None) -> bool:
    """The ``tail --rid/--trace/--workload`` filter: span rows about
    the request (directly, or as a member of a batch row's ``rids``),
    or — for ``--workload`` — rows a replay stamped with
    ``replay_of``.  With no filter every row passes; with one,
    non-span rows are noise."""
    if rid is None and trace is None and workload is None:
        return True
    if row.get("kind") != "span":
        return False
    if rid is not None and row.get("rid") != rid \
            and rid not in (row.get("rids") or ()):
        return False
    if trace is not None and row.get("trace_id") != trace:
        return False
    if workload is not None and row.get("replay_of") != workload:
        return False
    return True


def cmd_tail(args) -> int:
    files = _stream_files(args.logs_path)
    if not files and not args.follow:
        print(f"dtx-obs tail: no metrics.<proc>.jsonl or "
              f"spans.<proc>.jsonl under {args.logs_path!r}",
              file=sys.stderr)
        return 2
    # print the last -n formatted lines across streams, then follow
    from . import spans as spans_lib

    state: Dict[str, tuple] = {}
    backlog: List[tuple] = []
    for path in files:
        # a span stream's backlog spans its rotation boundary: the
        # rotated-away segments (oldest-first) feed the same sorted
        # backlog the live file does — only the live file is followed
        rows = []
        for seg in spans_lib.rotated_files(path)[:-1]:
            rows.extend(serve_lib.tail_rows(seg))
        rows.extend(serve_lib.tail_rows(path))
        try:
            st = os.stat(path)
            state[path] = (st.st_ino, st.st_size)
        except OSError:
            pass
        for r in rows:
            if not _tail_match(r, args.rid, args.trace or None,
                               args.workload or None):
                continue
            line = format_row(r)
            if line is not None:
                backlog.append((r.get("t") or 0.0, line))
    backlog.sort()
    for _, line in backlog[-args.lines:]:
        print(line)
    if not args.follow:
        return 0
    try:
        while True:
            time.sleep(args.interval)
            for path in _stream_files(args.logs_path):
                for ln in poll_new_lines(path, state):
                    try:
                        row = json.loads(ln)
                    except ValueError:
                        continue
                    if not isinstance(row, dict) or not _tail_match(
                            row, args.rid, args.trace or None,
                            args.workload or None):
                        continue
                    line = format_row(row)
                    if line is not None:
                        print(line, flush=True)
    except KeyboardInterrupt:
        return 0


def cmd_serve(args) -> int:
    srv = serve_lib.StatusServer(args.logs_path,
                                 cache_ttl_s=args.cache_s)
    port = srv.start(args.port, host=args.host)
    if port is None:
        return 2
    print(f"dtx-obs serve: http://{args.host or 'localhost'}:{port}"
          f"  (/status /metrics /report)  logs={args.logs_path}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        return 0
    finally:
        srv.close()


def _validate_one(path: str) -> List[str]:
    """Route one file to the right obs/schema.py validator by shape."""
    base = os.path.basename(path)
    if base.endswith(".jsonl"):
        if base.startswith("spans."):
            return schema_lib.validate_span_file(path)
        if base.startswith("metrics."):
            return schema_lib.validate_metrics_file(path)
        if base.startswith("restarts"):
            return schema_lib.validate_restart_file(path)
        # an unnamed JSONL: route by its first WELL-FORMED row's kind
        # (history files travel under arbitrary names; a torn first
        # line — a crashed writer — must not misroute the rest)
        kind = None
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
                        kind = row.get("kind")
                        break
        except OSError as e:
            return [f"{path}: unreadable ({e})"]
        if kind == "span":
            return schema_lib.validate_span_file(path)
        if kind == "bench_history":
            return schema_lib.validate_history_file(path)
        if kind == "restart":
            return schema_lib.validate_restart_file(path)
        return schema_lib.validate_metrics_file(path)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable ({e})"]
    if isinstance(doc, dict) and doc.get("kind") == "workload":
        # a dtx-obs capture document (schema v10) under any name
        return schema_lib.validate_workload(doc, where=path)
    if isinstance(doc, dict) and doc.get("kind") == "run_report":
        return schema_lib.validate_run_report(doc, where=path)
    if base == "report.json":
        # the chief's collate() post-mortem, not a per-proc dump: it
        # has its own (version-stamped) shape — check the version only
        return schema_lib.validate_version(doc, "version", where=path)
    return schema_lib.validate_flight_dump(doc, where=path)


def cmd_validate(args) -> int:
    targets: List[str] = []
    for path in args.paths:
        if os.path.isdir(path):
            targets += _stream_files(path)
            restarts = os.path.join(path, "restarts.jsonl")
            if os.path.isfile(restarts):
                targets.append(restarts)
            targets += sorted(glob.glob(os.path.join(path, "flight",
                                                     "*.json")))
        elif os.path.exists(path):
            targets.append(path)
        else:
            print(f"dtx-obs validate: {path}: no such file",
                  file=sys.stderr)
            return 2
    if not targets:
        print("dtx-obs validate: nothing to validate", file=sys.stderr)
        return 2
    failed = 0
    for path in targets:
        errs = _validate_one(path)
        if errs:
            failed += 1
            print(f"FAIL {path}")
            for e in errs[:args.max_errors]:
                print(f"  {e}")
            if len(errs) > args.max_errors:
                print(f"  ... {len(errs) - args.max_errors} more")
        else:
            print(f"OK   {path}")
    return 1 if failed else 0


def cmd_slo(args) -> int:
    from . import slo as slo_lib
    from . import spans as spans_lib

    try:
        specs = slo_lib.parse_specs(args.spec)
    except ValueError as e:
        print(f"dtx-obs slo: {e}", file=sys.stderr)
        return 2
    rows = spans_lib.load_spans(args.logs_path)
    if not rows:
        print(f"dtx-obs slo: no spans.<proc>.jsonl under "
              f"{args.logs_path!r} — was the engine started with "
              f"--trace_spans?", file=sys.stderr)
        return 2
    doc = slo_lib.evaluate(slo_lib.records_from_spans(rows),
                           specs=specs)
    print(json.dumps(doc, indent=None if args.compact else 1))
    if doc["breaches"]:
        print(f"dtx-obs slo: BREACH {','.join(doc['breaches'])}",
              file=sys.stderr)
        return 3
    return 0


def cmd_trace(args) -> int:
    from . import spans as spans_lib

    if args.export:
        # whole-timeline export (RID optional): run dirs AND fleet
        # parents both work, via the collector's discovery/merge
        from . import collector as col_lib

        try:
            col = col_lib.collect([args.logs_path])
        except FileNotFoundError as e:
            print(f"dtx-obs trace: {e}", file=sys.stderr)
            return 2
        rows = col["rows"]
        if args.rid is not None:
            rows = [r for r in rows
                    if r.get("kind") != "span"
                    or r.get("rid") == args.rid
                    or args.rid in (r.get("rids") or ())]
        doc = col_lib.chrome_trace(rows)
        if not any(e["ph"] != "M" for e in doc["traceEvents"]):
            print(f"dtx-obs trace: nothing to export under "
                  f"{args.logs_path!r}"
                  + (f" for rid {args.rid}" if args.rid is not None
                     else ""), file=sys.stderr)
            return 2
        out = json.dumps(doc, indent=None if args.compact else 1)
        if args.out:
            with open(args.out, "w") as f:
                f.write(out + "\n")
            print(f"dtx-obs trace: wrote "
                  f"{len(doc['traceEvents'])} events to {args.out} "
                  f"(open in ui.perfetto.dev)", file=sys.stderr)
        else:
            print(out)
        return 0
    if args.rid is None:
        print("dtx-obs trace: RID is required without --export",
              file=sys.stderr)
        return 2
    rows = spans_lib.load_spans(args.logs_path)
    if not rows:
        print(f"dtx-obs trace: no spans.<proc>.jsonl under "
              f"{args.logs_path!r}", file=sys.stderr)
        return 2
    doc = spans_lib.trace_record(rows, args.rid)
    if doc is None:
        print(f"dtx-obs trace: rid {args.rid} not in the span stream",
              file=sys.stderr)
        return 2
    print(json.dumps(doc, indent=None if args.compact else 1))
    return 0


def cmd_collect(args) -> int:
    from . import collector as col_lib

    try:
        col = col_lib.collect(args.paths, align=not args.no_align)
    except FileNotFoundError as e:
        print(f"dtx-obs collect: {e}", file=sys.stderr)
        return 2
    for s in col["sources"]:
        print(f"source {s['source']}: {s['rows']} rows, "
              f"{s['procs']} proc(s), skew {s['skew_s']:+.3f}s",
              file=sys.stderr)
    rows = col["rows"]
    if args.lines > 0:
        rows = rows[-args.lines:]
    if args.out:
        with open(args.out, "w") as f:
            for r in col["rows"]:
                f.write(json.dumps(r) + "\n")
        print(f"dtx-obs collect: wrote {len(col['rows'])} merged "
              f"rows to {args.out}", file=sys.stderr)
        return 0
    for r in rows:
        if args.json:
            print(json.dumps(r))
        else:
            line = format_row(r)
            if line is not None:
                print(f"[{r.get('source')}]{line}")
    return 0


def cmd_fleet(args) -> int:
    from . import collector as col_lib
    from . import slo as slo_lib

    try:
        specs = slo_lib.parse_specs(args.spec)
    except ValueError as e:
        print(f"dtx-obs fleet: {e}", file=sys.stderr)
        return 2
    try:
        report = col_lib.fleet_report(args.paths, specs=specs,
                                      align=not args.no_align)
    except FileNotFoundError as e:
        print(f"dtx-obs fleet: {e}", file=sys.stderr)
        return 2
    print(json.dumps(report, indent=None if args.compact else 1))
    bad = []
    if not report["exactly_once"]:
        bad.append("exactly-once violation")
    slo_doc = report.get("slo")
    if slo_doc is not None:
        if not slo_doc["identity"]["holds"]:
            bad.append("federated-identity violation")
        if slo_doc["breaches"]:
            bad.append(f"SLO breach {','.join(slo_doc['breaches'])}")
    if bad:
        print(f"dtx-obs fleet: {'; '.join(bad)}", file=sys.stderr)
        return 3
    return 0


def cmd_history(args) -> int:
    from . import history as hist_lib

    rc = 0
    if args.imports:
        appended, skipped = hist_lib.import_captures(args.history,
                                                     args.imports)
        print(f"dtx-obs history: imported {appended} capture(s), "
              f"skipped {len(skipped)}", file=sys.stderr)
        for msg in skipped:
            print(f"  {msg}", file=sys.stderr)
    if args.append:
        try:
            doc = cmp_lib.load_doc(args.append)
        except (OSError, ValueError) as e:
            print(f"dtx-obs history: {e}", file=sys.stderr)
            return 2
        entry = hist_lib.append_entry(
            args.history, doc,
            label=os.path.splitext(os.path.basename(args.append))[0],
            source=args.append)
        if not entry["metrics"]:
            print(f"dtx-obs history: {args.append}: no gate metrics "
                  f"extractable (recorded an empty entry)",
                  file=sys.stderr)
            rc = 1
    entries = hist_lib.read_history(args.history)
    if not entries:
        print(f"dtx-obs history: no entries in {args.history!r}",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(entries, indent=1))
    else:
        metrics = ([m.strip() for m in args.metrics.split(",")
                    if m.strip()] if args.metrics else None)
        print(hist_lib.trend_table(entries, metrics=metrics,
                                   last=args.last))
    return rc


def cmd_explain(args) -> int:
    from . import collector as col_lib
    from . import waterfall as wf_lib
    from .queueing import queueing_report

    try:
        col = col_lib.collect([args.logs_path])
    except FileNotFoundError as e:
        print(f"dtx-obs explain: {e}", file=sys.stderr)
        return 2
    span_rows = [r for r in col["rows"] if r.get("kind") == "span"]
    if args.workload:
        # only rows a replay stamped with this source workload id —
        # the A/B surface across replays of one capture
        span_rows = [r for r in span_rows
                     if r.get("replay_of") == args.workload]
    if args.fleet:
        q = queueing_report(span_rows)
        if q is None:
            print(f"dtx-obs explain: no request submits in the span "
                  f"stream under {args.logs_path!r}", file=sys.stderr)
            return 2
        print(json.dumps(q, indent=None if args.compact else 1))
        ll = q["littles_law"]
        if not ll["holds"]:
            print(f"dtx-obs explain: Little's law gap "
                  f"{ll['rel_err']:.1%} — {ll['violations']} "
                  f"in-flight/untracked request(s)", file=sys.stderr)
        return 0
    docs = wf_lib.waterfalls(span_rows, rid=args.rid,
                             trace_id=args.trace or None)
    if not docs:
        where = (f" for rid {args.rid}" if args.rid is not None
                 else f" for trace {args.trace!r}" if args.trace
                 else "")
        print(f"dtx-obs explain: no request lifecycles in the span "
              f"stream under {args.logs_path!r}{where}",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps({"summary": wf_lib.summarize(docs),
                          "waterfalls": docs},
                         indent=None if args.compact else 1))
        return 0
    for d in docs:
        head = (f"[p{d['proc']}] rid {d['rid']} -> "
                f"{d['terminal'] or 'IN FLIGHT'}  "
                f"wall {d['wall_ms']:.1f}ms")
        if d.get("trace_id"):
            head += f"  trace {d['trace_id']}"
        if d["requeues"]:
            head += f"  requeues {d['requeues']}"
        print(head)
        for seg in wf_lib.WATERFALL_SEGMENTS:
            ms = d["segments"].get(seg, 0.0)
            if ms <= 0.0:
                continue
            frac = ms / d["wall_ms"] if d["wall_ms"] > 0 else 0.0
            print(f"  {seg:<20} {ms:>10.2f}ms  {frac:>6.1%}")
        print(f"  {'sum':<20} {d['segment_sum_ms']:>10.2f}ms  "
              f"(residual {d['residual_ms']:+.3f}ms)")
    summ = wf_lib.summarize(docs)
    print(f"{summ['requests']} request(s), {summ['complete']} "
          f"complete; wall p50 {_fmt(summ['wall_p50_ms'])}ms "
          f"p99 {_fmt(summ['wall_p99_ms'])}ms; "
          f"sum-to-wall {'OK' if summ['sum_to_wall_ok'] else 'GAP'} "
          f"(max residual {summ['max_residual_frac']:.2%})")
    return 0


def cmd_drift(args) -> int:
    from . import drift as drift_lib

    if not os.path.isfile(args.history):
        print(f"dtx-obs drift: {args.history}: no such file",
              file=sys.stderr)
        return 2
    metrics = [m.strip() for m in args.metrics.split(",")
               if m.strip()] or None
    try:
        doc = drift_lib.drift_report(
            args.history, window=args.window,
            tolerance=args.tolerance, metrics=metrics,
            capture=args.capture or None)
    except (OSError, ValueError) as e:
        print(f"dtx-obs drift: {e}", file=sys.stderr)
        return 2
    if doc["entries"] < drift_lib.MIN_ENTRIES:
        print(f"dtx-obs drift: only {doc['entries']} history "
              f"entr{'y' if doc['entries'] == 1 else 'ies'} in "
              f"{args.history!r} — change-point detection needs "
              f">= {drift_lib.MIN_ENTRIES}", file=sys.stderr)
        return 2
    print(json.dumps(doc, indent=None if args.compact else 1))
    for d in doc["drifts"]:
        print(f"dtx-obs drift: CONFIRMED {d['metric']} shifted "
              f"{d['shift_frac']:+.1%} (tolerance "
              f"{d['tolerance']:.1%}) — first offending row "
              f"{d['first_offending']!r} (entry "
              f"{d['first_offending_index']})", file=sys.stderr)
    return 0 if doc["ok"] else 3


def cmd_capture(args) -> int:
    from . import workload as wl_lib

    try:
        doc = wl_lib.capture(args.run_dir, align=not args.no_align)
    except (FileNotFoundError, ValueError) as e:
        print(f"dtx-obs capture: {e}", file=sys.stderr)
        return 2
    if args.out:
        wl_lib.write_workload(doc, args.out)
        print(f"dtx-obs capture: {doc['workload_id']} "
              f"({doc['n_requests']} requests over "
              f"{doc['duration_s']:g}s) -> {args.out}")
    else:
        print(json.dumps(doc, indent=None if args.compact else 1,
                         sort_keys=True))
    return 0


def cmd_capacity(args) -> int:
    from . import capacity as cap_lib
    from . import workload as wl_lib

    try:
        doc = wl_lib.load_workload(args.workload)
    except (OSError, ValueError) as e:
        print(f"dtx-obs capacity: {e}", file=sys.stderr)
        return 2
    util = (args.utilization if args.utilization is not None
            else cap_lib.UTILIZATION_TARGET)
    tol = (args.tolerance if args.tolerance is not None
           else cap_lib.DEFAULT_TOLERANCE)
    try:
        fc = cap_lib.forecast(
            doc, service_tok_s=args.service_tok_s,
            utilization_target=util)
    except ValueError as e:
        print(f"dtx-obs capacity: {e}", file=sys.stderr)
        return 2
    out = dict(fc)
    rc = 0
    if args.measured_qps is not None:
        # the validation loop: a measured saturation knee (replaying
        # the same workload at increasing --replay_speed) against the
        # closed-form forecast — exit 3 on the drift convention when
        # measurement falls short beyond tolerance
        out["verdict"] = cap_lib.verdict(
            fc["sustainable_qps"], args.measured_qps,
            tolerance=tol)
        if not out["verdict"]["ok"]:
            rc = 3
    print(json.dumps(out, indent=None if args.compact else 1,
                     sort_keys=True))
    if rc:
        v = out["verdict"]
        print(f"dtx-obs capacity: measured {v['measured_qps']:g} qps "
              f"falls short of forecast {v['forecast_qps']:g} qps "
              f"beyond tolerance {v['tolerance']:.0%} "
              f"(rel_err {v['rel_err']:.1%})", file=sys.stderr)
    return rc


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dtx-obs",
        description="run analytics over the obs/ telemetry: goodput "
                    "reports, A/B regression gating, live tail/serve, "
                    "schema validation")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("report", help="aggregate a run into the run "
                                      "report (goodput decomposition)")
    r.add_argument("logs_path")
    r.add_argument("--summary", action="store_true",
                   help="one-line summary instead of JSON")
    r.add_argument("--compact", action="store_true",
                   help="single-line JSON")
    r.add_argument("-o", "--out", default="",
                   help="also write the JSON report to this file")
    r.set_defaults(fn=cmd_report)

    c = sub.add_parser("compare", help="A/B two runs; exit 3 on "
                                       "regression")
    c.add_argument("base", help="baseline: logs dir, run report JSON, "
                                "bench row/summary, BASELINE.json or "
                                "BENCH_*.json capture")
    c.add_argument("cand", help="candidate (same shapes)")
    c.add_argument("--threshold", type=float, default=None,
                   help="relative threshold for EVERY metric "
                        "(default: per-metric, 0.05 perf / 0.02 "
                        "accuracy)")
    c.add_argument("--thresholds", default="",
                   metavar="NAME=REL,...",
                   help="per-metric overrides, e.g. wall_s=0.1,mfu=0.02")
    c.add_argument("--compact", action="store_true")
    c.set_defaults(fn=cmd_compare)

    t = sub.add_parser("tail", help="one line per metrics window")
    t.add_argument("logs_path")
    t.add_argument("-n", "--lines", type=int, default=20)
    t.add_argument("-f", "--follow", action="store_true",
                   help="keep following a live run")
    t.add_argument("--interval", type=float, default=2.0,
                   help="follow poll interval seconds")
    t.add_argument("--rid", type=int, default=None,
                   help="only span rows about this request id "
                        "(directly or as a batch member)")
    t.add_argument("--workload", default="",
                   metavar="WID",
                   help="only span rows a replay stamped with "
                        "replay_of WID (dtx-serve --replay)")
    t.add_argument("--trace", default="",
                   metavar="ID",
                   help="only span rows stamped with this trace id")
    t.set_defaults(fn=cmd_tail)

    s = sub.add_parser("serve", help="serve /status /metrics /report "
                                     "over HTTP (works on finished "
                                     "runs)")
    s.add_argument("logs_path")
    s.add_argument("--port", type=int, default=8321)
    s.add_argument("--host", default="",
                   help="bind address (default: all interfaces)")
    s.add_argument("--cache_s", type=float, default=None,
                   help="response cache TTL in seconds — /report, "
                        "/fleet and /explain share one TTL cache "
                        "(default 15; 0 = recompute every request)")
    s.set_defaults(fn=cmd_serve)

    v = sub.add_parser("validate", help="schema-validate metrics/"
                                        "spans/history/flight/report "
                                        "files or a whole logs dir")
    v.add_argument("paths", nargs="+")
    v.add_argument("--max-errors", type=int, default=10,
                   help="errors printed per file")
    v.set_defaults(fn=cmd_validate)

    o = sub.add_parser("slo", help="evaluate the serving SLOs over "
                                   "the span stream; exit 3 on "
                                   "breach")
    o.add_argument("logs_path")
    o.add_argument("--spec", default="",
                   metavar="NAME<=VALUE,...",
                   help="SLO specs (ttft_p99_ms<=MS, "
                        "latency_p99_ms<=MS, error_rate<=FRAC); "
                        "empty = the obs/slo.py defaults")
    o.add_argument("--compact", action="store_true")
    o.set_defaults(fn=cmd_slo)

    tr = sub.add_parser("trace", help="one request's reconstructed "
                                      "lifecycle from the span "
                                      "stream; --export chrome for "
                                      "the Perfetto timeline")
    tr.add_argument("logs_path")
    tr.add_argument("rid", type=int, nargs="?", default=None,
                    help="request id (optional with --export: the "
                         "whole timeline exports by default)")
    tr.add_argument("--export", choices=("chrome",), default="",
                    help="render as Chrome trace-event JSON "
                         "(ui.perfetto.dev) instead of the lifecycle "
                         "record")
    tr.add_argument("-o", "--out", default="",
                    help="write the export to this file instead of "
                         "stdout")
    tr.add_argument("--compact", action="store_true")
    tr.set_defaults(fn=cmd_trace)

    co = sub.add_parser("collect", help="merge N run dirs into one "
                                        "causally-ordered fleet "
                                        "timeline")
    co.add_argument("paths", nargs="+",
                    help="run dirs (or parents of run dirs)")
    co.add_argument("-n", "--lines", type=int, default=0,
                    help="print only the newest N merged rows")
    co.add_argument("--json", action="store_true",
                    help="raw merged rows instead of tail lines")
    co.add_argument("--no-align", action="store_true",
                    help="skip per-source clock-skew alignment")
    co.add_argument("-o", "--out", default="",
                    help="write the merged rows (JSONL) to this file")
    co.set_defaults(fn=cmd_collect)

    fl = sub.add_parser("fleet", help="fleet report over merged "
                                      "streams: exactly-once verdict "
                                      "+ federated SLO; exit 3 on "
                                      "breach/violation")
    fl.add_argument("paths", nargs="+",
                    help="run dirs (or parents of run dirs)")
    fl.add_argument("--spec", default="",
                    metavar="NAME<=VALUE,...",
                    help="SLO specs (the dtx-obs slo DSL); empty = "
                         "the obs/slo.py defaults")
    fl.add_argument("--no-align", action="store_true",
                    help="skip per-source clock-skew alignment")
    fl.add_argument("--compact", action="store_true")
    fl.set_defaults(fn=cmd_fleet)

    h = sub.add_parser("history", help="rolling bench history: trend "
                                       "table, --import backfill, "
                                       "--append recording")
    h.add_argument("history", help="the history.jsonl file")
    h.add_argument("--import", dest="imports", nargs="+", default=[],
                   metavar="CAPTURE",
                   help="backfill from BENCH_*.json captures (or any "
                        "comparison document); idempotent per label")
    h.add_argument("--append", default="",
                   metavar="DOC",
                   help="record one comparison document (bench "
                        "summary / run report / capture) as a new "
                        "entry")
    h.add_argument("--last", type=int, default=0,
                   help="show only the newest N entries")
    h.add_argument("--metrics", default="",
                   metavar="NAME,...",
                   help="trend-table columns (default: the headline "
                        "set present in the file)")
    h.add_argument("--json", action="store_true",
                   help="dump the raw entries instead of the table")
    h.set_defaults(fn=cmd_history)

    ex = sub.add_parser("explain",
                        help="per-request latency waterfalls: where "
                             "every millisecond between submit and "
                             "terminal went; --fleet for queueing "
                             "analytics")
    ex.add_argument("logs_path",
                    help="run dir (or parent of run dirs)")
    ex.add_argument("--rid", type=int, default=None,
                    help="only this request id")
    ex.add_argument("--trace", default="",
                    metavar="ID",
                    help="only requests stamped with this trace id")
    ex.add_argument("--workload", default="",
                    metavar="WID",
                    help="only requests a replay stamped with "
                         "replay_of WID (dtx-serve --replay)")
    ex.add_argument("--fleet", action="store_true",
                    help="queueing analytics (arrival rate, service "
                         "time by bucket, Little's-law check) "
                         "instead of per-request waterfalls")
    ex.add_argument("--json", action="store_true",
                    help="raw waterfall documents instead of tables")
    ex.add_argument("--compact", action="store_true")
    ex.set_defaults(fn=cmd_explain)

    dr = sub.add_parser("drift",
                        help="change-point detection over the bench "
                             "history; exit 3 on confirmed drift")
    dr.add_argument("history", help="the history.jsonl file")
    dr.add_argument("--window", type=int, default=0,
                    help="only the newest N entries (0 = all)")
    dr.add_argument("--tolerance", type=float, default=None,
                    help="relative shift tolerance for EVERY metric "
                         "(default: per-metric, 2x the gate "
                         "threshold, floor 0.05)")
    dr.add_argument("--metrics", default="",
                    metavar="NAME,...",
                    help="only these metrics (default: every metric "
                         "present in enough entries)")
    dr.add_argument("--capture", default="",
                    metavar="BENCH.json",
                    help="join this capture's measured decode "
                         "throughput against the roofline closed "
                         "forms")
    dr.add_argument("--compact", action="store_true")
    dr.set_defaults(fn=cmd_drift)

    ca = sub.add_parser("capture",
                        help="distill a run's span stream into a "
                             "portable WORKLOAD document — the input "
                             "to dtx-serve --replay and capacity")
    ca.add_argument("run_dir",
                    help="run dir (or fleet parent of run dirs)")
    ca.add_argument("-o", "--out", default="",
                    help="write the workload json here instead of "
                         "stdout")
    ca.add_argument("--no-align", action="store_true",
                    help="skip cross-source clock alignment")
    ca.add_argument("--compact", action="store_true")
    ca.set_defaults(fn=cmd_capture)

    cp = sub.add_parser("capacity",
                        help="closed-form capacity forecast off a "
                             "captured workload; exit 3 when a "
                             "--measured-qps knee falls short of "
                             "forecast beyond tolerance")
    cp.add_argument("workload", help="a dtx-obs capture json")
    cp.add_argument("--service-tok-s", type=float, required=True,
                    dest="service_tok_s",
                    help="one replica's decode budget in generated "
                         "tokens/s (a measured unloaded replay rate, "
                         "or the obs/capacity.py roofline on the "
                         "card)")
    cp.add_argument("--utilization", type=float,
                    default=None,
                    help="target utilization the forecast plans to "
                         "(default 0.8)")
    cp.add_argument("--measured-qps", type=float, default=None,
                    dest="measured_qps",
                    help="the measured saturation knee (replaying at "
                         "increasing --replay_speed); joins a "
                         "verdict and arms exit 3")
    cp.add_argument("--tolerance", type=float, default=None,
                    help="verdict tolerance (default 0.25)")
    cp.add_argument("--compact", action="store_true")
    cp.set_defaults(fn=cmd_capacity)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""The status server over a logs dir and, with an engine, the serving
front door — the port's copy of the JAX package's ``obs/serve.py``;
stdlib only (``http.server``).

``StatusServer(logs_path, engine=...)`` answers:

- ``/`` and ``/status`` — JSON from the metrics JSONL tails plus
  heartbeat freshness (``collect_status``), with the engine's
  ``stats()`` under ``serving``;
- ``/metrics`` — the same signals as Prometheus text gauges
  (``prometheus_text``): ``dtx_*`` of the run, ``dtx_generate_*`` of the
  engine, ``dtx_slo_*`` of the SLO verdict, ``dtx_fleet_*`` of the fleet
  report and ``dtx_waterfall_*`` of the latency attribution (the router
  adds ``dtx_router_*`` on its own server);
- ``/report`` — the ``obs/aggregate.py`` run report, cached by the input
  files' (path, mtime, size) signature and a TTL;
- ``/slo`` — the ``obs/slo.py`` burn-rate verdict over the span stream;
- ``/trace?rid=N`` — one request's reconstructed lifecycle and its rows;
- ``/fleet`` — the ``obs/collector.py`` fleet report over ``logs_path``
  (a run dir is a one-source fleet, a parent of run dirs federates its
  children);
- ``/explain[?rid=N][&trace=ID]`` — per-request latency waterfalls and
  their summary;
- ``/healthz`` — ``{"ok": true, "serving": <engine stats>}``, the one
  endpoint the JAX package's server lacks (the port's tests and probes
  read it);
- ``POST /generate`` — ``{"prompt": [ids], "max_new_tokens": N,
  "temperature": t, "deadline_ms": d}`` -> the engine's result; 503 +
  ``Retry-After`` when shed, 504 on a deadline, 400 on a bad request.
  A W3C ``traceparent`` header's trace id rides every span the request
  emits, and the response carries one either way.

``/report``, ``/fleet`` and ``/explain`` share one ``TTLCache`` each
(``cache_ttl_s``, the ``--status_cache_s`` flag).  The reader side only
reads the files a run appends to, with bounded tail reads
(``TAIL_BYTES``).  The port's trainer writes its metrics and heartbeat
streams under ``--metrics`` and serves this server under
``--status_port``; over a serving logs dir ``/status`` reports no
processes and ``/report`` answers 500 until a metrics stream is there.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from . import heartbeat as hb_lib

TAIL_BYTES = 256 * 1024
# a heartbeat older than this marks the process (and the run) stale
STALE_HEARTBEAT_S = 120.0
# /report cache lifetime: long enough to shrug off a hammering
# poller, short enough that wall-clock fields (heartbeat_age_s) keep
# aging visibly for a HUNG run whose files stopped changing
REPORT_CACHE_TTL_S = 15.0


class TTLCache:
    """The ONE cache for the recompute-heavy endpoints (/report,
    /fleet, /explain — each was growing its own lock + timestamp +
    signature triple).  ``get(compute)`` returns the cached value
    while it is younger than ``ttl_s``; pass ``sig`` (any comparable
    snapshot of the inputs, e.g. file stat triples) to ALSO
    invalidate the moment the inputs change — the /report semantics.
    ``None`` is a legitimate cached value (a fleet with no streams),
    so freshness is tracked explicitly, not by value."""

    def __init__(self, ttl_s: float = REPORT_CACHE_TTL_S):
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        self._sig: Any = None
        self._value: Any = None
        self._t = -1e18
        self._filled = False

    def get(self, compute, sig: Any = None) -> Any:
        now = time.monotonic()
        with self._lock:
            if (self._filled and now - self._t < self.ttl_s
                    and (sig is None or sig == self._sig)):
                return self._value
        value = compute()
        with self._lock:
            self._sig = sig
            self._value = value
            self._t = now
            self._filled = True
        return value


def tail_rows(path: str, max_bytes: int = TAIL_BYTES) -> List[Dict[str, Any]]:
    """Parse the last ``max_bytes`` of a JSONL file. When the read
    starts mid-file the first (possibly torn) line is dropped."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            if size > max_bytes:
                f.seek(size - max_bytes)
            chunk = f.read().decode("utf-8", errors="replace")
    except OSError:
        return []
    lines = chunk.splitlines()
    if size > max_bytes and lines:
        lines = lines[1:]
    rows = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rows.append(json.loads(line))
        except ValueError:
            continue
    return rows


def collect_status(logs_path: str,
                   now: Optional[float] = None) -> Dict[str, Any]:
    """The /status document: metrics tails + heartbeat freshness."""
    from .aggregate import metrics_files

    now = time.time() if now is None else now
    beats = hb_lib.read_heartbeats(logs_path)
    procs: Dict[str, Dict[str, Any]] = {}
    run_end = None
    last_window = None
    anomalies = 0
    chief: Optional[int] = None
    for pid, path in metrics_files(logs_path):
        rows = tail_rows(path)
        windows = [r for r in rows if r.get("kind") == "window"]
        events = [r for r in rows if r.get("kind") == "event"]
        anomalies += sum(1 for r in events if r.get("event") == "anomaly")
        w = windows[-1] if windows else {}
        hb = beats.get(pid)
        procs[str(pid)] = {
            "step": w.get("step"),
            "epoch": w.get("epoch"),
            "cost": w.get("cost"),
            "examples_per_sec": w.get("examples_per_sec"),
            "tokens_per_sec": w.get("tokens_per_sec"),
            "mfu": w.get("mfu"),
            "step_time_p50_ms": w.get("step_time_p50_ms"),
            "rss_bytes": w.get("rss_bytes"),
            "t": w.get("t"),
            "heartbeat_step": hb[0] if hb else None,
            "heartbeat_age_s": (round(max(0.0, now - hb[1]), 3)
                                if hb else None),
        }
        if chief is None or pid < chief:
            chief = pid
            last_window = w or None
            run_end = next((r for r in reversed(events)
                            if r.get("event") == "run_end"), None)
    ages = [p["heartbeat_age_s"] for p in procs.values()
            if p["heartbeat_age_s"] is not None]
    complete = run_end is not None
    return {
        "t": now,
        "logs_path": os.path.abspath(logs_path),
        "procs": procs,
        "proc_count": len(procs),
        "last_window": last_window,
        "run_end": run_end,
        "run_complete": complete,
        "live": bool(procs) and not complete
        and (min(ages) < STALE_HEARTBEAT_S if ages else True),
        "anomalies": anomalies,
        "flight_dumps": len([
            n for n in (os.listdir(os.path.join(logs_path, "flight"))
                        if os.path.isdir(os.path.join(logs_path,
                                                      "flight")) else [])
            if n.endswith(".json") and n != "report.json"]),
    }


def prometheus_text(status: Dict[str, Any],
                    serving: Optional[Dict[str, Any]] = None,
                    slo: Optional[Dict[str, Any]] = None,
                    fleet: Optional[Dict[str, Any]] = None,
                    waterfall: Optional[Dict[str, Any]] = None,
                    router: Optional[Dict[str, Any]] = None) -> str:
    """Render a /status document in Prometheus text exposition format
    (version 0.0.4). Gauges only — everything here is a point-in-time
    read of the run's own counters. ``serving``: a
    DecodeEngine.stats() document (schema.SERVING_STATS) appended as
    the ``dtx_generate_*`` request-latency gauges.  ``slo``: an
    obs/slo.evaluate document appended as the ``dtx_slo_*`` burn-rate
    gauges (per-SLO per-window burn rate, breach flags, observed
    p99).  ``fleet``: an obs/collector.fleet_report document appended
    as the ``dtx_fleet_*`` gauges (merged-timeline accounting, the
    exactly-once and federated-identity verdicts, per-source skew and
    burn).  ``waterfall``: an obs/waterfall.summarize document
    appended as the ``dtx_waterfall_*`` latency-attribution gauges
    (per-segment p50/p99 and the sum-to-wall residual).  ``router``:
    a serving/router.Router.stats() document appended as the
    ``dtx_router_*`` fleet gauges (fleet counters plus per-replica
    health / breaker / load, labelled ``replica``)."""
    out: List[str] = []

    def fmt(v) -> str:
        return format(float(v), ".10g")

    def gauge(name, help_text, samples):
        """samples: [(label_dict_or_None, value)] — None values are
        skipped (absent ≠ zero)."""
        kept = [(lb, v) for lb, v in samples
                if isinstance(v, (int, float))
                and not isinstance(v, bool)]
        if not kept:
            return
        out.append(f"# HELP {name} {help_text}")
        out.append(f"# TYPE {name} gauge")
        for labels, v in kept:
            if labels:
                lab = ",".join(f'{k}="{val}"'
                               for k, val in sorted(labels.items()))
                out.append(f"{name}{{{lab}}} {fmt(v)}")
            else:
                out.append(f"{name} {fmt(v)}")

    procs = status.get("procs") or {}

    def per_proc(key):
        return [({"proc": pid}, p.get(key))
                for pid, p in sorted(procs.items(), key=lambda kv:
                                     int(kv[0]))]

    gauge("dtx_up", "1 while the run looks live (fresh heartbeat, no "
          "run_end)", [(None, 1 if status.get("live") else 0)])
    gauge("dtx_run_complete", "1 once the run_end event was written",
          [(None, 1 if status.get("run_complete") else 0)])
    gauge("dtx_procs", "processes with a metrics stream",
          [(None, status.get("proc_count"))])
    gauge("dtx_step", "latest window step per process",
          per_proc("step"))
    gauge("dtx_cost", "latest window cost per process",
          per_proc("cost"))
    gauge("dtx_examples_per_sec", "latest window throughput",
          per_proc("examples_per_sec"))
    gauge("dtx_tokens_per_sec", "latest window token throughput",
          per_proc("tokens_per_sec"))
    gauge("dtx_mfu", "latest window model FLOPs utilization",
          per_proc("mfu"))
    gauge("dtx_step_time_p50_ms", "latest window median step time",
          per_proc("step_time_p50_ms"))
    gauge("dtx_rss_bytes", "latest resident set size per process",
          per_proc("rss_bytes"))
    gauge("dtx_heartbeat_age_seconds", "seconds since each process's "
          "last heartbeat", per_proc("heartbeat_age_s"))
    gauge("dtx_anomalies_total", "anomaly events in the metrics tails",
          [(None, status.get("anomalies"))])
    gauge("dtx_flight_dumps_total", "flight dumps on disk",
          [(None, status.get("flight_dumps"))])
    run_end = status.get("run_end") or {}
    gauge("dtx_total_time_seconds", "final run wall time (run_end)",
          [(None, run_end.get("total_time_s"))])
    gauge("dtx_test_accuracy", "final test accuracy (run_end)",
          [(None, run_end.get("test_accuracy"))])
    if serving:
        gauge("dtx_generate_requests_total", "requests accepted by "
              "the decode engine", [(None, serving.get("requests_total"))])
        gauge("dtx_generate_completed_total", "requests completed",
              [(None, serving.get("completed_total"))])
        gauge("dtx_generate_inflight", "requests in the live decode "
              "batch", [(None, serving.get("inflight"))])
        gauge("dtx_generate_queued", "requests waiting for admission",
              [(None, serving.get("queued"))])
        gauge("dtx_generate_latency_p50_ms", "median request latency",
              [(None, serving.get("latency_p50_ms"))])
        gauge("dtx_generate_latency_p99_ms", "p99 request latency",
              [(None, serving.get("latency_p99_ms"))])
        gauge("dtx_generate_ttft_p50_ms", "median time to first token",
              [(None, serving.get("ttft_p50_ms"))])
        gauge("dtx_generate_ttft_p99_ms", "p99 time to first token",
              [(None, serving.get("ttft_p99_ms"))])
        gauge("dtx_generate_tokens_total", "tokens generated",
              [(None, serving.get("tokens_generated_total"))])
        gauge("dtx_generate_tokens_per_sec", "aggregate decode "
              "throughput", [(None, serving.get("tokens_per_sec"))])
        gauge("dtx_generate_page_occupancy", "KV cache page occupancy "
              "fraction", [(None, serving.get("page_occupancy_frac"))])
        gauge("dtx_generate_decode_ticks_total", "decode engine ticks "
              "executed", [(None, serving.get("decode_ticks_total"))])
        # fail-open serving: typed terminals + admission
        # control + supervision counters
        gauge("dtx_generate_shed_total", "requests refused by the "
              "bounded queue (typed 503)",
              [(None, serving.get("shed_total"))])
        gauge("dtx_generate_timeout_total", "requests retired by "
              "deadline expiry or client cancel (typed timeout)",
              [(None, serving.get("timeout_total"))])
        gauge("dtx_generate_failed_total", "requests failed after the "
              "supervised retry budget (typed failed)",
              [(None, serving.get("failed_total"))])
        gauge("dtx_generate_requeued_total", "requests re-queued by a "
              "supervised engine restart",
              [(None, serving.get("requeued_total"))])
        gauge("dtx_generate_engine_restarts_total", "supervised "
              "engine-loop restarts",
              [(None, serving.get("engine_restarts_total"))])
        gauge("dtx_generate_queue_peak", "peak pending-queue depth "
              "observed (bound: queue_limit, 0 = unbounded)",
              [(None, serving.get("queue_peak"))])
        gauge("dtx_generate_brownout_active", "1 while the brownout "
              "admission clamp is active",
              [(None, serving.get("brownout_active"))])
        gauge("dtx_generate_brownout_clamped_total", "admissions with "
              "a brownout-clamped token budget",
              [(None, serving.get("brownout_clamped_total"))])
    if slo:
        gauge("dtx_slo_requests", "terminal requests the SLO windows "
              "slide over", [(None, slo.get("requests"))])
        docs = slo.get("slos") or []
        gauge("dtx_slo_burn_rate", "error-budget burn rate per SLO "
              "and window (1.0 = burning exactly at budget)",
              [({"slo": d.get("name"), "window": label},
                (d.get("windows") or {}).get(label, {}).get("burn_rate"))
               for d in docs for label in ("fast", "slow")])
        gauge("dtx_slo_breach", "1 while the SLO burns past its "
              "threshold on BOTH windows",
              [({"slo": d.get("name")}, 1 if d.get("breach") else 0)
               for d in docs])
        gauge("dtx_slo_observed_p99_ms", "observed p99 of the SLO's "
              "metric over its slow window",
              [({"slo": d.get("name")}, d.get("observed_p99_ms"))
               for d in docs])
        gauge("dtx_slo_shed_rate", "shed fraction of terminal "
              "requests over the slow window (load-shedding "
              "pressure; deliberately not an SLO breach input)",
              [(None, (slo.get("shed") or {}).get("rate"))])
    if fleet:
        sources = fleet.get("sources") or []
        gauge("dtx_fleet_sources", "run dirs merged into the fleet "
              "timeline", [(None, len(sources))])
        gauge("dtx_fleet_rows", "rows on the merged fleet timeline",
              [(None, fleet.get("rows"))])
        gauge("dtx_fleet_requests", "request lifecycles reconstructed "
              "fleet-wide", [(None, fleet.get("requests"))])
        gauge("dtx_fleet_exactly_once", "1 while every fleet request "
              "has exactly one typed terminal",
              [(None, 1 if fleet.get("exactly_once") else 0)])
        gauge("dtx_fleet_restarts_total", "engine restarts on the "
              "merged timeline", [(None, fleet.get("restarts"))])
        gauge("dtx_fleet_source_skew_seconds", "clock-skew offset the "
              "collector aligned away per source",
              [({"source": s.get("source")}, s.get("skew_s"))
               for s in sources])
        fslo = fleet.get("slo") or {}
        if fslo:
            gauge("dtx_fleet_identity_holds", "1 while the federated "
                  "burn identity (fleet == request-weighted per-source "
                  "combination) holds exactly",
                  [(None, 1 if (fslo.get("identity") or {}).get("holds")
                    else 0)])
            fdocs = (fslo.get("fleet") or {}).get("slos") or []
            gauge("dtx_fleet_burn_rate", "fleet-wide error-budget burn "
                  "rate per SLO and window",
                  [({"slo": d.get("name"), "window": label},
                    (d.get("windows") or {}).get(label, {})
                    .get("burn_rate"))
                   for d in fdocs for label in ("fast", "slow")])
            gauge("dtx_fleet_source_burn_rate", "per-source slow-window "
                  "burn rate per SLO",
                  [({"source": src, "slo": d.get("name")},
                    (d.get("windows") or {}).get("slow", {})
                    .get("burn_rate"))
                   for src, ps in sorted(
                       (fslo.get("per_source") or {}).items())
                   for d in (ps.get("slos") or [])])
    if waterfall:
        segs = waterfall.get("segments") or {}
        gauge("dtx_waterfall_requests", "requests with a derived "
              "latency waterfall",
              [(None, waterfall.get("requests"))])
        gauge("dtx_waterfall_segment_p50_ms", "median per-request "
              "time in each waterfall segment",
              [({"segment": name}, st.get("p50_ms"))
               for name, st in sorted(segs.items())])
        gauge("dtx_waterfall_segment_p99_ms", "p99 per-request time "
              "in each waterfall segment",
              [({"segment": name}, st.get("p99_ms"))
               for name, st in sorted(segs.items())])
        gauge("dtx_waterfall_residual_frac_max", "largest |wall - "
              "segment sum| fraction across requests (the sum-to-wall "
              "honesty bound; ~0 by construction)",
              [(None, waterfall.get("max_residual_frac"))])
    if router:
        # fleet router (serving/router.Router.stats())
        per_replica = router.get("per_replica") or []
        gauge("dtx_router_replicas", "replicas behind the fleet "
              "router", [(None, router.get("replicas"))])
        gauge("dtx_router_replicas_healthy", "replicas whose circuit "
              "breaker is closed",
              [(None, router.get("replicas_healthy"))])
        gauge("dtx_router_draining", "1 while the router is draining "
              "(SIGTERM: no new admissions)",
              [(None, router.get("draining"))])
        gauge("dtx_router_requests_total", "requests the router "
              "accepted and placed",
              [(None, router.get("requests_total"))])
        gauge("dtx_router_completed_total", "requests that reached a "
              "clean result through the router",
              [(None, router.get("completed_total"))])
        gauge("dtx_router_failovers_total", "cross-engine failover "
              "hops (a request re-submitted to another replica)",
              [(None, router.get("failovers_total"))])
        gauge("dtx_router_fleet_failed_total", "requests failed after "
              "the fleet-level retry budget (typed failed fleet-wide)",
              [(None, router.get("fleet_failed_total"))])
        gauge("dtx_router_shed_total", "requests the router refused "
              "(draining, every replica shed, or breakers open)",
              [(None, router.get("shed_total"))])
        gauge("dtx_router_drain_cancelled_total", "queued requests "
              "typed-cancelled by a drain",
              [(None, router.get("drain_cancelled_total"))])
        gauge("dtx_router_replica_health", "per-replica health score "
              "in [0, 1] (serving/health.health_score)",
              [({"replica": r.get("name")}, r.get("health"))
               for r in per_replica])
        gauge("dtx_router_replica_load", "per-replica queued + "
              "in-flight load at the last probe",
              [({"replica": r.get("name")}, r.get("load"))
               for r in per_replica])
        gauge("dtx_router_breaker_open", "1 while the replica's "
              "circuit breaker is not closed (open or half-open)",
              [({"replica": r.get("name")},
                0 if (r.get("breaker") or {}).get("state") == "closed"
                else 1) for r in per_replica])
        gauge("dtx_router_breaker_trips_total", "lifetime circuit-"
              "breaker trips per replica",
              [({"replica": r.get("name")},
                (r.get("breaker") or {}).get("trips"))
               for r in per_replica])
    return "\n".join(out) + "\n"


# the /generate handler's ceiling wait; a request carrying its own
# deadline waits only deadline + grace (the engine retires it with a
# typed timeout terminal AT the deadline — the 504 is engine-truth,
# not just the client giving up).  A handler-side expiry with no
# engine deadline cancels the request so engine-side state frees.
GENERATE_TIMEOUT_S = 600.0
GENERATE_DEADLINE_GRACE_S = 5.0


class StatusServer:
    """Threaded HTTP status server over a ``logs_path``. ``start()``
    binds and serves from a daemon thread (port 0 = ephemeral;
    ``.port`` is the bound port); ``close()`` shuts down cleanly.
    Never raises out of start(): a taken port logs a NOTE and returns
    None (the server must not kill the run it reports on).

    ``engine``: a serving/engine.DecodeEngine (or any object with
    ``submit``/``result``/``stats``) — enables ``POST /generate`` and
    the ``dtx_generate_*`` gauges (the dtx-serve front door).

    ``slos``: obs/slo.SLOSpec list evaluated by ``/slo`` and the
    ``dtx_slo_*`` gauges (None = obs/slo.DEFAULT_SLOS)."""

    def __init__(self, logs_path: str, engine=None, slos=None,
                 cache_ttl_s: Optional[float] = None):
        self.logs_path = logs_path
        self.engine = engine
        self.slos = slos
        self.port: Optional[int] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        ttl = (REPORT_CACHE_TTL_S if cache_ttl_s is None
               else float(cache_ttl_s))
        # /report cache keyed by the input files' stat signature: the
        # aggregate is recomputed only when the run wrote something
        # new, so a dashboard poller cannot stall the chief.  A short
        # TTL rides along because the report carries WALL-CLOCK-derived
        # fields (heartbeat_age_s): a HUNG run stops touching its
        # files, and a signature-only cache would pin the ages at
        # their last fresh-looking values forever — the exact stall
        # signal the field exists to expose.
        self._report_cache = TTLCache(ttl)
        # /fleet and /explain caches: the collector re-reads every
        # span stream end to end (rotated segments included) and the
        # waterfall derivation walks every request's boundaries, so a
        # scrape must not recompute an unchanged fleet.  TTL-only —
        # neither has wall-clock fields, and a stat signature across
        # N run dirs would cost nearly as much as the work it guards.
        self._fleet_cache = TTLCache(ttl)
        self._explain_cache = TTLCache(ttl)

    def _report_signature(self) -> tuple:
        """(path, mtime_ns, size) for every file /report reads —
        metrics streams, heartbeats, flight dumps and the restart
        timeline.  Size rides along so an append inside one mtime
        granule still misses."""
        import glob as glob_lib

        sig = []
        for pattern in ("metrics.*.jsonl", "heartbeat.*",
                        "restarts.jsonl",
                        os.path.join("flight", "*.json")):
            for path in glob_lib.glob(os.path.join(self.logs_path,
                                                   pattern)):
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                sig.append((path, st.st_mtime_ns, st.st_size))
        return tuple(sorted(sig))

    def report_json(self) -> bytes:
        """The /report payload, recomputed when the signature of the
        underlying files changed OR the cached copy aged past the
        cache TTL (heartbeat ages must keep growing for a hung
        run)."""
        from . import aggregate as agg_lib

        return self._report_cache.get(
            lambda: json.dumps(agg_lib.aggregate(self.logs_path))
            .encode(),
            sig=self._report_signature())

    def _span_rows(self):
        """The /slo and /trace data source.  With a live engine whose
        recorder is attached (dtx-serve --trace_spans) this is the
        recorder's in-memory ring — no file re-read per request;
        offline it is the bounded span-stream tails across processes,
        time-ordered (same O(tail) discipline as /status)."""
        rec = getattr(self.engine, "recorder", None) \
            if self.engine is not None else None
        if rec is not None:
            return rec.snapshot()
        from .spans import span_files

        rows = []
        for _pid, path in span_files(self.logs_path):
            rows.extend(r for r in tail_rows(path)
                        if r.get("kind") == "span")
        rows.sort(key=lambda r: (r.get("t") or 0.0))
        return rows

    def slo_doc(self, rows=None) -> Dict[str, Any]:
        from . import slo as slo_lib

        if rows is None:
            rows = self._span_rows()
        return slo_lib.evaluate(slo_lib.records_from_spans(rows),
                                specs=self.slos)

    def fleet_doc(self) -> Optional[Dict[str, Any]]:
        """The /fleet payload: obs/collector.fleet_report over this
        server's ``logs_path`` (a run dir is a one-source fleet; a
        parent of run dirs federates its children).  None when no
        span/metrics streams exist underneath.  TTL-cached."""
        from . import collector as col_lib

        def compute() -> Optional[Dict[str, Any]]:
            if col_lib.discover_sources([self.logs_path]):
                return col_lib.fleet_report([self.logs_path],
                                            specs=self.slos)
            return None

        return self._fleet_cache.get(compute)

    def explain_docs(self) -> List[Dict[str, Any]]:
        """The /explain data: every reconstructible per-request
        waterfall over the current span rows (engine ring when live,
        span tails offline).  TTL-cached unfiltered; the rid/trace
        query filters are applied per request — filtering is cheap,
        the derivation is not."""
        from . import waterfall as wf_lib

        return self._explain_cache.get(
            lambda: wf_lib.waterfalls(self._span_rows()))

    def get_doc(self, path: str, query: str = ""):
        """``(status code, body bytes, content type)`` of a GET on
        ``path`` (trailing slash stripped) with the query string
        ``query``: the JAX status server's payloads, codes and error
        bodies, plus ``/healthz``.  Raises on a bad read (the handler
        answers 500 with the error)."""
        from urllib.parse import parse_qs

        engine = self.engine

        def doc(code: int, obj) -> tuple:
            return code, json.dumps(obj).encode(), "application/json"

        if path in ("/", "/status"):
            out = collect_status(self.logs_path)
            if engine is not None:
                out["serving"] = engine.stats()
            return doc(200, out)
        if path == "/healthz":
            return doc(200, {"ok": True, "serving": (
                engine.stats() if engine is not None else None)})
        if path == "/metrics":
            from . import waterfall as wf_lib

            spans = self._span_rows()
            falls = self.explain_docs()
            text = prometheus_text(
                collect_status(self.logs_path),
                serving=engine.stats() if engine is not None else None,
                slo=self.slo_doc(spans) if spans else None,
                fleet=self.fleet_doc(),
                waterfall=wf_lib.summarize(falls) if falls else None)
            return 200, text.encode(), "text/plain; version=0.0.4"
        if path == "/report":
            return 200, self.report_json(), "application/json"
        if path == "/slo":
            return doc(200, self.slo_doc())
        if path == "/trace":
            from .spans import trace_record

            rid = (parse_qs(query).get("rid") or [None])[0]
            try:
                rid = int(rid)
            except (TypeError, ValueError):
                return doc(400, {"error": "/trace needs ?rid=N (an "
                                          "integer request id)"})
            rec = trace_record(self._span_rows(), rid)
            if rec is None:
                return doc(404, {"error": f"rid {rid} not in the span "
                                          f"stream tails"})
            return doc(200, rec)
        if path == "/fleet":
            rep = self.fleet_doc()
            if rep is None:
                return doc(404, {"error": "no span/metrics streams "
                                          "under this logs_path"})
            return doc(200, rep)
        if path == "/explain":
            from . import waterfall as wf_lib

            q = parse_qs(query)
            docs = self.explain_docs()
            rid_q = (q.get("rid") or [None])[0]
            if rid_q is not None:
                try:
                    rid_q = int(rid_q)
                except ValueError:
                    return doc(400, {"error": "?rid=N must be an "
                                              "integer"})
                docs = [d for d in docs if d["rid"] == rid_q]
            trace_q = (q.get("trace") or [None])[0]
            if trace_q is not None:
                docs = [d for d in docs if d.get("trace_id") == trace_q]
            return doc(200, {"summary": wf_lib.summarize(docs),
                             "waterfalls": docs})
        return doc(404, {
            "error": f"unknown path {path!r}",
            "endpoints": ["/status", "/metrics", "/report", "/slo",
                          "/trace", "/fleet", "/explain"]
            + (["/generate"] if engine is not None else [])
            + ["/healthz"]})

    def start(self, port: int, host: str = "") -> Optional[int]:
        engine = self.engine
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # stdout belongs to the run
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json",
                      headers: Optional[Dict[str, str]] = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                path = path.rstrip("/") or "/"
                try:
                    code, body, ctype = server.get_doc(path, query)
                except Exception as e:  # a bad read must not kill serving
                    code, body, ctype = 500, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode(), \
                        "application/json"
                self._send(code, body, ctype)

            def do_POST(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path != "/generate":
                    self._send(404, json.dumps(
                        {"error": f"unknown POST path {path!r}"}).encode())
                    return
                if engine is None:
                    self._send(503, json.dumps(
                        {"error": "no decode engine attached (start "
                                  "via dtx-serve)"}).encode())
                    return
                from ..serving.admission import ShedError

                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    req = json.loads(self.rfile.read(n) or b"{}")
                    prompt = req.get("prompt")
                    if not isinstance(prompt, list):
                        raise ValueError(
                            "'prompt' must be a list of token ids")
                    deadline_ms = req.get("deadline_ms")
                    if deadline_ms is not None:
                        deadline_ms = float(deadline_ms)
                        if deadline_ms < 0:
                            raise ValueError("'deadline_ms' must be "
                                             ">= 0")
                    # W3C trace context: a malformed header degrades
                    # to a fresh trace inside submit, never a 400
                    traceparent = self.headers.get("traceparent")
                    rid = engine.submit(
                        prompt,
                        int(req.get("max_new_tokens", 16)),
                        temperature=float(req.get("temperature", 0.0)),
                        deadline_ms=deadline_ms,
                        traceparent=traceparent)
                except ShedError as e:
                    # typed load shedding: the bounded queue is full —
                    # overloaded, not broken; Retry-After tells the
                    # client when one queue slot should have drained
                    # (integer-seconds CEIL via the one shared helper
                    # — rounding DOWN invited the retry back early)
                    from ..serving.admission import retry_after_header

                    self.send_response(503)
                    body = json.dumps(
                        {"error": str(e), "status": "shed",
                         "retry_after_s": e.retry_after_s}).encode()
                    self.send_header(
                        "Retry-After",
                        str(retry_after_header(e.retry_after_s)))
                    self.send_header("Content-Type",
                                     "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                except (ValueError, TypeError, KeyError) as e:
                    self._send(400, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode())
                    return
                except RuntimeError as e:
                    # the engine loop died (submit refuses after a
                    # failure): the server is up, generation is not
                    self._send(503, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode())
                    return
                # the response traceparent: the request's trace id
                # (propagated or freshly minted by submit) with a new
                # span id naming the serving edge — read BEFORE the
                # wait, while the engine still holds the rid's context
                resp_headers: Optional[Dict[str, str]] = None
                ctx_of = getattr(engine, "trace_context", None)
                ctx = ctx_of(rid) if ctx_of is not None else None
                if ctx is not None:
                    from .spans import format_traceparent, new_span_id

                    resp_headers = {"traceparent": format_traceparent(
                        ctx[0], new_span_id())}
                # the handler wait honors the REQUEST's deadline (its
                # own field, or the engine default): the engine
                # retires it at the deadline with a typed timeout
                # terminal, so the wait only needs a grace window on
                # top — never the full 600s ceiling against a request
                # that contracted to finish in two seconds
                if deadline_ms is None:
                    deadline_ms = float(getattr(engine, "deadline_ms",
                                                0.0) or 0.0)
                wait_s = GENERATE_TIMEOUT_S
                if deadline_ms and deadline_ms > 0:
                    wait_s = min(wait_s, deadline_ms / 1e3
                                 + GENERATE_DEADLINE_GRACE_S)
                try:
                    res = engine.result(rid, timeout=wait_s)
                    if res is None:
                        # handler-side expiry with no engine-side
                        # terminal yet: cancel so engine state frees
                        # (pages, queue slot) instead of decoding for
                        # a client that already got its 504
                        cancel = getattr(engine, "cancel", None)
                        if cancel is not None:
                            cancel(rid)
                        self._send(504, json.dumps(
                            {"error": "generation timed out",
                             "status": "timeout",
                             "rid": rid}).encode(),
                            headers=resp_headers)
                        return
                    if res.get("status") == "timeout":
                        # the engine's typed deadline/cancel terminal
                        self._send(504, json.dumps(res).encode(),
                                   headers=resp_headers)
                        return
                    if "error" in res:
                        # typed "failed" (retry budget spent) or the
                        # engine loop died while THIS request was in
                        # flight
                        self._send(500, json.dumps(res).encode(),
                                   headers=resp_headers)
                        return
                    self._send(200, json.dumps(res).encode(),
                               headers=resp_headers)
                except Exception as e:
                    self._send(500, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode())

        try:
            self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        except OSError as e:
            print(f"NOTE: status server failed to bind port {port}: {e}",
                  file=sys.stderr)
            return None
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dtx-status",
            daemon=True)
        self._thread.start()
        return self.port

    def close(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

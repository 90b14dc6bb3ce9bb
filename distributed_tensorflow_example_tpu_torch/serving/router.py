"""Fleet router: health-checked placement and cross-engine failover —
the port's copy of the JAX package's ``serving/router.py``.

N replicas behind one door, where a dead or sick replica costs retries,
never answers:

- **placement** is least-loaded over health: each submit ranks the
  replicas by ``(load + 1) / health_score`` (``serving/health.py``) and
  dispatches to the best one whose circuit breaker admits it;
- **circuit breakers** (``serving/health.CircuitBreaker``, one per
  replica, seeded ``seed + index``): placement peeks with the
  non-consuming ``would_allow``; only the dispatch consumes the
  half-open probe, and a dispatch the replica sheds hands it back;
- **failover**: a request whose replica fails it (``--engine_retries``
  budget spent, or the engine refusing as dead) is re-submitted to
  another replica with the same trace id and the accumulated
  ``attempts`` count (``engine.submit(attempts=)`` seeds the new
  engine's retry ledger), bounded by ``fleet_retries`` hops.  Every
  accepted request ends in exactly one typed terminal fleet-wide: each
  hop's lifecycle closes in its replica's span stream (intermediate
  hops as ``failed``), and ``obs/collector.py`` joins the hops by trace
  id into one verdict;
- **narration**: with a recorder the router appends ``route`` /
  ``failover`` spans (fleet rid, replica name, attempt, trace id) to its
  own stream.

``RouterServer`` is the stdlib HTTP front door: ``POST /generate``
proxied across the in-process replicas (503 + Retry-After when every
replica sheds or the router drains), ``/status`` with a per-replica
section, ``/metrics`` with the ``dtx_router_*`` gauges, and SIGTERM
draining (stop admitting, finish in-flight, typed-cancel the queued).

Pure Python like the scheduler: no torch in this module.  The replicas
share the card when they are engines on it, each with its own thread.
"""

from __future__ import annotations

import json
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set

from ..obs import spans as spans_lib
from .admission import ShedError, retry_after_header
from .health import BreakerPolicy, CircuitBreaker, HealthMonitor

# the Retry-After hint a router-level refusal carries when no replica
# offered one (all breakers open): at least this, or the earliest
# breaker re-probe, whichever is later
ROUTER_RETRY_AFTER_S = 1.0
# health-score floor in the placement ratio: a zero score must rank
# the replica last, not divide by zero
_SCORE_EPS = 1e-6


class _Replica:
    """One replica's routing state: the engine handle plus its health
    monitor, circuit breaker and dispatch accounting."""

    __slots__ = ("index", "name", "engine", "monitor", "breaker",
                 "dispatched", "load")

    def __init__(self, index: int, engine, policy: BreakerPolicy,
                 clock) -> None:
        self.index = index
        self.name = f"replica{index}"
        self.engine = engine
        self.monitor = HealthMonitor(clock=clock)
        # each replica's breaker draws its own jitter stream: same
        # policy, seed offset by the index (de-synchronized re-probes
        # in production, still fully deterministic in tests)
        self.breaker = CircuitBreaker(
            BreakerPolicy(**{**_policy_kw(policy),
                             "seed": policy.seed + index}),
            clock=clock)
        self.dispatched = 0
        self.load = 0


def _policy_kw(p: BreakerPolicy) -> Dict[str, Any]:
    return {"failures": p.failures, "base_s": p.base_s,
            "cap_s": p.cap_s, "jitter": p.jitter,
            "health_floor": p.health_floor, "seed": p.seed}


class _FleetRequest:
    """The router's ledger entry for one accepted request: where it
    currently lives, everything needed to re-submit it, and the
    failover accounting."""

    __slots__ = ("rid", "replica_index", "replica_rid", "trace_id",
                 "parent_id", "prompt", "max_new_tokens",
                 "temperature", "deadline_abs", "deadline_ms",
                 "attempts", "hops", "drained", "done")

    def __init__(self, rid: int) -> None:
        self.rid = rid
        self.replica_index = -1
        self.replica_rid = -1
        self.trace_id: Optional[str] = None
        self.parent_id: Optional[str] = None
        self.prompt: List[int] = []
        self.max_new_tokens = 0
        self.temperature = 0.0
        self.deadline_abs: Optional[float] = None
        self.deadline_ms: Optional[float] = None
        self.attempts = 0
        self.hops = 0
        self.drained = False
        self.done = False


class Router:
    """Health-checked least-loaded routing over N in-process replicas
    with circuit breakers and bounded cross-engine failover.

    ``replicas``: engine-like objects (serving/engine.DecodeEngine or
    any object with ``submit`` / ``result`` / ``cancel`` / ``stats``;
    ``waiting_rids`` and ``fast_burn`` are consumed when present).
    ``fleet_retries`` bounds the FAILOVER hops per request (on top of
    each engine's own ``engine_retries`` budget); ``breaker`` is the
    per-replica BreakerPolicy (each replica's breaker gets
    ``seed + index``).  ``recorder``: an obs/spans.SpanRecorder for
    the router's own route/failover narration stream.  The clock is
    injectable (tests drive the breakers without sleeping)."""

    def __init__(self, replicas: Sequence[Any], fleet_retries: int = 2,
                 breaker: Optional[BreakerPolicy] = None,
                 recorder=None, clock=time.monotonic):
        if not replicas:
            raise ValueError("Router needs at least one replica")
        if fleet_retries < 0:
            raise ValueError(
                f"fleet_retries={fleet_retries} must be >= 0")
        policy = breaker or BreakerPolicy()
        self.fleet_retries = int(fleet_retries)
        self.recorder = recorder
        self._clock = clock
        self._replicas = [_Replica(i, e, policy, clock)
                          for i, e in enumerate(replicas)]
        self._lock = threading.Lock()
        self._requests: Dict[int, _FleetRequest] = {}
        self._by_replica: Dict[tuple, int] = {}
        self._next_rid = 0
        self._draining = False
        # fleet accounting (stats()/dtx_router_* surface)
        self._accepted = 0
        self._completed = 0
        self._failovers = 0
        self._exhausted = 0
        self._shed = 0
        self._drain_cancelled = 0

    # ---- placement ----
    def _probe(self, r: _Replica) -> None:
        """Refresh one replica's health from its live stats (and its
        fast-window burn when the engine exposes one); a health
        collapse trips the breaker here, before placement ranks."""
        try:
            stats = r.engine.stats()
        except Exception:  # noqa: BLE001 — a dead stats() is sick, not fatal
            r.breaker.note_health(0.0, now=self._clock())
            return
        burn_of = getattr(r.engine, "fast_burn", None)
        burn = burn_of() if callable(burn_of) else None
        score = r.monitor.update(stats, burn_rate=burn,
                                 now=self._clock())
        r.load = int(stats.get("queued") or 0) \
            + int(stats.get("inflight") or 0)
        r.breaker.note_health(score, now=self._clock())

    def _placement(self,
                   exclude: Optional[Set[int]] = None) -> List[_Replica]:
        """Candidate replicas in dispatch order: breaker-admittable
        (non-consuming peek), ranked least-loaded-per-health —
        ``(load + 1) / score`` ascending, index as the deterministic
        tie-break."""
        now = self._clock()
        ranked = []
        for r in self._replicas:
            if exclude and r.index in exclude:
                continue
            self._probe(r)
            if not r.breaker.would_allow(now=now):
                continue
            score = max(r.monitor.score, _SCORE_EPS)
            ranked.append(((r.load + 1) / score, r.index, r))
        return [r for _, _, r in sorted(ranked, key=lambda t: t[:2])]

    def _dispatch(self, req: _FleetRequest, order: List[_Replica],
                  first: bool) -> Optional[_Replica]:
        """Try each candidate in order; returns the replica that
        accepted (ledger updated, narration emitted) or None.  Shed
        hints are folded into ``req``-independent state by the
        caller via the raised ShedError on the first hop."""
        hints: List[float] = []
        for r in order:
            if not r.breaker.allow(now=self._clock()):
                continue
            header = spans_lib.format_traceparent(
                req.trace_id, req.parent_id or spans_lib.new_span_id())
            kw: Dict[str, Any] = {"temperature": req.temperature,
                                  "deadline_ms": self._remaining_ms(req),
                                  "traceparent": header}
            if req.attempts:
                # the attempts accounting carries ACROSS engines: the new
                # replica's retry ledger starts where the old stopped
                kw["attempts"] = req.attempts
            try:
                rrid = r.engine.submit(list(req.prompt),
                                       req.max_new_tokens, **kw)
            except ShedError as e:
                hints.append(float(e.retry_after_s))
                r.breaker.abort_probe()   # nothing was probed
                continue
            except RuntimeError as e:
                # the engine refused as dead — a typed failure for
                # the breaker, and placement moves on
                r.breaker.record_failure(f"submit refused: {e}",
                                         now=self._clock())
                continue
            with self._lock:
                req.replica_index = r.index
                req.replica_rid = int(rrid)
                self._by_replica[(r.index, int(rrid))] = req.rid
                r.dispatched += 1
            if self.recorder is not None:
                event = "route" if first else "failover"
                extra: Dict[str, Any] = {}
                if req.trace_id:
                    extra["trace_id"] = req.trace_id
                if not first:
                    extra["reason"] = "replica failed"
                self.recorder.emit(event, rid=req.rid, replica=r.name,
                                   attempt=req.attempts, **extra)
            return r
        if hints:
            raise ShedError(
                "every admittable replica shed (queues full)",
                retry_after_s=min(hints))
        return None

    def _remaining_ms(self, req: _FleetRequest) -> Optional[float]:
        """The deadline a (re-)submit carries: the ORIGINAL absolute
        deadline re-expressed as remaining milliseconds — a failover
        must not restart the client's clock.  Floored at 1ms so a
        past-deadline re-submit is accepted and immediately retired
        with the typed timeout terminal (the lifecycle closes in a
        replica stream either way)."""
        if req.deadline_abs is None:
            return req.deadline_ms
        return max(1.0, (req.deadline_abs - self._clock()) * 1e3)

    def _breaker_wait_s(self) -> float:
        """Retry-After when every breaker refused: the earliest
        re-probe across replicas, floored at ROUTER_RETRY_AFTER_S."""
        now = self._clock()
        waits = [r.breaker._retry_at - now for r in self._replicas
                 if r.breaker._retry_at is not None]
        wait = min((w for w in waits if w > 0), default=0.0)
        return round(max(ROUTER_RETRY_AFTER_S, wait), 3)

    # ---- request surface ----
    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0,
               deadline_ms: Optional[float] = None,
               traceparent: Optional[str] = None) -> int:
        """Place one request on the best admittable replica; returns
        the FLEET rid (the router's own namespace — replica rids are
        internal).  Raises ShedError when draining, when every
        admittable replica shed, or when every breaker is open
        (Retry-After = the earliest re-probe)."""
        with self._lock:
            if self._draining:
                self._shed += 1
                raise ShedError("router draining",
                                retry_after_s=ROUTER_RETRY_AFTER_S)
            rid = self._next_rid
            self._next_rid += 1
        ctx = spans_lib.parse_traceparent(traceparent)
        req = _FleetRequest(rid)
        req.trace_id, req.parent_id = ctx if ctx is not None else (
            spans_lib.new_trace_id(), None)
        req.prompt = [int(t) for t in prompt]
        req.max_new_tokens = int(max_new_tokens)
        req.temperature = float(temperature)
        req.deadline_ms = deadline_ms
        if deadline_ms is not None and float(deadline_ms) > 0:
            req.deadline_abs = self._clock() + float(deadline_ms) / 1e3
        try:
            placed = self._dispatch(req, self._placement(), first=True)
        except ShedError:
            with self._lock:
                self._shed += 1
            raise
        if placed is None:
            with self._lock:
                self._shed += 1
            raise ShedError("no admittable replica (circuit breakers "
                            "open)", retry_after_s=self._breaker_wait_s())
        with self._lock:
            self._requests[rid] = req
            self._accepted += 1
        return rid

    def trace_context(self, rid: int) -> Optional[tuple]:
        """``(trace_id, parent_id)`` for an accepted fleet rid — the
        serving edge stamps the response traceparent from this (the
        DecodeEngine surface, fleet-scoped)."""
        with self._lock:
            req = self._requests.get(int(rid))
        return (req.trace_id, req.parent_id) if req is not None else None

    def cancel(self, rid: int) -> bool:
        """Client-side cancellation, routed to the request's current
        replica (typed timeout terminal with reason "cancel" there)."""
        with self._lock:
            req = self._requests.get(int(rid))
        if req is None or req.done:
            return False
        r = self._replicas[req.replica_index]
        return bool(r.engine.cancel(req.replica_rid))

    def result(self, rid: int, timeout: Optional[float] = None):
        """Block until the fleet terminal: the replica result with
        ``rid`` rewritten to the fleet rid (plus ``failovers`` when
        hops happened).  A typed ``failed`` from the current replica
        triggers failover while the ``fleet_retries`` hop budget
        lasts; a drain-cancelled queued request comes back as status
        "shed" with a ``retry_after_s`` (the replica stream holds its
        typed timeout/cancel terminal; the CLIENT contract is "try
        again elsewhere", not "you timed out").  None = ``timeout``
        elapsed with the request still in flight."""
        deadline = None if timeout is None \
            else self._clock() + float(timeout)
        with self._lock:
            req = self._requests[int(rid)]
        while True:
            r = self._replicas[req.replica_index]
            remaining = None if deadline is None \
                else max(0.0, deadline - self._clock())
            res = r.engine.result(req.replica_rid, timeout=remaining)
            if res is None:
                return None
            status = res.get("status")
            if status == "result":
                r.breaker.record_success()
                with self._lock:
                    self._completed += 1
                    req.done = True
                return self._rewrite(res, req)
            if status == "timeout":
                if req.drained:
                    with self._lock:
                        self._drain_cancelled += 1
                        req.done = True
                    out = {"rid": req.rid, "status": "shed",
                           "error": "router draining: cancelled "
                                    "before completion",
                           "retry_after_s": ROUTER_RETRY_AFTER_S}
                    if req.trace_id:
                        out["trace_id"] = req.trace_id
                    return out
                # a deadline/cancel terminal is the CLIENT's contract
                # playing out, not the replica's fault: no breaker
                # penalty, no failover
                with self._lock:
                    req.done = True
                return self._rewrite(res, req)
            # typed "failed" (or the engine died mid-request): the
            # failover path
            reason = str(res.get("error") or "typed failed terminal")
            r.breaker.record_failure(reason, now=self._clock())
            req.attempts = int(res.get("attempts")
                               or req.attempts + 1)
            if req.hops >= self.fleet_retries or self._draining:
                with self._lock:
                    self._exhausted += 1
                    req.done = True
                out = self._rewrite(res, req)
                out["attempts"] = req.attempts
                out["error"] = (f"{reason} (fleet retry budget spent: "
                                f"{req.hops} failovers, fleet_retries="
                                f"{self.fleet_retries})")
                return out
            try:
                placed = self._dispatch(
                    self._mark_hop(req),
                    self._placement(exclude={req.replica_index}
                                    if len(self._replicas) > 1
                                    else None),
                    first=False)
            except ShedError:
                # every failover candidate shed: same terminal as "no
                # admittable replica" — the request already HAS its
                # typed failed terminal in the old replica's stream
                placed = None
            if placed is None:
                with self._lock:
                    self._exhausted += 1
                    req.hops -= 1
                    self._failovers -= 1
                    req.done = True
                out = self._rewrite(res, req)
                out["attempts"] = req.attempts
                out["error"] = (f"{reason} (no admittable replica for "
                                f"failover)")
                return out

    def _mark_hop(self, req: _FleetRequest) -> _FleetRequest:
        with self._lock:
            req.hops += 1
            self._failovers += 1
        return req

    def _rewrite(self, res: Dict[str, Any],
                 req: _FleetRequest) -> Dict[str, Any]:
        out = dict(res)
        out["rid"] = req.rid
        if req.hops:
            out["failovers"] = req.hops
        return out

    # ---- drain ----
    def drain(self) -> int:
        """SIGTERM semantics: stop admitting (new submits shed),
        typed-cancel every router-owned request still WAITING on its
        replica (its stream closes with the typed timeout/cancel
        terminal; its client gets the shed remap), let in-flight
        decodes finish.  Returns the number of cancelled requests;
        idempotent."""
        with self._lock:
            if self._draining:
                return 0
            self._draining = True
            by_replica = dict(self._by_replica)
        cancelled = 0
        for r in self._replicas:
            waiting_of = getattr(r.engine, "waiting_rids", None)
            if not callable(waiting_of):
                continue
            for rrid in waiting_of():
                frid = by_replica.get((r.index, int(rrid)))
                if frid is None:
                    continue
                with self._lock:
                    req = self._requests.get(frid)
                    if req is None or req.done:
                        continue
                    req.drained = True
                if r.engine.cancel(int(rrid)):
                    cancelled += 1
        return cancelled

    @property
    def draining(self) -> bool:
        return self._draining

    # ---- observability ----
    def stats(self) -> Dict[str, Any]:
        """Point-in-time fleet counters + a per-replica section (the
        dtx_router_* gauges and the RouterServer /status read this)."""
        per_replica = []
        healthy = 0
        for r in self._replicas:
            self._probe(r)
            desc = r.breaker.describe()
            if desc["state"] == "closed":
                healthy += 1
            per_replica.append({
                "name": r.name,
                "health": r.monitor.score,
                "load": r.load,
                "dispatched": r.dispatched,
                "breaker": desc,
            })
        with self._lock:
            return {
                "replicas": len(self._replicas),
                "replicas_healthy": healthy,
                "draining": int(self._draining),
                "fleet_retries": self.fleet_retries,
                "requests_total": self._accepted,
                "completed_total": self._completed,
                "failovers_total": self._failovers,
                "fleet_failed_total": self._exhausted,
                "shed_total": self._shed,
                "drain_cancelled_total": self._drain_cancelled,
                "per_replica": per_replica,
            }


class RouterServer:
    """The fleet's stdlib HTTP front door (the obs/serve.StatusServer
    idiom): ``POST /generate`` proxied through the router (503 +
    integer-ceil Retry-After on shed — admission.retry_after_header —
    whether the hint came from a replica's bounded queue or the
    router's own drain/breaker refusals), ``GET /status`` with the
    per-replica health/breaker section, ``GET /metrics`` with the
    ``dtx_router_*`` gauges.  ``install_sigterm()`` arms the drain
    handler (main thread only — signal module rules)."""

    def __init__(self, router: Router):
        self.router = router
        self.port: Optional[int] = None
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self._prev_sigterm = None

    def install_sigterm(self) -> None:
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            self.router.drain()
            if callable(prev):
                prev(signum, frame)

        self._prev_sigterm = prev
        signal.signal(signal.SIGTERM, handler)

    def start(self, port: int, host: str = "") -> Optional[int]:
        from http.server import (
            BaseHTTPRequestHandler,
            ThreadingHTTPServer,
        )

        from ..obs.serve import (
            GENERATE_DEADLINE_GRACE_S,
            GENERATE_TIMEOUT_S,
            prometheus_text,
        )

        router = self.router

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # stdout belongs to the fleet
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

            def _shed(self, msg: str, retry_after_s: float,
                      headers: Optional[Dict[str, str]] = None) -> None:
                hdrs = dict(headers or {})
                hdrs["Retry-After"] = str(
                    retry_after_header(retry_after_s))
                self._send(503, json.dumps(
                    {"error": msg, "status": "shed",
                     "retry_after_s": retry_after_s}).encode(),
                    headers=hdrs)

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path in ("/", "/status"):
                        doc = {"live": not router.draining,
                               "router": router.stats()}
                        self._send(200, json.dumps(doc).encode())
                    elif path == "/metrics":
                        text = prometheus_text(
                            {"live": not router.draining},
                            router=router.stats())
                        self._send(200, text.encode(),
                                   "text/plain; version=0.0.4")
                    else:
                        self._send(404, json.dumps(
                            {"error": f"unknown path {path!r}",
                             "endpoints": ["/status", "/metrics",
                                           "/generate"]}).encode())
                except Exception as e:  # a bad read must not kill serving
                    self._send(500, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode())

            def do_POST(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path != "/generate":
                    self._send(404, json.dumps(
                        {"error": f"unknown POST path {path!r}"}
                    ).encode())
                    return
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
                    rid = router.submit(
                        prompt,
                        int(req.get("max_new_tokens", 16)),
                        temperature=float(req.get("temperature", 0.0)),
                        deadline_ms=deadline_ms,
                        traceparent=self.headers.get("traceparent"))
                except ShedError as e:
                    # a replica 503's Retry-After hint is HONORED: the
                    # router propagates the smallest replica hint (or
                    # its own drain/breaker wait) into the header
                    self._shed(str(e), e.retry_after_s)
                    return
                except (ValueError, TypeError, KeyError) as e:
                    self._send(400, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode())
                    return
                resp_headers: Optional[Dict[str, str]] = None
                ctx = router.trace_context(rid)
                if ctx is not None:
                    resp_headers = {
                        "traceparent": spans_lib.format_traceparent(
                            ctx[0], spans_lib.new_span_id())}
                wait_s = GENERATE_TIMEOUT_S
                if deadline_ms and deadline_ms > 0:
                    wait_s = min(wait_s, deadline_ms / 1e3
                                 + GENERATE_DEADLINE_GRACE_S)
                try:
                    res = router.result(rid, timeout=wait_s)
                    if res is None:
                        router.cancel(rid)
                        self._send(504, json.dumps(
                            {"error": "generation timed out",
                             "status": "timeout", "rid": rid}).encode(),
                            headers=resp_headers)
                        return
                    if res.get("status") == "shed":
                        # the drain remap: typed-shed, try elsewhere
                        self._shed(str(res.get("error")),
                                   float(res.get("retry_after_s")
                                         or ROUTER_RETRY_AFTER_S),
                                   headers=resp_headers)
                        return
                    if res.get("status") == "timeout":
                        self._send(504, json.dumps(res).encode(),
                                   headers=resp_headers)
                        return
                    if "error" in res:
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
            print(f"NOTE: router server failed to bind port {port}: {e}")
            return None
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dtx-router",
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
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None

"""The port's fleet layer (``serving/health``, ``serving/router``) against
the JAX package's, on the CPU.

- **Health and breakers**: ``health_score``, ``HealthMonitor``,
  ``parse_breaker`` (values and error messages), ``BreakerPolicy``'s
  checks and ``CircuitBreaker`` state sequences under one injected clock
  are equal in both packages.
- **The router over scripted replicas**: each package's ``Router`` over
  the same ``FakeReplica`` scripts (a copy of the JAX tests' fake, kept
  here) gives the same placements, failovers, shed hints, drain results
  and ``stats()`` documents (fresh trace ids mapped to their order of
  appearance); the narration rows are equal; ``RouterServer`` answers
  ``/status``, ``/metrics``, ``POST /generate``, the 503 ceil and the
  SIGTERM drain as JAX's does.
- **The router over real engines**: over one healthy port engine it is
  bitwise invisible; a three-engine port fleet under a crash plan is
  exactly-once under the port's ``fleet_report`` and, over the same span
  dirs, under JAX's, with equal ``exactly_once``, ``requests`` and
  ``failover`` sections; the CLI's ``--replicas 2`` fleet answers.
"""

import json
import os
import signal
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from distributed_tensorflow_example_tpu.models import transformer as jtfm
from distributed_tensorflow_example_tpu.obs import collector as jcollector
from distributed_tensorflow_example_tpu.obs import spans as jspans
from distributed_tensorflow_example_tpu.serving import admission as jadm
from distributed_tensorflow_example_tpu.serving import health as jhl
from distributed_tensorflow_example_tpu.serving import router as jrt
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_example_tpu_torch.obs import collector as tcollector
from distributed_tensorflow_example_tpu_torch.obs import schema as tschema
from distributed_tensorflow_example_tpu_torch.obs import spans as tspans
from distributed_tensorflow_example_tpu_torch.serving import admission as tadm
from distributed_tensorflow_example_tpu_torch.serving import cli as tcli
from distributed_tensorflow_example_tpu_torch.serving import health as thl
from distributed_tensorflow_example_tpu_torch.serving import router as trt
from distributed_tensorflow_example_tpu_torch.serving.engine import (
    DecodeEngine)
from distributed_tensorflow_example_tpu_torch.serving.faults import FaultPlan

# (router, admission, health, spans) of each package
JAX = (jrt, jadm, jhl, jspans)
PORT = (trt, tadm, thl, tspans)


# --- health and breakers ---------------------------------------------------


def test_health_score_matches_jax():
    for queued in (0, 3, 9):
        for limit in (0, 4):
            for fail, ok in ((0, 0), (2, 3), (5, 0)):
                for burn in (None, 0.5, 3.0):
                    for stale in (0.0, 4.0, 30.0):
                        kw = dict(queued=queued, queue_limit=limit,
                                  failure_delta=fail, ok_delta=ok,
                                  burn_rate=burn, staleness_s=stale)
                        assert thl.health_score(**kw) == \
                            jhl.health_score(**kw), kw


def test_health_monitor_sequence_matches_jax():
    snaps = [({"queued": 1, "queue_limit": 4, "completed_total": 2}, None),
             ({"queued": 3, "queue_limit": 4, "completed_total": 3,
               "failed_total": 2, "shed_total": 1}, 0.8),
             ({"queued": 0, "queue_limit": 4, "completed_total": 9,
               "failed_total": 2, "shed_total": 1,
               "engine_restarts_total": 1}, 2.5)]
    mons = (thl.HealthMonitor(clock=lambda: 0.0),
            jhl.HealthMonitor(clock=lambda: 0.0))
    for i, (stats, burn) in enumerate(snaps):
        got = [m.update(stats, burn_rate=burn, now=1.5 * i) for m in mons]
        assert got[0] == got[1]


@pytest.mark.parametrize("text", ["", "on", "failures=5,base=0.5,cap=10",
                                  "jitter=0,floor=0.4,seed=7",
                                  "failures=0", "base=0", "cap=0.1",
                                  "jitter=2", "floor=1", "bogus=1",
                                  "failures", "failures=x", " , ,"])
def test_parse_breaker_matches_jax(text):
    """Values of a good spec, or the same ValueError message."""
    out = []
    for hl in (thl, jhl):
        try:
            out.append(("ok", _policy(hl.parse_breaker(text))))
        except ValueError as e:
            out.append(("err", str(e)))
    assert out[0] == out[1]


def _policy(p):
    return (p.failures, p.base_s, p.cap_s, p.jitter, p.health_floor, p.seed)


def _breaker_trace(hl):
    """One script of allow / would_allow / failure / success / health
    notes / probe aborts over a manual clock; every step's return and
    the breaker's description after it."""
    t = [0.0]
    b = hl.CircuitBreaker(hl.BreakerPolicy(failures=2, base_s=0.5,
                                           cap_s=3.0, jitter=0.3, seed=4),
                          clock=lambda: t[0])
    out = []
    script = ["allow", "fail", "allow", "fail", "allow", "peek", "tick",
              "peek", "allow", "allow", "fail", "tick", "tick", "allow",
              "abort", "allow", "success", "health0.1", "tick", "tick",
              "tick", "allow", "fail", "tick", "tick", "tick", "tick",
              "allow", "success", "fail", "health0.9"]
    for op in script:
        if op == "allow":
            r = b.allow()
        elif op == "peek":
            r = b.would_allow()
        elif op == "fail":
            r = b.record_failure("x")
        elif op == "success":
            r = b.record_success()
        elif op == "abort":
            r = b.abort_probe()
        elif op == "tick":
            t[0] += 0.7
            r = None
        else:
            r = b.note_health(float(op[len("health"):]))
        out.append((op, r, b.describe()))
    return out


def test_circuit_breaker_sequence_matches_jax():
    assert _breaker_trace(thl) == _breaker_trace(jhl)


def test_breaker_policy_checks_match_jax():
    for bad in ({"failures": 0}, {"base_s": 0.0}, {"cap_s": 0.1},
                {"jitter": 1.5}, {"health_floor": 1.0}):
        msgs = []
        for hl in (thl, jhl):
            with pytest.raises(ValueError) as err:
                hl.BreakerPolicy(**bad)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# --- scripted replicas ------------------------------------------------------


class FakeReplica:
    """Engine-shaped scripted replica (a copy of the JAX router tests'
    fake): ``script`` outcomes are consumed per submit ("ok" | "failed" |
    "shed" | "dead" | "wait"); extra submits default to "ok".  "wait"
    parks the request until cancel() types it timeout (the drain path).
    ``adm`` is the admission module whose ShedError the replica raises
    (each package's router catches its own)."""

    def __init__(self, adm, script=(), queued=0, queue_limit=0,
                 shed_hint=2.5):
        self.adm = adm
        self.script = list(script)
        self.queued = queued
        self.queue_limit = queue_limit
        self.shed_hint = shed_hint
        self.next_rid = 0
        self.results = {}
        self.submits = []
        self.waiting = []
        self.completed_total = 0
        self.failed_total = 0
        self.shed_total = 0

    def submit(self, prompt, max_new_tokens, temperature=0.0,
               deadline_ms=None, traceparent=None, attempts=0):
        outcome = self.script.pop(0) if self.script else "ok"
        if outcome == "shed":
            self.shed_total += 1
            raise self.adm.ShedError("queue full",
                                     retry_after_s=self.shed_hint)
        if outcome == "dead":
            raise RuntimeError("engine stopped")
        rid = self.next_rid
        self.next_rid += 1
        self.submits.append({
            "rid": rid, "prompt": [int(x) for x in prompt],
            "max_new_tokens": int(max_new_tokens),
            "temperature": temperature, "deadline_ms": deadline_ms,
            "traceparent": traceparent, "attempts": attempts})
        if outcome == "failed":
            self.failed_total += 1
            self.results[rid] = {
                "rid": rid, "status": "failed", "error": "injected",
                "attempts": int(attempts) + 1}
        elif outcome == "wait":
            self.waiting.append(rid)
            self.results[rid] = None
        else:
            self.completed_total += 1
            self.results[rid] = {
                "rid": rid, "status": "result", "tokens": [1, 2],
                "latency_ms": 1.0, "ttft_ms": 1.0}
        return rid

    def result(self, rid, timeout=None):
        return self.results.get(rid)

    def cancel(self, rid):
        if rid in self.waiting:
            self.waiting.remove(rid)
            self.results[rid] = {
                "rid": rid, "status": "timeout",
                "error": "cancelled before completion (cancel)"}
            return True
        return False

    def waiting_rids(self):
        return list(self.waiting)

    def stats(self):
        return {"queued": self.queued + len(self.waiting),
                "inflight": 0, "queue_limit": self.queue_limit,
                "completed_total": self.completed_total,
                "shed_total": self.shed_total, "timeout_total": 0,
                "failed_total": self.failed_total,
                "engine_restarts_total": 0}


class _Ids:
    """Fresh trace ids mapped to their order of appearance, so two runs
    that mint different random ids compare equal."""

    def __init__(self):
        self.seen = {}

    def __call__(self, x):
        if isinstance(x, dict):
            return {k: self(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(self(v) for v in x)
        if isinstance(x, str) and x.startswith("00-"):
            # a traceparent: its trace id mapped, its span id (fresh
            # when the request carried no parent) masked
            version, trace, _span, flags = x.split("-")
            return f"{version}-{self(trace)}-span-{flags}"
        if isinstance(x, str) and len(x) == 32 and all(
                c in "0123456789abcdef" for c in x):
            return self.seen.setdefault(x, f"trace{len(self.seen)}")
        return x


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the type and text compare
        return (type(e).__name__, str(e),
                getattr(e, "retry_after_s", None))


def _run_scenario(pkg, name):
    """One scripted scenario through ``pkg``'s router; returns every
    observable: results, submits seen by the replicas, stats."""
    rt, adm, hl, _spans = pkg
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    out = []
    if name == "placement":
        reps = [FakeReplica(adm, queued=5), FakeReplica(adm)]
        r = rt.Router(reps, clock=clock)
        out.append(r.result(r.submit([1, 2, 3], 4), timeout=5.0))
        ties = [FakeReplica(adm), FakeReplica(adm)]
        r2 = rt.Router(ties, clock=clock)
        out.append(r2.result(r2.submit([1], 2), timeout=5.0))
        reps += ties
    elif name == "failover":
        reps = [FakeReplica(adm, script=["failed"]), FakeReplica(adm)]
        r = rt.Router(reps, fleet_retries=2, clock=clock)
        rid = r.submit([5, 6], 4, deadline_ms=5000.0)
        t[0] += 1.0
        out.append(r.result(rid, timeout=5.0))
        out.append(r.trace_context(rid))
    elif name == "budget":
        reps = [FakeReplica(adm, script=["failed"] * 5),
                FakeReplica(adm, script=["failed"] * 5)]
        r = rt.Router(reps, fleet_retries=1, clock=clock)
        out.append(r.result(r.submit([1], 2), timeout=5.0))
    elif name == "shed_hints":
        reps = [FakeReplica(adm, script=["shed"], shed_hint=3.0),
                FakeReplica(adm, script=["shed"], shed_hint=2.0)]
        r = rt.Router(reps, clock=clock)
        out.append(_outcome(lambda: r.submit([1], 2)))
        out.append(r.stats())
        more = [FakeReplica(adm, script=["shed"], shed_hint=3.0),
                FakeReplica(adm)]
        r = rt.Router(more, clock=clock)
        out.append(r.result(r.submit([1], 2), timeout=5.0))
        reps += more
    elif name == "open_breakers":
        reps = [FakeReplica(adm, script=["failed"] * 9)]
        r = rt.Router(reps, fleet_retries=0,
                      breaker=hl.BreakerPolicy(failures=1, jitter=0.0,
                                               base_s=4.0), clock=clock)
        out.append(r.result(r.submit([1], 2), timeout=5.0))
        out.append(_outcome(lambda: r.submit([1], 2)))
        t[0] += 4.0
        out.append(r.result(r.submit([1], 2), timeout=5.0))
    elif name == "dead_replica":
        reps = [FakeReplica(adm, script=["dead"]), FakeReplica(adm)]
        r = rt.Router(reps, clock=clock)
        out.append(r.result(r.submit([1], 2), timeout=5.0))
    elif name == "drain":
        reps = [FakeReplica(adm, script=["wait", "wait"]), FakeReplica(adm)]
        r = rt.Router(reps, clock=clock)
        rids = [r.submit([1, 2], 4), r.submit([3], 2)]
        out.append((r.drain(), r.drain(), r.draining))
        out.append(_outcome(lambda: r.submit([3], 2)))
        out.append([r.result(x, timeout=5.0) for x in rids])
    else:
        raise KeyError(name)
    out.append(r.stats())
    out.append([rep.submits for rep in reps])
    return _Ids()(out)


@pytest.mark.parametrize("name", ["placement", "failover", "budget",
                                  "shed_hints", "open_breakers",
                                  "dead_replica", "drain"])
def test_router_over_scripted_replicas_matches_jax(name):
    got = _run_scenario(PORT, name)
    assert got == _run_scenario(JAX, name)


def test_router_validation_matches_jax():
    for bad in (dict(replicas=[]), dict(fleet_retries=-1)):
        msgs = []
        for rt, adm in ((trt, tadm), (jrt, jadm)):
            kw = dict(bad)
            reps = kw.pop("replicas", [FakeReplica(adm)])
            with pytest.raises(ValueError) as err:
                rt.Router(reps, **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_router_narration_rows_match_jax(tmp_path):
    """route then failover, fleet rid, replica names, attempt, reason,
    one trace id; reconstruct() reads the stream as narration."""
    rows = []
    for (rt, adm, _hl, spans), tag in ((PORT, "torch"), (JAX, "jax")):
        rec = spans.SpanRecorder(str(tmp_path / tag))
        r = rt.Router([FakeReplica(adm, script=["failed"]),
                       FakeReplica(adm)], fleet_retries=2, recorder=rec)
        rid = r.submit([1, 2], 4)
        assert r.result(rid, timeout=5.0)["status"] == "result"
        rec.close()
        rows.append(_Ids()([{k: v for k, v in row.items() if k != "t"}
                            for row in spans.read_spans(rec.path)]))
    assert rows[0] == rows[1]
    assert [row["event"] for row in rows[0]] == ["route", "failover"]
    trows = tspans.read_spans(str(tmp_path / "torch" / "spans.0.jsonl"))
    rec0 = tspans.reconstruct(trows)[(0, 0)]
    assert rec0["narration"] is True and rec0["errors"] == []
    assert tschema.validate_span_file(
        str(tmp_path / "torch" / "spans.0.jsonl")) == []


# --- RouterServer -----------------------------------------------------------


def _post(port, doc, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _server_surface(pkg):
    rt, adm = pkg[:2]
    r = rt.Router([FakeReplica(adm, script=["failed"]), FakeReplica(adm)],
                  fleet_retries=2, clock=lambda: 0.0)
    srv = rt.RouterServer(r)
    port = srv.start(0)
    out = []
    try:
        tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        code, hdrs, doc = _post(port, {"prompt": [1, 2, 3],
                                       "max_new_tokens": 4},
                                headers={"traceparent": tp})
        out.append((code, doc, hdrs["traceparent"].split("-")[1]))
        code, body = _get(port, "/status")
        out.append((code, json.loads(body)))
        code, body = _get(port, "/metrics")
        out.append((code, body.decode()))
        out.append(_post(port, {"prompt": "nope"})[::2])
        out.append(_get(port, "/nope"))
    finally:
        srv.close()
    shed = rt.Router([FakeReplica(adm, script=["shed"], shed_hint=1.2)])
    srv = rt.RouterServer(shed)
    port = srv.start(0)
    try:
        code, hdrs, doc = _post(port, {"prompt": [1], "max_new_tokens": 2})
        out.append((code, hdrs["Retry-After"], doc))
    finally:
        srv.close()
    return out


def test_router_server_http_surface_matches_jax():
    """POST through a failover, /status, /metrics (the dtx_router_*
    text byte for byte), a 400, a 404 and a 503 with its ceil'd
    Retry-After: equal in both packages."""
    got, want = _server_surface(PORT), _server_surface(JAX)
    assert got == want
    text = got[2][1]
    for g in ("dtx_router_replicas 2", "dtx_router_failovers_total 1",
              'dtx_router_replica_health{replica="replica0"}',
              'dtx_router_breaker_open{replica="replica1"} 0'):
        assert g in text
    assert got[-1][:2] == (503, "2")


def test_router_server_sigterm_drains():
    """The handler runs in this (main) thread: draining, new POSTs shed
    503 with Retry-After 1, /status not live; close() restores the
    previous handler."""
    prev = signal.getsignal(signal.SIGTERM)
    r = trt.Router([FakeReplica(tadm)])
    srv = trt.RouterServer(r)
    srv.install_sigterm()
    port = srv.start(0)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert r.draining
        code, hdrs, doc = _post(port, {"prompt": [1], "max_new_tokens": 2})
        assert code == 503 and "draining" in doc["error"]
        assert hdrs["Retry-After"] == "1"
        assert json.loads(_get(port, "/status")[1])["live"] is False
    finally:
        srv.close()
    assert signal.getsignal(signal.SIGTERM) == prev


# --- real engines -----------------------------------------------------------

_BASE = dict(input_size=32, num_classes=10, seq_len=32, d_model=32,
             n_heads=2, num_blocks=2, d_ff=64, objective="lm",
             vocab_size=50, causal=True)


@pytest.fixture(scope="module")
def lm():
    jspec = jtfm.TransformerSpec(**_BASE)
    tspec = ttfm.TransformerSpec(**_BASE)
    jp = jtfm.init(jax.random.PRNGKey(0), jspec)
    return tspec, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, tspec, device="cpu")


def test_router_over_one_healthy_replica_is_bitwise_invisible(lm):
    """Requests submitted before the engine starts (so the tick
    composition, and with it the seeded sampling, is fixed): the
    router's tokens equal the bare engine's, greedy and sampled."""
    spec, params = lm
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 50, size=n).tolist() for n in (3, 7, 5)]
    temps = (0.0, 0.9, 0.0)

    def run(routed):
        eng = DecodeEngine(spec, params, page_size=4, max_batch=2, seed=5,
                           device="cpu")
        front = trt.Router([eng]) if routed else eng
        rids = [front.submit(p, 5, temperature=t)
                for p, t in zip(prompts, temps)]
        eng.start()
        out = [front.result(x, timeout=60.0)["tokens"] for x in rids]
        eng.stop()
        return out

    assert run(True) == run(False)


def _settle(engines, timeout=10.0):
    """Let each engine reach its final tick boundary before stop() (the
    retire span lands one boundary after the seal that unblocked
    result())."""
    import time

    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if all(not e.sched.live and not e.sched.waiting for e in engines):
            time.sleep(0.05)
            return
        time.sleep(0.02)


@pytest.fixture(scope="module")
def chaos(lm, tmp_path_factory):
    """Three port engines (one crashing at boundaries 1-4 under
    engine_retries=1), each with its recorder under replica<i>, behind
    the router with its own under router/; ten ragged requests."""
    spec, params = lm
    run_dir = str(tmp_path_factory.mktemp("fleet_chaos"))
    recs = [tspans.SpanRecorder(os.path.join(run_dir, f"replica{i}"))
            for i in range(3)]
    router_rec = tspans.SpanRecorder(os.path.join(run_dir, "router"))
    fleet = []
    for i in range(3):
        plan = FaultPlan(crash_at_ticks=(1, 2, 3, 4)) if i == 0 \
            else FaultPlan()
        fleet.append(DecodeEngine(spec, params, page_size=4, max_batch=2,
                                  seed=5, engine_retries=1, faults=plan,
                                  recorder=recs[i], device="cpu"))
        fleet[-1].start()
    router = trt.Router(fleet, fleet_retries=2, recorder=router_rec)
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, 50, size=int(rng.randint(3, 9))).tolist(),
             int(rng.randint(3, 7))) for _ in range(10)]
    rids = [router.submit(p, n) for p, n in reqs]
    results = [router.result(r, timeout=120.0) for r in rids]
    _settle(fleet)
    for e in fleet:
        e.stop()
    for rec in recs + [router_rec]:
        rec.close()
    dirs = [os.path.join(run_dir, d) for d in sorted(os.listdir(run_dir))]
    return router, rids, results, dirs


def test_fleet_chaos_is_exactly_once_under_both_collectors(chaos):
    """Every request ends in a typed terminal; at least one failed over
    and kept its trace id; the port's fleet report is exactly-once with
    clean failover chains, and JAX's fleet report over the same span
    dirs gives the same exactly_once, requests and failover sections."""
    router, rids, results, dirs = chaos
    assert all(r is not None and r["status"] in
               ("result", "timeout", "shed", "failed") for r in results)
    moved = [r for r in results
             if r["status"] == "result" and r.get("failovers")]
    assert moved, "the crash plan must force at least one failover"
    for r in moved:
        assert r["trace_id"] == router.trace_context(r["rid"])[0]
    rep = tcollector.fleet_report(dirs)
    assert tschema.validate_fleet_report(rep) == []
    assert rep["exactly_once"], rep["errors"][:5]
    assert rep["failover"] is not None and rep["failover"]["clean"]
    assert rep["failover"]["chains"] >= len(moved)
    assert rep["requests"] >= len(rids)
    jrep = jcollector.fleet_report(dirs)
    for key in ("exactly_once", "requests", "failover", "rows", "restarts",
                "errors"):
        assert rep[key] == jrep[key], key
    assert rep["restarts"] >= 1


def test_cli_fleet_serves_behind_the_router(tmp_path):
    """``--replicas 2 --trace_spans --engine_retries 1``: one params copy
    shared by both engines, a POST answered, /status listing two
    replicas with health and breaker, the spans under replica0,
    replica1 and router, the narrator armed on both engines."""
    cfg = tconfig.parse_config([
        "--model=transformer", "--objective=lm", "--input_size=32",
        "--vocab_size=50", "--d_model=32", "--n_heads=2", "--num_blocks=2",
        "--d_ff=64", "--device=cpu", "--replicas=2", "--trace_spans",
        "--engine_retries=1", f"--logs_path={tmp_path}"])
    server, router, engines = tcli.serve_fleet(cfg, 0)
    try:
        code, _, doc = _post(server.port, {"prompt": [3, 1, 7],
                                           "max_new_tokens": 4})
        assert code == 200 and len(doc["tokens"]) == 4
        st = json.loads(_get(server.port, "/status")[1])["router"]
        assert [p["name"] for p in st["per_replica"]] == ["replica0",
                                                          "replica1"]
        assert all({"health", "breaker"} <= set(p)
                   for p in st["per_replica"])
        assert "dtx_router_replicas 2" in \
            _get(server.port, "/metrics")[1].decode()
    finally:
        server.close()
        tcli.stop_engines(engines, router)
    a, b = engines
    assert all(a.params[k] is b.params[k] for k in a.params)
    assert a.restart_narrator is b.restart_narrator is not None
    assert sorted(os.listdir(tmp_path)) == ["replica0", "replica1",
                                            "router"]


def test_launch_counts_lose_no_update_across_threads():
    """The kernel launch counts are process-wide and a fleet's engines
    raise them from their own threads: 32 threads (more than the cores)
    raising one count 2000 times each, with a shortened switch interval,
    leave exactly 64000 (a lost read-modify-write would show)."""
    import sys
    import threading

    from distributed_tensorflow_example_tpu_torch.ops import _counts

    def wrapper():
        pass

    wrapper.launches = 0

    def work():
        for _ in range(2000):
            _counts.count(wrapper)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 64000


def test_cli_main_fleet_drains_on_sigterm(tmp_path):
    """``dtx-serve (torch) --replicas 2`` as a process: it prints its
    fleet line, answers a POST, and on SIGTERM drains, prints that it
    drained and exits 0, leaving the replicas' and the router's span
    dirs."""
    import socket
    import subprocess
    import sys
    import time

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "distributed_tensorflow_example_tpu_torch.serving.cli",
         f"--serve_port={port}", "--model=transformer", "--objective=lm",
         "--input_size=32", "--vocab_size=50", "--d_model=32", "--n_heads=2",
         "--num_blocks=2", "--d_ff=64", "--device=cpu", "--replicas=2",
         "--trace_spans", f"--logs_path={tmp_path}"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "fleet of 2 replicas" in line, (line, proc.stderr.read())
        deadline = time.monotonic() + 60
        while True:
            try:
                code, _, doc = _post(port, {"prompt": [3, 1, 7],
                                            "max_new_tokens": 3})
                break
            except urllib.error.URLError:
                assert time.monotonic() < deadline
                time.sleep(0.1)
        assert code == 200 and len(doc["tokens"]) == 3
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode == 0, err
    assert "fleet drained, exiting" in out
    assert sorted(os.listdir(tmp_path)) == ["replica0", "replica1",
                                            "router"]

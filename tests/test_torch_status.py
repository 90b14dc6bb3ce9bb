"""The port's status surface (``obs/serve``, ``obs/aggregate``,
``obs/heartbeat``, ``obs/queueing``, ``obs/collector``,
``obs/slo.fleet_evaluate``) against the JAX package's, on the CPU.

- Over one fixture logs dir (the JAX obs tests' closed-form 3-process
  run: metrics rows, heartbeat files, a ``flight/`` dump, plus a
  ``restarts.jsonl`` from the port's narrator and a port engine's span
  stream), ``collect_status``, ``aggregate``, ``summary_line``,
  ``read_heartbeats``, ``straggler_report`` and ``tail_rows`` equal
  JAX's at one ``now``; each package's validators accept the other's
  documents.
- ``prometheus_text`` is byte-equal to JAX's on the same status,
  serving, SLO, fleet, waterfall and router documents.
- ``queueing_report``, ``fleet_evaluate``, ``collect``, ``fleet_report``
  (apart from ``generated_t``) and ``chrome_trace`` equal JAX's over the
  same merged span rows of two port engines' run dirs.
- ``StatusServer`` over a CPU port engine carrying JAX's params answers
  every GET path with the code and top-level keys of JAX's
  ``StatusServer`` over a JAX engine (``/trace``'s 400 and 404 bodies
  and ``/fleet``'s 404 over an empty logs dir byte-equal too), and the
  ``/generate`` tokens are equal.
"""

import json
import os
import shutil
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from distributed_tensorflow_example_tpu.models import transformer as jtfm
from distributed_tensorflow_example_tpu.obs import aggregate as jagg
from distributed_tensorflow_example_tpu.obs import collector as jcol
from distributed_tensorflow_example_tpu.obs import heartbeat as jhb
from distributed_tensorflow_example_tpu.obs import queueing as jq
from distributed_tensorflow_example_tpu.obs import schema as jschema
from distributed_tensorflow_example_tpu.obs import serve as jserve
from distributed_tensorflow_example_tpu.obs import slo as jslo
from distributed_tensorflow_example_tpu.obs import spans as jspans
from distributed_tensorflow_example_tpu.obs import waterfall as jwf
from distributed_tensorflow_example_tpu.serving.engine import (
    DecodeEngine as JaxEngine)
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_example_tpu_torch.obs import aggregate as tagg
from distributed_tensorflow_example_tpu_torch.obs import collector as tcol
from distributed_tensorflow_example_tpu_torch.obs import heartbeat as thb
from distributed_tensorflow_example_tpu_torch.obs import queueing as tq
from distributed_tensorflow_example_tpu_torch.obs import schema as tschema
from distributed_tensorflow_example_tpu_torch.obs import serve as tserve
from distributed_tensorflow_example_tpu_torch.obs import slo as tslo
from distributed_tensorflow_example_tpu_torch.obs import spans as tspans
from distributed_tensorflow_example_tpu_torch.obs import waterfall as twf
from distributed_tensorflow_example_tpu_torch.resilience import (
    restart as trestart)
from distributed_tensorflow_example_tpu_torch.serving.engine import (
    DecodeEngine)
from distributed_tensorflow_example_tpu_torch.serving.faults import FaultPlan

import test_obs_cli

_BASE = dict(input_size=32, num_classes=10, seq_len=32, d_model=32,
             n_heads=2, num_blocks=2, d_ff=64, objective="lm",
             vocab_size=50, causal=True)
NOW = 2.0e9      # one wall clock for both packages' age fields


@pytest.fixture(scope="module")
def lm():
    jspec = jtfm.TransformerSpec(**_BASE)
    tspec = ttfm.TransformerSpec(**_BASE)
    jp = jtfm.init(jax.random.PRNGKey(0), jspec)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   tspec, device="cpu")
    return (jspec, jp), (tspec, tp)


def _engine_run(spec, params, logs, crash=()):
    """Six ragged requests through a port engine with its recorder
    under ``logs`` (``crash``: injected crash boundaries under
    engine_retries=1, narrated to ``logs``/restarts.jsonl)."""
    rec = tspans.SpanRecorder(str(logs))
    eng = DecodeEngine(spec, params, page_size=4, max_batch=2, seed=1,
                       engine_retries=1, recorder=rec,
                       faults=FaultPlan(crash_at_ticks=tuple(crash)),
                       restart_narrator=trestart.RestartNarrator(str(logs)),
                       device="cpu")
    rng = np.random.RandomState(7)
    for n in (3, 6, 4, 8, 2, 5):
        eng.submit(rng.randint(0, 50, size=n).tolist(), 4)
    eng.run_until_idle()
    eng.step()
    rec.close()
    return eng


@pytest.fixture(scope="module")
def fleet(lm, tmp_path_factory):
    """A parent dir with two run dirs: ``siteA`` holds the closed-form
    metrics/heartbeat/flight fixture, a port engine's spans (one
    injected crash) and its restarts.jsonl; ``siteB`` a second engine's
    spans."""
    _, (tspec, tp) = lm
    parent = tmp_path_factory.mktemp("fleet")
    a = parent / "siteA"
    test_obs_cli.synth_run(str(a))
    eng = _engine_run(tspec, tp, a, crash=(2,))
    _engine_run(tspec, tp, parent / "siteB")
    return parent, a, eng


def test_collect_status_and_aggregate_match_jax(fleet):
    """At one ``now``: the /status and /report documents, the summary
    line and the heartbeat reads are equal; both validators accept the
    port's report; the restarts summary counts the narrated restart."""
    _, run, _ = fleet
    run = str(run)
    assert tserve.collect_status(run, now=NOW) == \
        jserve.collect_status(run, now=NOW)
    rep = tagg.aggregate(run, now=NOW)
    assert rep == jagg.aggregate(run, now=NOW)
    assert tagg.summary_line(rep) == jagg.summary_line(rep)
    assert tschema.validate_run_report(rep) == []
    assert jschema.validate_run_report(rep) == []
    assert rep["restarts"]["engine_restarts"] == 1
    assert rep["schema_errors"] == []
    assert tagg.metrics_files(run) == jagg.metrics_files(run)
    assert tagg.has_streams(run) and jagg.has_streams(run)
    assert thb.read_heartbeats(run) == jhb.read_heartbeats(run)
    for kw in ({"now": NOW}, {"now": NOW, "since": NOW}):
        assert thb.straggler_report(run, **kw) == \
            jhb.straggler_report(run, **kw)
    with pytest.raises(FileNotFoundError) as t_err:
        tagg.aggregate(str(fleet[0] / "siteB"))
    with pytest.raises(FileNotFoundError) as j_err:
        jagg.aggregate(str(fleet[0] / "siteB"))
    assert str(t_err.value) == str(j_err.value)


def test_metrics_rows_and_tails_match_jax(fleet, tmp_path):
    """Every fixture metrics row passes both validators; a doctored row
    gets the same errors; tail_rows of a whole and of a cut file are
    equal; clear_stale_signals removes the same files."""
    _, run, _ = fleet
    for _pid, path in tagg.metrics_files(str(run)):
        rows = [json.loads(x) for x in open(path) if x.strip()]
        for row in rows + [dict(rows[0], v=9), dict(rows[0], kind="x"),
                           {k: v for k, v in rows[-1].items()
                            if k != "t"}]:
            assert tschema.validate_metrics_row(row) == \
                jschema.validate_metrics_row(row)
        for cut in (tserve.TAIL_BYTES, 300):
            assert tserve.tail_rows(path, cut) == jserve.tail_rows(path, cut)
    for mod, tag in ((thb, "t"), (jhb, "j")):
        shutil.copytree(run, tmp_path / tag)
    assert thb.clear_stale_signals(str(tmp_path / "t")) == \
        jhb.clear_stale_signals(str(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))


def test_queueing_fleet_slo_collect_and_chrome_match_jax(fleet):
    """Over the merged rows of both run dirs: collect (rows and
    sources), queueing_report, records + fleet_evaluate at the defaults
    and at tight specs, fleet_report apart from generated_t, and
    chrome_trace are equal; both validators accept the fleet report."""
    parent, _, _ = fleet
    col = tcol.collect([str(parent)])
    assert col == jcol.collect([str(parent)])
    assert tcol.discover_sources([str(parent)]) == \
        jcol.discover_sources([str(parent)])
    rows = [r for r in col["rows"] if r.get("kind") == "span"]
    assert tq.queueing_report(rows) == jq.queueing_report(rows)
    assert tq.queueing_report(rows, tolerance=0.0) == \
        jq.queueing_report(rows, tolerance=0.0)
    assert tq.queueing_report([]) is jq.queueing_report([]) is None
    recs = tslo.records_from_spans(rows)
    text = "ttft_p99_ms<=50,error_rate<=0.01"
    for tspecs, jspecs in ((None, None), (tslo.parse_specs(text),
                                          jslo.parse_specs(text))):
        assert tslo.fleet_evaluate(recs, tspecs) == \
            jslo.fleet_evaluate(recs, jspecs)
    rep = tcol.fleet_report([str(parent)])
    jrep = jcol.fleet_report([str(parent)])
    rep.pop("generated_t")
    jrep.pop("generated_t")
    assert rep == jrep
    assert rep["exactly_once"] and len(rep["sources"]) == 2
    assert rep["slo"]["identity"]["holds"]
    full = tcol.fleet_report([str(parent)])
    assert tschema.validate_fleet_report(full) == []
    assert jschema.validate_fleet_report(full) == []
    assert tcol.chrome_trace(col["rows"]) == jcol.chrome_trace(col["rows"])


def test_prometheus_text_is_byte_equal_to_jax(fleet):
    """The same status, serving, SLO, fleet, waterfall and router
    documents render to the same bytes (and each alone, and none)."""
    from distributed_tensorflow_example_tpu_torch.serving import (
        router as trt)

    parent, run, eng = fleet
    status = tserve.collect_status(str(run), now=NOW)
    rows = tspans.read_spans(str(run / "spans.0.jsonl"))
    docs = dict(
        serving=eng.stats(),
        slo=tslo.evaluate(tslo.records_from_spans(rows)),
        fleet=tcol.fleet_report([str(parent)]),
        waterfall=twf.summarize(twf.waterfalls(rows)),
        router=trt.Router([eng], clock=lambda: 0.0).stats())
    assert tserve.prometheus_text(status, **docs) == \
        jserve.prometheus_text(status, **docs)
    for name, doc in docs.items():
        assert tserve.prometheus_text({}, **{name: doc}) == \
            jserve.prometheus_text({}, **{name: doc}), name
    text = tserve.prometheus_text(status, **docs)
    for gauge in ("dtx_procs 3", "dtx_generate_requests_total 6",
                  "dtx_slo_requests", "dtx_fleet_exactly_once 1",
                  "dtx_waterfall_requests 6", "dtx_router_replicas 1"):
        assert gauge in text, gauge
    assert tserve.prometheus_text({}) == jserve.prometheus_text({})


def test_ttl_cache_recomputes_on_age_and_signature():
    calls = []
    for ttl, sigs, want in ((60.0, (None, None), 1), (0.0, (None, None), 2),
                            (60.0, ((1,), (2,)), 2), (60.0, ((1,), (1,)), 1)):
        calls.clear()
        cache = tserve.TTLCache(ttl)
        vals = [cache.get(lambda: calls.append(1) or len(calls), sig=s)
                for s in sigs]
        assert len(calls) == want and vals[-1] == want


# --- the served status surface ---------------------------------------------

_PATHS = ("/", "/status", "/metrics", "/report", "/slo", "/trace",
          "/trace?rid=x", "/trace?rid=0", "/trace?rid=99", "/fleet",
          "/explain", "/explain?rid=0", "/explain?rid=x",
          "/explain?trace=nope", "/nope")


def _http(port, path, doc=None):
    url = f"http://127.0.0.1:{port}{path}"
    req = (urllib.request.Request(url, data=json.dumps(doc).encode())
           if doc is not None else url)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _served(server_cls, engine, logs, prompts):
    """POST each prompt, wait for the retire rows, then GET every path:
    ``(tokens, {path: (code, body)})``."""
    srv = server_cls(str(logs), engine=engine)
    port = srv.start(0)
    try:
        tokens = []
        for p in prompts:
            code, body = _http(port, "/generate", {"prompt": p,
                                                   "max_new_tokens": 4})
            assert code == 200, body
            tokens.append(json.loads(body)["tokens"])
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            code, body = _http(port, f"/trace?rid={len(prompts) - 1}")
            if code == 200 and json.loads(body)["record"].get(
                    "terminal") == "result":
                break
            time.sleep(0.05)
        return tokens, {p: _http(port, p) for p in _PATHS}
    finally:
        srv.close()


def _shape(code, body, path):
    if path == "/metrics":
        names = sorted({line.split()[2] for line in body.decode().splitlines()
                        if line.startswith("# TYPE")})
        return code, names
    doc = json.loads(body)
    return code, sorted(doc)


def test_status_server_matches_jax_status_server(lm, tmp_path):
    """A port StatusServer over a CPU port engine with JAX's params, and
    JAX's over a JAX engine, each logging spans over a copy of the
    closed-form metrics fixture: equal /generate tokens; every GET path
    answers the same code and top-level keys (the gauge names on
    /metrics); /trace's 400/404 and /explain's 400 bodies byte-equal;
    the 404 of an unknown path lists JAX's endpoints and /healthz."""
    (jspec, jp), (tspec, tp) = lm
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 50, size=n).tolist() for n in (3, 6)]
    served = []
    for cls, make, spans_mod, tag in (
            (jserve.StatusServer, lambda r: JaxEngine(
                jspec, jp, page_size=4, max_batch=2, recorder=r),
             jspans, "jax"),
            (tserve.StatusServer, lambda r: DecodeEngine(
                tspec, tp, page_size=4, max_batch=2, recorder=r,
                device="cpu"), tspans, "torch")):
        logs = tmp_path / tag
        test_obs_cli.synth_run(str(logs))
        rec = spans_mod.SpanRecorder(str(logs))
        eng = make(rec)
        eng.start()
        try:
            served.append(_served(cls, eng, logs, prompts))
        finally:
            eng.stop()
            rec.close()
    (jtok, jget), (ttok, tget) = served
    assert ttok == jtok
    for path in _PATHS:
        assert _shape(*tget[path], path) == _shape(*jget[path], path), path
    for path in ("/trace", "/trace?rid=x", "/trace?rid=99",
                 "/explain?rid=x"):
        assert tget[path] == jget[path], path
    assert tget["/report"][0] == 200
    assert tschema.validate_run_report(json.loads(tget["/report"][1])) == []
    fleet = json.loads(tget["/fleet"][1])
    assert fleet["exactly_once"] and len(fleet["sources"]) == 1
    assert json.loads(tget["/status"][1])["serving"]["completed_total"] == 2
    endpoints = json.loads(tget["/nope"][1])["endpoints"]
    assert endpoints == json.loads(jget["/nope"][1])["endpoints"] \
        + ["/healthz"]


def test_status_server_over_an_empty_logs_dir_matches_jax(tmp_path):
    """No engine, no streams: /fleet is JAX's 404 body, /report JAX's
    500, /status no processes, POST /generate JAX's 503, /healthz up."""
    out = []
    for cls, tag in ((jserve.StatusServer, "jax"),
                     (tserve.StatusServer, "torch")):
        (tmp_path / tag).mkdir()
        srv = cls(str(tmp_path / tag), cache_ttl_s=0.0)
        port = srv.start(0)
        try:
            status = json.loads(_http(port, "/status")[1])
            status.pop("t")
            status.pop("logs_path")
            out.append([_http(port, "/fleet"), _http(port, "/report")[0],
                        status, _http(port, "/generate", {"prompt": [1]}),
                        _http(port, "/slo")])
        finally:
            srv.close()
    assert out[0] == out[1]
    assert out[1][0][0] == 404 and out[1][2]["proc_count"] == 0
    srv = tserve.StatusServer(str(tmp_path / "torch"))
    assert json.loads(srv.get_doc("/healthz")[1]) == {"ok": True,
                                                      "serving": None}

"""The port's request tracing, SLOs and waterfalls against the JAX
package's, on the CPU, at the ``tests/test_serving.py`` sizes.

- One scripted request set (a shed, a deadline timeout, two injected
  crashes under ``engine_retries=1``: a requeue, then a spent budget)
  through the JAX and the port engine, each with its own recorder,
  gives the same sequence of ``(event, rid, fields)``, wall times and
  trace ids aside; every port row passes the port's validator.
- ``reconstruct``, ``trace_record``, ``records_from_spans``,
  ``evaluate``, ``waterfalls`` and ``summarize`` give equal documents
  when the port's and JAX's are fed the same rows (that stream and the
  fixtures of ``tests/test_spans.py``, ``test_slo.py`` and
  ``test_waterfall.py``); ``parse_specs`` raises on the same bad
  strings; the validators agree on good and bad rows.
- Rotation and keep; ``simulate_degraded`` equal to JAX's on the same
  Poisson workload; the brownout tripping on the SLO burn rate at the
  same boundary in both engines.
"""

import dataclasses
import os
import time

import numpy as np
import pytest

import jax

from distributed_tensorflow_example_tpu.models import transformer as jtfm
from distributed_tensorflow_example_tpu.obs import schema as jschema
from distributed_tensorflow_example_tpu.obs import slo as jslo
from distributed_tensorflow_example_tpu.obs import spans as jspans
from distributed_tensorflow_example_tpu.obs import waterfall as jwf
from distributed_tensorflow_example_tpu.obs import workload as jworkload
from distributed_tensorflow_example_tpu.serving import admission as jadm
from distributed_tensorflow_example_tpu.serving import faults as jfaults
from distributed_tensorflow_example_tpu.serving import scheduler as jsched
from distributed_tensorflow_example_tpu.serving.engine import (
    DecodeEngine as JaxEngine)
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_example_tpu_torch.obs import schema as tschema
from distributed_tensorflow_example_tpu_torch.obs import slo as tslo
from distributed_tensorflow_example_tpu_torch.obs import spans as tspans
from distributed_tensorflow_example_tpu_torch.obs import waterfall as twf
from distributed_tensorflow_example_tpu_torch.obs import workload as tworkload
from distributed_tensorflow_example_tpu_torch.serving import admission as tadm
from distributed_tensorflow_example_tpu_torch.serving import faults as tfaults
from distributed_tensorflow_example_tpu_torch.serving import scheduler as tsched
from distributed_tensorflow_example_tpu_torch.serving.engine import (
    DecodeEngine)

import test_slo
import test_spans
import test_waterfall

_BASE = dict(num_classes=10, d_model=32, n_heads=2, num_blocks=2, d_ff=64,
             objective="lm", vocab_size=50, causal=True)
# span fields that carry wall-clock readings or fresh random ids: equal
# in presence, not in value, between two runs
_VOLATILE = ("t", "arrival", "finish_t", "ttft_ms", "dur_ms", "deadline",
             "trace_id", "parent_id")


def _models(seq_len):
    kw = dict(_BASE, input_size=seq_len, seq_len=seq_len)
    jspec = jtfm.TransformerSpec(**kw)
    tspec = ttfm.TransformerSpec(**kw)
    jp = jtfm.init(jax.random.PRNGKey(0), jspec)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   tspec, device="cpu")
    return (jspec, jp), (tspec, tp)


@pytest.fixture(scope="module")
def lm():
    return _models(32)


def _norm(row):
    return {k: (None if k in _VOLATILE else v) for k, v in row.items()}


def _scripted(make_engine, faults_mod, spans_mod, logs):
    """rid 0 times out waiting (1 ms deadline), rid 2 is shed (queue
    full), rids 1, 3, 4 run through two injected crashes (boundaries 3
    and 4) under engine_retries=1: the first re-queues the in-flight
    requests, the second spends their budget (typed failed); rid 5 is
    submitted last and completes."""
    rec = spans_mod.SpanRecorder(str(logs))
    plan = faults_mod.FaultPlan(crash_at_ticks=(3, 4))
    eng = make_engine(recorder=rec, faults=plan)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 50, size=n).tolist()
               for n in (4, 6, 3, 5, 7, 2)]
    eng.submit(prompts[0], 4, deadline_ms=1.0)
    eng.submit(prompts[1], 5)
    with pytest.raises(Exception) as err:
        eng.submit(prompts[2], 5)
    assert type(err.value).__name__ == "ShedError"
    time.sleep(0.02)
    assert eng.step()
    eng.submit(prompts[3], 6)
    eng.submit(prompts[4], 4)
    eng.run_until_idle()
    eng.submit(prompts[5], 3)
    eng.run_until_idle()
    # the last retire lands at the next scheduler boundary
    eng.step()
    rec.close()
    return rec, eng


@pytest.fixture(scope="module")
def streams(lm, tmp_path_factory):
    (jspec, jp), (tspec, tp) = lm
    kw = dict(page_size=4, max_batch=2, max_queue=2, engine_retries=1)
    jrec, jeng = _scripted(
        lambda **a: JaxEngine(jspec, jp, **kw, **a), jfaults, jspans,
        tmp_path_factory.mktemp("jax"))
    trec, teng = _scripted(
        lambda **a: DecodeEngine(tspec, tp, device="cpu", **kw, **a),
        tfaults, tspans, tmp_path_factory.mktemp("torch"))
    return jrec, trec, jeng, teng


def test_engine_span_stream_matches_jax(streams):
    """The same rows in the same order, field for field (wall times and
    trace ids aside); the ring holds what the file holds; the terminals
    cover result, timeout, shed and failed; the port's file validates."""
    jrec, trec, jeng, teng = streams
    jrows = jspans.read_spans(jrec.path)
    trows = tspans.read_spans(trec.path)
    assert [_norm(r) for r in trows] == [_norm(r) for r in jrows]
    assert trows == trec.snapshot()
    assert tschema.validate_span_file(trec.path) == []
    assert jschema.validate_span_file(trec.path) == []
    events = {r["event"] for r in trows}
    assert {"submit", "blocked", "admit", "prefill", "first_token", "tick",
            "tick_done", "retire", "timeout", "shed", "requeue",
            "engine_restart", "failed"} <= events
    terminals = {r["rid"]: r["terminal"]
                 for r in tspans.reconstruct(trows).values()}
    assert sorted(set(terminals.values())) == ["failed", "result", "shed",
                                               "timeout"]
    for key in ("shed_total", "timeout_total", "failed_total",
                "requeued_total", "engine_restarts_total"):
        assert teng.stats()[key] == jeng.stats()[key], key
    # each trace id is stable over a lifecycle and is the result's
    for rid, rec in tspans.reconstruct(trows).items():
        assert not rec["errors"] or rec["terminal"] == "failed", rec
    assert teng.result(5)["trace_id"] == \
        tspans.trace_record(trows, 5)["record"]["trace_id"]


def _fixture_rows(tmp):
    """Rows from the JAX package's own span, SLO and waterfall test
    fixtures: a pages-blocked scheduler run through the JAX recorder,
    hand-built lifecycles with timeout/failed/shed terminals, and two
    waterfall requests."""
    rows = jspans.read_spans(test_spans._spanned_run(tmp))
    for rid, tick in ((10, 1), (11, 2)):
        rows += test_slo._lifecycle(rid, tick, ttft=10.0 * rid)
    rows += [test_slo._vrow("submit", rid=12, prompt_len=2,
                            max_new_tokens=9, arrival=0.0),
             test_slo._vrow("timeout", rid=12, reason="deadline", tick=3,
                            generated=1),
             test_slo._vrow("shed", rid=13, reason="queue", tick=2,
                            queued=4),
             test_slo._vrow("submit", rid=14, prompt_len=2,
                            max_new_tokens=9, arrival=0.0),
             test_slo._vrow("failed", rid=14, reason="budget", attempts=2)]
    rows += [dict(r, proc=1) for r in test_waterfall._two_request_rows()]
    return rows


@pytest.mark.parametrize("which", ["engine", "fixtures"])
def test_reconstruct_trace_slo_and_waterfall_docs_match_jax(streams, which,
                                                            tmp_path):
    """Fed the same rows, the port's and JAX's functions return equal
    documents: reconstruct, trace_record of every rid, records_from_spans,
    evaluate at the defaults and at tight specs, waterfalls and
    summarize; every waterfall passes both validators."""
    rows = (jspans.read_spans(streams[0].path) if which == "engine"
            else _fixture_rows(tmp_path))
    assert tspans.reconstruct(rows) == jspans.reconstruct(rows)
    for _proc, rid in jspans.reconstruct(rows):
        assert tspans.trace_record(rows, rid) == \
            jspans.trace_record(rows, rid)
    assert tspans.trace_record(rows, 999) is None
    recs = tslo.records_from_spans(rows)
    assert recs == jslo.records_from_spans(rows)
    text = "ttft_p99_ms<=15,latency_p99_ms<=1,error_rate<=0.2"
    for tspecs, jspecs in ((None, None), (tslo.parse_specs(text),
                                          jslo.parse_specs(text))):
        assert tslo.evaluate(recs, specs=tspecs) == \
            jslo.evaluate(recs, specs=jspecs)
        assert tslo.evaluate(recs, specs=tspecs, now_tick=2) == \
            jslo.evaluate(recs, specs=jspecs, now_tick=2)
    docs = twf.waterfalls(rows)
    assert docs == jwf.waterfalls(rows)
    assert docs and twf.summarize(docs) == jwf.summarize(docs)
    for d in docs:
        assert tschema.validate_waterfall(d) == []
        assert jschema.validate_waterfall(d) == []
    assert twf.waterfalls(rows, rid=1) == jwf.waterfalls(rows, rid=1)


def test_parse_specs_and_validators_agree_with_jax():
    """The SLO DSL parses to JAX's specs and raises on the same bad
    strings; the span-row validator gives JAX's errors on good rows,
    rows missing a field, unknown events and unversioned rows."""
    for text in ("", "ttft_p99_ms<=250, latency_p99_ms<=2000, "
                     "error_rate<=0.05", "error_rate<=0.01"):
        assert [dataclasses.asdict(s) for s in tslo.parse_specs(text)] == \
            [dataclasses.asdict(s) for s in jslo.parse_specs(text)]
    for bad in ("p99<=1", "ttft_p99_ms", "ttft_p99_ms<=abc",
                "ttft_p99_ms<=-5", "error_rate<=1.5", "error_rate<=0"):
        with pytest.raises(ValueError):
            jslo.parse_specs(bad)
        with pytest.raises(ValueError):
            tslo.parse_specs(bad)
    good = {"kind": "span", "v": tschema.SCHEMA_VERSION, "t": 1.0,
            "proc": 0, "event": "admit", "rid": 3, "pages_held": 2,
            "tick": 5}
    for row in (good, {k: v for k, v in good.items() if k != "pages_held"},
                dict(good, event="finish"), dict(good, v=3),
                {k: v for k, v in good.items() if k != "v"},
                dict(good, rid=True), dict(good, trace_id=7),
                dict(good, event="phase", phase="bogus", trace_id="a",
                     dur_ms=1.0)):
        assert tschema.validate_span_row(row) == \
            jschema.validate_span_row(row)
    assert tschema.SCHEMA_VERSION == jschema.SCHEMA_VERSION
    for prompt in ([], [1], list(range(40)), [7] * 17):
        assert tworkload.prompt_fingerprint(prompt) == \
            jworkload.prompt_fingerprint(prompt)


def test_traceparent_helpers_match_jax():
    for header in ("00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
                   " 00-" + "AB" * 16 + "-" + "cd" * 8 + "-00 ",
                   "00-" + "0" * 32 + "-" + "cd" * 8 + "-01",
                   "00-" + "ab" * 16 + "-" + "0" * 16 + "-01",
                   "garbage", None, 7):
        assert tspans.parse_traceparent(header) == \
            jspans.parse_traceparent(header)
    assert len(tspans.new_trace_id()) == 32
    assert len(tspans.new_span_id()) == 16
    assert tspans.format_traceparent("a" * 32, "b" * 16) == \
        jspans.format_traceparent("a" * 32, "b" * 16)


def test_recorder_rotation_and_keep(tmp_path):
    """The port's recorder rotates like JAX's: a rotated stream of the
    port's scheduler reconstructs as the unrotated JAX one does, and
    keep=2 holds .1 and .2 only, the newest rotation .1; unknown
    events raise; non-finite floats stringify."""
    runs = {}
    for name, sched, spans, rot in (("t", tsched, tspans, 600),
                                    ("j", jsched, jspans, 0)):
        rec = spans.SpanRecorder(str(tmp_path / name), rotate_bytes=rot,
                                 keep=10)
        s = sched.ContinuousScheduler(num_pages=5, page_size=4,
                                      max_batch=4, recorder=rec)
        sched.simulate(s, [(0, 4, 4), (1, 4, 4), (2, 4, 4)])
        rec.close()
        runs[name] = rec
    assert os.path.exists(runs["t"].path + ".1")
    rows = tspans.read_spans(runs["t"].path)
    assert len(tspans.read_spans(runs["t"].path, include_rotated=False)) \
        < len(rows)
    assert [_norm(r) for r in rows] == \
        [_norm(r) for r in jspans.read_spans(runs["j"].path)]
    assert len(tspans.load_spans(str(tmp_path / "t"))) == len(rows)

    rec = tspans.SpanRecorder(str(tmp_path / "k"), rotate_bytes=200,
                              keep=2)
    for i in range(40):
        rec.emit("blocked", rid=i, reason="pages", tick=i)
    with pytest.raises(ValueError, match="unknown span event"):
        rec.emit("finish", rid=0)
    rec.emit("tick_done", tick=41, dur_ms=float("nan"))
    rec.close()
    assert tspans.rotated_files(rec.path) == [
        rec.path + ".2", rec.path + ".1", rec.path]
    assert not os.path.exists(rec.path + ".3")
    t2 = tspans.read_spans(rec.path + ".2", include_rotated=False)[-1]
    t1 = tspans.read_spans(rec.path + ".1", include_rotated=False)[0]
    assert t1["tick"] > t2["tick"]
    assert tspans.read_spans(rec.path)[-1]["dur_ms"] == "nan"


def test_simulate_degraded_matches_jax():
    """The closed-form workload of tests/test_serving_faults.py (24
    Poisson arrivals, seed 0, every third with a 6-tick deadline, 4
    slots, a queue of 3): the port's simulator gives JAX's result
    (16 completed, 4 shed, 4 timed out), and so on the hand-computed
    1-slot case."""
    rng = np.random.RandomState(0)
    reqs, t = [], 0.0
    for i in range(24):
        t += float(rng.exponential(1.0))
        p, n = int(rng.randint(4, 24)), int(rng.randint(2, 18))
        reqs.append((i, p, n, t, t + 6.0 if i % 3 == 0 else None))
    got = tfaults.simulate_degraded(tsched.ContinuousScheduler(33, 8, 4),
                                    reqs, max_queue=3)
    want = jfaults.simulate_degraded(jsched.ContinuousScheduler(33, 8, 4),
                                     reqs, max_queue=3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.completed, got.shed, got.timed_out) == (16, 4, 4)
    small = [(0, 3, 4, 0.0, None), (1, 3, 2, 0.0, 2.0),
             (2, 3, 2, 0.0, None), (3, 3, 2, 0.5, None)]
    got = tfaults.simulate_degraded(tsched.ContinuousScheduler(33, 4, 1),
                                    small, max_queue=2)
    assert got.terminals == {0: "result", 1: "timeout", 2: "shed",
                             3: "result"}
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jfaults.simulate_degraded(jsched.ContinuousScheduler(33, 4, 1),
                                  small, max_queue=2))


def test_brownout_trips_on_the_slo_burn_at_the_same_boundary(tmp_path):
    """A ttft SLO every request breaks (0.001 ms) and a brownout on the
    burn rate alone (occupancy never reaches 1.0): the first burn fold
    (boundary 0) sees no terminal, the next (boundary BURN_EVERY = 32)
    sees the short request retired, burn 100 >= 2, and both engines
    turn the brownout on at that boundary; without a recorder the port
    never does."""
    (jspec, jp), (tspec, tp) = _models(64)
    specs = "ttft_p99_ms<=0.001"

    def first_active(eng):
        eng.submit([1, 2, 3], 45)
        eng.submit([4, 5], 2)
        for n in range(60):
            if not eng.step():
                return None
            if eng.stats()["brownout_active"]:
                return n
        return None

    common = dict(page_size=4, max_batch=2, num_pages=64)
    jeng = JaxEngine(jspec, jp, **common, slos=jslo.parse_specs(specs),
                     brownout=jadm.parse_brownout("occ=1.0,burn=2"),
                     recorder=jspans.SpanRecorder(str(tmp_path / "j")))
    teng = DecodeEngine(tspec, tp, **common, device="cpu",
                        slos=tslo.parse_specs(specs),
                        brownout=tadm.parse_brownout("occ=1.0,burn=2"),
                        recorder=tspans.SpanRecorder(str(tmp_path / "t")))
    want = first_active(jeng)
    assert want == 32
    assert first_active(teng) == want
    bare = DecodeEngine(tspec, tp, **common, device="cpu",
                        slos=tslo.parse_specs(specs),
                        brownout=tadm.parse_brownout("occ=1.0,burn=2"))
    assert first_active(bare) is None
    for eng in (jeng, teng):
        eng.recorder.close()

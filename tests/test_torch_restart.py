"""The port's restart narrator, its engine's supervision ledger and the
serving parser's depth flags against the JAX package's, on the CPU.

- ``resilience/restart``: ``dead_procs``, ``backoff_s``, the
  ``RestartPolicy`` decision table and a ``Supervisor`` run over an
  injected launcher give equal results in both packages; the narrator's
  rows validate under both packages' ``validate_restart_file`` and read
  back through both ``read_restarts``.
- A port engine and a JAX engine with ``engine_retries=1``, a narrator
  and the same crash plan write ``restarts.jsonl`` rows with the same
  event sequence, field names and payloads (wall times aside).
- ``submit(attempts=k)`` offsets the local retry budget in both engines
  alike (a failed-over request fails after ``engine_retries`` more
  crashes, with the cumulative count); ``submit(fingerprint=)`` replaces
  the submit span's fingerprint; ``waiting_rids()`` and ``fast_burn()``
  read what the JAX engine reads.
- ``--decode_page_size`` and ``--decode_max_batch`` at 0 and -3: both
  CLIs exit 2 at parse.
"""

import json

import numpy as np
import pytest

import jax

from distributed_tensorflow_example_tpu.models import transformer as jtfm
from distributed_tensorflow_example_tpu.obs import schema as jschema
from distributed_tensorflow_example_tpu.obs import spans as jspans
from distributed_tensorflow_example_tpu.resilience import restart as jrestart
from distributed_tensorflow_example_tpu.serving import cli as jcli
from distributed_tensorflow_example_tpu.serving import faults as jfaults
from distributed_tensorflow_example_tpu.serving.engine import (
    DecodeEngine as JaxEngine)
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_example_tpu_torch.obs import schema as tschema
from distributed_tensorflow_example_tpu_torch.obs import spans as tspans
from distributed_tensorflow_example_tpu_torch.resilience import (
    restart as trestart)
from distributed_tensorflow_example_tpu_torch.serving import cli as tcli
from distributed_tensorflow_example_tpu_torch.serving import faults as tfaults
from distributed_tensorflow_example_tpu_torch.serving.engine import (
    DecodeEngine)

_BASE = dict(input_size=32, num_classes=10, seq_len=32, d_model=32,
             n_heads=2, num_blocks=2, d_ff=64, objective="lm",
             vocab_size=50, causal=True)


@pytest.fixture(scope="module")
def lm():
    jspec = jtfm.TransformerSpec(**_BASE)
    tspec = ttfm.TransformerSpec(**_BASE)
    jp = jtfm.init(jax.random.PRNGKey(0), jspec)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   tspec, device="cpu")
    return (jspec, jp), (tspec, tp)


def test_dead_procs_and_backoff_match_jax():
    beats = {0: (10, 100.0), 1: (9, 60.0), 2: (10, 95.0), 3: (2, 10.0)}
    for kw in ({}, {"now": 80.0}, {"dead_after_s": 5.0},
               {"since": 50.0}, {"since": 200.0}):
        assert trestart.dead_procs(beats, **kw) == \
            jrestart.dead_procs(beats, **kw), kw
    assert trestart.dead_procs({}, now=1.0) == []
    for attempt in range(8):
        for kw in ({}, {"base_s": 0.05, "cap_s": 2.0},
                   {"base_s": 3.0, "factor": 1.5, "cap_s": 20.0}):
            assert trestart.backoff_s(attempt, **kw) == \
                jrestart.backoff_s(attempt, **kw)
    for mod in (trestart, jrestart):
        with pytest.raises(ValueError, match="attempt=-1 must be >= 0"):
            mod.backoff_s(-1)


def test_restart_policy_table_and_supervisor_match_jax():
    """Every (attempt, alive, dp) verdict of the policy is equal, the
    argument checks raise the same messages, and a supervisor over a
    launcher that fails twice, then reforms, then succeeds takes the
    same decisions, sleeps and narrated events."""
    for kw in ({}, {"max_retries": 1, "min_dp": 2},
               {"max_retries": 0, "backoff_base_s": 0.5}):
        tp, jp = trestart.RestartPolicy(**kw), jrestart.RestartPolicy(**kw)
        for attempt in range(4):
            for dp in (1, 2, 4):
                for alive in range(dp + 1):
                    t = tp.decide(attempt, alive, dp, dead=(3,))
                    j = jp.decide(attempt, alive, dp, dead=(3,))
                    assert (t.action, t.wait_s, t.dp, t.attempt, t.reason,
                            t.dead) == (j.action, j.wait_s, j.dp,
                                        j.attempt, j.reason, j.dead)
    for bad in ({"max_retries": -1}, {"min_dp": 0},
                {"backoff_base_s": -1.0}, {"backoff_factor": 0.5}):
        msgs = []
        for mod in (trestart, jrestart):
            with pytest.raises(ValueError) as err:
                mod.RestartPolicy(**bad)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]

    def drive(mod, tmp):
        codes = iter([1, 1, 1, 0])
        slept = []
        narr = mod.RestartNarrator(str(tmp))
        sup = mod.Supervisor(mod.RestartPolicy(max_retries=2),
                             narrator=narr, sleep=slept.append)
        out = sup.run(lambda plan: next(codes), dp=4,
                      health=lambda: {"alive": 3, "dead": [2]})
        rows = mod.read_restarts(str(tmp))
        return ({k: v for k, v in out.items() if k != "decisions"},
                [(d.action, d.dp, d.wait_s) for d in out["decisions"]],
                slept, [{k: v for k, v in r.items() if k != "t"}
                        for r in rows])

    assert drive(trestart, _tmp("t")) == drive(jrestart, _tmp("j"))


def _tmp(tag):
    import tempfile

    return tempfile.mkdtemp(prefix=f"restart_{tag}_")


def test_narrator_rows_validate_in_both_packages(tmp_path):
    """Every event of the vocabulary: the port's rows pass both
    validators and read back equal through both readers; an unknown
    event raises the same message; the vocabularies are equal."""
    from distributed_tensorflow_example_tpu.obs import buckets as jbuckets
    from distributed_tensorflow_example_tpu_torch.obs import (
        buckets as tbuckets)

    assert tbuckets.RESTART_EVENTS == jbuckets.RESTART_EVENTS
    narr = trestart.RestartNarrator(str(tmp_path))
    for ev in tbuckets.RESTART_EVENTS:
        narr.emit(ev, reason="r", attempt=1)
    msgs = []
    for mod, n in ((trestart, narr),
                   (jrestart, jrestart.RestartNarrator(str(tmp_path)))):
        with pytest.raises(ValueError) as err:
            n.emit("bogus")
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    path = str(tmp_path / "restarts.jsonl")
    assert tschema.validate_restart_file(path) == []
    assert jschema.validate_restart_file(path) == []
    assert trestart.read_restarts(str(tmp_path)) == \
        jrestart.read_restarts(str(tmp_path))
    with open(path, "a") as f:
        f.write('{"kind": "restart", "v": 9, "t": 1.0, "proc": 0, '
                '"event": "preempt"}\n{"kind": "x", "v": 10, "t": 1, '
                '"proc": 0, "event": "nope"}\n{torn\n')
    assert tschema.validate_restart_file(path) == \
        jschema.validate_restart_file(path) != []


def _crash_run(make_engine, faults_mod, restart_mod, spans_mod, logs):
    """Three requests through two injected crashes (boundaries 1 and 2)
    under engine_retries=1: the first re-queues the in-flight requests,
    the second spends their budget.  Returns the restart rows, the
    results and the span rows."""
    narr = restart_mod.RestartNarrator(str(logs))
    rec = spans_mod.SpanRecorder(str(logs))
    eng = make_engine(restart_narrator=narr, recorder=rec,
                      faults=faults_mod.FaultPlan(crash_at_ticks=(1, 2)))
    rng = np.random.RandomState(4)
    rids = [eng.submit(rng.randint(0, 50, size=n).tolist(), 4)
            for n in (3, 5, 6)]
    eng.run_until_idle()
    eng.step()
    rec.close()
    results = [eng.result(r, timeout=0) for r in rids]
    return restart_mod.read_restarts(str(logs)), results, \
        spans_mod.read_spans(rec.path)


def test_engine_narrates_restarts_as_jax_does(lm, tmp_path):
    """The narrator's rows: the same event sequence, field names and
    payloads (restart ordinal, reason, inflight, queued) as the JAX
    engine's under the same plan, wall times aside; JAX's validator
    accepts the port's file; the results' statuses and attempts are
    equal."""
    (jspec, jp), (tspec, tp) = lm
    kw = dict(page_size=4, max_batch=2, engine_retries=1)
    jrows, jres, _ = _crash_run(
        lambda **a: JaxEngine(jspec, jp, **kw, **a), jfaults, jrestart,
        jspans, tmp_path / "jax")
    trows, tres, _ = _crash_run(
        lambda **a: DecodeEngine(tspec, tp, device="cpu", **kw, **a),
        tfaults, trestart, tspans, tmp_path / "torch")
    assert [r["event"] for r in trows] == ["engine_restart"] * 2
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    assert [{k: v for k, v in r.items() if k != "t"} for r in trows] == \
        [{k: v for k, v in r.items() if k != "t"} for r in jrows]
    assert jschema.validate_restart_file(
        str(tmp_path / "torch" / "restarts.jsonl")) == []
    assert [(r["status"], r.get("attempts")) for r in tres] == \
        [(r["status"], r.get("attempts")) for r in jres]


def test_submit_attempts_offsets_the_budget_as_jax_does(lm, tmp_path):
    """A request submitted with attempts=1 (a failover) survives one
    crash under engine_retries=1 and fails at the second with attempts
    3 — in both engines, with equal requeue/failed spans."""
    (jspec, jp), (tspec, tp) = lm
    kw = dict(page_size=4, max_batch=2, engine_retries=1)

    def run(make, faults_mod, spans_mod, logs):
        rec = spans_mod.SpanRecorder(str(logs))
        eng = make(recorder=rec,
                   faults=faults_mod.FaultPlan(crash_at_ticks=(1, 2, 3)))
        a = eng.submit([3, 1, 4, 1], 6, attempts=1)
        b = eng.submit([5, 9, 2], 6)
        eng.run_until_idle()
        eng.step()
        rec.close()
        rows = [(r["event"], r.get("rid"), r.get("attempt"),
                 r.get("attempts"))
                for r in spans_mod.read_spans(rec.path)
                if r["event"] in ("requeue", "failed")]
        return [eng.result(a, timeout=0)["status"],
                eng.result(a, timeout=0).get("attempts"),
                eng.result(b, timeout=0)["status"]], rows

    want = run(lambda **a: JaxEngine(jspec, jp, **kw, **a), jfaults,
               jspans, tmp_path / "jax")
    got = run(lambda **a: DecodeEngine(tspec, tp, device="cpu", **kw, **a),
              tfaults, tspans, tmp_path / "torch")
    assert got == want
    assert got[0][:2] == ["failed", 3]


def test_submit_fingerprint_rides_the_submit_span_as_in_jax(lm, tmp_path):
    """A passed fingerprint replaces the computed one on the submit span
    (a replay's recorded chain), and without one the engine computes
    the prompt's: the same rows in both engines."""
    (jspec, jp), (tspec, tp) = lm
    out = []
    for make, spans_mod, tag in (
            (lambda r: JaxEngine(jspec, jp, page_size=4, max_batch=2,
                                 recorder=r), jspans, "jax"),
            (lambda r: DecodeEngine(tspec, tp, page_size=4, max_batch=2,
                                    recorder=r, device="cpu"), tspans,
             "torch")):
        rec = spans_mod.SpanRecorder(str(tmp_path / tag))
        eng = make(rec)
        eng.submit(list(range(1, 20)), 2, fingerprint=["aa", "bb"])
        eng.submit(list(range(1, 20)), 2)
        rec.close()
        out.append([r["fingerprint"] for r in spans_mod.read_spans(rec.path)
                    if r["event"] == "submit"])
    assert out[0] == out[1]
    assert out[1][0] == ["aa", "bb"] and len(out[1][1]) == 2


def test_waiting_rids_and_fast_burn_read_as_in_jax(lm, tmp_path):
    """Before any tick every submit is waiting; fast_burn is None
    without a recorder and the recorder's fold with one — the same
    numbers in both engines over the same requests."""
    (jspec, jp), (tspec, tp) = lm
    out = []
    for make, spans_mod, tag in (
            (lambda **a: JaxEngine(jspec, jp, page_size=4, max_batch=2,
                                   **a), jspans, "jax"),
            (lambda **a: DecodeEngine(tspec, tp, page_size=4, max_batch=2,
                                      device="cpu", **a), tspans, "torch")):
        bare = make()
        rids = [bare.submit([1, 2, 3], 2) for _ in range(3)]
        waiting = bare.waiting_rids()
        burn0 = bare.fast_burn()
        rec = spans_mod.SpanRecorder(str(tmp_path / tag))
        traced = make(recorder=rec)
        for _ in range(3):
            traced.submit([1, 2, 3], 2, deadline_ms=0.001)
        traced.run_until_idle()
        traced.step()
        burn = traced.fast_burn()
        rec.close()
        out.append((rids == waiting, burn0, burn))
    assert out[0] == out[1]
    assert out[1][0] and out[1][1] is None and out[1][2] > 0


@pytest.mark.parametrize("flag,value", [("--decode_page_size", "0"),
                                        ("--decode_page_size", "-3"),
                                        ("--decode_max_batch", "0"),
                                        ("--decode_max_batch", "-3")])
def test_depth_flags_exit_2_at_parse_in_both_clis(flag, value, capsys):
    """A page size or batch below 1 is refused by argparse (exit 2,
    "depth ... must be >= 1") before any model is built, in both
    CLIs."""
    argv = ["--serve_port=1", "--model=transformer", "--objective=lm",
            f"{flag}={value}"]
    for main in (jcli.main, lambda a: tcli.main(a + ["--device=cpu"])):
        with pytest.raises(SystemExit) as err:
            main(argv)
        assert err.value.code == 2
        assert f"depth {value} must be >= 1" in capsys.readouterr().err


def test_one_engine_cli_arms_the_narrator(tmp_path):
    """``--engine_retries 1``: the served engine carries a narrator on
    ``<logs_path>/restarts.jsonl``; without the flag it carries none."""
    from distributed_tensorflow_example_tpu_torch import config

    flags = ["--model=transformer", "--objective=lm", "--input_size=32",
             "--vocab_size=50", "--d_model=32", "--n_heads=2",
             "--num_blocks=2", "--d_ff=64", "--device=cpu",
             f"--logs_path={tmp_path}"]
    eng = tcli.build_engine(config.parse_config(flags
                                                + ["--engine_retries=1"]))
    assert eng.restart_narrator.path == str(tmp_path / "restarts.jsonl")
    eng.restart_narrator.emit("engine_restart", restart=1, reason="x",
                              inflight=0, queued=0)
    with open(eng.restart_narrator.path) as f:
        assert json.loads(f.readline())["event"] == "engine_restart"
    assert tcli.build_engine(config.parse_config(flags)).restart_narrator \
        is None

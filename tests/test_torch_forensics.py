"""The port trainer's failure forensics (``obs/{anomaly,flight,tracer}``,
``--on_anomaly``, ``--flight``, ``--profile_steps``, the run-start
signal hygiene) against the JAX package's, on the CPU.

- ``LossWatchdog``/``AnomalyPolicy`` on ``tests/test_forensics.py``'s
  vectors give JAX's verdicts, counters and records;
  ``parse_profile_steps`` JAX's values and refusals; ``WindowedTracer``
  over a stub profiler JAX's start/stop/annotation sequence.
- The flight recorder: the port's dumps are valid under JAX's
  ``validate_flight_dump`` and collate as JAX's collate the same dumps;
  the excepthook and SIGUSR1 handlers chain with the SIGTERM handler of
  ``resilience/signals.py`` in either install order.
- The trainer: ``skip`` under the blow-up (``--learning_rate=1e30
  --naive_ce``) gives JAX's ``anomalies``, ``skipped_steps`` and
  ``steps`` and its final params (1e-5 of scale, f32); ``halt`` JAX's
  ``reason``, ``last_step`` and blame keys, on the host path even from
  the default fast loop; a crash mid-window dumps and stops the trace
  once; a real ``torch.profiler`` window writes a Chrome trace with the
  ``TRACE_SCOPES`` ranges; the run-start cleanup leaves the files JAX's
  leaves; ``--debug_nans`` raises ``FloatingPointError``.
"""

import contextlib
import dataclasses
import io
import json
import os
import signal
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.obs import anomaly as janomaly
from distributed_tensorflow_example_tpu.obs import flight as jflight
from distributed_tensorflow_example_tpu.obs import schema as jschema
from distributed_tensorflow_example_tpu.obs import tracer as jtracer
from distributed_tensorflow_example_tpu.train import loop as jloop
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch.obs import anomaly as tanomaly
from distributed_tensorflow_example_tpu_torch.obs import buckets as tbuckets
from distributed_tensorflow_example_tpu_torch.obs import flight as tflight
from distributed_tensorflow_example_tpu_torch.obs import schema as tschema
from distributed_tensorflow_example_tpu_torch.obs import tracer as ttracer
from distributed_tensorflow_example_tpu_torch.parallel import step as tstep
from distributed_tensorflow_example_tpu_torch.resilience import (
    signals as tsignals)
from distributed_tensorflow_example_tpu_torch.train import loop as tloop

from test_torch_monitoring import run_both

# one intra-op thread: the suite runs six test workers (and the rank
# processes) on the machine's cores, where torch would start one a core
torch.set_num_threads(1)


class StubProfiler:
    """Records the windowing contract instead of tracing (the stub of
    ``tests/test_forensics.py``)."""

    def __init__(self, raise_on_stop: bool = False):
        self.starts, self.stops, self.events = [], 0, []
        self._raise_on_stop = raise_on_stop

    def start_trace(self, d):
        self.starts.append(d)
        self.events.append(("start", d))

    def stop_trace(self):
        self.stops += 1
        self.events.append(("stop", None))
        if self._raise_on_stop:
            raise RuntimeError("synthetic corrupt-trace failure")

    def _scope(self, label):
        events = self.events

        class _S:
            def __enter__(self):
                events.append(("enter", label))

            def __exit__(self, *exc):
                events.append(("exit", label))
                return False

        return _S()

    def StepTraceAnnotation(self, name, step_num=None):
        return self._scope(f"{name}:{step_num}")

    def TraceAnnotation(self, name):
        return self._scope(name)


class _StubFlight:
    def __init__(self):
        self.anomalies, self.dumps = [], []

    def record_anomaly(self, step, **fields):
        self.anomalies.append(dict(step=step, **fields))

    def dump(self, reason, exc=None):
        self.dumps.append(reason)
        return "/dev/null"


# ---------------------------------------------------------------------------
# obs/anomaly
# ---------------------------------------------------------------------------


def _watchdog_trace(mod):
    out = []
    w = mod.LossWatchdog(factor=10.0, warmup=3)
    for step, loss in enumerate([float("nan"), float("inf"), 2.0, 2.0, 2.0,
                                 2.0, 2.1, 50.0, 2.0, None, "x", 1e9]):
        out.append(w.observe(step, loss))
    out.append(round(w.ema, 12))
    w2 = mod.LossWatchdog(factor=2.0, warmup=50)
    out += [w2.observe(i, v) for i, v in enumerate([1.0, 30.0, 0.1, 500.0])]
    with pytest.raises(ValueError):
        mod.LossWatchdog(factor=1.0)
    return out


def _policy_trace(mod):
    out = []
    for mode in ("halt", "dump", "skip"):
        fl = _StubFlight()
        p = mod.AnomalyPolicy(mode, leaf_names=["['W1']", "['b1']"],
                              flight=fl, max_dump_writes=2,
                              watchdog=mod.LossWatchdog(warmup=2))
        for step, (loss, flagged, counts) in enumerate([
                (1.0, False, None), (1.1, False, None),
                (float("nan"), True, np.array([7, 0])),
                (float("nan"), True, np.array([0, 0])),
                (300.0, False, None), (float("nan"), True,
                                       np.array([1, 2]))], 1):
            try:
                out.append(p.on_step(step, loss=loss, flagged=flagged,
                                     counts=counts))
            except mod.AnomalyError as e:
                out.append(("halt", str(e)))
        costs = np.array([1.0, 2.0, float("nan"), 1.5, float("inf"), 40.0])
        out.append(p.on_epoch(0, costs, base_step=100) if mode != "halt"
                   else None)
        out.append((p.summary(), fl.dumps,
                    [{k: v for k, v in a.items() if k != "t"}
                     for a in fl.anomalies]))
    for bad in ("explode", ""):
        with pytest.raises(ValueError):
            mod.AnomalyPolicy(bad)
    return out


def test_anomaly_policy_and_watchdog_equal_jax():
    assert tanomaly.POLICIES == janomaly.POLICIES
    assert _watchdog_trace(tanomaly) == _watchdog_trace(janomaly)
    assert repr(_policy_trace(tanomaly)) == repr(_policy_trace(janomaly))


# ---------------------------------------------------------------------------
# obs/tracer
# ---------------------------------------------------------------------------


def test_parse_profile_steps_equal_jax():
    for s in ("", None, "500:20", "0:1"):
        assert ttracer.parse_profile_steps(s) == jtracer.parse_profile_steps(s)
    for bad in ("20", "a:b", "5:0", "-1:5", "1:2:3"):
        for mod in (ttracer, jtracer):
            with pytest.raises(ValueError) as e:
                mod.parse_profile_steps(bad)
            if mod is ttracer:
                msg = str(e.value)
            else:
                assert str(e.value) == msg


def _drive(mod, tmp, script, **kw):
    """One scripted tracer session over a stub profiler: its events, the
    boundaries it signalled and its window count."""
    prof = StubProfiler(raise_on_stop=kw.pop("raise_on_stop", False))
    tr = mod.WindowedTracer(str(tmp), profiler=prof, **kw)
    edges = []
    tr.begin_run()
    for kind, arg in script:
        if kind == "step":
            if tr.boundary(arg):
                edges.append(arg)
            tr.on_step(arg)
            with tr.step_annotation(arg), tr.annotate("dispatch"):
                pass
        elif kind == "range":
            tr.on_range(*arg)
        elif kind == "scope":
            with tr.annotate(arg):
                pass
    tr.stop()
    tr.stop()
    return prof.events, edges, tr.windows_captured


TRACER_CASES = {
    "window": dict(window=(5, 3)),
    "whole_run": dict(whole_run=True),
    "disabled": dict(window=(0, 5), enabled=False),
    "crash_mid_window": dict(window=(1, 100), raise_on_stop=True),
}


@pytest.mark.parametrize("case", sorted(TRACER_CASES))
def test_windowed_tracer_contract_equals_jax(case, tmp_path):
    script = [("step", s) for s in range(12)] + [("scope", "eval")]
    if case == "window":
        script += [("range", (r * 10, r * 10 + 10)) for r in range(4)]
    kw = TRACER_CASES[case]
    got = _drive(ttracer, tmp_path, script, **dict(kw))
    want = _drive(jtracer, tmp_path, script, **dict(kw))
    assert got == want
    if case == "window":
        assert got[1] == [5, 8] and got[2] == 1
    fast = [("range", (r * 10, r * 10 + 10)) for r in range(4)]
    assert _drive(ttracer, tmp_path, fast, window=(15, 5)) == _drive(
        jtracer, tmp_path, fast, window=(15, 5))
    with pytest.raises(ValueError, match="unknown trace scope"):
        ttracer.WindowedTracer(str(tmp_path)).annotate("bogus")
    assert set(tbuckets.TRACE_SCOPES) == {
        "data_wait", "h2d", "dispatch", "device_wait", "ckpt", "eval",
        "checkpoint"}


def test_torch_profiler_window_writes_a_chrome_trace(tmp_path):
    """The real backend on the CPU: a window exports a Chrome trace
    before it counts, holding the step and TRACE_SCOPES ranges."""
    tr = ttracer.WindowedTracer(str(tmp_path), window=(1, 2))
    x = torch.ones(8, 8)
    for step in range(4):
        tr.on_step(step)
        with tr.step_annotation(step):
            for name in ("data_wait", "dispatch"):
                with tr.annotate(name):
                    x = x @ x / 8
    tr.stop()
    assert tr.windows_captured == 1
    path = os.path.join(str(tmp_path), "profile", "trace.0.json")
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"train#1", "train#2", "data_wait", "dispatch"} <= names
    assert "train#0" not in names and "train#3" not in names


# ---------------------------------------------------------------------------
# obs/flight
# ---------------------------------------------------------------------------


def _record(mod, tmp, proc, last, reason, exc=None):
    fr = mod.FlightRecorder(str(tmp), proc, capacity=4, window_capacity=2,
                            config={"seed": 1})
    for i in range(last - 9, last + 1):
        fr.record_step(i, epoch=0, batch_index=i, cost=float("nan"))
    fr.record_window(last, cost=1.5, timing={"steps": 4})
    fr.attach_loss(last - 1, 2.25)
    if proc == 1:
        fr.record_anomaly(last - 2, reasons=["divergence"], policy="halt",
                          loss=float("inf"))
    return fr.dump(reason, exc=exc)


def test_flight_dumps_and_collate_equal_jax(tmp_path):
    try:
        raise RuntimeError("mid-step boom")
    except RuntimeError as e:
        exc = e
    docs, reports = {}, {}
    for side, mod in (("t", tflight), ("j", jflight)):
        for proc, last, reason in ((0, 120, "crash"), (1, 90, "sigusr1")):
            path = _record(mod, tmp_path / side, proc, last, reason, exc)
            docs[side, proc] = mod.read_flight(path)
        reports[side] = mod.collate(str(tmp_path / side))
    for proc in (0, 1):
        t, j = docs["t", proc], docs["j", proc]
        assert jschema.validate_flight_dump(t) == []
        assert tschema.validate_flight_dump(t) == []
        assert tschema.validate_flight_dump(j) == []
        for key in ("version", "proc", "reason", "last_step"):
            assert t[key] == j[key]
        strip = (lambda recs: [{k: v for k, v in r.items() if k != "t"}
                               for r in recs])
        for key in ("steps", "windows", "anomalies"):
            assert strip(t[key]) == strip(j[key])
        assert t["exception"]["type"] == "RuntimeError"
        assert t["env"]["config"] == {"seed": 1} and "torch" in t["env"]
        assert "jax" not in t["env"]
    strip_t = (lambda r: {k: v for k, v in r.items() if k != "t"})
    assert strip_t(reports["t"]) | {"procs": None, "anomalies": None} == \
        strip_t(reports["j"]) | {"procs": None, "anomalies": None}
    assert strip(reports["t"]["anomalies"]) == strip(
        reports["j"]["anomalies"])
    assert {p: strip_t(v) for p, v in reports["t"]["procs"].items()} == {
        p: strip_t(v) for p, v in reports["j"]["procs"].items()}
    assert reports["t"]["step_spread"] == 30
    assert tflight.collate(str(tmp_path / "none"))["proc_count"] == 0
    assert tschema.validate_flight_file(
        os.path.join(str(tmp_path / "t"), "flight", "0.json")) == []


@pytest.mark.parametrize("order", ["flight_first", "preempt_first"])
def test_flight_hooks_chain_with_the_preemption_handler(tmp_path, order):
    """The excepthook and SIGUSR1 hooks and the SIGTERM handler installed
    in either order: SIGUSR1 dumps (and calls the handler it found),
    SIGTERM still reaches the preemption handler, an unhandled exception
    dumps and still reaches the previous excepthook, and uninstalling
    restores every handler."""
    prev = {s: signal.getsignal(s) for s in (signal.SIGUSR1,
                                              signal.SIGTERM)}
    hook = sys.excepthook
    usr1 = []
    signal.signal(signal.SIGUSR1, lambda s, f: usr1.append(s))
    before_usr1 = signal.getsignal(signal.SIGUSR1)
    seen = []
    sys.excepthook = lambda *a: seen.append(a[0])
    fr = tflight.FlightRecorder(str(tmp_path), 0, capacity=4)
    fr.record_step(7)
    ph = tsignals.PreemptionHandler()
    try:
        for obj in ((fr, ph) if order == "flight_first" else (ph, fr)):
            obj.install()
        os.kill(os.getpid(), signal.SIGUSR1)
        doc = tflight.read_flight(fr.path)
        assert doc["reason"] == "sigusr1" and usr1 == [signal.SIGUSR1]
        assert os.path.exists(fr.stacks_path)
        os.kill(os.getpid(), signal.SIGTERM)
        assert ph.requested and ph.signum == signal.SIGTERM
        try:
            raise ValueError("unhandled")
        except ValueError:
            sys.excepthook(*sys.exc_info())
        assert tflight.read_flight(fr.path)["reason"] == "crash"
        assert seen == [ValueError]
    finally:
        for obj in ((ph, fr) if order == "flight_first" else (fr, ph)):
            obj.uninstall()
        sys.excepthook = hook
    assert signal.getsignal(signal.SIGUSR1) is before_usr1
    assert signal.getsignal(signal.SIGTERM) == prev[signal.SIGTERM]
    signal.signal(signal.SIGUSR1, prev[signal.SIGUSR1])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

BLOWUP = dict(training_epochs=1, batch_size=16, hidden_sizes=(16,),
              learning_rate=1e30, naive_ce=True, frequency=5, seed=3,
              summaries=False)


def _halt(tmp, pkg):
    """One halt run of either package (default fast loop, 3 epochs):
    its flight dump and report."""
    kw = dict(BLOWUP, on_anomaly="halt", training_epochs=3,
              dataset="synthetic", synthetic_train_size=160,
              synthetic_test_size=32, logs_path=str(tmp))
    cfg = (jconfig.Config(**kw, compilation_cache="", data_parallel=1)
           if pkg == "jax" else tconfig.Config(**kw, device="cpu"))
    run = jloop.run if pkg == "jax" else tloop.run
    err = janomaly.AnomalyError if pkg == "jax" else tanomaly.AnomalyError
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(err):
            run(cfg)
    doc = tflight.read_flight(os.path.join(str(tmp), "flight", "0.json"))
    rep = json.load(open(os.path.join(str(tmp), "flight", "report.json")))
    return doc, rep


def test_skip_blowup_matches_jax(tmp_path_factory):
    """Host path and fast path under ``--on_anomaly=skip`` with the
    blow-up: JAX's anomalies, skipped steps and steps, and final params
    within 1e-5 of JAX's scale (f32; the masked steps keep the params
    the first step made), every one finite."""
    from test_torch_monitoring import _close

    tmp = tmp_path_factory.mktemp("skip")
    for name, extra in (("host", dict(fast_loop=False, metrics=True,
                                      log_every=5)), ("fast", {})):
        both = run_both(tmp / name, dict(BLOWUP, on_anomaly="skip",
                                         **extra),
                        train_size=160, test_size=32, ckpt=True)
        t, j = both["torch"][0], both["jax"][0]
        for key in ("anomalies", "skipped_steps", "steps", "fast_loop"):
            assert t[key] == j[key], (name, key, t[key], j[key])
        assert t["skipped_steps"] >= 1 and t["steps"] == 10
        assert t["fast_loop"] is (name == "fast")
        got, want = (np.load(os.path.join(both[side][2].checkpoint_dir,
                                          "ckpt-00000010.npz"))
                     for side in ("torch", "jax"))
        keys = [k for k in want.files if k.startswith(".params")]
        assert keys and sorted(keys) == sorted(
            k for k in got.files if k.startswith(".params"))
        for k in keys:
            assert np.isfinite(got[k]).all(), k
            _close(got[k], want[k], 1e-5, k)
        if name == "host":
            path = os.path.join(both["torch"][2].logs_path,
                                "metrics.0.jsonl")
            rows = [json.loads(ln) for ln in open(path)]
            assert sum(r.get("event") == "anomaly" for r in rows) \
                == t["anomalies"]
            assert tschema.validate_metrics_file(path) == []


def test_halt_matches_jax_on_the_host_path(tmp_path):
    """``halt`` from the default fast loop takes the host path in both
    packages, stops inside epoch 0 and leaves a valid dump with JAX's
    reason, last step and blame keys, and the chief's report."""
    got, t_rep = _halt(tmp_path / "t", "torch")
    want, j_rep = _halt(tmp_path / "j", "jax")
    assert jschema.validate_flight_dump(got) == []
    assert got["reason"] == want["reason"] == "anomaly_halt"
    assert got["exception"]["type"] == "AnomalyError"
    assert got["last_step"] == want["last_step"] < 10
    assert [sorted(a["blame"]) for a in got["anomalies"]] == \
        [sorted(a["blame"]) for a in want["anomalies"]]
    assert all(k.startswith("[") for a in got["anomalies"]
               for k in a["blame"])
    assert any("loss" in r for r in got["steps"])
    assert t_rep["procs"]["0"]["reason"] == j_rep["procs"]["0"]["reason"]


def test_crash_mid_step_dumps_flight_and_stops_the_trace(tmp_path,
                                                         monkeypatch):
    """An exception on the 4th step inside an open profile window: the
    flight dump carries it with the three completed steps, and the
    window was stopped exactly once (stub profiler)."""
    prof = StubProfiler()
    monkeypatch.setattr(ttracer, "TorchProfiler", lambda: prof)
    real = tstep.make_sync_step_body

    def crashing(*a, **k):
        body, calls = real(*a, **k), {"n": 0}

        def step(*sa, **sk):
            calls["n"] += 1
            if calls["n"] == 4:
                raise RuntimeError("injected mid-step crash")
            return body(*sa, **sk)
        return step

    monkeypatch.setattr(tstep, "make_sync_step_body", crashing)
    cfg = tconfig.Config(training_epochs=1, batch_size=16, hidden_sizes=(8,),
                         dataset="synthetic", synthetic_train_size=160,
                         synthetic_test_size=32, frequency=5,
                         summaries=False, fast_loop=False, flight=True,
                         profile_steps="2:50", device="cpu",
                         logs_path=str(tmp_path))
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(RuntimeError, match="injected"):
            tloop.run(cfg)
    doc = tflight.read_flight(os.path.join(str(tmp_path), "flight",
                                           "0.json"))
    assert jschema.validate_flight_dump(doc) == []
    assert doc["reason"] == "crash" and doc["last_step"] == 3
    assert "injected mid-step crash" in doc["exception"]["message"]
    assert len(prof.starts) == 1 and prof.stops == 1


def test_profile_window_on_the_host_path(tmp_path, monkeypatch):
    """``--profile_steps 3:2`` on a 10-step host run: one window, the
    step ranges of steps 3 and 4 only, closed before eval."""
    prof = StubProfiler()
    monkeypatch.setattr(ttracer, "TorchProfiler", lambda: prof)
    cfg = tconfig.Config(training_epochs=1, batch_size=16, hidden_sizes=(8,),
                         dataset="synthetic", synthetic_train_size=160,
                         synthetic_test_size=32, frequency=5,
                         summaries=False, fast_loop=False,
                         profile_steps="3:2", device="cpu",
                         logs_path=str(tmp_path))
    with contextlib.redirect_stdout(io.StringIO()):
        res = tloop.run(cfg)
    assert len(prof.starts) == 1 and prof.stops == 1
    assert res["profile_windows"] == 1
    ev = prof.events
    assert ev.index(("start", prof.starts[0])) < ev.index(("enter",
                                                           "train:3"))
    assert ev.index(("exit", "train:4")) < ev.index(("stop", None))
    assert ("enter", "train:5") not in ev and ("enter", "eval") not in ev
    assert ("enter", "dispatch") in ev and ("enter", "h2d") in ev


def _stale_logs(d):
    os.makedirs(os.path.join(d, "flight"), exist_ok=True)
    for name in ("heartbeat.0", "heartbeat.3"):
        with open(os.path.join(d, name), "w") as f:
            json.dump({"proc": int(name[-1]), "step": 5, "t": 1.0}, f)
    for proc, reason in ((0, "crash"), (1, "sigterm")):
        with open(os.path.join(d, "flight", f"{proc}.json"), "w") as f:
            json.dump({"reason": reason}, f)
    with open(os.path.join(d, "flight", "report.json"), "w") as f:
        json.dump({}, f)


def _left(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _ds, fs in os.walk(d) for f in fs
                  if f.startswith("heartbeat") or r.endswith("flight"))


@pytest.mark.parametrize("flags", [dict(resume="latest"),
                                   dict(metrics=True),
                                   dict(metrics=True, resume="latest")],
                         ids=["resume_only", "metrics", "metrics_resume"])
def test_run_start_cleanup_matches_jax(tmp_path, flags):
    """A reused logs_path with an older run's heartbeats and flight
    dumps: a ``--resume`` with no monitoring flag touches none (the
    port cleaned them before this slice), a fresh ``--metrics`` run
    clears them all, a resuming one keeps the heartbeats and the
    preemption dump — the files left are JAX's."""
    left = {}
    for side in ("jax", "torch"):
        d = str(tmp_path / side)
        _stale_logs(d)
        kw = dict(training_epochs=1, batch_size=20, hidden_sizes=(8,),
                  dataset="synthetic", fast_loop=False,
                  synthetic_train_size=40, synthetic_test_size=10,
                  summaries=False, logs_path=d,
                  checkpoint_dir=str(tmp_path / f"ckpt_{side}"), **flags)
        cfg = (jconfig.Config(**kw, compilation_cache="", data_parallel=1)
               if side == "jax" else tconfig.Config(**kw, device="cpu"))
        with contextlib.redirect_stdout(io.StringIO()):
            (jloop.run if side == "jax" else tloop.run)(cfg)
        left[side] = _left(d)
    assert left["torch"] == left["jax"]
    if flags == dict(resume="latest"):
        assert "heartbeat.3" in left["torch"]
        assert os.path.join("flight", "0.json") in left["torch"]


def test_debug_nans_stops_at_the_first_nonfinite_step(tmp_path):
    """``--debug_nans`` takes the host path and raises
    ``FloatingPointError`` at the blow-up's first non-finite step; it
    refuses to combine with ``--on_anomaly`` as JAX does."""
    cfg = tconfig.Config(**BLOWUP, debug_nans=True, dataset="synthetic",
                         synthetic_train_size=160, synthetic_test_size=32,
                         device="cpu", logs_path=str(tmp_path))
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(FloatingPointError, match="step 2"):
            tloop.run(cfg)
    bad = dataclasses.replace(cfg, on_anomaly="halt")
    with pytest.raises(ValueError, match="debug_nans"):
        tloop.run(bad)


def test_chip_smoke_monitoring_phase_rehearses_on_cpu():
    """``chip_smoke.py``'s phase 5c rehearsed on the CPU at narrow widths
    (784-16-10 relu under --pallas, batch 50, 8 steps; a 1-block
    transformer): the monitored fast run bitwise the plain one, polled
    live, the blow-up skipped and halted inside the epoch, a Chrome
    trace with the step and eval ranges.  The counters stay 0: CPU
    tensors take the plain versions."""
    import chip_smoke

    flags = ["--hidden_sizes=16", "--activation=relu", "--pallas",
             "--batch_size=50", "--dataset=synthetic",
             "--synthetic_train_size=400", "--synthetic_test_size=100",
             "--training_epochs=1", "--no_summaries", "--frequency=1",
             "--seed=1"]
    tfm = ["--model=transformer", "--attention=flash", "--causal",
           "--fused_ln", "--input_size=64", "--seq_len=16", "--d_model=32",
           "--n_heads=2", "--num_blocks=1", "--d_ff=64", "--optimizer=adam",
           "--batch_size=4", "--dataset=synthetic",
           "--synthetic_train_size=16", "--synthetic_test_size=4",
           "--no_summaries", "--frequency=1", "--training_epochs=1"]
    with contextlib.redirect_stdout(io.StringIO()):
        res = chip_smoke.phase_monitoring("cpu", {"mlp_forward": 0},
                                          flags=flags, tfm_flags=tfm,
                                          device="cpu")
    assert res["skipped"] >= 1 and res["first_flagged"] >= 1
    assert res["first_flagged"] <= res["halt_step"] < 8
    assert set(res["counts"].values()) == {0}
    assert res["mfu"] is None and res["tfm_mfu"] == [None]


BAD_FLAGS = [dict(profile_steps="oops"), dict(profile_steps="5:0"),
             dict(profile=True, profile_steps="5:2"),
             dict(on_anomaly="explode"), dict(flight=True, flight_steps=0),
             dict(on_anomaly="halt", anomaly_factor=1.0),
             dict(log_every=0), dict(status_port=-1),
             dict(early_stop_patience=-1),
             dict(histograms=True, summaries=False)]


@pytest.mark.parametrize("kw", BAD_FLAGS, ids=lambda kw: ",".join(kw))
def test_monitoring_flags_refused_with_jax_messages(kw):
    with pytest.raises(ValueError) as want:
        jloop.run(jconfig.Config(**kw))
    with pytest.raises(ValueError) as got:
        tloop.run(tconfig.Config(**kw, device="cpu"))
    assert str(got.value) == str(want.value)


def test_profile_port_is_refused_for_good(capsys):
    """``--profile_port`` exits 2 at parse, its help says why; the
    monitoring flags parse to JAX's values."""
    from distributed_tensorflow_example_tpu_torch import main as tmain

    with pytest.raises(SystemExit) as e:
        tmain.main(["--device=cpu", "--profile_port=9012"])
    assert e.value.code == 2
    assert "no PyTorch counterpart" in capsys.readouterr().err
    helps = {a.dest: a.help for a in
             tconfig.build_train_parser()._actions}
    assert "refused" in helps["profile_port"]
    argv = ["--metrics", "--log_every=7", "--flight", "--flight_steps=9",
            "--on_anomaly=dump", "--anomaly_factor=4", "--status_port=81",
            "--status_cache_s=2", "--histograms", "--profile_steps=3:4",
            "--early_stop_patience=2"]
    t = tconfig.parse_train_config(argv)
    j = jconfig.parse_config(argv)
    for f in ("metrics", "log_every", "flight", "flight_steps", "on_anomaly",
              "anomaly_factor", "status_port", "status_cache_s",
              "histograms", "profile", "profile_steps", "profile_port",
              "early_stop_patience", "debug_nans"):
        assert getattr(t, f) == getattr(j, f), f
    assert tconfig.Config().on_anomaly == jconfig.Config().on_anomaly

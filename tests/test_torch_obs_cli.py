"""The port's ``dtx-obs`` (``obs/{cli,compare,history,drift,capacity}``
and the rest of ``obs/schema``) against the JAX package's, on the CPU.

One module fixture writes small logs with the port on the CPU: two MLP
trainer runs under ``--metrics --flight`` (one clean, one blown up under
``--on_anomaly=dump``: anomaly events and a flight dump), one engine's
span stream with a crash and its restart row, a two-replica fleet
behind the router, a workload captured from the engine's stream and a
``replay_sim`` stream stamped with it, and a bench history with a
planted level shift.

- Every subcommand of JAX's ``obs/cli.main`` and the port's, run on the
  same inputs and arguments (``tail -f`` and ``serve`` in a thread the
  test stops, through the CLI module's ``time``), gives the same exit
  code, the same stdout and stderr (JSON parsed, the fields of
  ``WALL_CLOCK`` dropped) and the same files written.
- Both parsers take the same subcommands and flags.
- Each package's validators accept the other's history and drift
  documents, and a version-9 document gets JAX's diagnosis in both.
- ``compare`` reads every documented shape as JAX does, from files
  built here; ``poll_new_lines`` follows appends, torn lines,
  truncation and rotation as JAX's does; ``drift`` names JAX's first
  offending row; ``capacity`` gives JAX's forecast and verdict and a
  null roofline on the CPU.
"""

import argparse
import contextlib
import io
import json
import os
import shutil
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.obs import capacity as jcap
from distributed_tensorflow_example_tpu.obs import cli as jcli
from distributed_tensorflow_example_tpu.obs import compare as jcmp
from distributed_tensorflow_example_tpu.obs import drift as jdrift
from distributed_tensorflow_example_tpu.obs import history as jhist
from distributed_tensorflow_example_tpu.obs import schema as jschema
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_example_tpu_torch.obs import aggregate as tagg
from distributed_tensorflow_example_tpu_torch.obs import capacity as tcap
from distributed_tensorflow_example_tpu_torch.obs import cli as tcli
from distributed_tensorflow_example_tpu_torch.obs import compare as tcmp
from distributed_tensorflow_example_tpu_torch.obs import drift as tdrift
from distributed_tensorflow_example_tpu_torch.obs import history as thist
from distributed_tensorflow_example_tpu_torch.obs import schema as tschema
from distributed_tensorflow_example_tpu_torch.obs import spans as tspans
from distributed_tensorflow_example_tpu_torch.obs import workload as twl
from distributed_tensorflow_example_tpu_torch.resilience import (
    restart as trestart)
from distributed_tensorflow_example_tpu_torch.serving import replay as trp
from distributed_tensorflow_example_tpu_torch.serving import cli as tserve_cli
from distributed_tensorflow_example_tpu_torch.serving import router as trt
from distributed_tensorflow_example_tpu_torch.serving.engine import (
    DecodeEngine)
from distributed_tensorflow_example_tpu_torch.serving.faults import FaultPlan
from distributed_tensorflow_example_tpu_torch.train import loop as tloop

# one intra-op thread: the suite runs six test workers on the cores
torch.set_num_threads(1)

# the only fields left out of a comparison: stamps of the wall clock at
# the moment a command runs (a document's generation time, /status's
# "t", a heartbeat's age and its gauge, a history entry appended now)
WALL_CLOCK = ("generated_t", "t", "heartbeat_age_s",
              "dtx_heartbeat_age_seconds")

_MLP = dict(training_epochs=2, batch_size=20, hidden_sizes=(16,),
            learning_rate=0.3, seed=3, metrics=True, log_every=2,
            flight=True, summaries=False, dataset="synthetic",
            synthetic_train_size=120, synthetic_test_size=40, device="cpu")
_BLOWUP = dict(learning_rate=1e30, naive_ce=True, on_anomaly="dump")
_LM = dict(input_size=32, num_classes=10, seq_len=32, d_model=32, n_heads=2,
           num_blocks=2, d_ff=64, objective="lm", vocab_size=50,
           causal=True)
# the bench history: wall_s shifts up ~24% (r03 a spike, then the level
# from r05), mfu drops ~24% at r06
_HIST = [("r01", 10.0, 0.40), ("r02", 10.2, 0.41), ("r03", 14.0, 0.40),
         ("r04", 9.9, 0.40), ("r05", 12.5, 0.41), ("r06", 12.6, 0.30),
         ("r07", 12.4, 0.31)]


def _write_history(path, rows):
    for i, (label, wall, mfu) in enumerate(rows):
        thist.append_entry(path, {"metric": "wall", "value": wall,
                                  "mfu": mfu}, label=label,
                           source="bench", t=1.0e9 + i)


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs")
    paths = {"root": str(root)}
    # the trainer: a clean run and a blow-up dumped to flight/0.json
    for name, kw in (("mlp", {}), ("blowup", _BLOWUP)):
        paths[name] = str(root / name)
        with contextlib.redirect_stdout(io.StringIO()):
            tloop.run(tconfig.Config(**dict(_MLP, **kw),
                                     logs_path=paths[name]))
    assert os.path.isfile(os.path.join(paths["blowup"], "flight", "0.json"))
    os.makedirs(root / "reports")
    for name in ("mlp", "blowup"):
        with open(root / "reports" / f"{name}.json", "w") as f:
            json.dump(tagg.aggregate(paths[name]), f)
    # one engine: six ragged requests, a crash at tick 2 restarted
    spec = ttfm.TransformerSpec(**_LM)
    params = ttfm.init(spec, seed=0, device="cpu")
    paths["serve"] = str(root / "serve")
    rec = tspans.SpanRecorder(paths["serve"])
    eng = DecodeEngine(spec, params, page_size=4, max_batch=2, seed=1,
                       engine_retries=1, recorder=rec,
                       faults=FaultPlan(crash_at_ticks=(2,)),
                       restart_narrator=trestart.RestartNarrator(
                           paths["serve"]), device="cpu")
    rng = np.random.RandomState(7)
    for n in (3, 6, 4, 8, 2, 5):
        eng.submit(rng.randint(0, 50, size=n).tolist(), 4)
    eng.run_until_idle()
    eng.step()
    rec.close()
    # two replicas behind the router, the requests placed before the
    # engines start; replica0 crashes at its first two tick boundaries,
    # past its one retry, so its requests fail over to replica1 (and
    # would complete on replica0 too: it crashes no more)
    paths["fleet"] = str(root / "fleet")
    recs = [tspans.SpanRecorder(os.path.join(paths["fleet"], f"replica{i}"))
            for i in range(2)]
    router_rec = tspans.SpanRecorder(os.path.join(paths["fleet"], "router"))
    fleet = [DecodeEngine(spec, params, page_size=4, max_batch=2, seed=5,
                          engine_retries=1, recorder=recs[i],
                          faults=FaultPlan(crash_at_ticks=(1, 2)
                                           if i == 0 else ()),
                          device="cpu") for i in range(2)]
    rt = trt.Router(fleet, fleet_retries=2, recorder=router_rec)
    rids = [rt.submit(rng.randint(0, 50, size=n).tolist(), 3)
            for n in (4, 7, 3, 5)]
    for e in fleet:
        e.start()
    try:
        results = [rt.result(r, timeout=120.0) for r in rids]
        tserve_cli.settle(fleet)
    finally:
        for e in fleet:
            e.stop()
        for r in recs + [router_rec]:
            r.close()
    assert all(r is not None and r["status"] == "result" for r in results)
    assert any(r.get("failovers") for r in results)
    # the engine's workload, and a replay_sim stream stamped with it
    paths["wl"] = str(root / "workload.json")
    doc = twl.capture(paths["serve"])
    twl.write_workload(doc, paths["wl"])
    paths["wid"] = doc["workload_id"]
    paths["replay"] = str(root / "replay")
    rrec = trp.replay_recorder(paths["replay"], doc["workload_id"])
    trp.replay_sim(doc, recorder=rrec)
    rrec.close()
    # the bench history and captures for --import / --capture
    paths["hist"] = str(root / "history.jsonl")
    _write_history(paths["hist"], _HIST)
    paths["hist_short"] = str(root / "short.jsonl")
    _write_history(paths["hist_short"], _HIST[:3])
    caps = root / "caps"
    os.makedirs(caps)
    for name, tail in (
            ("BENCH_r08", 'bench: noise\n{"metric": "wall", "value": 12.1,'
                          ' "mfu": 0.3}\n{"gate": "ok"}\n'),
            ("BENCH_r09", '{"metric": "wall", "value": 12.2, "mfu": 0.29}'),
            ("BENCH_bad", "no json here")):
        with open(caps / f"{name}.json", "w") as f:
            json.dump({"tail": tail}, f)
    with open(caps / "decode.json", "w") as f:
        json.dump({"decode_step_ms": 2.0, "decode_hbm_frac": 0.42,
                   "tokens_per_sec": 4000.0, "wall_s": 1.5}, f)
    with open(caps / "input_row.json", "w") as f:
        json.dump({"prefetch_step_ms": 2.0, "blocking_step_ms": 3.0,
                   "overlap_ratio": 1.5}, f)
    paths["caps"] = str(caps)
    # version-9 streams: a metrics row and a history entry
    os.makedirs(root / "v9")
    with open(root / "v9" / "metrics.0.jsonl", "w") as f:
        f.write(json.dumps({"kind": "event", "v": 9, "t": 1.0, "proc": 0,
                            "event": "run_start"}) + "\n")
    with open(root / "v9" / "old_history.jsonl", "w") as f:
        f.write(json.dumps({"v": 9, "kind": "bench_history", "t": 1.0,
                            "label": "r00", "source": "bench",
                            "metrics": {"wall_s": 1.0}}) + "\n")
    paths["v9"] = str(root / "v9")
    # what each side starts from where a command writes
    paths["seed"] = str(root / "seed")
    os.makedirs(paths["seed"])
    shutil.copy(paths["hist"], os.path.join(paths["seed"], "h.jsonl"))
    shutil.copytree(paths["blowup"], os.path.join(paths["seed"], "live"))
    return paths


def _drop(x):
    """``x`` without the WALL_CLOCK fields, at any depth."""
    if isinstance(x, dict):
        return {k: _drop(v) for k, v in x.items() if k not in WALL_CLOCK}
    if isinstance(x, list):
        return [_drop(v) for v in x]
    return x


def _gauge(line: str) -> str:
    """The metric a Prometheus text line is about (else its first
    word)."""
    if line.startswith(("# HELP ", "# TYPE ")):
        return line.split()[2]
    return line.split("{")[0].split(" ")[0]


def _parsed(text: str):
    """A command's output for comparison: one JSON document, JSON lines,
    or text lines (the lines of a WALL_CLOCK gauge dropped)."""
    try:
        return _drop(json.loads(text))
    except ValueError:
        pass
    lines = text.splitlines()
    try:
        return [_drop(json.loads(ln)) for ln in lines]
    except ValueError:
        return [ln for ln in lines if _gauge(ln) not in WALL_CLOCK]


class _Clock:
    """The CLI module's ``time`` while a follow or serve loop runs:
    ``sleep`` calls ``hook(n)`` (n = 1, 2, ...) instead of waiting, and
    raises KeyboardInterrupt, as ^C does, once the hook returns True."""

    def __init__(self, hook):
        self.hook, self.n = hook, 0

    def sleep(self, _s):
        self.n += 1
        if self.hook(self.n):
            raise KeyboardInterrupt


def _run(mod, argv, hook=None):
    """``mod.main(argv)`` in a thread with a bounded join: (rc, stdout,
    stderr)."""
    out, err, box = io.StringIO(), io.StringIO(), {}

    def target():
        try:
            box["rc"] = mod.main(argv)
        except SystemExit as e:        # argparse refusals
            box["rc"] = e.code
    with pytest.MonkeyPatch.context() as mp:
        if hook is not None:
            mp.setattr(mod, "time", _Clock(hook))
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            th = threading.Thread(target=target, daemon=True)
            th.start()
            th.join(timeout=60)
    assert not th.is_alive(), f"{argv} still running after 60 s"
    return box.get("rc"), out.getvalue(), err.getvalue()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _serve_hook(port, paths, answers):
    def hook(_n):
        for p in paths:
            code, body = _get(port, p)
            answers.append((p, code, _parsed(body)))
        return True
    return hook


_ROW = {"kind": "window", "v": 10, "t": 5.0, "proc": 0, "step": 100,
        "epoch": 9, "cost": 0.5, "path": "host", "steps": 2,
        "window_wall_s": 0.1, "step_time_p50_ms": 1.0,
        "step_time_p95_ms": 1.5, "step_time_max_ms": 2.0,
        "examples_per_sec": 100.0, "mfu": None}


def _follow_hook(path):
    """A live stream under ``tail -f``: a whole row and a torn one, the
    torn one completed, the file truncated to one row, then rotated
    away and replaced; then ^C."""
    def row(step):
        return json.dumps(dict(_ROW, step=step))

    def hook(n):
        if n == 1:
            with open(path, "a") as f:
                f.write(row(101) + "\n" + row(102)[:20])
        elif n == 2:
            with open(path, "a") as f:
                f.write(row(102)[20:] + "\n")
        elif n == 3:
            with open(path, "w") as f:
                f.write(row(103) + "\n")
        elif n == 4:
            os.rename(path, path + ".old")
            with open(path, "w") as f:
                f.write(row(104) + "\n" + row(105) + "\n")
        return n >= 5
    return hook


# (id, argv, rc); "{name}" is a fixture path, "{side}" a directory of the
# package's own that starts as a copy of the fixture's seed
CASES = [
    ("report", ["report", "{blowup}"], 0),
    ("report_summary", ["report", "{mlp}", "--summary"], 0),
    ("report_out", ["report", "{mlp}", "--compact", "-o",
                    "{side}/report.json"], 0),
    ("report_missing", ["report", "{root}/nope"], 2),
    ("compare", ["compare", "{mlp}", "{blowup}"], 3),
    ("compare_thresholds", ["compare", "{reports}/blowup.json",
                            "{reports}/mlp.json", "--compact",
                            "--thresholds", "wall_s=0.9,mfu=0.02"], None),
    ("compare_threshold_all", ["compare", "{reports}/mlp.json",
                               "{blowup}", "--threshold", "10"], 0),
    ("compare_unknown_metric", ["compare", "{mlp}", "{blowup}",
                                "--thresholds", "bogus=1"], 2),
    ("compare_no_overlap", ["compare", "{caps}/decode.json",
                            "{caps}/input_row.json"], 2),
    ("tail", ["tail", "{blowup}", "-n", "50"], 0),
    ("tail_rid", ["tail", "{serve}", "--rid", "1", "-n", "100"], 0),
    ("tail_workload", ["tail", "{replay}", "--workload", "{wid}"], 0),
    ("tail_follow", ["tail", "{side}/live", "-f", "-n", "3",
                     "--interval", "0"], 0),
    ("serve_run", ["serve", "{blowup}", "--host", "127.0.0.1", "--port",
                   "{port}", "--cache_s", "0"], 0),
    ("serve_spans", ["serve", "{serve}", "--host", "127.0.0.1", "--port",
                     "{port}"], 0),
    ("validate", ["validate", "{mlp}", "{blowup}", "{serve}",
                  "{fleet}/replica0", "{fleet}/replica1", "{fleet}/router",
                  "{hist}", "{wl}", "{reports}/mlp.json",
                  "{blowup}/flight/0.json"], 0),
    ("validate_v9", ["validate", "{v9}", "{v9}/old_history.jsonl"], 1),
    ("validate_missing", ["validate", "{root}/nope"], 2),
    ("slo", ["slo", "{serve}"], None),
    ("slo_breach", ["slo", "{serve}", "--spec", "ttft_p99_ms<=0.001",
                    "--compact"], 3),
    ("slo_bad_spec", ["slo", "{serve}", "--spec", "nonsense"], 2),
    ("trace", ["trace", "{serve}", "1"], 0),
    ("trace_unknown_rid", ["trace", "{serve}", "99"], 2),
    ("trace_export_chrome", ["trace", "{fleet}", "--export", "chrome"], 0),
    ("trace_export_chrome_rid", ["trace", "{serve}", "2", "--export",
                                 "chrome", "-o", "{side}/trace.json"], 0),
    ("collect", ["collect", "{fleet}"], 0),
    ("collect_json", ["collect", "{fleet}", "{serve}", "--json", "-n",
                      "25", "--no-align"], 0),
    ("collect_out", ["collect", "{fleet}", "-o", "{side}/merged.jsonl"], 0),
    ("fleet", ["fleet", "{fleet}"], None),
    ("fleet_error_budget", ["fleet", "{fleet}", "--spec",
                            "error_rate<=0.01"], 0),
    ("fleet_breach", ["fleet", "{fleet}", "--spec", "ttft_p99_ms<=0.001",
                      "--compact"], 3),
    ("history", ["history", "{hist}", "--last", "5"], 0),
    ("history_append", ["history", "{side}/h.jsonl", "--append",
                        "{reports}/blowup.json", "--json"], 0),
    ("history_import", ["history", "{side}/h.jsonl", "--import",
                        "{caps}/BENCH_r08.json", "{caps}/BENCH_r09.json",
                        "{caps}/BENCH_bad.json", "--metrics",
                        "wall_s,mfu"], 0),
    ("history_empty", ["history", "{root}/none.jsonl"], 2),
    ("explain", ["explain", "{serve}"], 0),
    ("explain_json", ["explain", "{fleet}", "--json", "--compact"], 0),
    ("explain_fleet", ["explain", "{fleet}", "--fleet"], 0),
    ("explain_workload", ["explain", "{replay}", "--workload", "{wid}"], 0),
    ("drift", ["drift", "{hist}"], 3),
    ("drift_capture", ["drift", "{hist}", "--capture",
                       "{caps}/decode.json", "--metrics", "mfu"], 3),
    ("drift_window", ["drift", "{hist}", "--window", "4",
                      "--tolerance", "0.5"], 0),
    ("drift_too_few", ["drift", "{hist_short}"], 2),
    ("capture", ["capture", "{serve}"], 0),
    ("capture_fleet_out", ["capture", "{fleet}", "-o", "{side}/wl.json"], 0),
    ("capacity", ["capacity", "{wl}", "--service-tok-s", "120"], 0),
    ("capacity_measured_qps_short", ["capacity", "{wl}", "--service-tok-s",
                                     "120", "--measured-qps", "0.5"], 3),
    ("capacity_measured_qps_ok", ["capacity", "{wl}", "--service-tok-s",
                                  "120", "--measured-qps", "1e6",
                                  "--utilization", "0.5",
                                  "--tolerance", "0.1"], 0),
    ("capacity_bad_rate", ["capacity", "{wl}", "--service-tok-s", "0"], 2),
]


@pytest.mark.parametrize("argv,rc", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_cli_matches_jax(logs, tmp_path, argv, rc):
    """JAX's ``obs/cli.main`` and the port's on the same inputs: the same
    exit code (the stated one where it is fixed), stdout and stderr, the
    HTTP answers of ``serve`` and the files a command writes."""
    port = _free_port() if argv[0] == "serve" else None
    got = {}
    for side, mod in (("jax", jcli), ("torch", tcli)):
        side_dir = str(tmp_path / side)
        shutil.copytree(logs["seed"], side_dir)
        args = [a.format(side=side_dir, port=port,
                         reports=os.path.join(logs["root"], "reports"),
                         **logs) for a in argv]
        answers, hook = [], None
        if argv[0] == "serve":
            hook = _serve_hook(port, ["/status", "/metrics", "/report",
                                      "/slo", "/fleet", "/explain?rid=1",
                                      "/trace?rid=1", "/nope"], answers)
        elif "-f" in argv:
            hook = _follow_hook(os.path.join(side_dir, "live",
                                             "metrics.0.jsonl"))
        code, out, err = _run(mod, args, hook)
        written = {}
        for name in sorted(os.listdir(side_dir)):
            full = os.path.join(side_dir, name)
            if os.path.isfile(full):
                with open(full) as f:
                    written[name] = _parsed(f.read())
        got[side] = (code, _parsed(out.replace(side_dir, "{side}")),
                     err.replace(side_dir, "{side}"), answers, written)
    j, t = got["jax"], got["torch"]
    assert t[0] == j[0], (t[0], j[0], t[2], j[2])
    if rc is not None:
        assert t[0] == rc, t[2]
    assert t[1] == j[1]
    assert t[2] == j[2]
    if argv[0] == "serve":
        # the port's status server also answers /healthz (obs/serve.py),
        # which its 404 names after JAX's endpoints
        path, code, body = t[3][-1]
        assert (path, code) == ("/nope", 404)
        assert body["endpoints"].pop() == "/healthz"
    assert t[3] == j[3]
    assert t[4] == j[4]
    if argv[0] == "serve" and argv[1] == "{blowup}":
        assert [a[1] for a in t[3]][:3] == [200, 200, 200]
    if argv[0] == "tail" and "-f" in argv:
        assert [ln.split()[2] for ln in t[1][-5:]] == \
            ["101", "102", "103", "104", "105"]


def test_parsers_take_jax_subcommands_and_flags():
    """The same 14 subcommands in JAX's order, each with JAX's
    positionals and flags (names, destinations, defaults, types,
    choices, arity, required)."""
    def table(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {name: [(tuple(a.option_strings), a.dest, a.default,
                        getattr(a.type, "__name__", a.type), a.choices,
                        a.nargs, a.required) for a in p._actions]
                for name, p in sub.choices.items()}
    t, j = table(tcli.build_parser()), table(jcli.build_parser())
    assert list(t) == list(j) and len(t) == 14
    assert t == j


def test_history_and_drift_documents_cross_validate(logs, tmp_path):
    """Each package's validators accept the other's history file, drift
    report (with its roofline join) and workload file; a version-9 entry
    or report gets the same diagnosis from both."""
    for side, hist, drift in (("torch", thist, tdrift),
                              ("jax", jhist, jdrift)):
        path = str(tmp_path / f"{side}.jsonl")
        for label, wall, mfu in _HIST:
            hist.append_entry(path, {"metric": "wall", "value": wall,
                                     "mfu": mfu}, label=label)
        doc = drift.drift_report(path, capture=os.path.join(
            logs["caps"], "decode.json"))
        for schema in (tschema, jschema):
            assert schema.validate_history_file(path) == []
            assert schema.validate_drift_report(doc) == []
            assert schema.validate_workload_file(logs["wl"]) == []
    old = {"v": 9, "kind": "drift_report"}
    for validate in ("validate_drift_report", "validate_history_entry",
                     "validate_version", "validate_run_report"):
        want = getattr(jschema, validate)(old)
        assert getattr(tschema, validate)(old) == want
        assert want and "written by schema v9; this tool reads schema " \
            "v10" in want[0]
    path = os.path.join(logs["v9"], "old_history.jsonl")
    assert tschema.validate_history_file(path) == \
        jschema.validate_history_file(path) != []
    bad = {"v": 10, "kind": "bench_history", "t": "x", "label": 1}
    assert tschema.validate_history_entry(bad) == \
        jschema.validate_history_entry(bad)
    assert tschema.validate_workload_file("/nonexistent.json") == \
        jschema.validate_workload_file("/nonexistent.json")
    stats = {k: 0 for k in jschema.SERVING_STATS}
    stats.update(page_occupancy_frac=0.5, latency_p50_ms=None,
                 brownout_active=True)
    assert tschema.SERVING_STATS == jschema.SERVING_STATS
    assert tschema.validate_serving_stats(stats) == \
        jschema.validate_serving_stats(stats) != []
    assert tschema.HISTORY_ENTRY == jschema.HISTORY_ENTRY
    assert tschema.DRIFT_REPORT == jschema.DRIFT_REPORT


# the bench rows extract_metrics recognises by a key only the row carries
_ROW_KEYS = ("sync_comm_bytes_per_token", "decode_step_ms",
             "decode_kv_scale_bytes_per_step", "ckpt_write_ms",
             "continuous_ticks", "trace_on_tok_s", "waterfall_requests",
             "degraded_sim_ticks", "fleet_failover_requests",
             "workload_replay_requests")


def _shapes():
    """One document of every shape extract_metrics documents, each
    carrying every gate metric's name (but the input-pipeline row's
    marker, prefetch_step_ms) so that a branch's choice shows."""
    every = {name: 0.25 + i for i, name in enumerate(jcmp.GATE_METRICS)
             if name != "prefetch_step_ms"}
    summary = dict(every, metric="wall_clock_s", value=12.0,
                   learning_accuracy=0.9,
                   input_pipeline_blocking_step_ms=3.0,
                   input_pipeline_prefetch_step_ms=2.0,
                   input_pipeline_overlap_ratio=1.5)
    return {
        "summary": summary,
        "bench_row": dict(every, wall_clock_20ep_s=20.0,
                          goodput_summary={"goodput_frac": 0.9}),
        "baseline": {"measured": {"cpu_baseline_wall_clock_20ep_s": 30.0,
                                  "cpu_baseline_test_accuracy": 0.91}},
        "capture": {"tail": "x\n" + json.dumps(summary)
                    + '\n{"gate": "verdict"}\nnot json\n'},
        "capture_empty": {"tail": "{}\nno metrics"},
        "history_entry": {"kind": "bench_history", "metrics": {
            "wall_s": 3.0, "mfu": True, "bogus": 1.0, "serving_tok_s": "x",
            "decode_hbm_frac": 0.4}},
        "history_baseline": {"kind": "history_baseline",
                             "metrics": {"wall_s": 2.0, "mfu": 0.1}},
        "input_row": dict(every, prefetch_step_ms=1.0),
        "pp_row": dict(every, **{
            f"{n}_bubble_fraction": 0.1 * i for i, n in enumerate(
                ("1f1b", "gpipe", "interleaved_v2", "interleaved_v4"))}),
        **{f"row_{k}": dict(every, **{k: 1}) for k in _ROW_KEYS},
        "direct": {"wall_s": 1.0, "mfu": 0.5, "other": 3},
        "not_a_dict": [1, 2],
    }


def test_compare_reads_every_documented_shape(logs, tmp_path):
    """extract_metrics equals JAX's, key order included, on every
    documented shape, written to files and read back by load_doc (a
    text capture, a logs directory and a run report among them);
    compare and its thresholds equal JAX's over every pair, and a zero
    baseline gives strict JSON."""
    shapes, seen = _shapes(), {}
    with open(os.path.join(logs["root"], "reports", "mlp.json")) as f:
        shapes["run_report"] = json.load(f)
    for name, doc in shapes.items():
        path = str(tmp_path / f"{name}.json")
        with open(path, "w") as f:
            json.dump(doc, f)
        got = tcmp.load_doc(path)
        assert got == jcmp.load_doc(path)
        m = tcmp.extract_metrics(got)
        assert list(m.items()) == list(jcmp.extract_metrics(got).items())
        assert m or name in ("capture_empty", "not_a_dict"), name
        seen[name] = tuple(m)
    # each bench row took a branch of its own
    rows = {seen[k] for k in seen if k.startswith(("row_", "input_row",
                                                    "pp_row", "bench_row"))}
    assert len(rows) == len(_ROW_KEYS) + 3
    text = str(tmp_path / "stdout.txt")
    with open(text, "w") as f:
        f.write(shapes["capture"]["tail"])
    assert tcmp.load_doc(text) == jcmp.load_doc(text)
    assert tcmp.load_doc(logs["mlp"])["kind"] == "run_report"
    with open(tmp_path / "junk.txt", "w") as f:
        f.write("no json at all\n")
    for mod in (tcmp, jcmp):
        with pytest.raises(ValueError, match="neither JSON"):
            mod.load_doc(str(tmp_path / "junk.txt"))
    names = sorted(shapes)
    for a in names:
        for b in names:
            for kw in ({}, {"default_threshold": 0.5},
                       {"thresholds": {"wall_s": 0.0, "mfu": 1.0}}):
                assert tcmp.compare(shapes[a], shapes[b], **kw) == \
                    jcmp.compare(shapes[a], shapes[b], **kw)
    zero = tcmp.compare({"wall_s": 0.0, "mfu": 0.0}, {"wall_s": 2.0,
                                                       "mfu": 0.0})
    assert zero == jcmp.compare({"wall_s": 0.0, "mfu": 0.0},
                                {"wall_s": 2.0, "mfu": 0.0})
    assert zero["metrics"]["wall_s"]["verdict"] == "incomparable"
    assert zero["ok"] and json.loads(json.dumps(zero, allow_nan=False)) \
        == zero
    assert tcmp.GATE_METRICS == jcmp.GATE_METRICS


def test_poll_new_lines_follows_rotation_and_truncation_as_jax(tmp_path):
    """The same file history through both poll_new_lines: appends, a
    torn tail held back, a missing file, truncation and rotation each
    give JAX's lines and state."""
    path = str(tmp_path / "spans.0.jsonl")
    states = {"torch": {}, "jax": {}}

    def poll():
        got = tcli.poll_new_lines(path, states["torch"])
        assert got == jcli.poll_new_lines(path, states["jax"])
        assert states["torch"] == states["jax"]
        return got

    assert poll() == []
    steps = [lambda: open(path, "w").write('{"a": 1}\n{"b"'),
             lambda: open(path, "a").write(': 2}\n'),
             lambda: None,
             lambda: open(path, "w").write('{"c": 3}\n'),
             lambda: (os.rename(path, path + ".1"),
                      open(path, "w").write('{"d": 4}\n{"e": 5}\n')),
             lambda: os.remove(path)]
    seen = []
    for step in steps:
        step()
        seen.append(poll())
    assert seen == [['{"a": 1}'], ['{"b": 2}'], [], ['{"c": 3}'],
                    ['{"d": 4}', '{"e": 5}'], []]


@pytest.mark.parametrize("metric,values", [
    ("wall_s", [10.0, 10.2, 14.0, 9.9, 12.5, 12.6, 12.4]),
    ("mfu", [0.40, 0.41, 0.40, 0.40, 0.41, 0.30, 0.31]),
    ("serving_tok_s", [100.0, 99.0, 101.0, 60.0, 61.0]),
    ("wall_s", [1.0, 1.01, 0.99, 1.02, 1.0, 1.01]),
    ("custom_metric", [5.0, 5.0, 5.1, 2.0, 2.1, 2.0]),
    ("wall_s", [0.0, 0.0, 1.0, 2.0]),
    # the first row past the tolerance precedes the bulk of the shift
    ("wall_s", [10.0, 10.1, 9.9, 11.5, 13.0, 13.1, 12.9]),
    ("mfu", [0.4, 0.4, 0.4, 0.35, 0.3, 0.3, 0.3]),
])
def test_drift_names_jax_first_offending_row(metric, values):
    """detect over planted shifts (up, down, either way, none, a zero
    pre-median, a first offending row before the level) gives JAX's
    verdict and first offending row, at the default tolerance and an
    explicit one."""
    labels = [f"r{i:02d}" for i in range(len(values))]
    for tol in (None, 0.1):
        assert tdrift.detect(labels, values, metric, tol) == \
            jdrift.detect(labels, values, metric, tol)
    assert tdrift.MIN_ENTRIES == jdrift.MIN_ENTRIES == 4


def test_history_helpers_match_jax(logs, tmp_path):
    """read_history skips torn lines as JAX's does; rolling_baseline,
    trend_table and import_captures give JAX's results."""
    path = str(tmp_path / "h.jsonl")
    shutil.copy(logs["hist"], path)
    with open(path, "a") as f:
        f.write('{"kind": "bench_history", "label": "torn"\n[1, 2]\n')
    entries = thist.read_history(path)
    assert entries == jhist.read_history(path) and len(entries) == len(_HIST)
    for n in (1, 3, 100):
        assert thist.rolling_baseline(entries, n) == \
            jhist.rolling_baseline(entries, n)
    for kw in ({}, {"last": 2}, {"metrics": ["mfu", "wall_s", "none"]}):
        assert thist.trend_table(entries, **kw) == \
            jhist.trend_table(entries, **kw)
    caps = [os.path.join(logs["caps"], f) for f in sorted(os.listdir(
        logs["caps"]))] + [str(tmp_path / "missing.json")]
    for side, mod in (("torch", thist), ("jax", jhist)):
        p = str(tmp_path / f"{side}_imp.jsonl")
        first = mod.import_captures(p, caps)
        again = mod.import_captures(p, caps)
        if side == "torch":
            want = (first, again, mod.read_history(p))
        else:
            assert (first, again, mod.read_history(p)) == want
    assert want[0][0] == 4 and want[1][0] == 0


def test_capacity_matches_jax_with_a_null_roofline_on_the_cpu(logs):
    """forecast and verdict equal JAX's (bar generated_t); the roofline
    is None on the CPU in both packages, and drift's roofline join gives
    JAX's off-card document."""
    doc = twl.load_workload(logs["wl"])
    for rate, util in ((120.0, 0.8), (1.0, 1.0), (1e4, 0.05)):
        got = tcap.forecast(doc, rate, utilization_target=util)
        assert _drop(got) == _drop(jcap.forecast(
            doc, rate, utilization_target=util))
        for measured in (0.0, got["sustainable_qps"] * 0.7, 1e9):
            assert tcap.verdict(got["sustainable_qps"], measured) == \
                jcap.verdict(got["sustainable_qps"], measured)
    for mod in (tcap, jcap):
        with pytest.raises(ValueError):
            mod.forecast(doc, 0.0)
        with pytest.raises(ValueError):
            mod.forecast(doc, 1.0, utilization_target=1.5)
        with pytest.raises(ValueError):
            mod.verdict(0.0, 1.0)
    assert tcap.workload_shape(doc) == jcap.workload_shape(doc)
    assert (tcap.UTILIZATION_TARGET, tcap.DEFAULT_TOLERANCE) == \
        (jcap.UTILIZATION_TARGET, jcap.DEFAULT_TOLERANCE)
    assert tcap.roofline_decode_tok_s(ttfm.TransformerSpec(**_LM), 8,
                                      40.0) is None
    cap = os.path.join(logs["caps"], "decode.json")
    roof = tdrift.drift_report(logs["hist"], capture=cap)["roofline"]
    assert roof == jdrift.drift_report(logs["hist"], capture=cap)["roofline"]
    assert roof["chip_peak_hbm_gbps"] is None and "note" in roof
    assert roof["decode_hbm_frac"] == 0.42


def test_chip_smoke_obs_phase_rehearses_on_cpu(logs, tmp_path):
    """``chip_smoke.py``'s phase 9 over a kept tree laid out as the smoke
    keeps it, built from this file's logs (the engine's stream as the
    traced serve, the fleet as the fleet and chaos runs, the MLP runs as
    the monitoring runs, a 16-request replay_sim stream as the replay):
    every subcommand's exit code as the phase requires, the tree
    removed.  MFU and the HBM peak are null on the CPU."""
    import chip_smoke

    root = str(tmp_path / "kept")
    for name, src in (("traced", logs["serve"]), ("status", logs["mlp"]),
                      ("fleet", logs["fleet"]), ("chaos", logs["fleet"]),
                      ("monitoring/mon", logs["mlp"]),
                      ("monitoring/skip", logs["blowup"]),
                      ("monitoring/halt", logs["blowup"]),
                      ("monitoring/tfm", logs["blowup"])):
        chip_smoke._keep(root, name, src)
    doc = twl.synthetic_workload(chip_smoke.REPLAY_N, seed=0, mean_prompt=5,
                                 mean_new=4)
    os.makedirs(os.path.join(root, "replay"))
    twl.write_workload(doc, os.path.join(root, "replay", "workload.json"))
    rec = trp.replay_recorder(os.path.join(root, "replay", "replay0"),
                              doc["workload_id"])
    trp.replay_sim(doc, recorder=rec)
    rec.close()
    with contextlib.redirect_stdout(io.StringIO()):
        res = chip_smoke.phase_obs("cpu", root, ttfm.TransformerSpec(**_LM),
                                   {"tps": [100.0], "qps": [5.0]},
                                   device="cpu")
    assert res["calls"] == 30 and not os.path.exists(root)
    assert res["mfu"] is None and res["roof"] is None and res["peak"] is None

"""The port trainer's telemetry (``obs/{flops,metrics}``, the step's
``with_norms``/``with_anomaly`` vectors, ``--metrics``, ``--histograms``,
``--status_port`` and the ``DTX_*`` switches) against the JAX package's,
on the CPU.

- ``obs/flops``: every function equals JAX's exactly on MLP, transformer
  and MoE specs; the peak is the card's by name and None on the CPU.
- ``WindowTimer`` on one scripted clock gives JAX's row; ``_scrub_
  nonfinite`` JAX's copy; the port's metrics file is valid under JAX's
  validator and JAX's under the port's.
- One step with ``with_norms`` and ``with_anomaly`` against JAX's
  ``build_train_step``: norms to f32 rtol 1e-5, the non-finite counts and
  the flag exactly, in JAX's leaf order; under ``skip`` a NaN batch
  keeps the params and slots bitwise.
- The trainer on the host path (``--histograms``) and the fast path with
  ``--metrics --log_every=2``: the rows' ``(step, epoch, path, timing,
  steps)`` sequence is JAX's, costs within 1e-5 of scale (f32, the
  tolerance of ``tests/test_torch_train.py``), the histogram and
  learning-rate summaries carry JAX's tags with values within 1e-4 of
  scale (norms of params after one more update path, f32).
- ``DTX_METRICS``/``DTX_FLIGHT``/``DTX_STATUS_PORT`` turn the flags on
  and off as JAX's ``main`` does; ``/status`` and ``/metrics`` answer a
  poller while the port trainer runs.
- ``--early_stop_patience`` stops at JAX's epoch with JAX's
  ``Validation-Accuracy`` prints and checkpoint extras, on both paths.
"""

import contextlib
import glob
import io
import json
import os
import socket
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu import main as jmain
from distributed_tensorflow_example_tpu.data import mnist as jmnist
from distributed_tensorflow_example_tpu.models import mlp as jmlp
from distributed_tensorflow_example_tpu.obs import flops as jflops
from distributed_tensorflow_example_tpu.obs import metrics as jmetrics
from distributed_tensorflow_example_tpu.obs import schema as jschema
from distributed_tensorflow_example_tpu.parallel import mesh as jmesh
from distributed_tensorflow_example_tpu.parallel import step as jstep
from distributed_tensorflow_example_tpu.train import loop as jloop
from distributed_tensorflow_example_tpu.train import optim as joptim
from distributed_tensorflow_example_tpu.train import state as jstate
from distributed_tensorflow_example_tpu.utils import summary as jsummary
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch import main as tmain
from distributed_tensorflow_example_tpu_torch.data import mnist as tmnist
from distributed_tensorflow_example_tpu_torch.models import mlp as tmlp
from distributed_tensorflow_example_tpu_torch.obs import flops as tflops
from distributed_tensorflow_example_tpu_torch.obs import metrics as tmetrics
from distributed_tensorflow_example_tpu_torch.obs import schema as tschema
from distributed_tensorflow_example_tpu_torch.parallel import step as tstep
from distributed_tensorflow_example_tpu_torch.train import loop as tloop
from distributed_tensorflow_example_tpu_torch.train import optim as toptim
from distributed_tensorflow_example_tpu_torch.train import state as tstate
from distributed_tensorflow_example_tpu_torch.utils import summary as tsummary

# one intra-op thread: the suite runs six test workers (and the rank
# processes) on the machine's cores, where torch would start one a core
torch.set_num_threads(1)


def _close(got, want, rtol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max |diff| {err} > {rtol} x {scale}"


# ---------------------------------------------------------------------------
# obs/flops
# ---------------------------------------------------------------------------

SPEC_FLAGS = {
    "mlp": dict(hidden_sizes=(64, 32), input_size=784),
    "transformer": dict(model="transformer", input_size=256, seq_len=64,
                        d_model=64, n_heads=4, num_blocks=2, d_ff=128,
                        causal=True, compute_dtype="bfloat16"),
    "moe": dict(model="transformer", objective="lm", input_size=64,
                vocab_size=32, d_model=32, n_heads=2, num_blocks=2,
                d_ff=64, num_experts=4, moe_dispatch="alltoall",
                moe_topk=2),
}


@pytest.mark.parametrize("name", sorted(SPEC_FLAGS))
def test_flops_equal_jax_exactly(name):
    kw = SPEC_FLAGS[name]
    js = jloop.make_spec(jconfig.Config(**kw))
    ts = tloop.make_spec(tconfig.Config(**kw))
    pairs = [
        (jflops.model_flops_per_step(js, 64),
         tflops.model_flops_per_step(ts, 64)),
        (jflops.tokens_per_example(js), tflops.tokens_per_example(ts)),
        (jflops.num_params(js), tflops.num_params(ts)),
        (jflops.num_param_leaves(js), tflops.num_param_leaves(ts)),
        (jflops.sync_dp_comm_bytes_per_step(js, 4),
         tflops.sync_dp_comm_bytes_per_step(ts, 4)),
        (jflops.sync_dp_comm_bytes_per_step(js, 4, itemsize=2),
         tflops.sync_dp_comm_bytes_per_step(ts, 4, itemsize=2)),
        (jflops.local_sgd_comm_bytes_per_round(js, 3),
         tflops.local_sgd_comm_bytes_per_round(ts, 3)),
        (jflops.local_sgd_outer_quant_bytes_per_round(js, 3),
         tflops.local_sgd_outer_quant_bytes_per_round(ts, 3)),
        (jflops.comm_bytes_per_token(1e6, 8, jflops.tokens_per_example(js)),
         tflops.comm_bytes_per_token(1e6, 8, tflops.tokens_per_example(ts))),
        (jflops.mfu(3e12, 20.0, 989e12, 2), tflops.mfu(3e12, 20.0, 989e12, 2)),
        (jflops.mfu(3e12, 20.0, None), tflops.mfu(3e12, 20.0, None)),
        (jflops.hbm_frac(5e9, 0.01, 3.35e12), tflops.hbm_frac(5e9, 0.01,
                                                              3.35e12)),
        (jflops.hbm_frac(5e9, 0.0, 3.35e12), tflops.hbm_frac(5e9, 0.0,
                                                             3.35e12)),
        (jflops.mlp_flops_per_step((100,), 50), tflops.mlp_flops_per_step(
            (100,), 50)),
        (jflops.attention_flops(2, 128, 4, 32, True, grad=True),
         tflops.attention_flops(2, 128, 4, 32, True, grad=True)),
        (jflops.allreduce_bytes_per_replica(1e6, 1),
         tflops.allreduce_bytes_per_replica(1e6, 1)),
    ]
    if name != "mlp":
        for kv_len, extra in ((17.5, {}), (100, {"kv_dtype_bytes": 1}),
                              (3, {"heads": 2})):
            pairs += [
                (jflops.decode_kv_bytes_per_step(js, 8, kv_len, **extra),
                 tflops.decode_kv_bytes_per_step(ts, 8, kv_len, **extra)),
                (jflops.decode_bytes_per_step(js, 8, kv_len, **extra),
                 tflops.decode_bytes_per_step(ts, 8, kv_len, **extra)),
            ]
        pairs += [
            (jflops.decode_weight_bytes(js), tflops.decode_weight_bytes(ts)),
            (jflops.decode_kv_scale_bytes_per_step(js, 8, 40.0),
             tflops.decode_kv_scale_bytes_per_step(ts, 8, 40.0)),
        ]
    for i, (j, t) in enumerate(pairs):
        assert t == j and type(t) is type(j), (i, j, t)


def test_peaks_are_the_cards_and_none_on_the_cpu(monkeypatch):
    """No TPU figure in the port; the H100's by name, None on the CPU or
    an unlisted card (MFU null, never made up)."""
    assert not any("TPU" in k for k in tflops.PEAK_BF16_FLOPS)
    assert not any("TPU" in k for k in tflops.PEAK_HBM_BYTES)
    assert tflops.chip_peak_flops(torch.device("cpu")) is None
    assert tflops.chip_peak_hbm_bytes(torch.device("cpu")) is None
    assert jflops.chip_peak_flops(jax.devices("cpu")[0]) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    names = iter(["NVIDIA H100 80GB HBM3", "NVIDIA H100 80GB HBM3",
                  "Some Other GPU"])
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: next(names))
    dev = torch.device("cuda", 0)
    assert tflops.chip_peak_flops(dev) == 989e12
    assert tflops.chip_peak_hbm_bytes(dev) == 3.35e12
    assert tflops.chip_peak_flops(dev) is None


# ---------------------------------------------------------------------------
# obs/metrics
# ---------------------------------------------------------------------------


def test_window_timer_and_scrub_equal_jax(monkeypatch):
    """The same charges on one scripted clock give JAX's window row; an
    unknown bucket raises in both; the scrubber stringifies as JAX's."""
    rows = []
    for mod in (jmetrics, tmetrics):
        ticks = iter(np.arange(100.0, 200.0, 0.125).tolist())
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        t = mod.WindowTimer()
        for step in range(5):
            t.charge("data_wait", 0.01 * step)
            t.charge("dispatch", 0.002)
            if step % 2:
                t.charge("device_wait", 0.03)
            t.step_done()
        t.charge("ckpt", 0.004)
        rows.append(t.window_row())
        with pytest.raises(ValueError, match="unknown window bucket"):
            t.charge("bogus", 1.0)
    assert rows[1] == rows[0]
    row = {"a": float("nan"), "b": [float("inf"), np.float32(1.5)],
           "c": np.int64(3), "d": {"e": -float("inf")}, "f": object}
    assert tmetrics._scrub_nonfinite(row) == jmetrics._scrub_nonfinite(row)


def _window_fields():
    return dict(step=10, epoch=0, cost=float("nan"), path="host", steps=5,
                window_wall_s=0.4, step_time_p50_ms=80.0,
                step_time_p95_ms=90.0, step_time_max_ms=95.0,
                data_wait_s=0.01, h2d_s=0.02, dispatch_s=0.1,
                device_wait_s=0.2, ckpt_s=0.0, host_s=0.07,
                examples_per_sec=1950.0, tokens_per_sec=None,
                model_flops_per_step=4.8e6, tflops_per_sec=0.012, mfu=None)


def test_metrics_files_validate_across_packages(tmp_path):
    for side, mod in (("t", tmetrics), ("j", jmetrics)):
        m = mod.MetricsLogger(str(tmp_path / side), process_index=0)
        m.log_window(**_window_fields())
        m.log_event("compile", what="train_step", dispatch_wall_s=0.7)
        m.log_event("anomaly", step=3, reasons=["divergence"],
                    policy="dump", loss=float("nan"))
        m.close()
        for validate in (jschema.validate_metrics_file,
                         tschema.validate_metrics_file):
            assert validate(m.path) == [], (side, validate)
    t_rows = tmetrics.read_metrics(str(tmp_path / "t" / "metrics.0.jsonl"))
    j_rows = jmetrics.read_metrics(str(tmp_path / "j" / "metrics.0.jsonl"))
    drop = ("t", "rss_bytes")
    assert [{k: v for k, v in r.items() if k not in drop} for r in t_rows] \
        == [{k: v for k, v in r.items() if k not in drop} for r in j_rows]
    assert t_rows[0]["device_memory"] is None       # the CPU
    assert tmetrics.device_memory_stats(torch.device("cpu")) is None
    # drift fails loudly in the port's validator too
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "window", "v": 10, "t": 1.0, "proc": 0}\n'
                   'not json\n')
    errs = tschema.validate_metrics_file(str(bad))
    assert any("step_time_p95_ms" in e for e in errs)
    assert any("not JSON" in e for e in errs)


# ---------------------------------------------------------------------------
# the step's telemetry vectors
# ---------------------------------------------------------------------------

# sigmoid (the reference's activation): a NaN input poisons the same
# gradient elements in both packages.  Under relu it does not: JAX's relu
# backward zeroes the gradient where its input is NaN, torch's passes it
# on, so the flags agree and the counts do not (ROADMAP.md, rules)
STEP_SPEC = dict(input_size=16, hidden_sizes=(12, 8), num_classes=4,
                 activation="sigmoid")


def _pair(**kw):
    kw = dict(dict(optimizer="adam", learning_rate=0.05, seed=2), **kw)
    jspec, tspec = jmlp.MLPSpec(**STEP_SPEC), tmlp.MLPSpec(**STEP_SPEC)
    jcfg, tcfg = jconfig.Config(**kw), tconfig.Config(**kw)
    jopt, topt = joptim.make_optimizer(jcfg), toptim.make_optimizer(tcfg)
    mesh = jmesh.build_mesh(1, 1)
    jst = jstate.create_train_state(jax.random.PRNGKey(2), jspec, jopt)
    np_params = {k: np.asarray(v) for k, v in jst.params.items()}
    jst = jmesh.place_state(jst, mesh, jmesh.state_pspecs(jspec, jopt))
    params = convert.mlp_params_from_numpy(np_params, tspec, device="cpu")
    tst = tstate.TrainState(torch.zeros((), dtype=torch.int32), params,
                            topt.init(params))
    return (jstep.build_train_step(jcfg, mesh, jspec, jopt, with_norms=True,
                                   with_anomaly=True),
            tstep.make_sync_step_body(tcfg, tspec, topt, with_norms=True,
                                      with_anomaly=True),
            jst, tst, jspec, tspec)


def _batch(seed, poison=False):
    rng = np.random.RandomState(seed)
    x = rng.rand(24, 16).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 24)]
    if poison:
        x[3, 5] = np.nan
    return x, y


@pytest.mark.parametrize("on_anomaly", ["", "skip"])
def test_step_norms_and_anomaly_vectors_match_jax(on_anomaly):
    """Two clean steps and a poisoned one: the norms within f32 rtol 1e-5,
    the counts and the flag exactly, in JAX's leaf order; the blame names
    are JAX's key paths.  Under ``skip`` the poisoned step keeps the
    params and the Adam slots bitwise and still advances ``step``."""
    jfn, tfn, jst, tst, jspec, tspec = _pair(on_anomaly=on_anomaly)
    names = tstep.leaf_names(tspec)
    jnames = [jax.tree_util.keystr(kp) for kp, _ in
              jax.tree_util.tree_flatten_with_path(jst.params)[0]]
    assert names == jnames
    for seed, poison in ((0, False), (1, False), (2, True)):
        x, y = _batch(seed, poison)
        before = {k: v.clone() for k, v in tst.params.items()}
        slots = [v.clone() for v in toptim.tree_leaves(tst.opt_state)]
        jst, jc, ja, jn, janom = jfn(jst, x, y)
        tst, tc, ta, tn, tanom = tfn(tst, torch.from_numpy(x),
                                     torch.from_numpy(y))
        assert bool(tanom["flag"]) == bool(janom["flag"]) == poison
        assert tanom["counts"].dtype == torch.int32
        assert tanom["counts"].tolist() == np.asarray(
            janom["counts"]).tolist()
        if not poison:
            for key in ("grad", "param"):
                np.testing.assert_allclose(tn[key].numpy(),
                                           np.asarray(jn[key]), rtol=1e-5)
            continue
        assert sum(tanom["counts"].tolist()) > 0
        if on_anomaly == "skip":
            for k in before:
                assert torch.equal(tst.params[k], before[k]), k
            for a, b in zip(toptim.tree_leaves(tst.opt_state), slots):
                assert torch.equal(a, b)
            np.testing.assert_allclose(tn["param"].numpy(),
                                       np.asarray(jn["param"]), rtol=1e-5)
    assert int(tst.step) == int(jst.step) == 3


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

RUN = dict(training_epochs=2, batch_size=20, hidden_sizes=(16,),
           learning_rate=0.3, frequency=3, seed=3, metrics=True,
           log_every=2)


def _jax_init(jcfg):
    jspec = jloop.make_spec(jcfg)
    jparams = jstate.create_train_state(
        jax.random.PRNGKey(jcfg.seed), jspec,
        joptim.make_optimizer(jcfg)).params
    init_np = {k: np.asarray(v) for k, v in jparams.items()}

    def init(spec, optimizer, seed=1, device=None):
        params = convert.mlp_params_from_numpy(init_np, spec, device="cpu")
        return tstate.TrainState(torch.zeros((), dtype=torch.int32), params,
                                 optimizer.init(params))
    return init


def run_both(tmp, kw, train_size=120, test_size=40, ckpt=False):
    """The JAX trainer and the port's with the same flags, from JAX's
    initial params on the same synthetic data; ``{side: (result,
    stdout, cfg)}``.  ``ckpt``: each saves its exit checkpoint under
    its own ``checkpoint_dir``."""
    data = dict(train_size=train_size, test_size=test_size, input_size=784)
    jdata = jmnist.synthesize_dataset(seed=0, **data)
    tdata = tmnist.synthesize_dataset(seed=0, **data)

    def dirs(side):
        return dict(logs_path=str(tmp / side),
                    checkpoint_dir=str(tmp / f"{side}_ckpt") if ckpt else "")

    cfgs = {"jax": jconfig.Config(**kw, data_parallel=1,
                                  compilation_cache="", **dirs("jax")),
            "torch": tconfig.Config(**kw, device="cpu", **dirs("torch"))}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "load_datasets", lambda *a, **k: jdata)
        mp.setattr(tloop, "load_datasets", lambda *a, **k: tdata)
        mp.setattr(tloop, "create_train_state", _jax_init(cfgs["jax"]))
        for side, fn in (("jax", jloop.run), ("torch", tloop.run)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = fn(cfgs[side])
            out[side] = (res, buf.getvalue(), cfgs[side])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mon")
    return {"host": run_both(tmp / "host", dict(RUN, fast_loop=False,
                                                histograms=True)),
            "fast": run_both(tmp / "fast", dict(RUN, summaries=False))}


def _rows(cfg):
    return tmetrics.read_metrics(os.path.join(cfg.logs_path,
                                              "metrics.0.jsonl"))


@pytest.mark.parametrize("path", ["host", "fast"])
def test_metrics_rows_follow_jax(runs, path):
    both = runs[path]
    t_rows, j_rows = (_rows(both[s][2]) for s in ("torch", "jax"))
    assert tschema.validate_metrics_file(os.path.join(
        both["torch"][2].logs_path, "metrics.0.jsonl")) == []
    assert jschema.validate_metrics_file(os.path.join(
        both["torch"][2].logs_path, "metrics.0.jsonl")) == []

    def ident(rows):
        return [(r["kind"], r.get("event"), r.get("step"), r.get("epoch"),
                 r.get("path"), r.get("timing"), r.get("steps"))
                for r in rows]

    assert ident(t_rows) == ident(j_rows)
    t_w = [r for r in t_rows if r["kind"] == "window"]
    j_w = [r for r in j_rows if r["kind"] == "window"]
    assert len(t_w) == (6 if path == "host" else 2)
    _close([r["cost"] for r in t_w], [r["cost"] for r in j_w], 1e-5,
           "window costs")
    for r in t_w:
        assert r["mfu"] is None     # the CPU: no peak, never made up
        assert r["model_flops_per_step"] == jflops.mlp_flops_per_step(
            (16,), 20)
        assert r["examples_per_sec"] > 0
    end = [r for r in t_rows if r.get("event") == "run_end"][0]
    assert end["steps"] == 12 and "compile_s" in end
    assert both["torch"][0]["fast_loop"] is (path == "fast")


def test_histograms_carry_jax_tags(runs):
    """``--histograms``: grad_norm and param_norm histograms and the
    learning_rate scalar every window, at JAX's steps, within 1e-4 of
    scale (f32 norms of the same run)."""
    def events(cfg):
        path = glob.glob(os.path.join(cfg.logs_path, "events.*"))[0]
        return [e for e in tsummary.read_event_file(path)
                if e["histograms"] or "learning_rate" in e["scalars"]]

    t_ev = events(runs["host"]["torch"][2])
    j_ev = [e for e in jsummary.read_event_file(glob.glob(os.path.join(
        runs["host"]["jax"][2].logs_path, "events.*"))[0])
        if e["histograms"] or "learning_rate" in e["scalars"]]
    assert [(e["step"], sorted(e["histograms"]), sorted(e["scalars"]))
            for e in t_ev] == [(e["step"], sorted(e["histograms"]),
                                sorted(e["scalars"])) for e in j_ev]
    assert {k for e in t_ev for k in e["histograms"]} == {"grad_norm",
                                                         "param_norm"}
    for te, je in zip(t_ev, j_ev):
        for tag, h in te["histograms"].items():
            for field in ("min", "max", "sum", "sum_squares"):
                _close(h[field], je["histograms"][tag][field], 1e-4,
                       f"{tag} {field} at {te['step']}")
        if "learning_rate" in te["scalars"]:
            assert te["scalars"]["learning_rate"] == pytest.approx(
                je["scalars"]["learning_rate"], rel=1e-7)


def test_host_lr_follows_the_schedule():
    kw = dict(lr_schedule="cosine", warmup_steps=3, learning_rate=0.2,
              lr_min_factor=0.1)
    j = jloop._host_lr(jconfig.Config(**kw), 20)
    t = tloop._host_lr(tconfig.Config(**kw), 20)
    for step in (1, 2, 3, 4, 10, 20, 25):
        assert t(step) == pytest.approx(j(step), rel=1e-6)
    assert tloop._host_lr(tconfig.Config(), 5)(3) == 0.0005


# ---------------------------------------------------------------------------
# the operator switches and the status server
# ---------------------------------------------------------------------------

ENV_CASES = [
    {}, {"DTX_METRICS": "1"}, {"DTX_METRICS": "0"}, {"DTX_FLIGHT": "yes"},
    {"DTX_FLIGHT": "off"}, {"DTX_METRICS": "true", "DTX_STATUS_PORT": "8123"},
    {"DTX_STATUS_PORT": "0"}, {"DTX_STATUS_PORT": "abc"},
]


@pytest.mark.parametrize("env", ENV_CASES, ids=lambda e: ",".join(
    f"{k}={v}" for k, v in e.items()) or "none")
def test_env_switches_as_in_jax(env, monkeypatch):
    for k in ("DTX_METRICS", "DTX_FLIGHT", "DTX_STATUS_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}
    monkeypatch.setattr(jmain, "run", lambda cfg: seen.setdefault("j", cfg))
    monkeypatch.setattr(tloop, "run", lambda cfg: seen.setdefault("t", cfg))
    assert jmain.main([]) == 0 and tmain.main([]) == 0
    for field in ("metrics", "flight", "status_port"):
        assert getattr(seen["t"], field) == getattr(seen["j"], field), field
    # a flag already given wins over the switch
    monkeypatch.setenv("DTX_STATUS_PORT", "8123")
    cfg = tmain.apply_env_switches(tconfig.Config(status_port=9000))
    assert cfg.status_port == 9000


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_status_server_answers_while_the_trainer_runs(tmp_path, monkeypatch):
    """``--status_port``: a thread polls ``/status`` and ``/metrics`` while
    the port trainer runs (its steps paced to 20 ms) and sees the run's
    window rows live; the server closes with the run."""
    real = tstep.make_sync_step_body

    def paced(*a, **k):
        body = real(*a, **k)

        def step(*sa, **sk):
            time.sleep(0.02)
            return body(*sa, **sk)
        return step

    monkeypatch.setattr(tstep, "make_sync_step_body", paced)
    port = _free_port()
    seen = {"status": [], "metrics": []}
    done = threading.Event()

    def poll():
        while not done.is_set():
            try:
                for path in ("status", "metrics"):
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/{path}",
                            timeout=5) as r:
                        seen[path].append(r.read().decode())
            except OSError:
                pass
            time.sleep(0.05)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    cfg = tconfig.Config(training_epochs=1, batch_size=10, hidden_sizes=(8,),
                         dataset="synthetic", synthetic_train_size=600,
                         synthetic_test_size=20, frequency=100,
                         summaries=False, fast_loop=False, metrics=True,
                         log_every=5, status_port=port, device="cpu",
                         logs_path=str(tmp_path))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            res = tloop.run(cfg)
    finally:
        done.set()
        poller.join(timeout=10)
    assert not poller.is_alive() and res["steps"] == 60
    live = [json.loads(s) for s in seen["status"]]
    live = [d for d in live if d["live"] and d["last_window"]]
    assert live, "no live /status answer carried a window row"
    assert 0 < live[-1]["last_window"]["step"] <= 60
    assert any("dtx_" in m and "step" in m for m in seen["metrics"])
    with pytest.raises(OSError):                    # closed with the run
        urllib.request.urlopen(f"http://127.0.0.1:{port}/status", timeout=2)


@pytest.mark.parametrize("fast", [False, True], ids=["host", "fast"])
def test_early_stop_matches_jax(tmp_path, fast):
    """``--early_stop_patience=1``: the per-epoch ``Validation-Accuracy``
    prints, the epoch the run stops at and the ``best_val``/``val_wait``
    extras of its exit checkpoint equal JAX's (the same params to f32
    rounding, the same 10 validation examples)."""
    both = run_both(tmp_path, dict(RUN, training_epochs=6, metrics=False,
                                   summaries=False, learning_rate=3.0,
                                   early_stop_patience=1, fast_loop=fast),
                    ckpt=True)
    t, j = both["torch"], both["jax"]
    for key in ("stopped_early", "epochs_completed", "steps", "fast_loop"):
        assert t[0][key] == j[0][key], key
    assert t[0]["stopped_early"] and t[0]["epochs_completed"] < 6

    def vals(stdout):
        return [ln for ln in stdout.splitlines()
                if ln.startswith("Validation-Accuracy")]

    assert vals(t[1]) == vals(j[1]) and vals(t[1])
    from distributed_tensorflow_example_tpu.utils import checkpoint as jckpt
    from distributed_tensorflow_example_tpu_torch.utils import (
        checkpoint as tckpt)

    got = tckpt.load_extras(tckpt.latest_checkpoint(t[2].checkpoint_dir))
    want = jckpt.load_extras(jckpt.latest_checkpoint(j[2].checkpoint_dir))
    assert {k: got[k] for k in ("best_val", "val_wait")} == pytest.approx(
        {k: want[k] for k in ("best_val", "val_wait")})

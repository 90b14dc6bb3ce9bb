"""The port's resilience store and checkpoint formats (``resilience/``,
``utils/checkpoint.py``, the trainer's ``--ckpt_every``/``--resume``)
against the JAX package's, on the CPU.

- Snapshots: a store either package writes restores bitwise in the other
  (f32, bf16, a 0-d int32, a leaf in shards with their bounds); both
  write the same object names and part manifests, and the same
  retention leaves the same object set.
- Classic checkpoints: a sharded and async one (``ckpt-N.shards/``) and
  a single ``.npz``, written by either package, restore bitwise through
  the other's ``restore_checkpoint`` (Adam with bf16 moments: bf16
  leaves through the bit containers).
- The trainer: a tiny MLP under ``--ckpt_every=2`` run in a subprocess
  that SIGTERM reaches after its step-4 snapshot is valid exits through
  ``Preempted`` (143) with a ``preempt`` row, and a ``--resume=auto``
  relaunch ends bitwise equal to an uninterrupted port run; the
  uninterrupted run matches JAX's with the same flags and initial
  params (final params within 1e-4 of their scale, the tolerance of
  ``tests/test_torch_epoch.py``; per-step costs within 1e-5); a JAX
  resilience directory cut back to a mid-epoch snapshot resumes in the
  port to the same end (1e-4); the ``ckpt`` phase rows carry JAX's keys;
  a bare ``--resume`` continues a classic checkpoint on the fast path
  bitwise and falls forward to the snapshot store.
- ``validate_resilience_config`` (and the ``--async_checkpoints``
  check) refuse what JAX's refuse; the flags parse to JAX's values.
"""

import contextlib
import glob
import io
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.data import mnist as jmnist
from distributed_tensorflow_example_tpu.resilience import manifest as jman
from distributed_tensorflow_example_tpu.train import loop as jloop
from distributed_tensorflow_example_tpu.train import optim as joptim
from distributed_tensorflow_example_tpu.train import state as jstate
from distributed_tensorflow_example_tpu.utils import checkpoint as jckpt
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.data import mnist as tmnist
from distributed_tensorflow_example_tpu_torch.resilience import (
    manifest as tman)
from distributed_tensorflow_example_tpu_torch.resilience import resume as tres
from distributed_tensorflow_example_tpu_torch.resilience.restart import (
    read_restarts)
from distributed_tensorflow_example_tpu_torch.train import loop as tloop
from distributed_tensorflow_example_tpu_torch.train import optim as toptim
from distributed_tensorflow_example_tpu_torch.train import state as tstate
from distributed_tensorflow_example_tpu_torch.utils import checkpoint as tckpt

# one intra-op thread: the suite runs six test workers (and the rank
# processes) on the machine's cores, where torch would start one a core
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(a):
    """A tensor or array as (dtype name, shape, raw bytes): bitwise
    equality across the packages, bf16 included."""
    if isinstance(a, torch.Tensor):
        from distributed_tensorflow_example_tpu_torch.resilience import codec

        enc, name = codec.encode_array(a)
        return (name or enc.dtype.name, tuple(a.shape), enc.tobytes())
    a = np.asarray(a)
    return (a.dtype.name, a.shape, np.ascontiguousarray(a).tobytes())


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


def _snapshots(rng, step):
    """The same leaves for both packages: numpy (ml_dtypes bf16) for
    JAX, CPU tensors for the port."""
    w = rng.standard_normal((6, 4)).astype(np.float32)
    m = rng.standard_normal((5, 3)).astype(np.float32).astype(jnp.bfloat16)
    big = rng.standard_normal((8, 3)).astype(np.float32)
    jsnap = {".step": np.asarray(step, np.int32), ".params/W1": w,
             ".opt_state/mu/W1": m,
             ".params/b": [([[0, 4], [0, 3]], big[:4]),
                           ([[4, 8], [0, 3]], big[4:])]}
    tsnap = {".step": torch.tensor(step, dtype=torch.int32),
             ".params/W1": torch.from_numpy(w.copy()),
             ".opt_state/mu/W1": convert._to_tensor(m),
             ".params/b": [([[0, 4], [0, 3]], torch.from_numpy(big[:4])),
                           ([[4, 8], [0, 3]], torch.from_numpy(big[4:]))]}
    meta = {".params/b": {"shape": [8, 3], "dtype": "float32"}}
    whole = {".step": jsnap[".step"], ".params/W1": w,
             ".opt_state/mu/W1": m, ".params/b": big}
    return jsnap, tsnap, meta, whole


def _files(d, pattern):
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(d,
                                                                       pattern)))


def test_snapshot_store_restores_across_packages(tmp_path):
    """Three snapshots (the W leaf unchanged after the first: reused)
    written by each package: the same objects and part manifests; each
    restores bitwise through the other's ``restore_arrays``; keep-2
    retention leaves the same files in both stores."""
    rng = np.random.default_rng(0)
    seq = []
    for step in (2, 4, 6):
        seq.append(_snapshots(rng, step))
        seq[-1][0][".params/W1"] = seq[0][0][".params/W1"]
        seq[-1][1][".params/W1"] = seq[0][1][".params/W1"]
        seq[-1][3][".params/W1"] = seq[0][3][".params/W1"]
    dirs = {"torch": str(tmp_path / "t"), "jax": str(tmp_path / "j")}
    stats = {}
    for step, (jsnap, tsnap, meta, _w) in zip((2, 4, 6), seq):
        stats[step] = (
            tman.persist_snapshot(dirs["torch"], step, 0, tsnap,
                                  leaf_meta=meta,
                                  data_state={"batches_done": step}),
            jman.persist_snapshot(dirs["jax"], step, 0, jsnap,
                                  leaf_meta=meta,
                                  data_state={"batches_done": step}))
    for t, j in stats.values():
        assert {k: v for k, v in t.items() if k != "root"} == \
            {k: v for k, v in j.items() if k != "root"}
    assert stats[4][0]["objects_reused"] == 1
    assert _files(dirs["torch"], "objects/*") == _files(dirs["jax"],
                                                        "objects/*")
    for name in _files(dirs["jax"], "snap-*.part*.json"):
        assert tman.load_manifest(os.path.join(dirs["torch"], name)) == \
            jman.load_manifest(os.path.join(dirs["jax"], name))
    for who, d in dirs.items():
        for step, (_j, _t, _m, whole) in zip((2, 4, 6), seq):
            path = os.path.join(d, tman.root_name(step))
            data_t, s_t, _ = tman.restore_arrays(
                d, tman.load_manifest(path))
            data_j, s_j, _ = jman.restore_arrays(
                d, jman.load_manifest(path))
            assert s_t == s_j == step
            _same(data_t, whole)
            _same(data_j, whole)
    for d, man in ((dirs["torch"], tman), (dirs["jax"], jman)):
        man.prune_snapshots(d, keep=2, grace_s=0.0)
    for pattern in ("objects/*", "snap-*.json"):
        assert _files(dirs["torch"], pattern) == _files(dirs["jax"],
                                                        pattern)
    assert tman.newest_valid_snapshot(dirs["jax"])[0]["step"] == 6
    plan, flat = tres.auto_resume(dirs["jax"])
    assert (plan.step, plan.batches_done) == (6, 6)
    _same(flat, seq[2][3])


# ---------------------------------------------------------------------------
# classic checkpoints: sharded/async and single-file, both directions
# ---------------------------------------------------------------------------

_ADAM = dict(optimizer="adam", adam_moments_dtype="bfloat16",
             hidden_sizes=(16, 8), seed=4)


def _states():
    """One JAX state and the port's copy of it (Adam, bf16 moments),
    after one step so the moments hold values."""
    jcfg = jconfig.Config(**_ADAM)
    jspec = jloop.make_spec(jcfg)
    jopt = joptim.make_optimizer(jcfg)
    js = jstate.create_train_state(jax.random.PRNGKey(4), jspec, jopt)
    rng = np.random.default_rng(1)
    moved = {k: np.asarray(v) + rng.standard_normal(np.shape(v)).astype(
        np.float32) for k, v in js.params.items()}
    js = js.replace(
        params={k: jnp.asarray(v) for k, v in moved.items()},
        opt_state=jax.tree_util.tree_map(
            lambda x: x + jnp.ones_like(x) * 0.375 if x.ndim else x + 3,
            js.opt_state),
        step=js.step + 7)
    tcfg = tconfig.Config(**_ADAM, device="cpu")
    tspec = tloop.make_spec(tcfg)
    topt = toptim.make_optimizer(tcfg, 10)
    template = tstate.create_train_state(tspec, topt, device="cpu")
    return js, template


@pytest.mark.parametrize("fmt", ["sharded_async", "single"])
def test_classic_checkpoints_restore_across_packages(tmp_path, fmt):
    js, template = _states()
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    if fmt == "single":
        jpath = jckpt.save_checkpoint(jdir, js, 7, 1)
    else:
        jpath = jckpt.save_checkpoint_sharded(jdir, js, 7, 1, async_=True)
        jckpt.wait_for_pending_saves()
    assert jckpt.latest_checkpoint(jdir) == jpath
    ts, step, epoch = tckpt.restore_checkpoint(jpath, template)
    assert (step, epoch) == (7, 1)
    want = jckpt._flatten(js)
    got = tckpt.flatten_state(ts)
    _same(got, want)
    assert got[".opt_state/mu/W1"].dtype == torch.bfloat16
    if fmt == "single":
        tpath = tckpt.save_checkpoint(tdir, ts, 7, 1)
    else:
        tpath = tckpt.save_checkpoint_sharded(tdir, ts, 7, 1, async_=True)
        assert tckpt.latest_checkpoint(tdir) is None or os.path.isfile(
            os.path.join(tpath, "manifest.json"))
        tckpt.wait_for_pending_saves()
        assert sorted(os.listdir(tpath)) == ["manifest.json",
                                             "proc-00000.npz"]
        with open(os.path.join(tpath, "manifest.json")) as f, \
                open(os.path.join(jpath, "manifest.json")) as g:
            assert json.load(f) == json.load(g)
    assert tckpt.latest_checkpoint(tdir) == tpath
    back, step, epoch = jckpt.restore_checkpoint(tpath, js)
    assert (step, epoch) == (7, 1)
    _same(jckpt._flatten(back), want)
    assert tckpt.load_extras(tpath) == jckpt.load_extras(tpath) == {}


def test_async_checkpoint_failure_surfaces(tmp_path):
    _js, template = _states()
    (tmp_path / "ckpt-00000003.shards").write_text("a file in the way")
    with pytest.raises(Exception):
        tckpt.save_checkpoint_sharded(str(tmp_path), template, 3, 0,
                                      async_=True)
        tckpt.wait_for_pending_saves()
    tckpt.save_checkpoint_sharded(str(tmp_path), template, 5, 0,
                                  async_=True)
    tckpt.save_checkpoint_sharded(str(tmp_path), template, 6, 0,
                                  async_=True, on_complete=lambda:
                                  tckpt.prune_checkpoints(str(tmp_path), 1))
    tckpt.wait_for_pending_saves()
    assert tckpt.latest_checkpoint(str(tmp_path)).endswith(
        "ckpt-00000006.shards")
    assert not os.path.exists(tmp_path / "ckpt-00000005.shards")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

_TRAIN = ["--training_epochs=2", "--dataset=synthetic",
          "--synthetic_train_size=400", "--synthetic_test_size=100",
          "--batch_size=50", "--hidden_sizes=16", "--learning_rate=0.5",
          "--no_summaries", "--frequency=3", "--seed=3",
          "--ckpt_every=2"]

# the SIGTERM'd trainer: the port's main with each step paced, so the
# signal that follows the step-4 snapshot lands mid-run (the pace only
# waits: the steps and their numbers are the trainer's own)
_PACED_MAIN = (
    "import sys, time\n"
    "from distributed_tensorflow_example_tpu_torch import main\n"
    "from distributed_tensorflow_example_tpu_torch.parallel import step\n"
    "make = step.make_sync_step_body\n"
    "def paced(*a, **k):\n"
    "    body = make(*a, **k)\n"
    "    def run(*b):\n"
    "        out = body(*b)\n"
    "        time.sleep(0.4)\n"
    "        return out\n"
    "    return run\n"
    "step.make_sync_step_body = paced\n"
    "sys.exit(main.main(sys.argv[1:]))\n")


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = tloop.run(tconfig.parse_train_config(argv))
    return res, buf.getvalue()


def _final(ckpt_dir, man=tman):
    manifest, _ = man.newest_valid_snapshot(ckpt_dir)
    return man.restore_arrays(ckpt_dir, manifest)[0], manifest


def test_sigterm_then_resume_auto_is_bitwise_uninterrupted(tmp_path):
    """The run SIGTERM reaches after its step-4 snapshot: exit 143 through
    ``Preempted``, its final snapshot at the exact step, a ``preempt``
    row; ``--resume=auto`` restores it, skips the batches of its epoch
    already done, and ends with params, optimizer state and step bitwise
    equal to an uninterrupted run's; the relaunch narrates ``resumed``."""
    logs, cdir = str(tmp_path / "logs"), str(tmp_path / "ckpt")
    argv = _TRAIN + ["--device=cpu", f"--checkpoint_dir={cdir}",
                     f"--logs_path={logs}"]
    # one intra-op thread, as this process: the runs compared bitwise
    # must split their reductions alike
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", _PACED_MAIN] + argv,
                            cwd=_REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            found = tman.newest_valid_snapshot(cdir)
            if found is not None and found[0]["step"] >= 4:
                proc.send_signal(signal.SIGTERM)
                break
            time.sleep(0.02)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 128 + signal.SIGTERM, out
    m = [ln for ln in out.splitlines() if ln.startswith("Preempted")]
    assert m and "SIGTERM" in m[0], out
    stopped = tman.newest_valid_snapshot(cdir)[0]
    assert 4 <= stopped["step"] < 16
    assert f"final snapshot at step {stopped['step']}" in m[0]
    assert [r["event"] for r in read_restarts(logs)].count("preempt") == 1

    res, out = _run(argv + ["--resume=auto"])
    assert res["fast_loop"] is False and res["steps"] == 16
    ds = stopped["data_state"]
    assert (f"step {stopped['step']} (+{ds['batches_done']} in-epoch "
            f"batches)") in out
    resumed = [r for r in read_restarts(logs) if r["event"] == "resumed"]
    assert resumed and resumed[0]["step"] == stopped["step"]

    ref_dir = str(tmp_path / "ref")
    ref, ref_out = _run(_TRAIN + ["--device=cpu", f"--checkpoint_dir={ref_dir}",
                                  f"--logs_path={tmp_path / 'ref_logs'}"])
    got, gman = _final(cdir)
    want, wman = _final(ref_dir)
    assert gman["step"] == wman["step"] == 16
    _same(got, want)
    # the printed windows after the resume point are the uninterrupted
    # run's (AvgTime aside)
    tail = [ln.split("AvgTime")[0] for ln in out.splitlines()
            if ln.startswith("Step:")]
    ref_lines = [ln.split("AvgTime")[0] for ln in ref_out.splitlines()
                 if ln.startswith("Step:")]
    assert tail and tail == ref_lines[-len(tail):]


def _jax_init(tcfg, jcfg):
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


_BOTH = dict(training_epochs=2, batch_size=50, hidden_sizes=(16,),
             learning_rate=0.5, frequency=3, seed=3, summaries=False,
             ckpt_every=2, trace_spans=True)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The same flags through the JAX trainer and the port's, from JAX's
    initial params on the same data; then the port resumed from the JAX
    store cut back to its newest snapshot before the end."""
    tmp = tmp_path_factory.mktemp("both")
    data = dict(train_size=400, test_size=100, input_size=784)
    jdata = jmnist.synthesize_dataset(seed=0, **data)
    tdata = tmnist.synthesize_dataset(seed=0, **data)
    out = {}
    cfgs = {"jax": jconfig.Config(**_BOTH, data_parallel=1,
                                  logs_path=str(tmp / "jl"),
                                  checkpoint_dir=str(tmp / "jc")),
            "torch": tconfig.Config(**_BOTH, device="cpu",
                                    logs_path=str(tmp / "tl"),
                                    checkpoint_dir=str(tmp / "tc"))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "load_datasets", lambda *a, **k: jdata)
        mp.setattr(tloop, "load_datasets", lambda *a, **k: tdata)
        mp.setattr(tloop, "create_train_state",
                   _jax_init(cfgs["torch"], cfgs["jax"]))
        for side, fn in (("jax", jloop.run), ("torch", tloop.run)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = fn(cfgs[side])
            out[side] = dict(result=res, stdout=buf.getvalue(),
                             cfg=cfgs[side])
        # the JAX store cut back to its newest snapshot before the end
        # (the writer may coalesce some away; step 2's always lands)
        cut = str(tmp / "cut")
        import shutil

        shutil.copytree(cfgs["jax"].checkpoint_dir, cut)
        steps = [s for s, _n in jman.list_snapshots(cut)]
        keep = max(s for s in steps if s < 16)
        for step, name in jman.list_snapshots(cut):
            if step > keep:
                os.remove(os.path.join(cut, name))
        out["cut_step"] = keep
        import dataclasses

        rcfg = dataclasses.replace(cfgs["torch"], checkpoint_dir=cut,
                                   resume="auto", trace_spans=False,
                                   logs_path=str(tmp / "rl"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out["resumed"] = dict(result=tloop.run(rcfg),
                                  stdout=buf.getvalue(), cfg=rcfg)
    return out


def _close(got, want, rtol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max |diff| {err} > {rtol} x {scale}"


def test_uninterrupted_run_matches_jax(both):
    t, j = both["torch"], both["jax"]
    assert t["result"]["fast_loop"] is j["result"]["fast_loop"] is False
    assert t["result"]["steps"] == j["result"]["steps"] == 16
    got, gman = _final(t["cfg"].checkpoint_dir)
    want, wman = _final(j["cfg"].checkpoint_dir, jman)
    assert gman["step"] == wman["step"] == 16
    assert gman["data_state"] == wman["data_state"]
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].numpy(), want[k], 1e-4, k)
    cost = [float(ln.split("Cost: ")[1].split(",")[0])
            for s in (t, j) for ln in s["stdout"].splitlines()
            if ln.startswith("Step:")]
    half = len(cost) // 2
    _close(cost[:half], cost[half:], 1e-3, "printed costs")
    stats = t["result"]["checkpoint_stats"]
    assert stats["written"] >= 1 and stats["last_step"] == 16
    assert len(stats["ckpt_stall_ms"]) == 8


def test_jax_store_resumes_in_the_port(both):
    """The port resumes JAX's mid-run snapshot (step k: epoch k // 8,
    k % 8 batches done) and ends where JAX's uninterrupted run ended
    (1e-4 of scale)."""
    r, j, k = both["resumed"], both["jax"], both["cut_step"]
    assert f"epoch {k // 8} step {k} (+{k % 8} in-epoch batches)" in \
        r["stdout"]
    assert r["result"]["steps"] == 16
    got, _ = _final(r["cfg"].checkpoint_dir)
    want, _ = _final(j["cfg"].checkpoint_dir, jman)
    for k in want:
        _close(got[k].numpy(), want[k], 1e-4, k)


def test_ckpt_phase_rows_carry_the_jax_keys(both):
    rows = {}
    for side in ("torch", "jax"):
        path = os.path.join(both[side]["cfg"].logs_path, "spans.0.jsonl")
        with open(path) as f:
            rows[side] = [json.loads(ln) for ln in f]
        assert rows[side] and all(r["event"] == "phase"
                                  and r["phase"] == "ckpt"
                                  for r in rows[side])
        assert len({r["trace_id"] for r in rows[side]}) == 1
    assert [sorted(r) for r in rows["torch"]] == \
        [sorted(r) for r in rows["jax"]]
    assert [r["step"] for r in rows["torch"]] == \
        [r["step"] for r in rows["jax"]] == list(range(2, 17, 2))
    from distributed_tensorflow_example_tpu_torch.obs import schema

    assert all(schema.validate_span_row(r) == [] for r in rows["torch"])


# (flags, passes) — both packages agree on every case
_VALIDATION = [
    (["--ckpt_every=-1"], False),
    (["--ckpt_keep=-1"], False),
    (["--ckpt_keep=2"], False),
    (["--ckpt_every=2"], False),
    (["--ckpt_every=2", "--checkpoint_dir=/tmp/x"], True),
    (["--ckpt_every=2", "--ckpt_keep=2", "--checkpoint_dir=/tmp/x"], True),
    (["--resume"], True),
    (["--resume=auto"], True),
    (["--resume=latest", "--checkpoint_dir=/tmp/x"], True),
    (["--async_checkpoints"], False),
    (["--async_checkpoints", "--sharded_checkpoints"], True),
]


@pytest.mark.parametrize("flags,passes", _VALIDATION)
def test_validate_resilience_config_refuses_as_jax(flags, passes):
    jcfg = jconfig.parse_config(flags)
    tcfg = tconfig.parse_train_config(flags)
    for name in ("resume", "ckpt_every", "ckpt_keep", "checkpoint_dir",
                 "sharded_checkpoints", "async_checkpoints"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    outcomes = []
    for validate in (jconfig.validate_resilience_config,
                     tconfig.validate_resilience_config):
        try:
            validate(jcfg if validate is jconfig.validate_resilience_config
                     else tcfg)
            outcomes.append(True)
        except ValueError:
            outcomes.append(False)
    if flags[0] == "--async_checkpoints" and not passes:
        # JAX checks it at the top of run(), before any other work
        with pytest.raises(ValueError, match="async_checkpoints"):
            jloop.run(jcfg)
        outcomes[0] = False
    try:
        tconfig.validate_train_config(tcfg)
    except ValueError:
        outcomes[1] = False
    assert outcomes == [passes, passes]


def test_resume_mode_is_refused_at_parse_in_both(capsys):
    for parse in (jconfig.parse_config, tconfig.parse_train_config):
        with pytest.raises(SystemExit) as e:
            parse(["--resume=sometimes"])
        assert e.value.code == 2
        assert "resume mode" in capsys.readouterr().err


def test_chip_smoke_resilience_phase_rehearses_on_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 5b rehearsed on the CPU at a narrow width
    (784-16-10, batch 50, 8 steps): two uninterrupted runs bitwise equal,
    the sharded async classic checkpoint restored bitwise, the paced
    trainer SIGTERM'd after its step-4 snapshot exiting 143 with a
    preempt row, the --resume=auto relaunch bitwise the uninterrupted
    run.  The counters stay 0: CPU tensors take the plain versions."""
    import chip_smoke

    # the paced trainer's process: one intra-op thread, as this one, so
    # the runs compared bitwise split their reductions alike
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    flags = ["--hidden_sizes=16", "--batch_size=50", "--dataset=synthetic",
             "--synthetic_train_size=400", "--synthetic_test_size=100",
             "--training_epochs=1", "--no_summaries", "--frequency=1",
             "--seed=1", "--learning_rate=0.5", "--ckpt_every=2"]
    res = chip_smoke.phase_resilience("cpu", flags, pace=0.5, device="cpu")
    assert set(res["counts"].values()) == {0}
    assert 4 <= res["stopped"] <= 8
    assert len(res["stall_ms"]) == 4 and res["snap_bytes"] > 0


def test_bare_resume_restores_classic_then_falls_forward(tmp_path):
    """Bare ``--resume`` on the fast path: a 1-epoch run's exit
    checkpoint resumed for a second epoch ends bitwise where an
    uninterrupted 2-epoch run ends; over a store only ``--ckpt_every``
    filled it falls forward to the newest snapshot, and refuses a
    mid-epoch one (that needs ``--resume=auto``)."""
    base = ["--device=cpu", "--dataset=synthetic",
            "--synthetic_train_size=400", "--synthetic_test_size=100",
            "--batch_size=50", "--hidden_sizes=16", "--learning_rate=0.5",
            "--no_summaries", "--seed=3", f"--logs_path={tmp_path}/l"]
    a, b = f"--checkpoint_dir={tmp_path}/a", f"--checkpoint_dir={tmp_path}/b"
    ref, _ = _run(base + [a, "--training_epochs=2"])
    _run(base + [b, "--training_epochs=1"])
    res, out = _run(base + [b, "--training_epochs=2", "--resume"])
    assert ref["fast_loop"] and res["fast_loop"] and res["steps"] == 16
    assert "ckpt-00000008.npz at epoch 1" in out
    want = np.load(tckpt.latest_checkpoint(f"{tmp_path}/a"))
    got = np.load(tckpt.latest_checkpoint(f"{tmp_path}/b"))
    assert sorted(want.files) == sorted(got.files)
    for k in want.files:
        assert want[k].tobytes() == got[k].tobytes(), k
    c = f"--checkpoint_dir={tmp_path}/c"
    _run(base + [c, "--training_epochs=1", "--ckpt_every=4"])
    res, out = _run(base + [c, "--training_epochs=2", "--resume"])
    assert res["fast_loop"] and "snap-00000008.json at epoch 1 step 8" in out
    # the store cut back to its mid-epoch step-4 snapshot (the classic
    # exit checkpoint of the run above removed too)
    cut = f"{tmp_path}/c"
    for step, name in tman.list_snapshots(cut):
        if step != 4:
            os.remove(os.path.join(cut, name))
    for path in glob.glob(os.path.join(cut, "ckpt-*.npz")):
        os.remove(path)
    with pytest.raises(ValueError, match="--resume=auto"):
        _run(base + [c, "--training_epochs=2", "--resume"])

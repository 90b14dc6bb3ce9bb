"""The port's MLP training stack against the JAX package, on the CPU.

Data, optimizers, the synchronous step, the whole ``run`` (stdout,
summaries, checkpoints both ways), two gloo processes against one, and
the CLI's refusals.  The same numpy inputs, and the JAX package's own
initial params (carried across with ``convert.mlp_params_from_numpy``),
go through both sides.  The ``run`` on both sides is the host path
(``fast_loop=False``; the default fast path has its own file,
``tests/test_torch_epoch.py``) with ``--pallas``, whose Pallas kernel
runs in interpret mode on the CPU.  Tolerances, all f32 unless stated:
the two sides sum in different orders, so parameters agree to ~1e-6
relative after a few updates (asserted within 1e-5, 1e-4 after a whole
run); printed costs are compared as parsed numbers within 1e-3 (they
print four decimals); bf16 Adam moments within one bf16 ulp (2^-7
relative).
"""

import contextlib
import glob
import io
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.data import mnist as jmnist
from distributed_tensorflow_example_tpu.models import mlp as jmlp
from distributed_tensorflow_example_tpu.parallel import mesh as jmesh
from distributed_tensorflow_example_tpu.parallel import step as jstep
from distributed_tensorflow_example_tpu.train import loop as jloop
from distributed_tensorflow_example_tpu.train import optim as joptim
from distributed_tensorflow_example_tpu.train import state as jstate
from distributed_tensorflow_example_tpu.utils import checkpoint as jckpt
from distributed_tensorflow_example_tpu.utils import summary as jsummary
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch import main as tmain
from distributed_tensorflow_example_tpu_torch.data import mnist as tmnist
from distributed_tensorflow_example_tpu_torch.models import mlp as tmlp
from distributed_tensorflow_example_tpu_torch.parallel import step as tstep
from distributed_tensorflow_example_tpu_torch.train import loop as tloop
from distributed_tensorflow_example_tpu_torch.train import optim as toptim
from distributed_tensorflow_example_tpu_torch.train import state as tstate
from distributed_tensorflow_example_tpu_torch.utils import checkpoint as tckpt
from distributed_tensorflow_example_tpu_torch.utils import summary as tsummary

# one intra-op thread: the suite runs six test workers (and the rank
# processes) on the machine's cores, where torch would start one a core
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_RE = re.compile(
    r"^Step: \d+,  Epoch: [ \d]\d,  Batch: [ \d]{3} of [ \d]{3},"
    r"  Cost: \d+\.\d{4},  AvgTime: +\d+\.\d{2}ms$")


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max |diff| {err} > {rtol} x {scale}"


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_synthetic_data_and_epochs_match_jax():
    """The synthetic dataset and the epoch permutations (unsharded and
    process 1 of 2) are bit-identical to the JAX package's."""
    j = jmnist.synthesize_dataset(seed=0, train_size=300, test_size=40)
    t = tmnist.synthesize_dataset(seed=0, train_size=300, test_size=40)
    for split in ("train", "validation", "test"):
        for arr in ("images", "labels"):
            assert np.array_equal(getattr(getattr(t, split), arr),
                                  getattr(getattr(j, split), arr))
    for kw in ({}, {"process_index": 1, "process_count": 2}):
        ji = jmnist.EpochIterator(j.train, batch_size=32, seed=7, **kw)
        ti = tmnist.EpochIterator(t.train, batch_size=32, seed=7, **kw)
        assert ti.batches_per_epoch == ji.batches_per_epoch
        for e in (0, 3):
            for (tx, ty), (jx, jy) in zip(ti.epoch(e), ji.epoch(e),
                                          strict=True):
                assert np.array_equal(tx, jx) and np.array_equal(ty, jy)


def test_idx_files_load_like_jax(tmp_path):
    """IDX files in ``--data_dir`` (one of them gzipped) load as the JAX
    package loads them, through ``auto`` and ``mnist``; bad magic
    raises."""
    import gzip
    import struct

    rng = np.random.RandomState(0)

    def write(name, magic, dims, data, gz=False):
        blob = struct.pack(">I" + "I" * len(dims), magic, *dims) + \
            data.tobytes()
        opener = gzip.open if gz else open
        with opener(str(tmp_path / (name + (".gz" if gz else ""))),
                    "wb") as f:
            f.write(blob)

    n_train, n_test = tmnist.VALIDATION_SIZE + 30, 20
    write(tmnist.TRAIN_IMAGES, tmnist.IMAGE_MAGIC, (n_train, 28, 28),
          rng.randint(0, 256, (n_train, 28, 28)).astype(np.uint8))
    write(tmnist.TRAIN_LABELS, tmnist.LABEL_MAGIC, (n_train,),
          rng.randint(0, 10, n_train).astype(np.uint8))
    write(tmnist.TEST_IMAGES, tmnist.IMAGE_MAGIC, (n_test, 28, 28),
          rng.randint(0, 256, (n_test, 28, 28)).astype(np.uint8), gz=True)
    write(tmnist.TEST_LABELS, tmnist.LABEL_MAGIC, (n_test,),
          rng.randint(0, 10, n_test).astype(np.uint8))
    want = jmnist.load_idx_dataset(str(tmp_path))
    for mode in ("auto", "mnist"):
        got = tmnist.load_datasets(str(tmp_path), mode)
        assert got.source == "mnist"
        for split in ("train", "validation", "test"):
            for arr in ("images", "labels"):
                assert np.array_equal(getattr(getattr(got, split), arr),
                                      getattr(getattr(want, split), arr))
    with pytest.raises(ValueError, match="magic"):
        tmnist.parse_idx_labels(struct.pack(">II", 0x803, 0))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

OPTIM_CASES = {
    "sgd_wd": dict(optimizer="sgd", weight_decay=0.01),
    "momentum_cosine": dict(optimizer="momentum", lr_schedule="cosine",
                            warmup_steps=2, schedule_steps=6),
    "adam_linear": dict(optimizer="adam", lr_schedule="linear",
                        warmup_steps=1, schedule_steps=5,
                        lr_min_factor=0.1),
    "adam_bf16_moments": dict(optimizer="adam",
                              adam_moments_dtype="bfloat16",
                              weight_decay=0.001),
}


def _jax_tree_np(tree):
    return [np.asarray(leaf, np.float32) for leaf in jax.tree.leaves(tree)]


@pytest.mark.parametrize("case", OPTIM_CASES)
def test_optimizers_match_jax_over_five_updates(case):
    """Five clipped updates (``grad_clip`` 1.0, binding) on the same
    grads: params and every slot against the JAX optimizer."""
    kw = dict(OPTIM_CASES[case], learning_rate=0.05)
    jopt = joptim.make_optimizer(jconfig.Config(**kw), total_steps=5)
    topt = toptim.make_optimizer(tconfig.Config(**kw), total_steps=5)
    rng = np.random.RandomState(11)
    params = {"W1": rng.randn(5, 3).astype(np.float32),
              "b1": rng.randn(3).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        g = {k: (rng.randn(*v.shape) * 3).astype(np.float32)
             for k, v in params.items()}
        jg, _ = joptim.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
        tg, _ = toptim.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
        jp, js = jopt.update(jg, js, jp)
        tp, ts = topt.update(tg, ts, tp)
    for k in params:
        _close(_np(tp[k]), jp[k], 1e-5, k)
    jl, tl = _jax_tree_np(js), [_np(v) for v in toptim.tree_leaves(ts)]
    assert len(jl) == len(tl)
    slot_tol = 2 ** -7 if "bf16" in case else 1e-5
    for i, (a, b) in enumerate(zip(tl, jl)):
        _close(a, b, slot_tol, f"slot {i}")


@pytest.mark.parametrize("case", OPTIM_CASES)
def test_checkpoints_cross_both_ways_for_every_optimizer(case, tmp_path):
    """A port checkpoint restores through the JAX ``restore_checkpoint``
    into the JAX state of the same optimizer, and a JAX checkpoint
    through the port's, bit for bit (bf16 moments through their uint16
    containers)."""
    kw = dict(OPTIM_CASES[case], learning_rate=0.05)
    jspec = jmlp.MLPSpec(input_size=6, hidden_sizes=(5,), num_classes=3)
    tspec = tmlp.MLPSpec(input_size=6, hidden_sizes=(5,), num_classes=3)
    jopt = joptim.make_optimizer(jconfig.Config(**kw), total_steps=5)
    topt = toptim.make_optimizer(tconfig.Config(**kw), total_steps=5)
    jst = jstate.create_train_state(jax.random.PRNGKey(0), jspec, jopt)
    tst = _port_state(tspec, topt, {k: np.asarray(v)
                                    for k, v in jst.params.items()})
    rng = np.random.RandomState(1)
    grads = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in jst.params.items()}
    jst = jstate.TrainState(jst.step + 1, *jopt.update(
        {k: jnp.asarray(v) for k, v in grads.items()}, jst.opt_state,
        jst.params))
    tst = tstate.TrainState(tst.step + 1, *topt.update(
        {k: torch.from_numpy(v) for k, v in grads.items()}, tst.opt_state,
        tst.params))
    tpath = tckpt.save_checkpoint(str(tmp_path / "t"), tst, 1, 0)
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), jst, 1, 0)
    with np.load(tpath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
    from_t, step, epoch = jckpt.restore_checkpoint(tpath, jst)
    assert (step, epoch) == (1, 0)
    tflat = tckpt.flatten_state(tst)
    for k, a in jckpt._flatten(from_t).items():
        assert str(a.dtype) == str(tflat[k].dtype).split(".")[-1], k
        assert np.array_equal(np.asarray(a, np.float32), _np(tflat[k])), k
    from_j, _, _ = tckpt.restore_checkpoint(jpath, tst)
    for k, a in jckpt._flatten(jst).items():
        assert np.array_equal(_np(tckpt.flatten_state(from_j)[k]),
                              np.asarray(a, np.float32)), k


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

STEP_CASES = {
    "sigmoid_f32_pallas_adam": dict(activation="sigmoid", pallas=True,
                                    optimizer="adam", learning_rate=0.01),
    "relu_f32_plain_momentum": dict(activation="relu", pallas=False,
                                    optimizer="momentum",
                                    learning_rate=0.05),
}


def _jax_init_np(jspec, seed):
    return {k: np.asarray(v)
            for k, v in jmlp.init(jax.random.PRNGKey(seed), jspec).items()}


def _port_state(tspec, optimizer, np_params):
    params = convert.mlp_params_from_numpy(np_params, tspec, device="cpu")
    return tstate.TrainState(torch.zeros((), dtype=torch.int32), params,
                             optimizer.init(params))


@pytest.mark.parametrize("case", STEP_CASES)
def test_step_matches_jax_build_train_step(case):
    """Three steps with ``grad_accum=2`` and a binding ``grad_clip``
    against the JAX ``build_train_step`` on a one-device mesh: costs
    within 1e-5, params within 1e-5 of their scale."""
    kw = dict(STEP_CASES[case], grad_accum=2, grad_clip=0.5, seed=2)
    spec_kw = dict(input_size=16, hidden_sizes=(12,), num_classes=4,
                   activation=kw["activation"])
    jspec, tspec = jmlp.MLPSpec(**spec_kw), tmlp.MLPSpec(**spec_kw)
    jcfg, tcfg = jconfig.Config(**kw), tconfig.Config(**kw)
    jopt, topt = joptim.make_optimizer(jcfg), toptim.make_optimizer(tcfg)
    mesh = jmesh.build_mesh(1, 1)
    jst = jstate.create_train_state(jax.random.PRNGKey(2), jspec, jopt)
    jst = jmesh.place_state(jst, mesh, jmesh.state_pspecs(jspec, jopt))
    tst = _port_state(tspec, topt, {k: np.asarray(v)
                                    for k, v in jst.params.items()})
    jfn = jstep.build_train_step(jcfg, mesh, jspec, jopt)
    tfn = tstep.make_sync_step_body(tcfg, tspec, topt)
    rng = np.random.RandomState(4)
    for _ in range(3):
        x = rng.rand(24, 16).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 24)]
        jst, jc, ja = jfn(jst, x, y)
        tst, tc, ta = tfn(tst, torch.from_numpy(x), torch.from_numpy(y))
        assert float(tc) == pytest.approx(float(jc), rel=1e-5)
        assert float(ta) == pytest.approx(float(ja), abs=1e-6)
    assert int(tst.step) == int(jst.step) == 3
    for k in jst.params:
        _close(_np(tst.params[k]), jst.params[k], 1e-5, k)


# ---------------------------------------------------------------------------
# the whole slice: run() against the JAX run()
# ---------------------------------------------------------------------------

RUN_KW = dict(training_epochs=1, batch_size=50, hidden_sizes=(16,),
              frequency=7, pallas=True, learning_rate=0.5,
              checkpoint_every=15, seed=3)


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """One JAX run and one port run of the same configuration on the same
    1000-example synthetic data from the same initial params."""
    tmp = tmp_path_factory.mktemp("runs")
    jdata = jmnist.synthesize_dataset(seed=0, train_size=1000, test_size=300)
    tdata = tmnist.synthesize_dataset(seed=0, train_size=1000, test_size=300)
    jcfg = jconfig.Config(**RUN_KW, fast_loop=False, data_parallel=1,
                          logs_path=str(tmp / "jax_logs"),
                          checkpoint_dir=str(tmp / "jax_ckpt"))
    tcfg = tconfig.Config(**RUN_KW, fast_loop=False, device="cpu",
                          logs_path=str(tmp / "torch_logs"),
                          checkpoint_dir=str(tmp / "torch_ckpt"))
    init_np = _jax_init_np(jloop.make_spec(jcfg), RUN_KW["seed"])

    def port_init(spec, optimizer, seed=1, device=None):
        return _port_state(spec, optimizer, init_np)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "load_datasets", lambda *a, **k: jdata)
        mp.setattr(tloop, "load_datasets", lambda *a, **k: tdata)
        mp.setattr(tloop, "create_train_state", port_init)
        for name, fn, cfg in (("jax", jloop.run, jcfg),
                              ("torch", tloop.run, tcfg)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = fn(cfg)
            out[name] = dict(stdout=buf.getvalue(), result=res, cfg=cfg)
    return out


def _costs(stdout):
    return [float(m) for m in re.findall(r"Cost: (\d+\.\d{4})", stdout)]


def test_run_prints_the_reference_format_and_matches_jax(both_runs):
    j, t = both_runs["jax"], both_runs["torch"]
    lines = t["stdout"].strip().split("\n")
    assert lines[0] == "Variables initialized ..."
    steps = [ln for ln in lines if ln.startswith("Step:")]
    assert len(steps) == 3 and all(STEP_RE.match(ln) for ln in steps)
    assert re.match(r"^Test-Accuracy: \d+\.\d{2}$", lines[-4])
    assert re.match(r"^Total Time: \d+\.\d{2}s$", lines[-3])
    assert re.match(r"^Final Cost: \d+\.\d{4}$", lines[-2])
    assert lines[-1] == "done"
    jsteps = [ln for ln in j["stdout"].split("\n") if ln.startswith("Step:")]
    assert [ln.split("Cost")[0] for ln in steps] == [
        ln.split("Cost")[0] for ln in jsteps]
    tc, jc = _costs(t["stdout"]), _costs(j["stdout"])
    assert len(tc) == len(jc) == 4
    assert np.allclose(tc, jc, rtol=0, atol=1e-3), (tc, jc)
    tr, jr = t["result"], j["result"]
    assert tr["test_accuracy"] == jr["test_accuracy"]
    for k in ("steps", "examples_seen", "global_batch", "dataset_source",
              "epochs_completed"):
        assert tr[k] == jr[k], k
    assert set(tr) == set(jr)


def test_run_final_params_and_checkpoints_match_jax(both_runs):
    """Final params within 1e-4 of their scale; the port's checkpoints
    restore through the JAX ``restore_checkpoint`` and the JAX run's
    through ``convert.train_state_from_checkpoint``; the same files at
    the same steps."""
    jdir = both_runs["jax"]["cfg"].checkpoint_dir
    tdir = both_runs["torch"]["cfg"].checkpoint_dir
    names = sorted(os.path.basename(p) for p in glob.glob(jdir + "/*.npz"))
    assert names == ["ckpt-00000015.npz", "ckpt-00000020.npz"]
    assert sorted(os.listdir(tdir)) == names
    jcfg = both_runs["jax"]["cfg"]
    jspec = jloop.make_spec(jcfg)
    jopt = joptim.make_optimizer(jcfg)
    template = jstate.create_train_state(jax.random.PRNGKey(0), jspec, jopt)
    tpath = tckpt.latest_checkpoint(tdir)
    jfrom_t, step, epoch = jckpt.restore_checkpoint(tpath, template)
    jfrom_j, jstep_, jepoch = jckpt.restore_checkpoint(
        jckpt.latest_checkpoint(jdir), template)
    assert (step, epoch) == (jstep_, jepoch) == (20, 1)
    assert int(jfrom_t.step) == 20
    for k in jfrom_j.params:
        _close(jfrom_t.params[k], jfrom_j.params[k], 1e-4, k)
    tspec = tloop.make_spec(both_runs["torch"]["cfg"])
    topt = toptim.make_optimizer(both_runs["torch"]["cfg"])
    tfrom_j, step, _ = convert.train_state_from_checkpoint(
        jdir, tspec, topt, device="cpu")
    assert step == 20 and int(tfrom_j.step) == 20
    for k in jfrom_j.params:
        assert np.array_equal(_np(tfrom_j.params[k]),
                              np.asarray(jfrom_j.params[k]))


def test_run_summaries_match_jax(both_runs):
    """The port's event file reads back through the JAX reader with the
    JAX run's tags, steps and graph; the scalars agree within 1e-3."""
    def events(name):
        files = glob.glob(os.path.join(both_runs[name]["cfg"].logs_path,
                                       "events.out.tfevents.*"))
        assert len(files) == 1
        return jsummary.read_event_file(files[0])

    te, je = events("torch"), events("jax")
    assert [e["file_version"] for e in te] == [e["file_version"] for e in je]
    assert [e["step"] for e in te] == [e["step"] for e in je]
    tg = [e["graph_nodes"] for e in te if e["graph_nodes"]]
    jg = [e["graph_nodes"] for e in je if e["graph_nodes"]]
    assert tg == jg and len(tg) == 1
    ts = [e["scalars"] for e in te if e["scalars"]]
    js = [e["scalars"] for e in je if e["scalars"]]
    assert len(ts) == len(js) == 20
    for a, b in zip(ts, js):
        assert set(a) == set(b) == {"cost", "accuracy"}
        assert a["cost"] == pytest.approx(b["cost"], abs=1e-3)
        assert a["accuracy"] == pytest.approx(b["accuracy"], abs=1e-6)
    # and the port's own reader agrees with the JAX one
    tfile = glob.glob(os.path.join(both_runs["torch"]["cfg"].logs_path,
                                   "events.*"))[0]
    assert tsummary.read_event_file(tfile) == jsummary.read_event_file(tfile)


# ---------------------------------------------------------------------------
# data parallelism: two gloo processes == one
# ---------------------------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(args):
    # one intra-op thread each: the model is tiny, and the suite runs
    # beside other test workers
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "distributed_tensorflow_example_tpu_torch.main",
         *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def test_two_gloo_processes_equal_one(tmp_path, capsys):
    """The same global batch of 40 over two CPU processes (gloo, each
    its 20-example shard, gradients all-reduced and averaged) and in one
    (this one): the same printed costs and test accuracy, final params
    within 1e-5 of their scale."""
    common = ["--device", "cpu", "--dataset=synthetic",
              "--synthetic_train_size=400", "--synthetic_test_size=100",
              "--batch_size=40", "--hidden_sizes=16", "--learning_rate=0.3",
              "--optimizer=momentum", "--frequency=4", "--no_summaries",
              "--training_epochs=1", "--seed=5", "--no_fast_loop"]
    port = _free_port()
    two = [_cli(common + [f"--task_index={r}",
                          f"--coordinator_address=127.0.0.1:{port}",
                          "--num_processes=2",
                          f"--checkpoint_dir={tmp_path / 'two'}"])
           for r in range(2)]
    assert tmain.main(common + ["--job_name=ps",
                                f"--checkpoint_dir={tmp_path / 'one'}"]) == 0
    single = capsys.readouterr().out
    outs = []
    for p in two:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
        outs.append(out)
    chief, worker = outs
    # --job_name=ps is explained away and trains as a worker
    assert single.startswith("NOTE: --job_name=ps maps to a no-op")
    assert _costs(chief) == _costs(single) and len(_costs(single)) == 4
    acc = re.findall(r"Test-Accuracy: (\S+)", single)
    assert re.findall(r"Test-Accuracy: (\S+)", chief) == acc
    assert "Test-Accuracy" not in worker and "done" not in worker
    assert _costs(worker) == _costs(chief)[:-1]   # no Final Cost line
    with np.load(tmp_path / "two" / "ckpt-00000010.npz") as a, \
            np.load(tmp_path / "one" / "ckpt-00000010.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k.startswith(".params"):
                _close(a[k], b[k], 1e-5, k)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--mnist_mirrors=http://127.0.0.1:1/"],
    ["--mnist_mirrors=http://127.0.0.1:1/,http://127.0.0.1:1/b/"]])
def test_cli_mnist_mirrors_parse_and_fail_offline_as_jax(argv, tmp_path):
    """``--mnist_mirrors`` parses to JAX's tuple; ``--dataset=mnist``
    with no IDX files in ``--data_dir`` tries each mirror (a closed
    local port: nothing leaves the machine) and raises JAX's
    ``FileNotFoundError`` (JAX's exit code 1) before any training."""
    data_dir = tmp_path / "nonexistent-mnist-dir"
    argv = argv + ["--dataset=mnist", f"--data_dir={data_dir}",
                   "--training_epochs=0"]
    t = tconfig.parse_train_config(argv)
    assert t.mnist_mirrors == jconfig.parse_config(argv).mnist_mirrors
    assert t.mnist_mirrors[0] == "http://127.0.0.1:1/"
    with pytest.raises(FileNotFoundError) as got:
        tmain.main(argv + ["--device", "cpu"])
    with pytest.raises(FileNotFoundError) as want:
        jmnist.load_datasets(str(data_dir), "mnist",
                             mirrors=t.mnist_mirrors)
    first = str(want.value).split("\n", 1)[0]
    assert str(got.value).startswith(first)
    assert "download failed" in first and "127.0.0.1:1" in str(got.value)


@pytest.mark.parametrize("argv", [
    ["--pipeline_parallel=2"], ["--serve_port=8000"],
    ["--model=transformer", "--expert_parallel=2"], ["--replicas=2"]])
def test_cli_refuses_what_is_not_ported(argv, capsys):
    """A flag the trainer does not have (the serving CLI's) exits 2 with
    a message naming ROADMAP.md, before any training;
    ``--expert_parallel`` and ``--pipeline_parallel`` parse since expert
    and pipeline parallelism were ported, and exit 2 with JAX's message
    without ``--num_experts`` or on the MLP."""
    try:
        rc = tmain.main(argv + ["--device", "cpu", "--training_epochs=0"])
    except SystemExit as e:
        rc = e.code
    assert rc == 2
    want = ("--expert_parallel requires --num_experts > 0"
            if "--expert_parallel=2" in argv
            else "--pipeline_parallel requires --model=transformer"
            if "--pipeline_parallel=2" in argv else "ROADMAP")
    assert want in capsys.readouterr().err


def test_cli_refuses_the_jax_operator_switches(monkeypatch, tmp_path):
    """The JAX ``main``'s operator switches are no longer refused: as
    there, ``DTX_METRICS=1`` turns ``--metrics`` on (the run writes its
    metrics stream) and ``DTX_METRICS=0`` leaves it off."""
    argv = ["--device", "cpu", "--training_epochs=0",
            "--synthetic_train_size=100", "--synthetic_test_size=10",
            "--no_summaries"]
    monkeypatch.setenv("DTX_METRICS", "0")
    assert tmain.main(argv + [f"--logs_path={tmp_path / 'off'}"]) == 0
    assert not (tmp_path / "off" / "metrics.0.jsonl").exists()
    monkeypatch.setenv("DTX_METRICS", "1")
    assert tmain.main(argv + [f"--logs_path={tmp_path / 'on'}"]) == 0
    assert (tmp_path / "on" / "metrics.0.jsonl").exists()


def test_run_needs_the_card_unless_cpu_is_asked_for():
    cfg = tconfig.Config(training_epochs=0, synthetic_train_size=100,
                         synthetic_test_size=10)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.run(cfg)


def test_cli_trains_on_the_cpu_in_the_reference_format(tmp_path, capsys):
    """The acceptance command line: one epoch on 2,000 synthetic examples
    prints the reference's format and ends in ``done``; the run learns
    (the reference MLP at lr 0.5 beats chance)."""
    rc = tmain.main(["--device", "cpu", "--training_epochs=1",
                     "--synthetic_train_size=2000",
                     "--synthetic_test_size=500", "--learning_rate=0.5",
                     f"--logs_path={tmp_path}"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().split("\n")
    assert lines[0] == "Variables initialized ..."
    assert all(STEP_RE.match(ln) for ln in lines[1:-4])
    assert len(lines) == 1 + 1 + 4      # 20 steps, frequency 100
    acc = float(lines[-4].split(": ")[1])
    assert acc > 0.2 and lines[-1] == "done"

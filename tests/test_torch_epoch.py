"""The port's device-resident epoch (``parallel/epoch.py``, the trainer's
default fast path) against the JAX package's, on the CPU.

``pack_images``/``normalize``, ``shard_dataset`` and ``build_fast_eval``
against their JAX counterparts; then the port's ``run`` at its defaults
(``fast_loop=True``) against the JAX ``run`` at its defaults, from the
JAX package's own initial params (carried across with
``convert.mlp_params_from_numpy`` / ``params_from_numpy``), on the same
synthetic data: a 2-epoch MLP (the whole-run runner), one ``--pallas``
MLP epoch (JAX's Pallas kernel in interpret mode), a tiny transformer,
and the per-epoch runner under ``--checkpoint_every``.  Both sides
shuffle each epoch with the same permutation (``utils/prng.py``), so the
same batches meet the same params.

Tolerances (f32; the two sides sum in other orders): per-step costs
from the event files within 1e-5 of their scale, accuracies within
1e-6, final params within 1e-4 of their scale (Adam on the transformer:
1e-3, its key bias within 2 lr per step as in
``tests/test_torch_transformer_train.py``), printed costs as parsed
numbers within 1e-3; test accuracies equal.
"""

import contextlib
import glob
import io
import os
import re

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.data import mnist as jmnist
from distributed_tensorflow_example_tpu.parallel import epoch as jepoch
from distributed_tensorflow_example_tpu.parallel import mesh as jmesh
from distributed_tensorflow_example_tpu.train import loop as jloop
from distributed_tensorflow_example_tpu.train import optim as joptim
from distributed_tensorflow_example_tpu.train import state as jstate
from distributed_tensorflow_example_tpu.utils import checkpoint as jckpt
from distributed_tensorflow_example_tpu.utils import summary as jsummary
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.data import mnist as tmnist
from distributed_tensorflow_example_tpu_torch.parallel import epoch as tepoch
from distributed_tensorflow_example_tpu_torch.train import loop as tloop
from distributed_tensorflow_example_tpu_torch.train import state as tstate

# one intra-op thread: the suite runs six test workers (and the rank
# processes) on the machine's cores, where torch would start one a core
torch.set_num_threads(1)

STEP_RE = re.compile(
    r"^Step: \d+,  Epoch: [ \d]\d,  Batch: [ \d]{3} of [ \d]{3},"
    r"  Cost: \d+\.\d{4},  AvgTime: +\d+\.\d{2}ms$")


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max |diff| {err} > {rtol} x {scale}"


# ---------------------------------------------------------------------------
# the staged data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["synthetic", "idx_like", "inexact"])
def test_pack_images_and_normalize_match_jax(source):
    """uint8 where every pixel is k/255 (the synthetic set, IDX pixels
    divided by 255), f32 otherwise; ``normalize`` gives back the very
    f32 images."""
    rng = np.random.RandomState(0)
    if source == "synthetic":
        images = tmnist.synthesize_split(64, seed=1).images
    elif source == "idx_like":
        images = rng.randint(0, 256, (64, 784)).astype(np.float32) / 255.0
    else:
        images = rng.rand(64, 784).astype(np.float32)
    got, want = tepoch.pack_images(images), jepoch._pack_images(images)
    assert got.dtype == want.dtype == (
        np.float32 if source == "inexact" else np.uint8)
    assert np.array_equal(got, want)
    back = tepoch.normalize(torch.from_numpy(got)).numpy()
    assert back.dtype == np.float32 and np.array_equal(back, images)


def test_shard_dataset_matches_jax():
    """Trimmed to whole batches, packed, the same arrays and steps as
    the JAX ``shard_dataset`` on a one-device mesh."""
    split = tmnist.synthesize_split(530, seed=2)
    img, lbl, spe = tepoch.shard_dataset(split.images, split.labels, 50,
                                         "cpu")
    jimg, jlbl, jspe = jepoch.shard_dataset(jmesh.build_mesh(1, 1),
                                            split.images, split.labels, 50)
    assert spe == jspe == 10 and img.shape[0] == 500
    assert np.array_equal(img.numpy(), np.asarray(jimg))
    assert np.array_equal(lbl.numpy(), np.asarray(jlbl))


def test_fast_eval_matches_jax():
    """The staged test split's accuracy, from one fetch, equal to the
    JAX ``build_fast_eval``'s on the same params (and to the host
    path's chunked eval)."""
    cfg = dict(hidden_sizes=(16,), seed=4)
    jcfg, tcfg = jconfig.Config(**cfg), tconfig.Config(**cfg, device="cpu")
    jspec, tspec = jloop.make_spec(jcfg), tloop.make_spec(tcfg)
    params = jstate.create_train_state(
        jax.random.PRNGKey(4), jspec, joptim.make_optimizer(jcfg)).params
    test = tmnist.synthesize_split(301, seed=3)
    want = jepoch.build_fast_eval(jcfg, jmesh.build_mesh(1, 1), jspec,
                                  test.images, test.labels)(params)
    fast_eval = tepoch.build_fast_eval(tcfg, tspec, test.images,
                                       test.labels, "cpu")
    tparams = convert.mlp_params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, tspec, device="cpu")
    assert fast_eval.n == 301
    assert fast_eval(tparams) == want


# ---------------------------------------------------------------------------
# the whole run at its defaults against the JAX run at its defaults
# ---------------------------------------------------------------------------

MLP_KW = dict(batch_size=50, hidden_sizes=(16,), frequency=7,
              learning_rate=0.5, seed=3)
TFM_KW = dict(model="transformer", input_size=64, seq_len=16, d_model=32,
              n_heads=2, num_blocks=2, d_ff=64, optimizer="adam",
              learning_rate=1e-3, seed=3, batch_size=8, frequency=2,
              eval_batch_size=8)

# name: (flags, train size, test size, input size)
RUNS = {
    "mlp_2_epochs": (dict(MLP_KW, training_epochs=2), 1020, 300, 784),
    "mlp_pallas": (dict(MLP_KW, training_epochs=1, pallas=True), 1000, 300,
                   784),
    "mlp_checkpoint_every": (dict(MLP_KW, training_epochs=2,
                                  checkpoint_every=15), 1000, 300, 784),
    "transformer": (dict(TFM_KW, training_epochs=1), 37, 12, 64),
}


def _port_init(tspec, init_np):
    def init(spec, optimizer, seed=1, device=None):
        if isinstance(tspec, tloop.tfm.TransformerSpec):
            params = convert.params_from_numpy(init_np, spec, device="cpu")
        else:
            params = convert.mlp_params_from_numpy(init_np, spec,
                                                   device="cpu")
        return tstate.TrainState(torch.zeros((), dtype=torch.int32), params,
                                 optimizer.init(params))
    return init


def _run_both(name, tmp):
    flags, n_train, n_test, width = RUNS[name]
    sizes = dict(train_size=n_train, test_size=n_test, input_size=width)
    jdata = jmnist.synthesize_dataset(seed=0, **sizes)
    tdata = tmnist.synthesize_dataset(seed=0, **sizes)
    common = dict(flags, logs_path=str(tmp / f"{name}_logs_%s"),
                  checkpoint_dir=str(tmp / f"{name}_ckpt_%s"))
    jcfg = jconfig.Config(**{k: (v % "jax" if isinstance(v, str)
                                 and "%s" in v else v)
                             for k, v in common.items()}, data_parallel=1)
    tcfg = tconfig.Config(**{k: (v % "torch" if isinstance(v, str)
                                 and "%s" in v else v)
                             for k, v in common.items()}, device="cpu")
    jspec = jloop.make_spec(jcfg)
    jparams = jstate.create_train_state(
        jax.random.PRNGKey(flags["seed"]), jspec,
        joptim.make_optimizer(jcfg)).params
    init_np = {k: np.asarray(v) for k, v in jparams.items()}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "load_datasets", lambda *a, **k: jdata)
        mp.setattr(tloop, "load_datasets", lambda *a, **k: tdata)
        mp.setattr(tloop, "create_train_state",
                   _port_init(tloop.make_spec(tcfg), init_np))
        for side, fn, cfg in (("jax", jloop.run, jcfg),
                              ("torch", tloop.run, tcfg)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = fn(cfg)
            out[side] = dict(stdout=buf.getvalue(), result=res, cfg=cfg)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fast_runs")
    return {name: _run_both(name, tmp) for name in RUNS}


def _events(cfg):
    files = glob.glob(os.path.join(cfg.logs_path, "events.out.tfevents.*"))
    assert len(files) == 1
    return jsummary.read_event_file(files[0])


def _scalars(cfg):
    return [(e["step"], e["scalars"]) for e in _events(cfg) if e["scalars"]]


def _final_params(cfg):
    path = jckpt.latest_checkpoint(cfg.checkpoint_dir)
    with np.load(path) as f:
        return {k: f[k] for k in f.files if k.startswith(".params")}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_fast_run_takes_the_fast_path_on_both_sides(runs, name):
    t, j = runs[name]["torch"], runs[name]["jax"]
    assert t["result"]["fast_loop"] is True
    assert j["result"]["fast_loop"] is True
    assert set(t["result"]) == set(j["result"])
    for k in ("steps", "examples_seen", "global_batch", "epochs_completed",
              "dataset_source", "test_accuracy"):
        assert t["result"][k] == j["result"][k], k


@pytest.mark.parametrize("name", sorted(RUNS))
def test_fast_run_per_step_costs_match_jax(runs, name):
    """Every step's summary (the fast path writes them from the returned
    arrays): the same steps, costs within 1e-5 of their scale,
    accuracies within 1e-6."""
    ts, js = (_scalars(runs[name][s]["cfg"]) for s in ("torch", "jax"))
    assert [s for s, _ in ts] == [s for s, _ in js]
    assert len(ts) == runs[name]["jax"]["result"]["steps"]
    tc = [v["cost"] for _, v in ts]
    jc = [v["cost"] for _, v in js]
    _close(tc, jc, 1e-5, "costs")
    assert np.allclose([v["accuracy"] for _, v in ts],
                       [v["accuracy"] for _, v in js], rtol=0, atol=1e-6)
    graphs = [e for e in _events(runs[name]["torch"]["cfg"])
              if e["graph_nodes"]]
    assert len(graphs) == 1


@pytest.mark.parametrize("name", sorted(RUNS))
def test_fast_run_final_params_match_jax(runs, name):
    """The final checkpoints: the same files at the same steps, params
    within 1e-4 of their scale (the transformer's Adam: 1e-3, the key
    bias within 2 lr per step)."""
    tcfg, jcfg = runs[name]["torch"]["cfg"], runs[name]["jax"]["cfg"]
    assert sorted(os.listdir(tcfg.checkpoint_dir)) == sorted(
        os.listdir(jcfg.checkpoint_dir))
    tp, jp = _final_params(tcfg), _final_params(jcfg)
    assert sorted(tp) == sorted(jp) and tp
    steps = runs[name]["jax"]["result"]["steps"]
    for k in jp:
        got, want = tp[k].astype(np.float32), jp[k].astype(np.float32)
        if k.endswith("_bqkv"):
            assert np.abs(got[1] - want[1]).max() <= 2 * steps * 1e-3, k
            got, want = got[0::2], want[0::2]
        _close(got, want, 1e-3 if name == "transformer" else 1e-4, k)


def test_fast_run_checkpoints_at_epoch_ends(runs):
    """Under ``--checkpoint_every`` the per-epoch runner hands control
    back at each epoch end, where a crossed boundary saves: step 20
    (15 crossed) and step 40 (30 crossed), as the JAX fast path."""
    for side in ("torch", "jax"):
        cdir = runs["mlp_checkpoint_every"][side]["cfg"].checkpoint_dir
        assert sorted(os.listdir(cdir)) == ["ckpt-00000020.npz",
                                            "ckpt-00000040.npz"], side


@pytest.mark.parametrize("name", sorted(RUNS))
def test_fast_run_prints_the_reference_format(runs, name):
    """The fast path's stdout: the reference's lines, the same step,
    epoch and batch numbers as the JAX fast path's and costs within
    1e-3; the ``AvgTime`` of a line is its steps x the run's (or the
    epoch's) wall over its steps."""
    t, j = runs[name]["torch"]["stdout"], runs[name]["jax"]["stdout"]
    lines = t.strip().split("\n")
    assert lines[0] == "Variables initialized ..." and lines[-1] == "done"
    steps = [ln for ln in lines if ln.startswith("Step:")]
    jsteps = [ln for ln in j.split("\n") if ln.startswith("Step:")]
    assert steps and all(STEP_RE.match(ln) for ln in steps)
    assert [ln.split("Cost")[0] for ln in steps] == [
        ln.split("Cost")[0] for ln in jsteps]
    assert re.match(r"^Test-Accuracy: \d+\.\d{2}$", lines[-4])
    assert re.match(r"^Total Time: \d+\.\d{2}s$", lines[-3])
    assert re.match(r"^Final Cost: \d+\.\d{4}$", lines[-2])

    def costs(out):
        return [float(m) for m in re.findall(r"Cost: (\d+\.\d{4})", out)]

    assert np.allclose(costs(t), costs(j), rtol=0, atol=1e-3)
    freq = RUNS[name][0]["frequency"]
    found = re.findall(r"Epoch: +(\d+),  Batch: +(\d+) of.*AvgTime: +(\S+)ms",
                       t)
    assert len(found) == len(steps)
    # a window of `frequency` steps prints the per-step average of its
    # run (or epoch): one value within each epoch
    for ep in {e for e, _b, _ms in found}:
        full = {ms for e, b, ms in found if e == ep and int(b) % freq == 0}
        assert len(full) == 1, (ep, full)

"""The port's transformer training against the JAX package, on the CPU.

The synchronous step against the JAX ``build_train_step`` on a
one-device mesh, ``--remat`` against no remat, the whole ``run`` against
the JAX ``run`` (host path, ``fast_loop=False``) with stdout, the test
accuracy, the final params and checkpoints read both ways, and a
transformer state with bf16 Adam moments carried across from a JAX
checkpoint.  The model is tiny (2 blocks, d_model 32, 2 heads, d_ff 64,
S 256), ``--attention=flash --causal --fused_ln``: the JAX side runs its
Pallas kernels in interpret mode, the port its plain versions.  Both
start from the JAX package's params (``convert.params_from_numpy``).

Tolerances: f32 sums run in other orders, so costs agree within 1e-5
relative after one step; with Adam each update is
``lr * m / (sqrt(v) + eps)``, which amplifies f32 differences in the
gradients of near-zero entries, so params are held within 1e-4 of their
scale (1e-3 after a whole run; bf16 moments round those differences to
2^-8 of the moment); printed costs are parsed numbers within 1e-3.
"""

import contextlib
import io
import os
import re

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.data import mnist as jmnist
from distributed_tensorflow_example_tpu.parallel import mesh as jmesh
from distributed_tensorflow_example_tpu.parallel import step as jstep
from distributed_tensorflow_example_tpu.train import loop as jloop
from distributed_tensorflow_example_tpu.train import optim as joptim
from distributed_tensorflow_example_tpu.train import state as jstate
from distributed_tensorflow_example_tpu.utils import checkpoint as jckpt
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.data import mnist as tmnist
from distributed_tensorflow_example_tpu_torch.parallel import step as tstep
from distributed_tensorflow_example_tpu_torch.train import loop as tloop
from distributed_tensorflow_example_tpu_torch.train import optim as toptim
from distributed_tensorflow_example_tpu_torch.train import state as tstate
from distributed_tensorflow_example_tpu_torch.utils import checkpoint as tckpt

TINY = dict(model="transformer", input_size=512, seq_len=256, d_model=32,
            n_heads=2, num_blocks=2, d_ff=64, attention="flash", causal=True,
            fused_ln=True, optimizer="adam", adam_moments_dtype="bfloat16",
            learning_rate=1e-3, seed=3)


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max |diff| {err} > {rtol} x {scale}"


def _close_params(got, want, rtol, key_bias_atol):
    """Every leaf within ``rtol`` of its scale, except the key bias
    ``bqkv[1]``, held to ``key_bias_atol``: softmax is invariant to it,
    so its true gradient is exactly 0 and both sides' gradients there
    are f32 noise, which Adam turns into steps of up to lr of either
    sign."""
    for k in want:
        g = (_np(got[k]) if isinstance(got[k], torch.Tensor)
             else np.asarray(got[k], np.float32))
        w = np.asarray(want[k], np.float32)
        if k.endswith("_bqkv"):
            assert np.abs(g[1] - w[1]).max() <= key_bias_atol, k
            g, w = g[0::2], w[0::2]
        _close(g, w, rtol, k)


def _port_state(tspec, optimizer, np_params):
    params = convert.params_from_numpy(np_params, tspec, device="cpu")
    return tstate.TrainState(torch.zeros((), dtype=torch.int32), params,
                             optimizer.init(params))


def _batch(rng, n, width):
    x = rng.rand(n, width).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)]
    return x, y


# name: (flags over TINY, steps)
STEP_CASES = {
    "classify_flash_fused_adam_bf16": ({}, 1),
    "lm_dense_sgd": (dict(objective="lm", input_size=256, attention="dense",
                          fused_ln=False, optimizer="sgd",
                          learning_rate=0.05, vocab_size=32), 2),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_matches_jax_build_train_step(case):
    """Synchronous steps on one device: costs within 1e-5, accuracy
    equal, params within 1e-4 of their scale, the key bias within 2 lr
    per step (``_close_params``)."""
    flags, n_steps = STEP_CASES[case]
    kw = dict(TINY, **flags)
    jcfg, tcfg = jconfig.Config(**kw), tconfig.Config(**kw)
    jspec, tspec = jloop.make_spec(jcfg), tloop.make_spec(tcfg)
    jopt, topt = joptim.make_optimizer(jcfg), toptim.make_optimizer(tcfg)
    mesh = jmesh.build_mesh(1, 1)
    jst = jstate.create_train_state(jax.random.PRNGKey(3), jspec, jopt)
    jst = jmesh.place_state(jst, mesh, jmesh.state_pspecs(jspec, jopt))
    tst = _port_state(tspec, topt, {k: np.asarray(v)
                                    for k, v in jst.params.items()})
    jfn = jstep.build_train_step(jcfg, mesh, jspec, jopt)
    tfn = tstep.make_sync_step_body(tcfg, tspec, topt)
    rng = np.random.RandomState(4)
    for _ in range(n_steps):
        x, y = _batch(rng, 4, kw["input_size"])
        jst, jc, ja = jfn(jst, x, y)
        tst, tc, ta = tfn(tst, torch.from_numpy(x), torch.from_numpy(y))
        assert float(tc) == pytest.approx(float(jc), rel=1e-5)
        assert float(ta) == pytest.approx(float(ja), abs=1e-6)
    assert int(tst.step) == int(jst.step) == n_steps
    _close_params(tst.params, jst.params, 1e-4,
                  2 * n_steps * kw["learning_rate"])


@pytest.mark.parametrize("dropout_rate", [0.0, 0.2])
def test_remat_leaves_the_step_unchanged(dropout_rate):
    """``--remat`` recomputes the forward in the backward: the same
    cost and the same updated params, bit for bit, with dropout too (the
    recompute draws the same masks)."""
    kw = dict(TINY, dropout_rate=dropout_rate)
    rng = np.random.RandomState(5)
    x, y = _batch(rng, 4, kw["input_size"])
    out = []
    for remat in (False, True):
        cfg = tconfig.Config(**kw, remat=remat)
        spec = tloop.make_spec(cfg)
        opt = toptim.make_optimizer(cfg)
        st = tstate.create_train_state(spec, opt, seed=1, device="cpu")
        st, cost, _ = tstep.make_sync_step_body(cfg, spec, opt)(
            st, torch.from_numpy(x), torch.from_numpy(y))
        out.append((float(cost), st.params))
    assert out[0][0] == out[1][0]
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


def test_dropout_step_seed_depends_on_the_step():
    """The per-step seed: None without dropout; with it, a function of
    (seed, step) — two steps draw different masks, a repeat the same."""
    cfg = tconfig.Config(**TINY, dropout_rate=0.1)
    spec = tloop.make_spec(cfg)
    rng_of = tstep.make_step_rng(cfg, spec)
    st = tstate.TrainState(torch.tensor(3, dtype=torch.int32), {}, ())
    st4 = tstate.TrainState(torch.tensor(4, dtype=torch.int32), {}, ())
    assert rng_of(st) == rng_of(st) != rng_of(st4)
    nodrop = tloop.make_spec(tconfig.Config(**TINY))
    assert tstep.make_step_rng(cfg, nodrop)(st) is None


# ---------------------------------------------------------------------------
# the whole run against the JAX run
# ---------------------------------------------------------------------------

RUN_KW = dict(TINY, training_epochs=1, batch_size=8, frequency=3,
              checkpoint_every=3, eval_batch_size=8)


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """One JAX run and one port run of the same tiny flash transformer on
    the same 32 training and 12 test examples from the same params."""
    tmp = tmp_path_factory.mktemp("tfm_runs")
    sizes = dict(train_size=32, test_size=12, input_size=512)
    jdata = jmnist.synthesize_dataset(seed=0, **sizes)
    tdata = tmnist.synthesize_dataset(seed=0, **sizes)
    jcfg = jconfig.Config(**RUN_KW, fast_loop=False, data_parallel=1,
                          logs_path=str(tmp / "jax_logs"),
                          checkpoint_dir=str(tmp / "jax_ckpt"))
    tcfg = tconfig.Config(**RUN_KW, fast_loop=False, device="cpu",
                          logs_path=str(tmp / "torch_logs"),
                          checkpoint_dir=str(tmp / "torch_ckpt"))
    jspec = jloop.make_spec(jcfg)
    jparams = jstate.create_train_state(
        jax.random.PRNGKey(RUN_KW["seed"]), jspec,
        joptim.make_optimizer(jcfg)).params
    init_np = {k: np.asarray(v) for k, v in jparams.items()}

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


def test_run_matches_jax_run(both_runs):
    """Costs as printed within 1e-3, the test accuracy and the counts
    equal, the same result keys."""
    j, t = both_runs["jax"], both_runs["torch"]
    lines = t["stdout"].strip().split("\n")
    assert lines[0] == "Variables initialized ..." and lines[-1] == "done"

    def costs(out):
        return [float(m) for m in re.findall(r"Cost: (\d+\.\d{4})", out)]

    tc, jc = costs(t["stdout"]), costs(j["stdout"])
    assert len(tc) == len(jc) >= 3
    assert np.allclose(tc, jc, rtol=0, atol=1e-3), (tc, jc)
    assert np.isfinite(tc).all()
    tr, jr = t["result"], j["result"]
    assert tr["test_accuracy"] == pytest.approx(jr["test_accuracy"],
                                                abs=1e-6)
    for k in ("steps", "examples_seen", "global_batch", "epochs_completed"):
        assert tr[k] == jr[k], k
    assert set(tr) == set(jr)


def test_run_final_params_and_checkpoints_match_jax(both_runs):
    """Final params within 1e-3 of their scale (the key bias within 2 lr
    per step, ``_close_params``); the port's checkpoint
    restores through the JAX ``restore_checkpoint`` and the JAX run's
    through ``convert.train_state_from_checkpoint`` bit for bit, bf16
    Adam moments included; the same files at the same steps."""
    jdir = both_runs["jax"]["cfg"].checkpoint_dir
    tdir = both_runs["torch"]["cfg"].checkpoint_dir
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "ckpt-00000003.npz", "ckpt-00000004.npz"]
    jcfg = both_runs["jax"]["cfg"]
    jspec = jloop.make_spec(jcfg)
    jopt = joptim.make_optimizer(jcfg)
    template = jstate.create_train_state(jax.random.PRNGKey(0), jspec, jopt)
    jfrom_t, step, epoch = jckpt.restore_checkpoint(
        tckpt.latest_checkpoint(tdir), template)
    jfrom_j, _, _ = jckpt.restore_checkpoint(
        jckpt.latest_checkpoint(jdir), template)
    assert (step, epoch) == (4, 1) and int(jfrom_t.step) == 4
    _close_params(jfrom_t.params, jfrom_j.params, 1e-3,
                  2 * 4 * RUN_KW["learning_rate"])
    tcfg = both_runs["torch"]["cfg"]
    tfrom_j, step, _ = convert.train_state_from_checkpoint(
        jdir, tloop.make_spec(tcfg), toptim.make_optimizer(tcfg),
        device="cpu")
    assert step == 4 and int(tfrom_j.step) == 4
    jflat = jckpt._flatten(jfrom_j)
    tflat = tckpt.flatten_state(tfrom_j)
    assert sorted(jflat) == sorted(tflat)
    mu = [k for k in tflat if k.startswith(".opt_state") and "L0_Wqkv" in k]
    assert mu and all(tflat[k].dtype == torch.bfloat16 for k in mu
                      if "/mu/" in k or "/nu/" in k)
    for k, a in jflat.items():
        assert np.array_equal(_np(tflat[k]), np.asarray(a, np.float32)), k

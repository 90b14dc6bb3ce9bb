"""The port's MoE transformer training against the JAX package's, on
the CPU.

One synchronous Adam step with ``--moe_aux_weight=0.01`` against the
JAX ``build_train_step`` on a one-device mesh (the grouped expert
kernel at top-2, with and without ``--remat``, and its fp8 form at
top-1, all under sparse dispatch with drops); a 3-step run of the whole trainer against the JAX ``run``
(host path) with its printed costs, the test accuracy and the MoE
``.npz`` checkpoints read both ways; the JAX package's value checks of
the MoE and fp8 flags.  The model is the ``moe_wide`` configuration's
shape cut to E 4, d_model 32, d_ff 64, 2 heads, 2 blocks, S 16, batch
4 (causal flash attention, the grouped kernel, bf16 Adam moments).  The
JAX side runs its Pallas kernels in interpret mode, the port its plain
versions; both start from the JAX package's params.

Tolerances: params within 1e-4 of their scale after one Adam step
(each update is ``lr * m / (sqrt(v) + eps)``, which amplifies f32
differences in the gradients of near-zero entries), except the key bias
(softmax is invariant to it: its true gradient is 0, both sides' are f32
noise); printed costs, parsed, within 1e-3; the test accuracy exactly.
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
from distributed_tensorflow_example_tpu_torch import main as tmain
from distributed_tensorflow_example_tpu_torch.data import mnist as tmnist
from distributed_tensorflow_example_tpu_torch.parallel import step as tstep
from distributed_tensorflow_example_tpu_torch.train import loop as tloop
from distributed_tensorflow_example_tpu_torch.train import optim as toptim
from distributed_tensorflow_example_tpu_torch.train import state as tstate
from distributed_tensorflow_example_tpu_torch.utils import checkpoint as tckpt

TINY_MOE = dict(model="transformer", input_size=64, seq_len=16, d_model=32,
                n_heads=2, num_blocks=2, d_ff=64, num_experts=4,
                moe_dispatch="alltoall", moe_topk=2, capacity_factor=1.25,
                moe_aux_weight=0.01, grouped_moe=True, attention="flash",
                causal=True, optimizer="adam",
                adam_moments_dtype="bfloat16", learning_rate=1e-3, seed=3)


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max |diff| {err} > {rtol} x {scale}"


def _close_params(got, want, rtol, key_bias_atol):
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


# name: flags over TINY_MOE
STEP_CASES = {
    "grouped_top2": {},
    "grouped_top2_remat": dict(remat=True),
    "fp8_top1": dict(moe_topk=1, fp8_ffn=True),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_moe_step_matches_jax_build_train_step(case):
    """One Adam step with the balance loss in the objective: the cost
    (plain CE, as printed) within 1e-5, the accuracy equal, the updated
    params within 1e-4 of their scale."""
    kw = dict(TINY_MOE, **STEP_CASES[case])
    jcfg, tcfg = jconfig.Config(**kw), tconfig.Config(**kw)
    jspec, tspec = jloop.make_spec(jcfg), tloop.make_spec(tcfg)
    assert tspec.aux_loss_weight == jspec.aux_loss_weight == 0.01
    jopt, topt = joptim.make_optimizer(jcfg), toptim.make_optimizer(tcfg)
    mesh = jmesh.build_mesh(1, 1)
    jst = jstate.create_train_state(jax.random.PRNGKey(3), jspec, jopt)
    jst = jmesh.place_state(jst, mesh, jmesh.state_pspecs(jspec, jopt))
    tst = _port_state(tspec, topt, {k: np.asarray(v)
                                    for k, v in jst.params.items()})
    rng = np.random.RandomState(4)
    x = rng.rand(4, kw["input_size"]).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 4)]
    jst, jc, ja = jstep.build_train_step(jcfg, mesh, jspec, jopt)(jst, x, y)
    tst, tc, ta = tstep.make_sync_step_body(tcfg, tspec, topt)(
        tst, torch.from_numpy(x), torch.from_numpy(y))
    assert float(tc) == pytest.approx(float(jc), rel=1e-5)
    assert float(ta) == pytest.approx(float(ja), abs=1e-6)
    _close_params(tst.params, jst.params, 1e-4, 2 * kw["learning_rate"])


def test_balance_loss_moves_only_the_router_and_the_objective():
    """``--moe_aux_weight`` changes the objective, not the printed
    cost: the same step with weight 0 reports the same cost, and only
    the routers' (and upstream) gradients differ."""
    costs, grads = [], []
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.rand(4, 64).astype(np.float32))
    y = torch.from_numpy(np.eye(10, dtype=np.float32)[rng.randint(0, 10,
                                                                  4)])
    for w in (0.0, 0.5):
        cfg = tconfig.Config(**dict(TINY_MOE, moe_aux_weight=w))
        spec = tloop.make_spec(cfg)
        params = tstate.create_train_state(
            spec, toptim.make_optimizer(cfg), seed=1, device="cpu").params
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        objective, (cost, _acc) = tstep._loss_and_acc(
            spec, leaves, x, y, False, False)
        costs.append(float(cost.detach()))
        grads.append(dict(zip(leaves, torch.autograd.grad(
            objective, list(leaves.values())))))
    assert costs[0] == costs[1]
    assert not torch.equal(grads[0]["L1_Wr"], grads[1]["L1_Wr"])
    assert torch.equal(grads[0]["W_head"], grads[1]["W_head"])


# ---------------------------------------------------------------------------
# the whole run against the JAX run
# ---------------------------------------------------------------------------

RUN_KW = dict(TINY_MOE, training_epochs=1, batch_size=4, frequency=1,
              checkpoint_every=2, eval_batch_size=8)


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """One JAX run and one port run of the tiny MoE transformer on the
    same 12 training (3 steps) and 8 test examples from the same
    params."""
    tmp = tmp_path_factory.mktemp("moe_runs")
    sizes = dict(train_size=12, test_size=8, input_size=64)
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


def test_moe_run_matches_jax_run(both_runs):
    """Three steps: each printed cost within 1e-3 of JAX's, the test
    accuracy and the counts equal."""
    j, t = both_runs["jax"], both_runs["torch"]

    def costs(out):
        return [float(m) for m in re.findall(r"Cost: (\d+\.\d{4})", out)]

    tc, jc = costs(t["stdout"]), costs(j["stdout"])
    assert len(tc) == len(jc) == 4           # 3 steps + Final Cost
    assert np.allclose(tc, jc, rtol=0, atol=1e-3), (tc, jc)
    tr, jr = t["result"], j["result"]
    assert tr["test_accuracy"] == pytest.approx(jr["test_accuracy"],
                                                abs=1e-6)
    for k in ("steps", "examples_seen", "global_batch"):
        assert tr[k] == jr[k], k


def test_moe_checkpoints_read_both_ways(both_runs):
    """The port's MoE checkpoint restores through the JAX
    ``restore_checkpoint`` and the JAX run's through
    ``convert.train_state_from_checkpoint``: the same keys (the expert
    leaves and their bf16 Adam moments among them), the JAX file's
    values bit for bit, the two runs' params within 1e-3 of scale."""
    jdir = both_runs["jax"]["cfg"].checkpoint_dir
    tdir = both_runs["torch"]["cfg"].checkpoint_dir
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "ckpt-00000002.npz", "ckpt-00000003.npz"]
    jcfg = both_runs["jax"]["cfg"]
    jspec = jloop.make_spec(jcfg)
    jopt = joptim.make_optimizer(jcfg)
    template = jstate.create_train_state(jax.random.PRNGKey(0), jspec, jopt)
    jfrom_t, step, _ = jckpt.restore_checkpoint(
        tckpt.latest_checkpoint(tdir), template)
    jfrom_j, _, _ = jckpt.restore_checkpoint(
        jckpt.latest_checkpoint(jdir), template)
    assert step == 3 and int(jfrom_t.step) == 3
    assert {"L0_Wr", "L0_We1", "L1_be2"} <= set(jfrom_t.params)
    _close_params(jfrom_t.params, jfrom_j.params, 1e-3,
                  2 * 3 * RUN_KW["learning_rate"])
    tcfg = both_runs["torch"]["cfg"]
    tfrom_j, step, _ = convert.train_state_from_checkpoint(
        jdir, tloop.make_spec(tcfg), toptim.make_optimizer(tcfg),
        device="cpu")
    assert step == 3
    jflat = jckpt._flatten(jfrom_j)
    tflat = tckpt.flatten_state(tfrom_j)
    assert sorted(jflat) == sorted(tflat)
    moments = [k for k in tflat if "L1_We2" in k
               and ("/mu/" in k or "/nu/" in k)]
    assert moments and all(tflat[k].dtype == torch.bfloat16
                           for k in moments)
    for k, a in jflat.items():
        assert np.array_equal(_np(tflat[k]), np.asarray(a, np.float32)), k


# ---------------------------------------------------------------------------
# the flags
# ---------------------------------------------------------------------------

BAD_FLAGS = {
    "negative_experts": dict(num_experts=-1),
    "experts_on_the_mlp": dict(model="mlp"),
    "zero_capacity": dict(capacity_factor=0.0),
    "topk_above_experts": dict(moe_topk=5),
    "topk_zero": dict(moe_topk=0),
    "aux_without_experts": dict(num_experts=0),
    "negative_aux": dict(moe_aux_weight=-0.1),
    "fp8_dense_dispatch": dict(fp8_ffn=True, moe_dispatch="dense"),
    "fp8_on_the_mlp": dict(model="mlp", num_experts=0, moe_aux_weight=0.0,
                           fp8_ffn=True),
}


@pytest.mark.parametrize("case", sorted(BAD_FLAGS))
def test_value_checks_match_jax(case):
    """Each flag combination the JAX trainer refuses, the port refuses
    too (ValueError, before any training)."""
    kw = dict(TINY_MOE, **BAD_FLAGS[case], dataset="synthetic",
              synthetic_train_size=4, synthetic_test_size=4,
              summaries=False)
    with pytest.raises(ValueError):
        jloop.run(jconfig.Config(**kw, fast_loop=False))
    with pytest.raises(ValueError):
        tloop.run(tconfig.Config(**kw, device="cpu"))


def test_cli_trains_moe_and_refuses_expert_parallel(capsys):
    """``main.py --num_experts ... --grouped_moe --fp8_ffn`` trains (a
    finite final cost); ``--expert_parallel`` exits 2 naming
    ROADMAP.md."""
    argv = ["--device", "cpu", "--model=transformer", "--num_experts=4",
            "--moe_dispatch=alltoall", "--grouped_moe", "--fp8_ffn",
            "--input_size=64", "--seq_len=16", "--d_model=32",
            "--n_heads=2", "--num_blocks=1", "--d_ff=64",
            "--batch_size=4", "--dataset=synthetic",
            "--synthetic_train_size=8", "--synthetic_test_size=4",
            "--no_summaries", "--training_epochs=1"]
    assert tmain.main(argv) == 0
    final = re.search(r"Final Cost: (\S+)", capsys.readouterr().out)
    assert final and np.isfinite(float(final.group(1)))
    try:
        rc = tmain.main(argv + ["--expert_parallel=2"])
    except SystemExit as e:
        rc = e.code
    assert rc == 2
    assert "ROADMAP" in capsys.readouterr().err

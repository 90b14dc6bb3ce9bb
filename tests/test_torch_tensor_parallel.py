"""Tensor parallelism in the port against the JAX package's one-process
``('data', 'model')`` mesh, on the CPU.

Four gloo rank subprocesses (``OMP_NUM_THREADS=1``), launched once:
first as two worlds of two ranks each at ``--model_parallel=2`` (dp 1
x mp 2), then as one world of four (dp 2 x mp 2).  Rank r plays device r
of JAX's mesh on the first ``dp x mp`` of the eight CPU devices (data
index ``r // mp``, model index ``r % mp``), so both sides train the same
rows from the same initial params (the JAX init, carried across with
``convert``) on the same synthetic data.

- the mesh: rank r at JAX's device-array position, ``layer_styles``,
  ``param_pspecs`` and ``build_mesh`` with JAX's values and messages;
- one step at dp 1 x mp 2 against JAX's ``build_train_step`` on
  ``build_mesh(1, 2)``: the MLP (col, row, rep) and the transformer
  under ``--attention=flash --fused_ln`` (the kernels' plain versions
  here), each with a binding ``--grad_clip`` and the ``--histograms``
  norms, the MLP with the ``--on_anomaly`` counts and flag (JAX's
  transformer step cannot return them under TP); ``--on_anomaly=skip``
  on a NaN batch; MoE x TP (attention split, 4 experts replicated, dense
  dispatch); ``--dropout_rate`` 0.1, where the two model ranks'
  replicated leaves are bitwise equal and the step equals the port's
  one-process step (the model ranks of data index 0 draw its masks);
- full driver runs: the transformer at dp 2 x mp 2 on the fast and the
  host path against JAX's ``--model_parallel=2 --data_parallel=2`` run
  (the printed costs, the test accuracy, the gathered final params),
  and ``--objective=lm --sample_after=2`` at dp 1 x mp 2, whose greedy
  samples equal JAX's ``generate_sharded``'s.

Tolerances (f32; the sums run in other orders): one step within rtol
2e-5, atol 2e-6 of each leaf's scale, JAX's own bound for TP against
one device (``tests/test_transformer.py``); the norms within 2e-5 of
theirs; after a run within 1e-4 of scale, printed costs within 1e-4
(one unit in their last printed place).  The transformer trains under
momentum: Adam's first update normalises each gradient element, and the
key bias's gradient is zero but for rounding (attention is invariant to
it), so Adam would turn the two sides' different rounding noise into
updates of the learning rate's size.  The launcher and
the rank script also serve ``tests/test_torch_tp_state.py``.
"""

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.models import transformer as jtfm
from distributed_tensorflow_example_tpu.parallel import mesh as jmesh
from distributed_tensorflow_example_tpu.parallel import step as jstep
from distributed_tensorflow_example_tpu.train import loop as jloop
from distributed_tensorflow_example_tpu.train import optim as joptim
from distributed_tensorflow_example_tpu.train import state as jstate
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_example_tpu_torch.parallel import step as tstep
from distributed_tensorflow_example_tpu_torch.train import loop as tloop
from distributed_tensorflow_example_tpu_torch.train import optim as toptim
from distributed_tensorflow_example_tpu_torch.train import state as tstate
from test_torch_data_parallel import (costs, free_port, latest_npz, npz,
                                      run_jax, save_init, start_ranks,
                                      wait_ranks)

# one intra-op thread: the suite runs six test workers (and the rank
# processes) on the machine's cores, where torch would start one a core
torch.set_num_threads(1)

# the ranks' program: for each phase, join this rank's world (a gloo
# group of the ranks the phase lists with it), run the world's jobs
# (train/loop.run, or one step of setup_strategy's body), leave it
RANK_SCRIPT = r'''
import contextlib, datetime, io, json, os, sys
import numpy as np
import torch
import torch.distributed as dist

me, plan_path = int(sys.argv[1]), sys.argv[2]
# below the suite's other workers: their timing-bound tests keep the cores
os.nice(10)
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.data import mnist as tmnist
from distributed_tensorflow_example_tpu_torch.models import transformer
from distributed_tensorflow_example_tpu_torch.obs import flops
from distributed_tensorflow_example_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_example_tpu_torch.train import loop as tloop
from distributed_tensorflow_example_tpu_torch.train import optim as toptim
from distributed_tensorflow_example_tpu_torch.train import state as tstate
from distributed_tensorflow_example_tpu_torch.utils import checkpoint

with open(plan_path) as f:
    plan = json.load(f)
out_dir = plan["out"]


def port_init(init_path):
    with np.load(init_path) as z:
        init_np = {k: z[k] for k in z.files}

    def init(spec, optimizer, seed=1, device=None):
        if isinstance(spec, transformer.TransformerSpec):
            params = convert.params_from_numpy(init_np, spec, device="cpu")
        else:
            params = convert.mlp_params_from_numpy(init_np, spec,
                                                   device="cpu")
        return tstate.TrainState(torch.zeros((), dtype=torch.int32),
                                 params, optimizer.init(params))
    return init


def config(job):
    kw = dict(job["cfg"])
    if "hidden_sizes" in kw:
        kw["hidden_sizes"] = tuple(kw["hidden_sizes"])
    return tconfig.Config(**kw, device="cpu")


def run_job(job, rank):
    cfg = config(job)
    data = tmnist.synthesize_dataset(seed=0, **job["sizes"])
    tloop.load_datasets = lambda *a, **k: data
    tloop.create_train_state = port_init(job["init"])
    if job.get("peak"):
        flops.chip_peak_flops = lambda dev: job["peak"]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            res = tloop.run(cfg)
        err = None
    except Exception as e:
        res, err = None, f"{type(e).__name__}: {e}"
    with open(os.path.join(out_dir, f"{job['name']}.{rank}.json"), "w") as f:
        json.dump({"stdout": buf.getvalue(), "result": res, "error": err},
                  f, default=str)


def step_job(job, rank):
    """One step of the strategy's host-path body from the plan's params
    on this rank's rows of the plan's batch; the updated state gathered
    to its global layout, with the cost and the telemetry."""
    cfg = config(job)
    spec = tloop.make_spec(cfg)
    opt = toptim.make_optimizer(cfg)
    mesh = tmesh.build_mesh(cfg.data_parallel, cfg.model_parallel)
    strat = tloop.setup_strategy(
        cfg, spec, opt, port_init(job["init"])(spec, opt), mesh,
        fast=False, with_anomaly=bool(cfg.on_anomaly))
    with np.load(job["batch"]) as z:
        x, y = z["x"], z["y"]
    rows = tmesh.batch_layout(mesh, x.shape[0])
    new, cost, acc, *extra = strat.body(
        strat.state, torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))
    out = {"cost": cost.numpy(), "acc": acc.numpy()}
    for k, v in checkpoint.gather_global(new, strat.layout).items():
        out["global" + k] = v.to(torch.float32).numpy()
    for k, v in new.params.items():
        out["local/" + k] = v.numpy()
    if cfg.histograms:
        out["grad_norms"] = extra[0]["grad"].numpy()
        out["param_norms"] = extra[0]["param"].numpy()
    if cfg.on_anomaly:
        out["flag"] = extra[-1]["flag"].numpy()
        out["counts"] = extra[-1]["counts"].numpy()
    np.savez(os.path.join(out_dir, f"{job['name']}.{rank}.npz"), **out)


for phase in plan["phases"]:
    world = next(w for w in phase if me in w["ranks"])
    rank = world["ranks"].index(me)
    # a rank that dies must not leave the others waiting out gloo's
    # 30-minute default
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{world['port']}",
        world_size=len(world["ranks"]), rank=rank,
        timeout=datetime.timedelta(seconds=120))
    for job in world["jobs"]:
        if job.get("wait_for") and rank == 0:
            # a file the test process writes once the JAX side is ready
            import time
            while not os.path.exists(job["wait_for"]):
                time.sleep(0.05)
        if job.get("copy_from") and rank == 0:
            # an earlier phase's checkpoint dir, as it is
            import shutil
            shutil.copytree(*job["copy_from"])
        if job.get("copy_from") or job.get("wait_for"):
            dist.barrier()
        (step_job if job.get("step") else run_job)(job, rank)
    # every rank's files (its checkpoint writer drained in its run) land
    # before any rank starts the next phase
    dist.barrier()
    dist.destroy_process_group()
'''


def launch(plan: dict, tmp, procs: int = 4, timeout: float = 180,
           meanwhile=None):
    """Run ``plan`` (``{"out": dir, "phases": [[{"ranks": [...], "jobs":
    [...]}, ...], ...]}``) in ``procs`` rank subprocesses at once; each
    phase's worlds get a free port.  ``meanwhile()`` runs in this
    process while the ranks do (the JAX side).  Returns ``{(job, rank):
    its json}`` for the run jobs."""
    os.makedirs(plan["out"], exist_ok=True)
    for phase in plan["phases"]:
        for world in phase:
            world["port"] = free_port()
    plan_path = os.path.join(str(tmp), "tp_plan.json")
    script = os.path.join(str(tmp), "tp_rank.py")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    with open(script, "w") as f:
        f.write(RANK_SCRIPT)
    ps, logs = start_ranks([[script, str(r), plan_path]
                            for r in range(procs)], tmp, "tp_rank")
    try:
        if meanwhile is not None:
            meanwhile()
        wait_ranks(ps, logs, timeout)
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {}
    for phase in plan["phases"]:
        for world in phase:
            for job in world["jobs"]:
                if job.get("step"):
                    continue
                for r in range(len(world["ranks"])):
                    with open(os.path.join(plan["out"],
                                           f"{job['name']}.{r}.json")) as f:
                        out[job["name"], r] = json.load(f)
    return out


def close(got, want, rtol, atol=0.0, what=""):
    """``|got - want| <= atol + rtol * scale``, ``scale`` the largest
    magnitude of ``want``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= atol + rtol * scale, (
        f"{what}: max |diff| {err} > {atol} + {rtol} x {scale}")


STEP_RTOL, STEP_ATOL = 2e-5, 2e-6
RUN_RTOL = 1e-4
MLP_KW = dict(dataset="synthetic", batch_size=16, hidden_sizes=(16, 16),
              learning_rate=0.01, optimizer="adam", frequency=4,
              summaries=False, training_epochs=1, seed=5)
TFM_KW = dict(model="transformer", input_size=64, seq_len=16, d_model=32,
              n_heads=4, num_blocks=2, d_ff=64, optimizer="momentum",
              learning_rate=0.01, seed=3, batch_size=8, frequency=2,
              eval_batch_size=8, dataset="synthetic", summaries=False,
              training_epochs=1, attention="flash", fused_ln=True)
TFM_SIZES = dict(train_size=32, test_size=12, input_size=64)
LM_KW = dict(TFM_KW, objective="lm", input_size=16, seq_len=16,
             sample_after=2, sample_temperature=0.0, attention="dense",
             fused_ln=False, training_epochs=1)
LM_SIZES = dict(train_size=16, test_size=4, input_size=16)
# one step at dp 1 x mp 2: name -> (flags, world); the NaN batch poisons
# one input of the MLP's
TELEMETRY = dict(grad_clip=0.05, histograms=True, on_anomaly="dump")
STEPS = {
    "mlp": (dict(MLP_KW, **TELEMETRY), "a"),
    "mlp_nan": (dict(MLP_KW, on_anomaly="skip"), "a"),
    # JAX's transformer step cannot return the anomaly outputs under TP
    # (its psum of the model-invariant loss flag over 'model' fails the
    # varying-axes check), so the transformer's telemetry is the clip
    # and the norms
    "tfm": (dict(TFM_KW, grad_clip=0.05, histograms=True), "b"),
    "moe": (dict(TFM_KW, num_experts=4, moe_dispatch="dense",
                 moe_topk=2, d_ff=48), "b"),
    "dropout": (dict(TFM_KW, dropout_rate=0.1), "a"),
}
# full runs: name -> (flags, sizes, dp)
RUNS = {
    "tfm_fast": (TFM_KW, TFM_SIZES, 2),
    "tfm_host": (dict(TFM_KW, fast_loop=False), TFM_SIZES, 2),
    "lm": (LM_KW, LM_SIZES, 1),
}


def _batch(kw, path, nan: bool = False) -> None:
    rng = np.random.RandomState(11)
    b = kw["batch_size"]
    x = rng.rand(b, kw.get("input_size", 784)).astype(np.float32)
    if nan:
        x[3, 5] = np.nan
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, b)]
    np.savez(path, x=x, y=y)


def _jax_step(kw, init, batch, mp: int, devices):
    """JAX's ``build_train_step`` on ``build_mesh(1, mp)`` from the saved
    init: ``(params, cost, extras)`` as numpy."""
    jcfg = jconfig.Config(**kw, model_parallel=mp, data_parallel=1,
                          compilation_cache="")
    jspec = jloop.make_spec(jcfg)
    jopt = joptim.make_optimizer(jcfg)
    state = jstate.create_train_state(jax.random.PRNGKey(jcfg.seed), jspec,
                                      jopt)
    with np.load(init) as z:
        params = {k: z[k] for k in z.files}
    state = jstate.TrainState(state.step, params, jopt.init(params))
    mesh = jmesh.build_mesh(1, mp, devices=devices[:mp])
    state = jmesh.place_state(state, mesh,
                              jmesh.state_pspecs(jspec, jopt, mp))
    fn = jstep.build_train_step(jcfg, mesh, jspec, jopt,
                                with_norms=jcfg.histograms,
                                with_anomaly=bool(jcfg.on_anomaly))
    with np.load(batch) as z:
        new, cost, _acc, *extra = fn(state, z["x"], z["y"])
    out = {"cost": float(cost)}
    if jcfg.histograms:
        out["grad_norms"] = np.asarray(extra[0]["grad"])
        out["param_norms"] = np.asarray(extra[0]["param"])
    if jcfg.on_anomaly:
        out["flag"] = bool(extra[-1]["flag"])
        out["counts"] = np.asarray(extra[-1]["counts"])
    return {k: np.asarray(v) for k, v in new.params.items()}, out


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The port's ranks: the steps and the lm run in two 2-rank worlds,
    then the dp 2 x mp 2 runs in one 4-rank world; JAX's runs."""
    tmp = tmp_path_factory.mktemp("tp")
    inits, batches, saved = {}, {}, {}

    def init_for(name, kw):
        """JAX's seeded init of ``kw``'s model, saved once a model."""
        key = repr(jloop.make_spec(jconfig.Config(**dict(
            kw, dropout_rate=0.0))))
        if key not in saved:
            saved[key] = str(tmp / f"init_{name}.npz")
            save_init(jconfig.Config(**kw), saved[key])
        inits[name] = saved[key]

    for name, (kw, _world) in STEPS.items():
        init_for(name, kw)
        batches[name] = str(tmp / f"batch_{name}.npz")
        _batch(kw, batches[name], nan=name == "mlp_nan")
    for name, (kw, _sizes, _dp) in RUNS.items():
        init_for(name, kw)
    worlds = {"a": [], "b": []}
    for name, (kw, world) in STEPS.items():
        worlds[world].append(dict(
            name=name, step=True, init=inits[name], batch=batches[name],
            cfg=dict(kw, model_parallel=2)))
    kw, sizes, _dp = RUNS["lm"]
    worlds["b"].append(dict(name="lm", init=inits["lm"], sizes=sizes,
                            cfg=dict(kw, model_parallel=2,
                                     logs_path=str(tmp / "torch_lm"))))
    four = [dict(name=name, init=inits[name], sizes=sizes,
                 cfg=dict(kw, model_parallel=2, data_parallel=dp,
                          checkpoint_dir=str(tmp / f"torch_{name}")))
            for name, (kw, sizes, dp) in RUNS.items() if dp == 2]
    plan = dict(out=str(tmp / "out"), phases=[
        [dict(ranks=[0, 1], jobs=worlds["a"]),
         dict(ranks=[2, 3], jobs=worlds["b"])],
        [dict(ranks=[0, 1, 2, 3], jobs=four)]])
    jax_runs, jax_steps = {}, {}

    def jax_side():
        for name, (kw, _world) in STEPS.items():
            if name != "dropout":
                jax_steps[name] = _jax_step(kw, inits[name], batches[name],
                                            2, jax.devices())
        for name, (kw, sizes, dp) in RUNS.items():
            jcfg = jconfig.Config(**kw, model_parallel=2, data_parallel=dp,
                                  compilation_cache="",
                                  logs_path=str(tmp / f"jax_{name}"),
                                  checkpoint_dir=str(tmp / f"jax_ck_{name}"))
            jax_runs[name] = run_jax(jcfg, sizes) + (jcfg,)

    port = launch(plan, tmp, meanwhile=jax_side)
    return dict(port=port, jax=jax_runs, jax_steps=jax_steps, tmp=tmp,
                inits=inits, batches=batches)


def _step_out(tp, name, rank=0) -> dict:
    return npz(tp["tmp"] / "out" / f"{name}.{rank}.npz")


# ---- the mesh ----


@pytest.mark.parametrize("dp,mp", [(1, 2), (2, 2), (4, 2), (2, 4)])
def test_rank_plays_jax_device_array_position(dp, mp):
    """Rank r sits where JAX's ``reshape(dp, mp)`` puts device r: data
    index r // mp, model index r % mp."""
    devices = jax.devices()[:dp * mp]
    jm = jmesh.build_mesh(dp, mp, devices=devices)
    for r in range(dp * mp):
        tm = tmesh.build_mesh(dp, mp, world=dp * mp, rank=r)
        pos = np.argwhere(jm.devices == devices[r])[0]
        assert (tm.data_index, tm.model_index) == tuple(pos)
        assert tm.devices == dp * mp


@pytest.mark.parametrize("kw,mp", [
    (dict(hidden_sizes=(16, 16)), 2), (dict(hidden_sizes=(8,)), 2),
    (dict(hidden_sizes=(8, 8, 8)), 4), (dict(hidden_sizes=(16, 16)), 1),
    (dict(TFM_KW), 2), (dict(TFM_KW, num_experts=4, d_ff=48), 4)])
def test_styles_and_pspecs_equal_jax(kw, mp):
    """``layer_styles`` and ``param_pspecs`` (the dim each leaf splits
    over 'model') equal JAX's for the MLP and the transformer."""
    jspec = jloop.make_spec(jconfig.Config(**kw))
    tspec = tloop.make_spec(tconfig.Config(**kw))
    assert tmesh.layer_styles(tspec, mp) == jmesh.layer_styles(jspec, mp)
    want = {}
    for k, sp in jmesh.param_pspecs(jspec, mp).items():
        dims = [i for i, part in enumerate(sp) if part == jmesh.MODEL_AXIS]
        want[k] = dims[0] if dims else None
    assert tmesh.param_pspecs(tspec, mp) == want


@pytest.mark.parametrize("kw,mp", [
    (dict(hidden_sizes=(15, 16)), 2), (dict(hidden_sizes=(16, 16, 15)), 2),
    (dict(TFM_KW, n_heads=2), 4), (dict(TFM_KW, d_ff=66), 4)])
def test_styles_errors_equal_jax(kw, mp):
    """Undividable widths raise JAX's messages (the MLP's layer dims,
    the transformer's ``check_tp``)."""
    jspec = jloop.make_spec(jconfig.Config(**kw))
    tspec = tloop.make_spec(tconfig.Config(**kw))
    with pytest.raises(ValueError) as j:
        jmesh.layer_styles(jspec, mp)
    with pytest.raises(ValueError) as t:
        tmesh.layer_styles(tspec, mp)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("dp,mp,n", [(-1, 3, 4), (3, 2, 4), (-1, 0, 4),
                                     (4, 2, 4)])
def test_build_mesh_messages_equal_jax(dp, mp, n):
    """``build_mesh``'s refusals are JAX's: mp must divide the world, a
    mesh larger than it raises."""
    with pytest.raises(ValueError) as j:
        jmesh.build_mesh(dp, mp, devices=jax.devices()[:n])
    with pytest.raises(ValueError) as t:
        tmesh.build_mesh(dp, mp, world=n)
    assert str(t.value) == str(j.value)


def test_model_operators_are_identity_without_a_group():
    """Without a model group the two Megatron operators pass the tensor
    and its gradient through."""
    x = torch.randn(3, 4, requires_grad=True)
    y = tmesh.model_copy(tmesh.model_psum(x, None), None)
    y.sum().backward()
    assert torch.equal(y, x) and torch.equal(x.grad, torch.ones(3, 4))


# ---- one step at dp 1 x mp 2 ----


@pytest.mark.parametrize("name", ["mlp", "tfm", "moe"])
def test_one_step_equals_jax_tp_step(tp, name):
    """The two ranks' step, gathered, against JAX's at build_mesh(1, 2):
    the updated params and cost, and under the telemetry flags the
    clipped update, the per-leaf gradient and param norms and the
    anomaly counts and flag."""
    jp, jout = tp["jax_steps"][name]
    for r in range(2):
        t = _step_out(tp, name, r)
        close(t["cost"], jout["cost"], STEP_RTOL, STEP_ATOL, "cost")
        for k in jp:
            close(t["global.params/" + k], jp[k], STEP_RTOL, STEP_ATOL,
                  f"{name} {k}")
        if "grad_norms" in jout:
            close(t["grad_norms"], jout["grad_norms"], STEP_RTOL, 0,
                  "grad norms")
            close(t["param_norms"], jout["param_norms"], STEP_RTOL, 0,
                  "param norms")
            # the clip binds: the clipped gradient's norm is the bound
            assert float(np.sqrt(np.sum(t["grad_norms"] ** 2))) > 0.05
        if "flag" in jout:
            assert bool(t["flag"]) == jout["flag"] is False
            np.testing.assert_array_equal(t["counts"], jout["counts"])


def test_skip_on_nan_batch_equals_jax(tp):
    """``--on_anomaly=skip`` on a batch with a NaN: both ranks flag the
    step, blame the leaves JAX blames with its counts, and keep their
    params."""
    _jp, jout = tp["jax_steps"]["mlp_nan"]
    init = npz(tp["inits"]["mlp_nan"])
    assert jout["flag"] is True
    for r in range(2):
        t = _step_out(tp, "mlp_nan", r)
        assert bool(t["flag"])
        np.testing.assert_array_equal(t["counts"], jout["counts"])
        for k in init:
            np.testing.assert_array_equal(t["global.params/" + k], init[k])


def test_dropout_model_ranks_agree_and_equal_one_rank(tp):
    """``--dropout_rate`` 0.1 under TP: the two model ranks' replicated
    leaves are bitwise equal (their masks are the same draws), and the
    gathered step equals the port's one-process step (data index 0's
    seed) within the step bound."""
    kw = STEPS["dropout"][0]
    a, b = _step_out(tp, "dropout", 0), _step_out(tp, "dropout", 1)
    cfg = tconfig.Config(**kw, model_parallel=2)
    spec = tloop.make_spec(cfg)
    split = {k for k, d in tmesh.param_pspecs(spec, 2).items()
             if d is not None}
    for k in a:
        if k.startswith("local/") and k[6:] not in split:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    one = tconfig.Config(**kw)
    opt = toptim.make_optimizer(one)
    with np.load(tp["inits"]["dropout"]) as z:
        params = convert.params_from_numpy({k: z[k] for k in z.files}, spec,
                                           device="cpu")
    state = tstate.TrainState(torch.zeros((), dtype=torch.int32), params,
                              opt.init(params))
    with np.load(tp["batches"]["dropout"]) as z:
        x, y = torch.from_numpy(z["x"]), torch.from_numpy(z["y"])
    new, cost, _acc = tstep.make_sync_step_body(one, spec, opt)(state, x, y)
    close(a["cost"], cost.numpy(), STEP_RTOL, STEP_ATOL, "cost")
    for k, v in new.params.items():
        close(a["global.params/" + k], v.numpy(), STEP_RTOL, STEP_ATOL, k)


# ---- full runs ----


@pytest.mark.parametrize("name", ["tfm_fast", "tfm_host"])
def test_dp2_mp2_run_equals_jax(tp, name):
    """The transformer at dp 2 x mp 2 (flash, fused LayerNorms) on the
    fast and the host path: every rank prints JAX's costs at its steps,
    the chief JAX's test accuracy; the path, the devices and the steps
    are JAX's; the gathered final params within the run bound."""
    j_out, j_res, jcfg = tp["jax"][name]
    for r in range(4):
        assert tp["port"][name, r]["error"] is None, tp["port"][name, r]
    chief = tp["port"][name, 0]
    t_res = chief["result"]
    assert t_res["fast_loop"] == j_res["fast_loop"] == (
        name == "tfm_fast")
    for k in ("steps", "global_batch", "devices", "examples_seen"):
        assert t_res[k] == j_res[k], k
    assert t_res["devices"] == 4
    jc, tc = costs(j_out), costs(chief["stdout"])
    assert len(tc) == len(jc) >= 2
    assert np.allclose(tc, jc, rtol=0, atol=1e-4), (tc, jc)
    for r in (1, 2, 3):
        assert costs(tp["port"][name, r]["stdout"]) == tc[:-1]
    assert t_res["test_accuracy"] == j_res["test_accuracy"]
    t = npz(latest_npz(tp["tmp"] / f"torch_{name}"))
    j = npz(latest_npz(jcfg.checkpoint_dir))
    keys = [k for k in j if k.startswith((".params/", ".opt_state/"))]
    assert sorted(k for k in t if not k.startswith("__")) == sorted(
        k for k in j if not k.startswith("__"))
    for k in keys:
        close(t[k], j[k], RUN_RTOL, 0, f"{name} {k}")


def test_lm_samples_equal_jax_generate_sharded(tp):
    """``--objective=lm --sample_after=2`` at dp 1 x mp 2: the port's
    samples (``generate_sharded`` over the model group, every rank
    decoding its heads) equal JAX's ``generate_sharded``'s, greedy."""
    j_out, _j_res, jcfg = tp["jax"]["lm"]
    assert tp["port"]["lm", 0]["error"] is None, tp["port"]["lm", 0]
    assert tp["port"]["lm", 1]["error"] is None, tp["port"]["lm", 1]
    assert "Sampled 2 sequences" in tp["port"]["lm", 0]["stdout"]
    t = npz(tp["tmp"] / "torch_lm" / "samples.npz")
    j = npz(os.path.join(jcfg.logs_path, "samples.npz"))
    assert t["samples"].shape == j["samples"].shape == (2, 16)
    np.testing.assert_array_equal(t["samples"], j["samples"])
    assert int(t["prompt_len"]) == int(j["prompt_len"])
    assert np.allclose(costs(tp["port"]["lm", 0]["stdout"]), costs(j_out),
                       rtol=0, atol=1e-4)


def test_generate_sharded_is_generate_without_a_group():
    """Outside a process group (``model_axis`` None) ``generate_sharded``
    is ``generate`` on the whole params, token for token, and matches
    JAX's greedy ``generate`` on the same params."""
    from distributed_tensorflow_example_tpu_torch.models import (
        transformer as ttfm)

    kw = dict(objective="lm", input_size=12, seq_len=12, vocab_size=16,
              d_model=16, n_heads=2, num_blocks=1, d_ff=32, causal=True)
    jspec = jtfm.TransformerSpec(**kw)
    tspec = ttfm.TransformerSpec(**kw)
    jp = jtfm.init(jax.random.PRNGKey(0), jspec)
    tparams = convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, tspec, device="cpu")
    prompt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    want = np.asarray(jtfm.generate(jspec, jp, prompt))
    got = ttfm.generate_sharded(tspec, tparams, torch.from_numpy(prompt),
                                None)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_prints_and_refusals_name_the_flag():
    """The trainer parses ``--model_parallel`` (JAX's default 1)."""
    cfg = tconfig.parse_train_config(["--model_parallel=2"])
    assert cfg.model_parallel == 2
    assert tconfig.parse_train_config([]).model_parallel == 1 == (
        jconfig.Config().model_parallel)
    assert re.search("model_parallel", tconfig.build_train_parser()
                     .format_help())

"""Expert parallelism in the port against the JAX package's one-process
``('data', 'expert'[, 'model'])`` mesh, on the CPU.

Four gloo rank subprocesses (``OMP_NUM_THREADS=1``, niced), launched
once, in one world of four that runs every case in turn; the JAX side
runs in this process meanwhile on the first devices of the eight CPU
devices.  Rank r plays device r of JAX's ``build_expert_mesh``: data
index ``r // (ep * mp)``, expert index ``(r // mp) % ep``, model index
``r % mp``.

- ``expert_all_to_all`` at ep 4 (the world as one expert axis), the
  dispatch and the combine, forward and backward, against a plain
  numpy emulation of JAX's tiled ``all_to_all``, and the bytes posted;
- one step at dp 2 x ep 2 under dense dispatch (top-1, the balance
  loss weighed in) with ``--grad_clip`` and the per-leaf norms, against
  JAX's ``build_train_step`` on ``build_expert_mesh(2, 2)``: the cost,
  the gradient and param norms and the new params (the
  ``expert_copy``/``expert_psum`` backward);
- full runs against JAX's ``train.loop.run``: sparse top-2 at capacity
  factor 4 under ``--grouped_moe`` and ``--zero_opt`` at dp 2 x ep 2
  (the ``[ep, dp, chunk]`` slots); sparse top-2 under ``--fp8_ffn`` at
  ep 4 (one expert a rank) on the lm objective with ``--sample_after``;
  dense top-2 at ep 2 x mp 2 (TP x EP) on the lm objective with
  ``--sample_after`` (the experts gathered, the decode
  tensor-parallel);
- the ZeRO run's checkpoint resumed by JAX, and JAX's by the port, for a
  second epoch each;
- 4-step runs with dropout: the expert ranks of a data index draw the
  same masks under dense dispatch, every (data, expert) shard its own
  under sparse dispatch;
- ``build_expert_mesh``'s placement and messages and the trainer's
  refusals, JAX's; the CLI's exit 2 on them.

Tolerances (f32; the shards sum in other orders): the exchange exactly
(it moves numbers); the step: cost 1e-5, norms and new params within
2e-5 of each leaf's scale (JAX's own EP tests: rtol 2e-5 to 3e-5 on
params, 1e-5 on the cost); runs: printed costs within 1e-4 (one unit in
their last printed place), final params within 1e-4 of each leaf's
scale (1e-3 under ``--fp8_ffn``), test accuracies within 1e-6, greedy
samples equal.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.parallel import mesh as jmesh
from distributed_tensorflow_example_tpu.parallel import step as jstep
from distributed_tensorflow_example_tpu.train import loop as jloop
from distributed_tensorflow_example_tpu.train import optim as joptim
from distributed_tensorflow_example_tpu.train import state as jstate
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch import main as tmain
from distributed_tensorflow_example_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_example_tpu_torch.train import loop as tloop
from test_torch_data_parallel import (REPO, costs, free_port, latest_npz,
                                      npz, run_jax, save_init, start_ranks,
                                      wait_ranks)

torch.set_num_threads(1)

RANK_SCRIPT = r'''
import contextlib, datetime, io, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist

me, world, port, plan_path = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
os.nice(10)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=me,
                        timeout=datetime.timedelta(seconds=120))
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.data import mnist as tmnist
from distributed_tensorflow_example_tpu_torch.models import transformer
from distributed_tensorflow_example_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_example_tpu_torch.train import loop as tloop
from distributed_tensorflow_example_tpu_torch.train import optim as toptim
from distributed_tensorflow_example_tpu_torch.train import state as tstate

with open(plan_path) as f:
    plan = json.load(f)
out_dir = plan["out"]


def wait_for(path):
    while not os.path.exists(path):
        time.sleep(0.05)


def port_init(init_path):
    with np.load(init_path) as z:
        init_np = {k: z[k] for k in z.files}

    def init(spec, optimizer, seed=1, device=None):
        params = convert.params_from_numpy(init_np, spec, device="cpu")
        return tstate.TrainState(torch.zeros((), dtype=torch.int32),
                                 params, optimizer.init(params))
    return init


def ops_job(job):
    """The dispatch and the combine over the world as one expert axis,
    values and the gradients of sum(out * w), and the bytes posted."""
    axis = tmesh.ExpertAxis(dist.group.WORLD, world, me)
    g = torch.Generator().manual_seed(100 + me)
    e, c, d = job["shape"]
    buf = torch.randn((e, c, d), generator=g).requires_grad_(True)
    h = torch.randn((e // world, world * c, d),
                    generator=g).requires_grad_(True)
    w1 = torch.randn((e // world, world * c, d), generator=g)
    w2 = torch.randn((e, c, d), generator=g)
    tmesh.EP_BYTES["all_to_all"] = 0
    sent = tmesh.expert_all_to_all(buf, axis)
    back = tmesh.expert_all_to_all(h, axis, reverse=True)
    posted = tmesh.EP_BYTES["all_to_all"]
    (torch.sum(sent * w1) + torch.sum(back * w2)).backward()
    np.savez(os.path.join(out_dir, f"ops.{me}.npz"), buf=buf.detach(),
             h=h.detach(), w1=w1, w2=w2, sent=sent.detach(),
             back=back.detach(), dbuf=buf.grad, dh=h.grad,
             posted=np.int64(posted))


def step_job(job):
    """One step of the synchronous body at the plan's mesh on this
    rank's rows of the plan's batch: the cost, the norms and the new
    params (the experts gathered over the expert group)."""
    cfg = tconfig.Config(**job["cfg"], device="cpu")
    spec = tloop.make_spec(cfg)
    opt = toptim.make_optimizer(cfg)
    mesh = tloop.train_mesh(cfg, spec)
    strat = tloop.setup_strategy(cfg, spec, opt, port_init(job["init"])(
        spec, opt), mesh, fast=False)
    with np.load(job["batch"]) as z:
        x, y = z["x"], z["y"]
    rows = tmesh.batch_layout(mesh, x.shape[0])
    new, cost, _acc, norms = strat.body(strat.state, torch.from_numpy(x[rows]),
                                        torch.from_numpy(y[rows]))
    params = tloop._gather_experts(new.params, spec, mesh)
    np.savez(os.path.join(out_dir, f"step.{me}.npz"), cost=cost.numpy(),
             grad=norms["grad"].numpy(), param=norms["param"].numpy(),
             **{f"p/{k}": v.numpy() for k, v in params.items()})


def run_job(job):
    kw = dict(job["cfg"])
    if job.get("wait"):
        wait_for(job["wait"])
    cfg = tconfig.Config(**kw, device="cpu")
    data = tmnist.synthesize_dataset(seed=0, **job["sizes"])
    tloop.load_datasets = lambda *a, **k: data
    tloop.create_train_state = port_init(job["init"])
    masks = {}
    drop = transformer._dropout
    if job.get("masks"):
        def keep(h, spec_, rng, salt):
            o = drop(h, spec_, rng, salt)
            masks.setdefault(f"salt{salt}", (o == 0).numpy())
            return o
        transformer._dropout = keep
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            res = tloop.run(cfg)
        err = None
    except Exception as e:
        res, err = None, f"{type(e).__name__}: {e}"
    transformer._dropout = drop
    if masks:
        np.savez(os.path.join(out_dir, f"{job['name']}.masks.{me}.npz"),
                 **masks)
    with open(os.path.join(out_dir, f"{job['name']}.{me}.json"), "w") as f:
        json.dump({"stdout": buf.getvalue(), "result": res, "error": err},
                  f, default=str)


for job in plan["jobs"]:
    if "init" in job:
        # the initial params, which the JAX side writes meanwhile
        wait_for(job["init"])
    {"ops": ops_job, "step": step_job, "run": run_job}[job["kind"]](job)
    dist.barrier()
    if job.get("mark") and me == 0:
        open(job["mark"], "w").close()
dist.destroy_process_group()
'''

# JAX's runs of the lm cases, in a process of their own beside this one's
# (the file's wall is JAX's compiles): each run's stdout and result
JAX_SCRIPT = r'''
import contextlib, io, json, os, sys
sys.path.insert(0, os.getcwd())
from __graft_entry__ import force_cpu_device_flags
os.environ["XLA_FLAGS"] = force_cpu_device_flags(
    os.environ.get("XLA_FLAGS", ""), 8)
import jax
jax.config.update("jax_platforms", "cpu")
from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.data import mnist as jmnist
from distributed_tensorflow_example_tpu.train import loop as jloop

for job in json.loads(sys.argv[1]):
    data = jmnist.synthesize_dataset(seed=0, **job["sizes"])
    jloop.load_datasets = lambda *a, **k: data
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = jloop.run(jconfig.Config(**job["cfg"]))
    with open(job["out"], "w") as f:
        json.dump({"stdout": buf.getvalue(), "result": res}, f,
                  default=lambda v: v.item() if hasattr(v, "item") else str(v))
'''

WORLD = 4
TFM_KW = dict(model="transformer", input_size=64, seq_len=16, d_model=32,
              n_heads=4, num_blocks=1, d_ff=48, optimizer="momentum",
              learning_rate=0.01, seed=3, batch_size=8, frequency=1,
              eval_batch_size=8, dataset="synthetic", summaries=False,
              training_epochs=1, fast_loop=False, num_experts=4)
TFM_SIZES = dict(train_size=32, test_size=12, input_size=64)
LM_KW = dict(TFM_KW, objective="lm", input_size=16, seq_len=16,
             vocab_size=32, sample_after=2, sample_temperature=0.0)
LM_SIZES = dict(train_size=32, test_size=4, input_size=16)
DENSE = dict(moe_dispatch="dense", moe_topk=1, moe_aux_weight=0.01)
SPARSE = dict(moe_dispatch="alltoall", moe_topk=2, capacity_factor=4.0,
              moe_aux_weight=0.01)
# name: (flags, sizes) of the full runs, each on all four ranks; JAX's
# lm runs go to JAX_SCRIPT's process
RUNS = {
    "sparse_zero": (dict(TFM_KW, **SPARSE, grouped_moe=True, zero_opt=True,
                         data_parallel=2, expert_parallel=2), TFM_SIZES),
    "fp8_lm": (dict(LM_KW, **SPARSE, fp8_ffn=True, data_parallel=1,
                    expert_parallel=4), LM_SIZES),
    "tp_lm": (dict(LM_KW, **dict(DENSE, moe_topk=2), data_parallel=1,
                   expert_parallel=2, model_parallel=2), LM_SIZES),
}
# the second epoch of the ZeRO run from the other package's checkpoint
RESUMED = dict(RUNS["sparse_zero"][0], training_epochs=2, resume=True)
# 4-step runs with dropout (no JAX side: its fold_in bits differ)
DROPOUT = {
    "drop_dense": dict(TFM_KW, **DENSE, data_parallel=2, expert_parallel=2,
                       dropout_rate=0.3),
    "drop_sparse": dict(TFM_KW, **SPARSE, grouped_moe=True,
                        data_parallel=2, expert_parallel=2,
                        dropout_rate=0.3),
}
STEP_KW = dict(TFM_KW, **DENSE, data_parallel=2, expert_parallel=2,
               grad_clip=0.05)
OPS_SHAPE = (8, 3, 5)
RUN_RTOL = 1e-4
# the fp8 run's bound: a value the two packages round to f32 one ulp
# apart can land on the other side of an fp8 rounding step (1/16 of its
# size), as tests/test_torch_moe_train.py's runs allow
FP8_RUN_RTOL = 1e-3
STEP_RTOL = 2e-5


def save_init_atomic(jcfg, path) -> None:
    """``save_init`` to a temporary name, then renamed: the ranks wait
    for ``path`` and read it whole."""
    tmp = path + ".part.npz"
    save_init(jcfg, tmp)
    os.replace(tmp, path)


def _jax_step(init, batch, devices):
    """JAX's ``build_train_step`` with the per-leaf norms on
    ``build_expert_mesh(2, 2)`` from the saved init: ``(new params,
    cost, grad norms, param norms)`` as numpy."""
    jcfg = jconfig.Config(**STEP_KW, compilation_cache="")
    jspec = jloop.make_spec(jcfg)
    jopt = joptim.make_optimizer(jcfg)
    state = jstate.create_train_state(jax.random.PRNGKey(jcfg.seed), jspec,
                                      jopt)
    with np.load(init) as z:
        params = {k: z[k] for k in z.files}
    state = jstate.TrainState(state.step, params, jopt.init(params))
    mesh = jmesh.build_expert_mesh(2, 2, devices=devices[:WORLD])
    state = jmesh.place_state(state, mesh, jmesh.state_pspecs(
        jspec, jopt, 1, jmesh.EXPERT_AXIS))
    fn = jstep.build_train_step(jcfg, mesh, jspec, jopt, with_norms=True)
    with np.load(batch) as z:
        new, cost, _acc, norms = fn(state, z["x"], z["y"])
    return ({k: np.asarray(v) for k, v in new.params.items()},
            float(cost), np.asarray(norms["grad"]),
            np.asarray(norms["param"]))


def launch(plan, tmp, meanwhile, timeout: float = 240):
    os.makedirs(plan["out"], exist_ok=True)
    plan_path = os.path.join(str(tmp), "ep_plan.json")
    script = os.path.join(str(tmp), "ep_rank.py")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    with open(script, "w") as f:
        f.write(RANK_SCRIPT)
    port = free_port()
    ps, logs = start_ranks([[script, str(r), str(WORLD), str(port),
                             plan_path] for r in range(WORLD)], tmp,
                           "ep_rank")
    try:
        meanwhile()
        wait_ranks(ps, logs, timeout)
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()


def _wait_for(path, timeout: float = 200):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        assert time.monotonic() < deadline, f"never written: {path}"
        time.sleep(0.05)


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    """The ranks' exchange, step, runs and resume; JAX's step, runs and
    resume of the port's checkpoint."""
    tmp = tmp_path_factory.mktemp("ep")
    models = dict({name: kw for name, (kw, _s) in RUNS.items()},
                  step=STEP_KW, **DROPOUT)
    keys = {name: repr(jloop.make_spec(jconfig.Config(**dict(
        kw, dropout_rate=0.0)))) for name, kw in models.items()}
    files = {key: str(tmp / f"init_{i}.npz")
             for i, key in enumerate(dict.fromkeys(keys.values()))}
    inits = {name: files[key] for name, key in keys.items()}
    rng = np.random.RandomState(11)
    batch = str(tmp / "batch.npz")
    np.savez(batch, x=rng.rand(8, 64).astype(np.float32),
             y=np.eye(10, dtype=np.float32)[rng.randint(0, 10, 8)])
    port_ckpt, jax_ckpt = tmp / "port_ckpt_ready", tmp / "jax_ckpt_ready"
    jobs = [dict(kind="ops", shape=OPS_SHAPE),
            dict(kind="step", init=inits["step"], batch=batch,
                 cfg=dict(STEP_KW, histograms=True))]
    for name, (kw, sizes) in RUNS.items():
        jobs.append(dict(kind="run", name=name, init=inits[name],
                         sizes=sizes, cfg=dict(
                             kw, checkpoint_dir=str(tmp / f"torch_{name}"),
                             logs_path=str(tmp / f"torch_logs_{name}"))))
        if name == "sparse_zero":
            jobs[-1]["mark"] = str(port_ckpt)
    for name, kw in DROPOUT.items():
        jobs.append(dict(kind="run", name=name, init=inits[name],
                         sizes=TFM_SIZES, masks=True,
                         cfg=dict(kw, checkpoint_dir=str(tmp / name))))
    jobs.append(dict(kind="run", name="resumed", init=inits["sparse_zero"],
                     sizes=TFM_SIZES, wait=str(jax_ckpt),
                     cfg=dict(RESUMED, checkpoint_dir=str(tmp / "t_from_j"))))
    plan = dict(out=str(tmp / "out"), jobs=jobs)
    jax_runs = {}
    jcfgs = {name: jconfig.Config(**kw, compilation_cache="",
                                  checkpoint_dir=str(tmp / f"jax_{name}"),
                                  logs_path=str(tmp / f"jax_logs_{name}"))
             for name, (kw, _s) in RUNS.items()}
    aside = [n for n in RUNS if RUNS[n][0].get("objective") == "lm"]
    jax_log = tmp / "jax_aside.log"
    with open(jax_log, "w") as log:
        jax_proc = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT, json.dumps([dict(
                cfg=dict(RUNS[n][0], compilation_cache="",
                         checkpoint_dir=jcfgs[n].checkpoint_dir,
                         logs_path=jcfgs[n].logs_path), sizes=RUNS[n][1],
                out=str(tmp / f"jax_{n}.json")) for n in aside])],
            cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
            stdout=log, stderr=subprocess.STDOUT)

    def jax_side():
        for path, kw in {inits[n]: kw for n, kw in models.items()}.items():
            save_init_atomic(jconfig.Config(**kw), path)
        for name, (_kw, sizes) in RUNS.items():
            if name in aside:
                continue
            jax_runs[name] = run_jax(jcfgs[name], sizes) + (jcfgs[name],)
            if name == "sparse_zero":
                shutil.copytree(tmp / "jax_sparse_zero", tmp / "t_from_j")
                open(jax_ckpt, "w").close()
        jax_runs["step"] = _jax_step(inits["step"], batch, jax.devices())
        _wait_for(port_ckpt)
        shutil.copytree(tmp / "torch_sparse_zero", tmp / "j_from_t")
        jcfg = jconfig.Config(**RESUMED, compilation_cache="",
                              checkpoint_dir=str(tmp / "j_from_t"))
        jax_runs["resumed"] = run_jax(jcfg, TFM_SIZES) + (jcfg,)

    try:
        launch(plan, tmp, jax_side)
        jax_proc.wait(timeout=240)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, jax_log.read_text()[-3000:]
    for name in aside:
        with open(tmp / f"jax_{name}.json") as f:
            got = json.load(f)
        jax_runs[name] = (got["stdout"], got["result"], jcfgs[name])
    port = {}
    for name in list(RUNS) + list(DROPOUT) + ["resumed"]:
        for r in range(WORLD):
            with open(tmp / "out" / f"{name}.{r}.json") as f:
                port[name, r] = json.load(f)
            assert port[name, r]["error"] is None, (name, r, port[name, r])
    out = tmp / "out"
    return dict(tmp=tmp, port=port, jax=jax_runs,
                ops=[npz(out / f"ops.{r}.npz") for r in range(WORLD)],
                step=[npz(out / f"step.{r}.npz") for r in range(WORLD)],
                masks={name: [npz(out / f"{name}.masks.{r}.npz")
                              for r in range(WORLD)] for name in DROPOUT})


def _final_params(ckpt_dir) -> dict:
    return {k: v for k, v in npz(latest_npz(ckpt_dir)).items()
            if k.startswith((".params/", ".opt_state/"))}


def _close_leaves(got: dict, want: dict, rtol: float, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], rtol=0,
            atol=rtol * max(float(np.abs(want[k]).max()), 1e-6),
            err_msg=f"{what} {k}")


# ---- the exchange ----


def test_expert_all_to_all_equals_the_tiled_emulation(ep):
    """The dispatch ``[E, C, d] -> [El, ep * C, d]`` hands rank r shard
    j's rows of experts ``[r * El, (r + 1) * El)`` at capacity rows ``[j
    * C, (j + 1) * C)``; the combine hands each block back; each one's
    backward is the other's exchange of the cotangent.  Exact, and
    every rank posts its two f32 buffers."""
    ops, n = ep["ops"], WORLD
    e, c, d = OPS_SHAPE
    el = e // n
    bufs = [o["buf"] for o in ops]
    hs = [o["h"] for o in ops]
    for r in range(n):
        want = np.concatenate([bufs[j][r * el:(r + 1) * el]
                               for j in range(n)], axis=1)
        np.testing.assert_array_equal(ops[r]["sent"], want)
        back = np.concatenate([hs[j][:, r * c:(r + 1) * c]
                               for j in range(n)], axis=0)
        np.testing.assert_array_equal(ops[r]["back"], back)
        # d/dbuf_r of sum_j sum(sent_j * w1_j): the w1 rows of each
        # receiver at this rank's capacity block
        dbuf = np.concatenate([ops[j]["w1"][:, r * c:(r + 1) * c]
                               for j in range(n)], axis=0)
        np.testing.assert_array_equal(ops[r]["dbuf"], dbuf)
        dh = np.concatenate([ops[j]["w2"][r * el:(r + 1) * el]
                             for j in range(n)], axis=1)
        np.testing.assert_array_equal(ops[r]["dh"], dh)
        assert int(ops[r]["posted"]) == 2 * e * c * d * 4


def test_expert_operators_are_identity_without_an_axis():
    """Without a live expert axis the exchange, the copy and the psum
    pass their input through."""
    x = torch.randn(4, 3, 2)
    assert tmesh.expert_all_to_all(x, None) is x
    assert tmesh.expert_all_to_all(x, None, reverse=True) is x
    assert tmesh.expert_copy(x, None) is x
    assert tmesh.expert_psum(x, None) is x
    one = tmesh.ExpertAxis(None, 1, 0)
    assert tmesh.expert_psum(x, one) is x


# ---- one step and the runs ----


def test_dense_step_equals_jax_expert_mesh(ep):
    """One dense-dispatch step (top-1) at dp 2 x ep 2 with the balance
    loss and a binding ``--grad_clip``: every rank's cost, per-leaf
    gradient and param norms (each expert leaf's summed over the expert
    group), and new params (the experts gathered) equal JAX's step on
    ``build_expert_mesh(2, 2)``.  (Dense dispatch's whole run is the TP
    x EP lm case, and its dropout run below.)"""
    params, cost, gnorm, pnorm = ep["jax"]["step"]
    for r in range(WORLD):
        s = ep["step"][r]
        np.testing.assert_allclose(float(s["cost"]), cost, rtol=1e-5)
        np.testing.assert_allclose(s["grad"], gnorm, rtol=STEP_RTOL,
                                   atol=STEP_RTOL * float(gnorm.max()))
        np.testing.assert_allclose(s["param"], pnorm, rtol=STEP_RTOL)
        _close_leaves({k[2:]: v for k, v in s.items()
                       if k.startswith("p/")}, params, STEP_RTOL,
                      f"rank {r}")


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_equals_jax_expert_mesh(ep, name):
    """Each run on four ranks against JAX's run of the same flags: the
    host path, the devices, the steps, every rank's printed costs, the
    chief's test accuracy, and the final params and slots of the chief's
    checkpoint (JAX's global layouts) within the run bound."""
    j_out, j_res, jcfg = ep["jax"][name]
    chief = ep["port"][name, 0]
    t_res = chief["result"]
    assert t_res["fast_loop"] is j_res["fast_loop"] is False
    for k in ("steps", "global_batch", "devices", "examples_seen"):
        assert t_res[k] == j_res[k], k
    assert t_res["devices"] == WORLD
    jc, tc = costs(j_out), costs(chief["stdout"])
    assert len(tc) == len(jc) >= 4
    assert np.allclose(tc, jc, rtol=0, atol=1e-4), (tc, jc)
    for r in range(1, WORLD):
        assert costs(ep["port"][name, r]["stdout"]) == tc[:-1]
    # the lm accuracy is a mean of per-example means, summed in another
    # order
    assert abs(t_res["test_accuracy"] - j_res["test_accuracy"]) <= 1e-6
    _close_leaves(_final_params(ep["tmp"] / f"torch_{name}"),
                  _final_params(jcfg.checkpoint_dir),
                  FP8_RUN_RTOL if name == "fp8_lm" else RUN_RTOL, name)


@pytest.mark.parametrize("name", ["fp8_lm", "tp_lm"])
def test_lm_samples_equal_jax(ep, name):
    """``--sample_after 2`` greedy: the chief's samples (the experts
    gathered over the expert group; tensor-parallel decode at mp 2)
    equal JAX's."""
    jcfg = ep["jax"][name][2]
    t = npz(ep["tmp"] / f"torch_logs_{name}" / "samples.npz")
    j = npz(os.path.join(jcfg.logs_path, "samples.npz"))
    assert t["samples"].shape == j["samples"].shape == (2, 16)
    np.testing.assert_array_equal(t["samples"], j["samples"])


def test_zero_checkpoint_crosses_packages(ep):
    """The ZeRO run's checkpoint (expert leaves whole, their slots
    ``[ep, dp, chunk]``): the port's resumed by JAX and JAX's resumed by
    the port at dp 2 x ep 2, a second epoch each, print the same costs
    and end at the same params and slots."""
    j_out, _j_res, jcfg = ep["jax"]["resumed"]
    t_out = ep["port"]["resumed", 0]["stdout"]
    assert "Resumed from" in t_out and "Resumed from" in j_out
    tc, jc = costs(t_out), costs(j_out)
    assert len(tc) == len(jc) >= 4
    assert np.allclose(tc, jc, rtol=0, atol=1e-4), (tc, jc)
    t = npz(latest_npz(ep["tmp"] / "t_from_j"))
    j = npz(latest_npz(jcfg.checkpoint_dir))
    assert int(t[".step"]) == int(j[".step"]) == 8
    e = RUNS["sparse_zero"][0]["num_experts"]
    slot = [k for k in j if k.startswith(".opt_state/") and
            k.endswith("L0_We1")]
    assert slot and j[slot[0]].shape[:2] == (2, 2), slot
    assert j[".params/L0_We1"].shape[0] == e
    _close_leaves({k: v for k, v in t.items()
                   if k.startswith((".params/", ".opt_state/"))},
                  {k: v for k, v in j.items()
                   if k.startswith((".params/", ".opt_state/"))},
                  RUN_RTOL, "resumed")


@pytest.mark.parametrize("name", sorted(DROPOUT))
def test_dropout_masks_follow_the_token_shards(ep, name):
    """A 4-step run with ``--dropout_rate 0.3`` at dp 2 x ep 2 trains
    (finite costs, equal on every rank); the first step's masks: under
    dense dispatch the expert ranks of a data index (0 and 1, 2 and 3)
    draw the same at every site and the data indices differ; under
    sparse dispatch all four (data, expert) shards differ."""
    prints = [costs(ep["port"][name, r]["stdout"]) for r in range(WORLD)]
    assert len(prints[0]) >= 4 and np.all(np.isfinite(prints[0]))
    assert all(p[:4] == prints[0][:4] for p in prints)
    m = ep["masks"][name]
    sites = sorted(m[0])
    assert len(sites) == 1 + 2 * TFM_KW["num_blocks"]
    for s in sites:
        if name == "drop_dense":
            np.testing.assert_array_equal(m[0][s], m[1][s])
            np.testing.assert_array_equal(m[2][s], m[3][s])
            assert not np.array_equal(m[0][s], m[2][s]), s
        else:
            for a in range(WORLD):
                for b in range(a + 1, WORLD):
                    assert not np.array_equal(m[a][s], m[b][s]), (s, a, b)


# ---- the mesh and the refusals ----


@pytest.mark.parametrize("dp,ep_,mp", [(1, 2, 1), (2, 2, 1), (1, 4, 1),
                                       (1, 2, 2), (2, 2, 2), (2, 4, 1)])
def test_rank_plays_jax_expert_mesh_position(dp, ep_, mp):
    """Rank r sits where JAX's ``build_expert_mesh`` puts device r: data
    index r // (ep mp), expert index (r // mp) % ep, model index r % mp;
    under sparse dispatch its batch shard is data_index * ep +
    expert_index, under dense its data index."""
    from distributed_tensorflow_example_tpu_torch.models import transformer

    n = dp * ep_ * mp
    devices = jax.devices()[:n]
    jm = jmesh.build_expert_mesh(dp, ep_, devices=devices, model_parallel=mp)
    sparse = transformer.TransformerSpec(num_experts=4,
                                         moe_dispatch="alltoall")
    for r in range(n):
        tm = tmesh.build_expert_mesh(dp, ep_, world=n, rank=r,
                                     model_parallel=mp)
        pos = tuple(np.argwhere(jm.devices == devices[r])[0])
        want = pos if mp > 1 else pos + (0,)
        assert (tm.data_index, tm.expert_index, tm.model_index) == want
        assert tm.devices == n
        assert tmesh.batch_layout(tm, 8 * dp) == slice(
            8 * tm.data_index, 8 * tm.data_index + 8)
        ts = tmesh.for_spec(tm, sparse)
        i = tm.data_index * ep_ + tm.expert_index
        assert tmesh.batch_layout(ts, 8 * dp * ep_) == slice(8 * i, 8 * i + 8)


@pytest.mark.parametrize("dp,ep_,mp,n", [(0, 2, 1, 4), (4, 2, 1, 4),
                                         (2, 2, 2, 4)])
def test_build_expert_mesh_messages_equal_jax(dp, ep_, mp, n):
    """A degree below 1 or a mesh larger than the world raises JAX's
    message; one that leaves ranks off the port's own."""
    with pytest.raises(ValueError) as j:
        jmesh.build_expert_mesh(dp, ep_, devices=jax.devices()[:n],
                                model_parallel=mp)
    with pytest.raises(ValueError) as t:
        tmesh.build_expert_mesh(dp, ep_, world=n, model_parallel=mp)
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError, match="leaves 4 of 8 ranks off"):
        tmesh.build_expert_mesh(2, 2, world=8)


def test_expert_shard_is_jax_device_block():
    """``convert.expert_shard`` cuts each expert leaf to the block of
    JAX's ``param_pspecs(expert_axis=...)`` that device r holds on
    ``build_expert_mesh(2, 2)``; the router and the other leaves
    whole."""
    from distributed_tensorflow_example_tpu.models import transformer as jtfm

    from distributed_tensorflow_example_tpu_torch import convert
    from distributed_tensorflow_example_tpu_torch.models import transformer

    kw = dict(input_size=64, seq_len=16, d_model=8, n_heads=2,
              num_blocks=1, d_ff=12, num_experts=4)
    jspec, tspec = jtfm.TransformerSpec(**kw), transformer.TransformerSpec(
        **kw)
    params = {k: np.asarray(v) for k, v in jtfm.init(
        jax.random.PRNGKey(0), jspec).items()}
    devices = jax.devices()[:4]
    mesh = jmesh.build_expert_mesh(2, 2, devices=devices)
    placed = jmesh.place_state(params, mesh, jmesh.param_pspecs(
        jspec, 1, jmesh.EXPERT_AXIS))
    whole = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    for r, dev in enumerate(devices):
        tm = tmesh.build_expert_mesh(2, 2, world=4, rank=r)
        mine = convert.expert_shard(whole, tspec, tm.ep, tm.expert_index)
        assert sorted(mine) == sorted(params)
        for k, a in placed.items():
            block = [s.data for s in a.addressable_shards
                     if s.device == dev][0]
            np.testing.assert_array_equal(mine[k].numpy(),
                                          np.asarray(block), err_msg=k)


REFUSALS = {
    "degree": dict(TFM_KW, expert_parallel=0),
    "no_experts": dict(TFM_KW, num_experts=0, expert_parallel=2),
    "uneven": dict(TFM_KW, num_experts=6, expert_parallel=4),
    "fsdp": dict(TFM_KW, expert_parallel=2, fsdp=True),
    "sync_period": dict(TFM_KW, expert_parallel=2, sync_period=2),
    "seq": dict(TFM_KW, expert_parallel=2, sequence_parallel=2),
    "sites": dict(TFM_KW, expert_parallel=2, sites=2),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_equal_jax(name):
    """The trainer refuses what JAX's refuses, with its message: a
    degree below 1, no MoE, experts that do not split, FSDP, local SGD,
    sequence parallelism and the multi-site layout beside the expert
    axis."""
    kw = REFUSALS[name]
    with pytest.raises(ValueError) as j:
        jloop.run(jconfig.Config(**kw, compilation_cache=""))
    with pytest.raises(ValueError) as t:
        tloop.run(tconfig.Config(**kw, device="cpu"))
    assert str(t.value) == str(j.value)


def test_trainer_parses_expert_parallel_with_jax_default(capsys):
    """``--expert_parallel`` parses with JAX's default; on one process
    ``--expert_parallel=2`` exits 2 with JAX's mesh message."""
    assert (tconfig.parse_train_config([]).expert_parallel
            == jconfig.Config().expert_parallel == 1)
    cfg = tconfig.parse_train_config(["--expert_parallel=4"])
    assert cfg.expert_parallel == 4
    rc = tmain.main(["--device", "cpu", "--model=transformer",
                     "--num_experts=4", "--expert_parallel=2",
                     "--training_epochs=0"])
    assert rc == 2
    assert ("mesh 1x2 over ('data', 'expert') needs 2 devices, have 1"
            in capsys.readouterr().err)

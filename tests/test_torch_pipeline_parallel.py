"""Pipeline parallelism in the port against the JAX package's one-process
``('data', 'stage'[, 'seq' | 'expert'][, 'model'])`` mesh, on the CPU.

Four gloo rank subprocesses (``OMP_NUM_THREADS=1``, niced), launched
once, in one world of four that runs every case in turn; the JAX steps
run in this process meanwhile on the first four of the eight CPU devices,
and JAX's full runs in a JAX process of their own beside it.  Rank r
plays device r of JAX's ``build_stage_mesh``: with x the seq or expert
degree, data index ``r // (pp x mp)``, stage index ``(r // (x mp)) %
pp``, seq or expert index ``(r // mp) % x``, model index ``r % mp``.

- the copied tick tables (``parallel/pp_schedule``) equal JAX's over
  JAX's own ``(p, v, m)`` matrix; the stacked layout bitwise JAX's at
  ``(stages, virtual)`` in {(2, 1), (2, 2), (4, 1)};
- the stage hop at pp 4 (the world as one stage axis) by
  ``batch_isend_irecv`` and by the zero-split ``all_to_all_single``
  (gloo's route on the card, its idle sides a one-element placeholder):
  the live pairs' tensors arrive, the routes agree, the payload bytes
  are tallied;
- one step against JAX's ``build_train_step`` on ``build_stage_mesh``
  (the cost, the per-leaf gradient and param norms, the new params and,
  under ZeRO-1, the slots, all in JAX's global stacked layout): (a)
  dp 2 x pp 2 gpipe, M 2, classify, ``--grad_clip`` under ``--zero_opt``
  (the ``[pp, dp, chunk]`` slots; and once more with the hop on the
  zero-split route: bitwise the same); (b) pp 2 x mp 2 1F1B lm; (c) dp 2
  x pp 2, 4 blocks, v 2, gpipe and 1F1B; (d) pp 2 x sp 2 ring lm gpipe;
  (e) pp 2 x ep 2 sparse top-2 with the balance loss, gpipe;
- full runs against JAX's ``train.loop.run``: dp 2 x pp 2 1F1B lm with
  ``--sample_after`` (greedy samples equal), dp 2 x pp 2 interleaved
  gpipe (v 2, 4 blocks); the interleaved run's checkpoint resumed by
  JAX for a second epoch and JAX's by the port; a ``(stages, virtual)``
  mismatch refused with JAX's message;
- dropout and remat, the port against itself (JAX's bits differ): gpipe
  and 1F1B draw the same masks (the per-microbatch seed and the stacked
  position's salts), so their params agree within 1e-6 of scale; the
  microbatches' masks differ; gpipe ``--remat`` equals gpipe;
- ``build_stage_mesh``'s placement, JAX's messages and the port's own;
  ``validate_pipeline_config``'s matrix against JAX's; the CLI's exit 2.

Tolerances, JAX's own PP tests' (``tests/test_transformer.py``), f32:
the step's cost within 1e-5 and its params and norms within 2e-5 of
each leaf's scale (the microbatch sums and the stage, data and model
sums add the same terms in other orders: a few ulps of the leaf); runs:
printed costs within 1e-4 (one unit in their last printed place), final
params within 1e-4 of each leaf's scale (four steps' rounding compounds
through the optimizer), accuracies within 1e-6 (the lm accuracy is a
mean of per-example means summed in another order); the hops and the
stacked layout exactly (they move numbers).
"""

import inspect
import json
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.models import transformer as jtfm
from distributed_tensorflow_example_tpu.parallel import mesh as jmesh
from distributed_tensorflow_example_tpu.parallel import pp_schedule as jpps
from distributed_tensorflow_example_tpu.parallel import step as jstep
from distributed_tensorflow_example_tpu.parallel import zero as jzero
from distributed_tensorflow_example_tpu.train import loop as jloop
from distributed_tensorflow_example_tpu.train import optim as joptim
from distributed_tensorflow_example_tpu.train import state as jstate
from distributed_tensorflow_example_tpu.utils import checkpoint as jckpt
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch import main as tmain
from distributed_tensorflow_example_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_example_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_example_tpu_torch.parallel import pp_schedule as tpps
from test_torch_data_parallel import (REPO, costs, free_port, latest_npz,
                                      npz, start_ranks, wait_ranks)

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
from distributed_tensorflow_example_tpu_torch.utils import checkpoint as ckpt

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


def hop_job(job):
    """Hops over the world as one stage axis of 4, each route: stage 0
    to 1 alone; every stage to the next (the wrap 3 -> 0 included); the
    gradient direction, stage 3 to 2 alone."""
    axis = tmesh.StageAxis(dist.group.WORLD, world, me, tuple(range(world)))
    like = torch.zeros(3, 2)
    got = {}
    for how in ("p2p", "a2a"):
        for k in tmesh.PP_BYTES:
            tmesh.PP_BYTES[k] = 0
        mine = torch.full((3, 2), float(me + 1))
        a = tmesh.stage_hop_start(mine if me == 0 else None,
                                  like if me == 1 else None, axis,
                                  transport=how, device="cpu").wait()[0]
        b = tmesh.stage_hop_start(mine * 10, like, axis, transport=how,
                                  device="cpu").wait()[0]
        c = tmesh.stage_hop_start(mine * 100 if me == 3 else None,
                                  like if me == 2 else None, axis,
                                  reverse=True, transport=how,
                                  device="cpu").wait()[0]
        for name, t in (("a", a), ("b", b), ("c", c)):
            got[f"{how}/{name}"] = (np.full((3, 2), np.nan) if t is None
                                    else t.numpy())
        got[f"{how}/fwd"] = np.int64(tmesh.PP_BYTES["fwd"])
        got[f"{how}/bwd"] = np.int64(tmesh.PP_BYTES["bwd"])
    np.savez(os.path.join(out_dir, f"hop.{me}.npz"), **got)


def step_job(job):
    """One step of the synchronous body at the plan's mesh on this
    rank's rows (and token columns) of the plan's batch: the cost, the
    norms and the new state in JAX's global stacked layout."""
    if job.get("a2a"):
        transformer.stage_hop_transport = lambda axis, device: "a2a"
    cfg = tconfig.Config(**job["cfg"], device="cpu")
    spec = tloop.make_spec(cfg)
    opt = toptim.make_optimizer(cfg)
    mesh = tloop.train_mesh(cfg, spec)
    strat = tloop.setup_strategy(cfg, spec, opt, port_init(job["init"])(
        spec, opt), mesh, fast=False)
    with np.load(job["batch"]) as z:
        x, y = z["x"], z["y"]
    rows = tmesh.batch_layout(mesh, x.shape[0])
    cols = tmesh.seq_columns(mesh, x.shape[1])
    new, cost, _acc, norms = strat.body(
        strat.state, torch.from_numpy(x[rows][:, cols]),
        torch.from_numpy(y[rows]))
    full = ckpt.gather_global(new, strat.layout)
    if me == 0:
        np.savez(os.path.join(out_dir, f"{job['name']}.npz"),
                 cost=cost.numpy(), grad=norms["grad"].numpy(),
                 param=norms["param"].numpy(),
                 **{k: v.numpy() for k, v in full.items()
                    if k != ".step"})
    transformer.stage_hop_transport = tmesh.stage_hop_transport


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
            if rng is not None and spec_.dropout_rate:
                masks.setdefault(f"{salt}:{rng}", (o == 0).numpy())
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
    {"hop": hop_job, "step": step_job, "run": run_job}[job["kind"]](job)
    dist.barrier()
    if job.get("mark") and me == 0:
        open(job["mark"], "w").close()
dist.destroy_process_group()
'''

# JAX's side, in processes of their own beside this one: runs (each run's
# stdout and result; a run with "copy" copies its checkpoint and marks it
# ready, one with "wait" copies another's once its mark exists) and steps
# (``_jax_step``, whose source is appended), in order
JAX_SCRIPT = r'''
import contextlib, io, json, os, shutil, sys, time
sys.path.insert(0, os.getcwd())
from __graft_entry__ import force_cpu_device_flags
os.environ["XLA_FLAGS"] = force_cpu_device_flags(
    os.environ.get("XLA_FLAGS", ""), 8)
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.data import mnist as jmnist
from distributed_tensorflow_example_tpu.models import transformer as jtfm
from distributed_tensorflow_example_tpu.parallel import mesh as jmesh
from distributed_tensorflow_example_tpu.parallel import step as jstep
from distributed_tensorflow_example_tpu.parallel import zero as jzero
from distributed_tensorflow_example_tpu.train import loop as jloop
from distributed_tensorflow_example_tpu.train import optim as joptim
from distributed_tensorflow_example_tpu.train import state as jstate
from distributed_tensorflow_example_tpu.utils import checkpoint as jckpt
WORLD = 4


def wait_for(path):
    while not os.path.exists(path):
        time.sleep(0.05)


def main():
    for job in json.loads(sys.argv[1]):
        if job["kind"] == "step":
            wait_for(job["init"])
            _jax_step(job["kw"], job["init"], job["batch"], job["out"])
            continue
        if job.get("wait"):
            wait_for(job["wait"]["mark"])
            if job["wait"].get("src"):
                shutil.copytree(job["wait"]["src"],
                                job["cfg"]["checkpoint_dir"])
        data = jmnist.synthesize_dataset(seed=0, **job["sizes"])
        jloop.load_datasets = lambda *a, **k: data
        with np.load(job["init"]) as z:
            init = {k: jnp.asarray(z[k]) for k in z.files}
        jloop.create_train_state = lambda key, spec, opt: jstate.TrainState(
            jnp.zeros((), jnp.int32), init, opt.init(init))
        buf = io.StringIO()
        res = err = None
        try:
            with contextlib.redirect_stdout(buf):
                res = jloop.run(jconfig.Config(**job["cfg"]))
        except ValueError as e:
            if not job.get("refused"):
                raise
            err = f"ValueError: {e}"
        with open(job["out"], "w") as f:
            json.dump({"stdout": buf.getvalue(), "result": res,
                       "error": err}, f,
                      default=lambda v: (v.item() if hasattr(v, "item")
                                         else str(v)))
        if job.get("copy"):
            shutil.copytree(job["cfg"]["checkpoint_dir"], job["copy"]["dst"])
            open(job["copy"]["mark"], "w").close()


'''

WORLD = 4
TFM_KW = dict(model="transformer", input_size=64, seq_len=16, d_model=32,
              n_heads=4, num_blocks=2, d_ff=48, optimizer="momentum",
              learning_rate=0.01, seed=3, batch_size=8, frequency=1,
              eval_batch_size=8, dataset="synthetic", summaries=False,
              training_epochs=1, fast_loop=False, microbatches=2)
TFM_SIZES = dict(train_size=32, test_size=12, input_size=64)
LM_KW = dict(TFM_KW, objective="lm", input_size=16, seq_len=16,
             vocab_size=32)
LM_SIZES = dict(train_size=32, test_size=4, input_size=16)
PP2 = dict(pipeline_parallel=2)
MOE = dict(num_experts=4, moe_dispatch="alltoall", moe_topk=2,
           capacity_factor=2.0, moe_aux_weight=0.01)
# name: the flags of one step, each on all four ranks
STEPS = {
    "a_gpipe_zero": dict(TFM_KW, **PP2, data_parallel=2, grad_clip=0.05,
                         zero_opt=True),
    "b_tp_1f1b_lm": dict(LM_KW, **PP2, model_parallel=2,
                         pp_schedule="1f1b"),
    "c_v2_gpipe": dict(TFM_KW, **PP2, data_parallel=2, num_blocks=4,
                       virtual_stages=2),
    "c_v2_1f1b": dict(TFM_KW, **PP2, data_parallel=2, num_blocks=4,
                      virtual_stages=2, pp_schedule="1f1b"),
    "d_sp_lm": dict(LM_KW, **PP2, sequence_parallel=2),
    "e_ep_aux": dict(TFM_KW, **PP2, **MOE, expert_parallel=2),
}
# name: (flags, sizes) of the full runs against JAX's
RUNS = {
    "lm_1f1b": (dict(LM_KW, **PP2, data_parallel=2, pp_schedule="1f1b",
                     sample_after=2, sample_temperature=0.0), LM_SIZES),
    "interleaved": (dict(TFM_KW, **PP2, data_parallel=2, num_blocks=4,
                         virtual_stages=2), TFM_SIZES),
}
# the interleaved run's second epoch from the other package's checkpoint
RESUMED = dict(RUNS["interleaved"][0], training_epochs=2, resume=True)
# the same checkpoint at another virtual degree: refused
MISMATCH = dict(RUNS["interleaved"][0], virtual_stages=1, resume=True)
# dp 2 x pp 2 runs with dropout (no JAX side: its fold_in bits differ)
DROP = dict(TFM_KW, **PP2, data_parallel=2, num_blocks=4, dropout_rate=0.3,
            optimizer="sgd", learning_rate=0.05)
DROPOUT = {"drop_gpipe": DROP,
           "drop_1f1b": dict(DROP, pp_schedule="1f1b"),
           "drop_remat": dict(DROP, remat=True)}
STEP_RTOL = 2e-5
RUN_RTOL = 1e-4


def save_init(kw, path) -> None:
    """Initial params of ``kw``'s model for both sides, drawn with numpy
    from ``kw``'s seed in the JAX package's distributions (weights
    N(0, 1) / sqrt(fan in), ``pos`` and ``W_emb`` 0.02 N(0, 1), unit
    gains, biases 0.1 N(0, 1) so each bias's gradient path is exercised)
    and written under a temporary name, then renamed: the ranks wait for
    ``path`` and read it whole."""
    jspec = jloop.make_spec(jconfig.Config(**kw))
    rng = np.random.RandomState(kw["seed"])
    out = {}
    for name, shape in jtfm.param_shapes(jspec).items():
        w = rng.standard_normal(shape).astype(np.float32)
        if name in ("pos", "W_emb"):
            out[name] = 0.02 * w
        elif "W" in name:
            fan_in = shape[-2] if name.endswith(("We1", "We2")) else shape[0]
            out[name] = w / np.float32(np.sqrt(fan_in))
        elif name.endswith("_g"):
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = 0.1 * w
    tmp = path + ".part.npz"
    np.savez(tmp, **out)
    os.replace(tmp, path)


def _jax_step(kw, init, batch, out):
    """JAX's ``build_train_step`` with the per-leaf norms on
    ``build_stage_mesh`` (the first four devices) from the saved flat
    init, stacked as JAX's trainer stacks it, written to ``out``: the
    global state leaves keyed as the port's checkpoints, the cost and the
    gradient and param norms."""
    jcfg = jconfig.Config(**kw, compilation_cache="")
    jspec = jloop.make_spec(jcfg)
    jopt = joptim.make_optimizer(jcfg)
    p, v = jcfg.pipeline_parallel, jcfg.virtual_stages
    with np.load(init) as z:
        flat = {k: z[k] for k in z.files}
    stacked = jtfm.pipeline_stack_params(jspec, flat, p, v)
    state = jstate.TrainState(jnp.zeros((), jnp.int32), stacked,
                              jopt.init(stacked))
    dp = (WORLD // (p * jcfg.model_parallel * jcfg.sequence_parallel
                    * jcfg.expert_parallel) if jcfg.data_parallel == -1
          else jcfg.data_parallel)
    mesh = jmesh.build_stage_mesh(
        dp, p, devices=jax.devices()[:WORLD],
        model_parallel=jcfg.model_parallel,
        sequence_parallel=jcfg.sequence_parallel,
        expert_parallel=jcfg.expert_parallel)
    sspecs = jmesh.pipeline_state_pspecs(
        jspec, jopt, jmesh.STAGE_AXIS,
        jmesh.tp_axis(jspec, jcfg.model_parallel),
        jmesh.axis_if_present(mesh, jmesh.EXPERT_AXIS))
    if jcfg.zero_opt:
        z_state, z_specs = jzero.zero_opt_state(jopt, stacked,
                                                sspecs.params, mesh, dp)
        state = jstate.TrainState(state.step, stacked, z_state)
        sspecs = jstate.TrainState(P(), sspecs.params, z_specs)
    state = jmesh.place_state(state, mesh, sspecs)
    fn = jstep.build_train_step(jcfg, mesh, jspec, jopt, with_norms=True)
    with np.load(batch) as z:
        new, cost, _acc, norms = fn(state, z["x"], z["y"])
    leaves = {k: a for k, a in jckpt._flatten(new).items() if k != ".step"}
    tmp = out + ".part.npz"
    np.savez(tmp, cost=np.float64(cost), grad=np.asarray(norms["grad"]),
             param=np.asarray(norms["param"]), **leaves)
    os.replace(tmp, out)


def launch(plan, tmp, meanwhile, timeout: float = 240):
    os.makedirs(plan["out"], exist_ok=True)
    plan_path = os.path.join(str(tmp), "pp_plan.json")
    script = os.path.join(str(tmp), "pp_rank.py")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    with open(script, "w") as f:
        f.write(RANK_SCRIPT)
    port = free_port()
    ps, logs = start_ranks([[script, str(r), str(WORLD), str(port),
                             plan_path] for r in range(WORLD)], tmp,
                           "pp_rank")
    try:
        meanwhile()
        wait_ranks(ps, logs, timeout)
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def pp(tmp_path_factory):
    """The ranks' hops, steps, runs and resume; JAX's steps here, JAX's
    runs and its resume of the port's checkpoint beside."""
    tmp = tmp_path_factory.mktemp("pp")
    models = dict({name: kw for name, (kw, _s) in RUNS.items()}, **STEPS,
                  **DROPOUT)
    keys = {name: repr(jloop.make_spec(jconfig.Config(**dict(
        kw, dropout_rate=0.0)))) for name, kw in models.items()}
    files = {key: str(tmp / f"init_{i}.npz")
             for i, key in enumerate(dict.fromkeys(keys.values()))}
    inits = {name: files[key] for name, key in keys.items()}
    rng = np.random.RandomState(11)
    batches = {}
    for width in (64, 16):
        batches[width] = str(tmp / f"batch{width}.npz")
        np.savez(batches[width], x=rng.rand(8, width).astype(np.float32),
                 y=np.eye(10, dtype=np.float32)[rng.randint(0, 10, 8)])
    port_ckpt, jax_ckpt = tmp / "port_ckpt_ready", tmp / "jax_ckpt_ready"
    jobs = [dict(kind="hop")]
    for name, kw in STEPS.items():
        jobs.append(dict(kind="step", name=name, init=inits[name],
                         batch=batches[kw["input_size"]],
                         cfg=dict(kw, histograms=True)))
    jobs.append(dict(jobs[1], name="a_gpipe_zero_a2a", a2a=True))
    for name, (kw, sizes) in RUNS.items():
        jobs.append(dict(kind="run", name=name, init=inits[name],
                         sizes=sizes, cfg=dict(
                             kw, checkpoint_dir=str(tmp / f"torch_{name}"),
                             logs_path=str(tmp / f"torch_logs_{name}"))))
        if name == "interleaved":
            jobs[-1]["mark"] = str(port_ckpt)
    jobs.append(dict(kind="run", name="mismatch", init=inits["interleaved"],
                     sizes=TFM_SIZES, cfg=dict(
                         MISMATCH,
                         checkpoint_dir=str(tmp / "torch_interleaved"))))
    for name, kw in DROPOUT.items():
        jobs.append(dict(kind="run", name=name, init=inits[name],
                         sizes=TFM_SIZES, masks=True,
                         cfg=dict(kw, checkpoint_dir=str(tmp / name))))
    jobs.append(dict(kind="run", name="resumed", init=inits["interleaved"],
                     sizes=TFM_SIZES, wait=str(jax_ckpt),
                     cfg=dict(RESUMED, checkpoint_dir=str(tmp / "t_from_j"))))
    plan = dict(out=str(tmp / "out"), jobs=jobs)
    for path, kw in {inits[n]: kw for n, kw in models.items()}.items():
        save_init(kw, path)
    jcfgs = {name: dict(kw, compilation_cache="",
                        checkpoint_dir=str(tmp / f"jax_{name}"),
                        logs_path=str(tmp / f"jax_logs_{name}"))
             for name, (kw, _s) in RUNS.items()}
    # the interleaved run and its resume share a compile cache
    jcache = str(tmp / "jax_cache")
    jcfgs["interleaved"]["compilation_cache"] = jcache

    def jstep_job(name):
        return dict(kind="step", kw=STEPS[name], init=inits[name],
                    batch=batches[STEPS[name]["input_size"]],
                    out=str(tmp / f"jax_{name}.npz"))

    def jrun_job(name, cfg, sizes, **more):
        return dict(kind="run", cfg=cfg, sizes=sizes,
                    init=inits[name if name in RUNS else "interleaved"],
                    out=str(tmp / f"jax_{name}.json"), **more)

    # JAX's work in three processes beside this one, which writes the
    # inits and then takes the first three steps
    here = ["a_gpipe_zero", "b_tp_1f1b_lm", "e_ep_aux"]
    sides = [
        [jrun_job("lm_1f1b", jcfgs["lm_1f1b"], LM_SIZES),
         jstep_job("c_v2_1f1b")],
        [jrun_job("interleaved", jcfgs["interleaved"], TFM_SIZES,
                  copy=dict(dst=str(tmp / "t_from_j"), mark=str(jax_ckpt))),
         jrun_job("resumed", dict(RESUMED, compilation_cache=jcache,
                                  checkpoint_dir=str(tmp / "j_from_t")),
                  TFM_SIZES, wait=dict(mark=str(port_ckpt),
                                       src=str(tmp / "torch_interleaved"))),
         jrun_job("mismatch", dict(MISMATCH, compilation_cache="",
                                   checkpoint_dir=str(
                                       tmp / "torch_interleaved")),
                  TFM_SIZES, refused=True)],
        [jstep_job(n) for n in ("c_v2_gpipe", "d_sp_lm")]]
    script = (JAX_SCRIPT + inspect.getsource(_jax_step)
              + "\n\nmain()\n")
    procs, logs = [], []
    for i, jobs_i in enumerate(sides):
        logs.append(tmp / f"jax_side{i}.log")
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, json.dumps(jobs_i)],
                cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
                stdout=log, stderr=subprocess.STDOUT))

    def jax_side():
        for name in here:
            _jax_step(STEPS[name], inits[name],
                      batches[STEPS[name]["input_size"]],
                      str(tmp / f"jax_{name}.npz"))

    try:
        launch(plan, tmp, jax_side)
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-3000:]
    jax_runs = {}
    for name in list(RUNS) + ["resumed", "mismatch"]:
        with open(tmp / f"jax_{name}.json") as f:
            jax_runs[name] = json.load(f)
    port = {}
    for name in list(RUNS) + list(DROPOUT) + ["resumed", "mismatch"]:
        for r in range(WORLD):
            with open(tmp / "out" / f"{name}.{r}.json") as f:
                port[name, r] = json.load(f)
            if name != "mismatch":
                assert port[name, r]["error"] is None, (name, r,
                                                        port[name, r])
    out = tmp / "out"
    return dict(tmp=tmp, port=port, jax=jax_runs,
                jax_steps={n: npz(tmp / f"jax_{n}.npz") for n in STEPS},
                hop=[npz(out / f"hop.{r}.npz") for r in range(WORLD)],
                steps={n: npz(out / f"{n}.npz")
                       for n in list(STEPS) + ["a_gpipe_zero_a2a"]},
                masks={name: [npz(out / f"{name}.masks.{r}.npz")
                              for r in range(WORLD)] for name in DROPOUT})


def _close_leaves(got: dict, want: dict, rtol: float, what: str) -> None:
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(
            np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
            rtol=0, atol=rtol * max(float(np.abs(want[k]).max()), 1e-6),
            err_msg=f"{what} {k}")


def _state_leaves(ckpt_dir) -> dict:
    return {k: v for k, v in npz(latest_npz(ckpt_dir)).items()
            if k.startswith((".params/", ".opt_state/"))}


# ---- the tick tables and the stacked layout (no ranks) ----


@pytest.mark.parametrize("p,v,m", [
    (2, 1, 1), (2, 1, 4), (3, 1, 6), (4, 1, 16), (2, 2, 2), (2, 2, 4),
    (2, 4, 4), (3, 2, 6), (4, 2, 8), (4, 2, 16), (4, 4, 8), (4, 4, 16)])
def test_tick_tables_equal_jax(p, v, m):
    """Every ``SubSlot`` of every row of both schedules, the stash
    capacity, the bubble accounting and ``check_table`` equal JAX's
    over JAX's own ``(p, v, m)`` matrix (``tests/test_pp_schedule.py``)."""
    for sched in ("gpipe", "1f1b"):
        t, j = (mod.schedule_table(sched, p, v, m) for mod in (tpps, jpps))
        for field in ("schedule", "n_stages", "virtual", "microbatches",
                      "ticks", "stash_cap", "total_units"):
            assert getattr(t, field) == getattr(j, field), (sched, field)
        for rows in ("fwd", "bwd"):
            tr, jr = getattr(t, rows), getattr(j, rows)
            assert [None if r is None else [tuple(vars(e).values())
                                            for e in r] for r in tr] == \
                [None if r is None else [tuple(vars(e).values())
                                         for e in r] for r in jr]
        assert tpps.bubble_fraction(t) == jpps.bubble_fraction(j)
        assert tpps.tick_counts(t) == jpps.tick_counts(j)
        tpps.check_table(t)
    assert tpps.stash_cap(p, v, m) == jpps.stash_cap(p, v, m)
    for ts in range(v * m):
        assert tpps.fwd_unit(ts, p, v) == jpps.fwd_unit(ts, p, v)
        assert tpps.bwd_unit(ts, p, v) == jpps.bwd_unit(ts, p, v)


@pytest.mark.parametrize("stages,virtual", [(2, 1), (2, 2), (4, 1)])
def test_stack_unstack_bitwise_jax(stages, virtual):
    """``pipeline_stack_params`` / ``pipeline_unstack_params`` (torch)
    and ``convert.stack_numpy`` / ``unstack_numpy`` equal JAX's at the
    same ``(stages, virtual)``, bit for bit; the stacked shapes are
    ``pipeline_param_shapes``."""
    kw = dict(input_size=64, seq_len=16, d_model=8, n_heads=2,
              num_blocks=4, d_ff=12, num_experts=2)
    jspec, tspec = jtfm.TransformerSpec(**kw), ttfm.TransformerSpec(**kw)
    rng = np.random.RandomState(5)
    flat = {k: rng.standard_normal(shape).astype(np.float32)
            for k, shape in jtfm.param_shapes(jspec).items()}
    jst = {k: np.asarray(a) for k, a in jtfm.pipeline_stack_params(
        jspec, flat, stages, virtual).items()}
    tst = ttfm.pipeline_stack_params(
        tspec, {k: torch.from_numpy(a.copy()) for k, a in flat.items()},
        stages, virtual)
    nst = convert.stack_numpy(flat, tspec, stages, virtual)
    assert sorted(tst) == sorted(jst) == sorted(nst)
    for k in jst:
        np.testing.assert_array_equal(tst[k].numpy(), jst[k], err_msg=k)
        np.testing.assert_array_equal(nst[k], jst[k], err_msg=k)
        assert tuple(tst[k].shape) == ttfm.pipeline_param_shapes(tspec)[k]
    back = ttfm.pipeline_unstack_params(tspec, tst, stages, virtual)
    jback = jtfm.pipeline_unstack_params(jspec, jst, stages, virtual)
    nback = convert.unstack_numpy(jst, tspec, stages, virtual)
    for k in flat:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))
        np.testing.assert_array_equal(nback[k], flat[k])
    port = convert.pipeline_params_from_numpy(jst, tspec, device="cpu")
    assert sorted(port) == sorted(jst)


# ---- the hop ----


def test_stage_hop_routes_agree(pp):
    """At pp 4 each route hands the live pairs' tensors over and nothing
    else: stage 0 to 1 alone, every stage to the next (3 wraps to 0),
    stage 3 back to 2; the zero-split route equals ``batch_isend_irecv``
    and both tally only the payloads (24 B a tensor)."""
    h = pp["hop"]
    for how in ("p2p", "a2a"):
        for r in range(WORLD):
            a, b, c = (h[r][f"{how}/{k}"] for k in "abc")
            if r == 1:
                np.testing.assert_array_equal(a, np.full((3, 2), 1.0))
            else:
                assert np.isnan(a).all()
            np.testing.assert_array_equal(
                b, np.full((3, 2), 10.0 * ((r - 1) % WORLD + 1)))
            if r == 2:
                np.testing.assert_array_equal(c, np.full((3, 2), 400.0))
            else:
                assert np.isnan(c).all()
            fwd = 24 * ((r == 0) + 1)
            assert int(h[r][f"{how}/fwd"]) == fwd
            assert int(h[r][f"{how}/bwd"]) == 24 * (r == 3)


# ---- one step ----


@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_equals_jax_stage_mesh(pp, name):
    """One step on four ranks against JAX's ``build_train_step`` on
    ``build_stage_mesh``: the cost, every leaf's gradient and param
    norms (a ``blk_*`` leaf's summed over the stage group, beside the
    model and expert sums), and the new params and slots gathered into
    JAX's global stacked layout (ZeRO-1's ``[pp, dp, chunk]``)."""
    got, want = pp["steps"][name], pp["jax_steps"][name]
    cost, gnorm, pnorm = float(want["cost"]), want["grad"], want["param"]
    leaves = {k: v for k, v in want.items() if k.startswith(".")}
    np.testing.assert_allclose(float(got["cost"]), cost, rtol=1e-5)
    np.testing.assert_allclose(got["grad"], gnorm, rtol=STEP_RTOL,
                               atol=STEP_RTOL * float(gnorm.max()))
    np.testing.assert_allclose(got["param"], pnorm, rtol=STEP_RTOL)
    mine = {k: v for k, v in got.items() if k.startswith(".")}
    if STEPS[name].get("zero_opt"):
        # JAX's [pp, dp, chunk] slots of a stacked leaf, [dp, chunk] of
        # a replicated one
        slot = [k for k in leaves if k.startswith(".opt_state")]
        assert slot and all(
            leaves[k].shape[:-1] == ((2, 2) if "blk_" in k else (2,))
            for k in slot), {k: leaves[k].shape for k in slot}
    _close_leaves(mine, leaves, STEP_RTOL, name)


def test_zero_split_hop_step_is_bitwise_p2p(pp):
    """Step (a) with every hop on the zero-split ``all_to_all_single``
    (gloo's route on the card) is bitwise the same step on
    ``batch_isend_irecv``."""
    a, b = pp["steps"]["a_gpipe_zero"], pp["steps"]["a_gpipe_zero_a2a"]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---- the runs and the checkpoints ----


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_equals_jax_stage_mesh(pp, name):
    """Each run on four ranks against JAX's run of the same flags: the
    host path, the devices, the steps, every rank's printed costs, the
    chief's test accuracy, and the final params and slots of the chief's
    checkpoint (JAX's global stacked layout) within the run bound."""
    j, chief = pp["jax"][name], pp["port"][name, 0]
    t_res, j_res = chief["result"], j["result"]
    assert t_res["fast_loop"] is j_res["fast_loop"] is False
    for k in ("steps", "global_batch", "devices", "examples_seen"):
        assert t_res[k] == j_res[k], k
    jc, tc = costs(j["stdout"]), costs(chief["stdout"])
    assert len(tc) == len(jc) >= 4
    assert np.allclose(tc, jc, rtol=0, atol=1e-4), (tc, jc)
    for r in range(1, WORLD):
        assert costs(pp["port"][name, r]["stdout"]) == tc[:-1]
    assert abs(t_res["test_accuracy"] - j_res["test_accuracy"]) <= 1e-6
    _close_leaves(_state_leaves(pp["tmp"] / f"torch_{name}"),
                  _state_leaves(pp["tmp"] / f"jax_{name}"), RUN_RTOL, name)


def test_lm_samples_equal_jax(pp):
    """``--sample_after 2`` greedy after the 1F1B lm run: the blocks
    gathered over the stage group and unstacked, the chief's samples
    equal JAX's."""
    t = npz(pp["tmp"] / "torch_logs_lm_1f1b" / "samples.npz")
    j = npz(pp["tmp"] / "jax_logs_lm_1f1b" / "samples.npz")
    assert t["samples"].shape == j["samples"].shape == (2, 16)
    np.testing.assert_array_equal(t["samples"], j["samples"])


def test_checkpoint_crosses_packages_at_v2(pp):
    """The interleaved run's checkpoint (``blk_*`` stacked ``[4, ...]``
    in the v 2 order, the ``pp_stages`` / ``pp_virtual`` extras): the
    port's resumed by JAX and JAX's by the port, a second epoch each,
    print the same costs and end at the same params and slots."""
    j_out = pp["jax"]["resumed"]["stdout"]
    t_out = pp["port"]["resumed", 0]["stdout"]
    assert "Resumed from" in t_out and "Resumed from" in j_out
    tc, jc = costs(t_out), costs(j_out)
    assert len(tc) == len(jc) >= 4
    assert np.allclose(tc, jc, rtol=0, atol=1e-4), (tc, jc)
    ckpt = npz(latest_npz(pp["tmp"] / "torch_interleaved"))
    assert ckpt[".params/blk_Wqkv"].shape[0] == 4
    assert int(ckpt["__x_pp_stages__"]) == 2
    assert int(ckpt["__x_pp_virtual__"]) == 2
    t = _state_leaves(pp["tmp"] / "t_from_j")
    j = _state_leaves(pp["tmp"] / "j_from_t")
    assert int(npz(latest_npz(pp["tmp"] / "t_from_j"))[".step"]) == 8
    _close_leaves(t, j, RUN_RTOL, "resumed")


def test_layout_mismatch_refused_with_jax_message(pp):
    """Resuming the v 2 checkpoint at ``--virtual_stages 1`` is refused
    on every rank with JAX's message (its ``run`` raises the same on the
    same directory)."""
    want = pp["jax"]["mismatch"]["error"]
    assert want and "(stages=2, virtual=2)" in want
    for r in range(WORLD):
        assert pp["port"]["mismatch", r]["error"] == want


# ---- dropout and remat, the port against itself ----


def test_dropout_masks_follow_the_microbatch_and_the_schedules_agree(pp):
    """Under ``--dropout_rate`` gpipe and 1F1B draw the same masks (the
    microbatch's seed, the stacked position's salt) and end within 1e-6
    of each leaf's scale with equal printed costs; the microbatches'
    masks differ (stage 0's embedding masks of one step); ``--remat``
    recomputes the same masks and ends at gpipe's params."""
    g, f = pp["masks"]["drop_gpipe"], pp["masks"]["drop_1f1b"]
    for r in range(WORLD):
        assert sorted(g[r]) == sorted(f[r])
        for k in g[r]:
            np.testing.assert_array_equal(g[r][k], f[r][k], err_msg=k)
    emb = sorted(k for k in g[0] if k.startswith(f"{0x9999}:"))
    assert len(emb) >= 2
    assert not np.array_equal(g[0][emb[0]], g[0][emb[1]])
    gc = costs(pp["port"]["drop_gpipe", 0]["stdout"])
    assert len(gc) >= 4 and np.all(np.isfinite(gc))
    for name in ("drop_1f1b", "drop_remat"):
        assert costs(pp["port"][name, 0]["stdout"]) == gc, name
        _close_leaves(_state_leaves(pp["tmp"] / name),
                      _state_leaves(pp["tmp"] / "drop_gpipe"), 1e-6, name)


# ---- the mesh, the validation and the CLI ----


@pytest.mark.parametrize("dp,pp_,mp,sp,ep", [
    (2, 2, 1, 1, 1), (1, 2, 2, 1, 1), (1, 2, 1, 2, 1), (1, 2, 1, 1, 2),
    (1, 4, 1, 1, 1), (2, 2, 2, 1, 1)])
def test_rank_plays_jax_stage_mesh_position(dp, pp_, mp, sp, ep):
    """Rank r sits where JAX's ``build_stage_mesh`` puts device r, and
    its ``StageAxis`` names the ranks of its (data, seq | expert, model)
    index in stage order."""
    n = dp * pp_ * mp * sp * ep
    devices = jax.devices()[:n]
    jm = jmesh.build_stage_mesh(dp, pp_, devices=devices, model_parallel=mp,
                                sequence_parallel=sp, expert_parallel=ep)
    for r in range(n):
        tm = tmesh.build_stage_mesh(dp, pp_, world=n, rank=r,
                                    model_parallel=mp, sequence_parallel=sp,
                                    expert_parallel=ep)
        pos = dict(zip(jm.axis_names,
                       np.argwhere(jm.devices == devices[r])[0]))
        assert tm.data_index == pos["data"]
        assert tm.stage_index == pos["stage"]
        assert tm.seq_index == pos.get("seq", 0)
        assert tm.expert_index == pos.get("expert", 0)
        assert tm.model_index == pos.get("model", 0)
        assert tm.devices == n
        ax = tmesh.stage_axis(tm)
        assert ax.index == tm.stage_index
        for s, rank in enumerate(ax.ranks):
            other = tmesh.build_stage_mesh(
                dp, pp_, world=n, rank=rank, model_parallel=mp,
                sequence_parallel=sp, expert_parallel=ep)
            assert other.stage_index == s
            assert (other.data_index, other.seq_index, other.expert_index,
                    other.model_index) == (tm.data_index, tm.seq_index,
                                           tm.expert_index, tm.model_index)


@pytest.mark.parametrize("dp,pp_,sp,ep,n", [
    (1, 2, 2, 2, 8), (4, 2, 1, 1, 4), (0, 2, 1, 1, 4), (1, 2, 4, 1, 4)])
def test_build_stage_mesh_messages_equal_jax(dp, pp_, sp, ep, n):
    """The seq and expert axes together, a degree below 1 or a mesh
    larger than the world raise JAX's message; one that leaves ranks off
    the port's own."""
    with pytest.raises(ValueError) as j:
        jmesh.build_stage_mesh(dp, pp_, devices=jax.devices()[:n],
                               sequence_parallel=sp, expert_parallel=ep)
    with pytest.raises(ValueError) as t:
        tmesh.build_stage_mesh(dp, pp_, world=n, sequence_parallel=sp,
                               expert_parallel=ep)
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError, match="leaves 4 of 8 ranks off"):
        tmesh.build_stage_mesh(1, 4, world=8)


# JAX's tests/test_cli.py matrix: the valid sets, then each refusal
VALID = [
    {}, dict(model="transformer", pipeline_parallel=2, num_blocks=4,
             microbatches=4),
    dict(model="transformer", pipeline_parallel=2, num_blocks=4,
         microbatches=4, virtual_stages=2),
    dict(model="transformer", pipeline_parallel=2, num_blocks=4,
         microbatches=4, pp_schedule="1f1b"),
    dict(model="transformer", pipeline_parallel=2, num_blocks=4,
         microbatches=4, pp_schedule="1f1b", virtual_stages=2),
    dict(model="transformer", pipeline_parallel=2, num_blocks=8,
         microbatches=8, pp_schedule="1f1b", virtual_stages=4,
         model_parallel=2)]
REFUSED = [
    dict(pipeline_parallel=0), dict(pipeline_parallel=2),
    dict(model="transformer", pipeline_parallel=3, num_blocks=2),
    dict(model="transformer", pipeline_parallel=2, num_blocks=2,
         microbatches=0),
    dict(model="transformer", pipeline_parallel=2, num_blocks=2, fsdp=True),
    dict(model="transformer", pipeline_parallel=2, num_blocks=2,
         sync_period=5),
    dict(model="transformer", pipeline_parallel=2, num_blocks=2,
         sequence_parallel=2, expert_parallel=2, num_experts=4),
    dict(pp_schedule="zb-h1"), dict(model="transformer", pp_schedule="1f1b"),
    dict(model="transformer", pipeline_parallel=2, num_blocks=2,
         sequence_parallel=2, pp_schedule="1f1b"),
    dict(model="transformer", pipeline_parallel=2, num_blocks=2,
         num_experts=4, moe_aux_weight=0.01, pp_schedule="1f1b"),
    dict(model="transformer", pipeline_parallel=2, num_blocks=2,
         grad_accum=2, pp_schedule="1f1b"),
    dict(model="transformer", pipeline_parallel=2, num_blocks=2, remat=True,
         pp_schedule="1f1b"),
    dict(virtual_stages=0), dict(model="transformer", virtual_stages=2),
    dict(model="transformer", pipeline_parallel=2, num_blocks=2,
         virtual_stages=2),
    dict(model="transformer", pipeline_parallel=2, num_blocks=4,
         virtual_stages=2, microbatches=3),
    dict(model="transformer", pipeline_parallel=2, num_blocks=4,
         virtual_stages=2, microbatches=3, pp_schedule="1f1b")]


@pytest.mark.parametrize("kw", VALID + REFUSED)
def test_validate_pipeline_config_equals_jax(kw):
    """JAX's ``tests/test_cli.py`` matrix: the same flag sets pass, and
    the same ones raise the same message."""
    try:
        jconfig.validate_pipeline_config(jconfig.Config(**kw))
        want = None
    except ValueError as e:
        want = str(e)
    try:
        tconfig.validate_pipeline_config(tconfig.Config(**kw))
        got = None
    except ValueError as e:
        got = str(e)
    assert got == want
    assert (want is None) == (kw in VALID)


@pytest.mark.parametrize("argv,want", [
    (["--pipeline_parallel=3"],
     "num_blocks=2 must divide evenly over pipeline_parallel=3"),
    (["--pipeline_parallel=2", "--pp_schedule=1f1b", "--remat"],
     "--remat has no effect under --pp_schedule=1f1b"),
    (["--pipeline_parallel=2", "--num_blocks=4", "--virtual_stages=2",
      "--microbatches=3"], "divisible by pipeline_parallel (2)"),
    (["--pipeline_parallel=2", "--sites=2"],
     "--sites composes with within-site data parallelism only"),
    (["--pipeline_parallel=2", "--sequence_parallel=2"],
     "mesh 1x2x2 over ('data', 'stage', 'seq') needs 4 devices, have 1")])
def test_cli_exits_2_with_jax_message(argv, want, capsys):
    """The trainer parses the three flags with JAX's defaults and exits 2
    with JAX's message on a refused combination or layout."""
    d = tconfig.parse_train_config([])
    jd = jconfig.Config()
    assert (d.pipeline_parallel, d.virtual_stages, d.pp_schedule) == (
        jd.pipeline_parallel, jd.virtual_stages, jd.pp_schedule)
    rc = tmain.main(["--device", "cpu", "--model=transformer",
                     "--training_epochs=0"] + argv)
    assert rc == 2
    assert want in capsys.readouterr().err


def test_device_resident_epoch_refuses_a_stage_axis():
    """The fast path's runner takes no stage axis (JAX's gate sends
    pipeline parallelism to the host path)."""
    from distributed_tensorflow_example_tpu_torch.config import Unported
    from distributed_tensorflow_example_tpu_torch.parallel import epoch
    from distributed_tensorflow_example_tpu_torch.train import loop as tloop

    cfg = tconfig.Config(**dict(TFM_KW, **PP2), device="cpu")
    spec = tloop.make_spec(cfg)
    mesh = tmesh.build_stage_mesh(1, 2, world=2, rank=0)
    with pytest.raises(Unported, match="no stage axis"):
        epoch._Runner(cfg, spec, None, 1, 1, mesh=mesh)

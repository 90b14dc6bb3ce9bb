"""Data parallelism in the port against the JAX package's one-process
data-parallel mesh, on the CPU.

Two gloo ranks of the port (subprocesses, ``OMP_NUM_THREADS=1``, one
launch) against the JAX ``run`` at ``--data_parallel=2`` on two of the
eight CPU devices: rank r plays device r, so both sides train on the
same rows from the same initial params (the JAX init, carried across
with ``convert.mlp_params_from_numpy``) on the same synthetic data.

- the default fast path (the device-resident epoch: rank r's contiguous
  shard, its permutation folded from r) and the host path
  (``--no_fast_loop``: rank r's rows of JAX's global batch);
  ``--no_shard_data`` takes the host path and trains as it does;
- local SGD, the async analog (``--sync_period=3``), on both paths;
- in the ranks' own script: local SGD with K=1 equals the synchronous
  step (SGD), and at K=3 the replicas differ between syncs and are equal
  at each boundary;
- ``--compilation_cache=auto`` prints its NOTE and trains;
  ``chip_smoke.py`` phase 5d rehearsed in a one-rank gloo group;
- a top-2 MoE transformer (dense dispatch) under ``--moe_aux_weight``:
  the balance loss's f and P are means over the data axis before they
  combine, as JAX's ``pmean`` over ``aux_axes`` makes them, so the
  costs and the final params equal JAX's dp=2 run;
- ``--sample_after`` through ``generate_dp``: a tiny lm at dp 2, 3
  greedy prompts (each rank decodes the 2 rows of its data index), its
  ``samples.npz`` bitwise JAX's dp=2 run's; at a temperature, each
  rank's generator seeded from the seed folded with its data index;
- ``--debug_nans`` on the blow-up under ``--fsdp``, ``--sync_period=3``
  and ``--sites=2``: both ranks raise at JAX's step (JAX's runs each in
  a process of its own), FSDP's blame the synchronous step's;
- a CPU profiler over a site round and a pipeline run: the
  ``outer_sync``, ``quant`` and ``pp_comm`` scopes; and, in this
  process, ``generate_dp``'s padding and count, its dp-1 form and its
  ``model_axis`` form against ``generate_sharded``.

Tolerances (f32; the sums run in other orders): printed costs as parsed
numbers within 1e-4 (one unit in their last printed place), test
accuracies equal, final params within 1e-5 of their scale (local SGD's
consensus, the mean of the replicas, on both sides).  The rank script
and ``launch_ranks`` also serve ``tests/test_torch_sharded_state.py``.
"""

import contextlib
import io
import json
import math
import os
import re
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.data import mnist as jmnist
from distributed_tensorflow_example_tpu.train import loop as jloop
from distributed_tensorflow_example_tpu.train import optim as joptim
from distributed_tensorflow_example_tpu.train import state as jstate
from distributed_tensorflow_example_tpu_torch import main as tmain
from distributed_tensorflow_example_tpu_torch.train import loop as tloop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the ranks' program: join a gloo group, then run each job of the plan
# (train/loop.run with the dataset and the initial params the plan
# names, or the step checks), writing what pytest compares
RANK_SCRIPT = r'''
import contextlib, io, json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, port, plan_path = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.data import mnist as tmnist
from distributed_tensorflow_example_tpu_torch.models import transformer
from distributed_tensorflow_example_tpu_torch.obs.buckets import NAMED_SCOPES
from distributed_tensorflow_example_tpu_torch.train import loop as tloop
from distributed_tensorflow_example_tpu_torch.train import state as tstate

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


def run_job(job):
    kw = dict(job["cfg"])
    if "hidden_sizes" in kw:
        kw["hidden_sizes"] = tuple(kw["hidden_sizes"])
    cfg = tconfig.Config(**kw, device="cpu")
    data = tmnist.synthesize_dataset(seed=0, **job["sizes"])
    tloop.load_datasets = lambda *a, **k: data
    tloop.create_train_state = port_init(job["init"])
    # each decode this rank runs: its rows and its generator's seed
    decodes, real_generate = [], transformer.generate

    def generate(spec, params, prompt, generator=None, **kw):
        decodes.append({"rows": int(prompt.shape[0]), "seed": (
            None if generator is None else generator.initial_seed())})
        return real_generate(spec, params, prompt, generator=generator,
                             **kw)

    transformer.generate = generate
    # the named scopes a CPU profiler saw over the whole run
    prof = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
        if job.get("scopes") else contextlib.nullcontext())
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf), prof:
            res = tloop.run(cfg)
        err = None
    except Exception as e:
        res, err = None, f"{type(e).__name__}: {e}"
    finally:
        transformer.generate = real_generate
    scopes = (sorted({e.name for e in prof.events()} & set(NAMED_SCOPES))
              if job.get("scopes") else None)
    with open(os.path.join(out_dir, f"{job['name']}.{rank}.json"), "w") as f:
        json.dump({"stdout": buf.getvalue(), "result": res, "error": err,
                   "decodes": decodes, "scopes": scopes}, f, default=str)


def step_checks(job):
    """K=1 local SGD vs the sync step, and the K=3 replicas step by step,
    from the plan's params on this rank's rows of seeded batches."""
    from distributed_tensorflow_example_tpu_torch.parallel import step
    from distributed_tensorflow_example_tpu_torch.train import optim

    cfg = tconfig.Config(**dict(job["cfg"], hidden_sizes=tuple(
        job["cfg"]["hidden_sizes"])), device="cpu")
    spec = tloop.make_spec(cfg)
    opt = optim.make_optimizer(cfg)
    init = port_init(job["init"])
    rng = np.random.RandomState(7)
    b = cfg.batch_size // world
    batches = []
    for _ in range(6):
        x = rng.rand(cfg.batch_size, cfg.input_size).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.randint(0, 10,
                                                     cfg.batch_size)]
        batches.append((torch.from_numpy(x[rank * b:(rank + 1) * b]),
                        torch.from_numpy(y[rank * b:(rank + 1) * b])))
    out = {}
    sync_body = step.make_sync_step_body(cfg, spec, opt)
    local_body = step.make_local_step_body(cfg, spec, opt)
    s_sync = init(spec, opt)
    s_local = init(spec, opt)
    for x, y in batches[:2]:
        s_sync, _c, _a = sync_body(s_sync, x, y)
        s_local, _c, _a = local_body(s_local, x, y)
        s_local = step.param_sync(s_local)
    for k in s_sync.params:
        out[f"k1_sync/{k}"] = s_sync.params[k].numpy()
        out[f"k1_local/{k}"] = s_local.params[k].numpy()
    state = init(spec, opt)
    for i, (x, y) in enumerate(batches):
        state, _c, _a = local_body(state, x, y)
        if (i + 1) % 3 == 0:
            state = step.param_sync(state)
        out[f"k3/{i + 1}"] = state.params["W1"].numpy().copy()
    np.savez(os.path.join(out_dir, f"steps.{rank}.npz"), **out)


for job in plan["jobs"]:
    (step_checks if job.get("steps") else run_job)(job)
dist.destroy_process_group()
'''


# one JAX --debug_nans run in a process of its own (JAX sets
# jax_debug_nans for the process, and a second such run in the same
# process dies in JAX's re-trace): its stdout and the error it raised
JAX_NANS_SCRIPT = r'''
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

job = json.loads(sys.argv[1])
data = jmnist.synthesize_dataset(seed=0, **job["sizes"])
jloop.load_datasets = lambda *a, **k: data
buf = io.StringIO()
try:
    with contextlib.redirect_stdout(buf):
        jloop.run(jconfig.Config(**job["cfg"]))
    err = None
except FloatingPointError as e:
    err = f"FloatingPointError: {e}"
with open(job["out"], "w") as f:
    json.dump({"stdout": buf.getvalue(), "error": err}, f)
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(argvs, tmp, name: str) -> tuple:
    """One subprocess a rank (``argvs[r]``, run by this Python from the
    repo, one intra-op thread), its output in ``tmp/name<r>.log``:
    ``(procs, log paths)``."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    logs = [os.path.join(str(tmp), f"{name}{r}.log")
            for r in range(len(argvs))]
    procs = []
    for argv, path in zip(argvs, logs):
        with open(path, "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable] + argv, cwd=REPO, env=env, stdout=log,
                stderr=subprocess.STDOUT))
    return procs, logs


def wait_ranks(procs, logs, timeout: float) -> None:
    """Wait for every rank: the first to exit non-zero fails the test at
    once with its log (its peers, left in a collective, are killed, not
    waited for), as does a rank still running ``timeout`` seconds on."""
    def tail(path):
        with open(path) as f:
            return f.read()[-3000:]

    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            for p, path in zip(procs, logs):
                assert p.poll() in (None, 0), tail(path)
            assert time.monotonic() < deadline, (
                f"ranks still running after {timeout} s: "
                + tail(logs[0]))
            time.sleep(0.05)
        for p, path in zip(procs, logs):
            assert p.returncode == 0, tail(path)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def launch_ranks(plan: dict, tmp, world: int = 2, timeout: float = 120):
    """Run ``plan`` (``{"out": dir, "jobs": [...]}``) in ``world`` gloo
    ranks at once; returns ``{(job, rank): its json}`` for the run jobs."""
    os.makedirs(plan["out"], exist_ok=True)
    plan_path = os.path.join(str(tmp), "plan.json")
    script = os.path.join(str(tmp), "rank.py")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    with open(script, "w") as f:
        f.write(RANK_SCRIPT)
    port = free_port()
    procs, logs = start_ranks(
        [[script, str(r), str(world), str(port), plan_path]
         for r in range(world)], tmp, "rank")
    wait_ranks(procs, logs, timeout)
    out = {}
    for job in plan["jobs"]:
        if job.get("steps"):
            continue
        for r in range(world):
            with open(os.path.join(plan["out"],
                                   f"{job['name']}.{r}.json")) as f:
                out[job["name"], r] = json.load(f)
    return out


def save_init(jcfg, path) -> None:
    """The JAX package's seeded initial params of ``jcfg``'s model, for
    both sides."""
    jspec = jloop.make_spec(jcfg)
    params = jstate.create_train_state(
        jax.random.PRNGKey(jcfg.seed), jspec,
        joptim.make_optimizer(jcfg)).params
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def run_jax(jcfg, sizes: dict, monkeypatch_init=None):
    """The JAX ``run`` on ``sizes``' synthetic data: (stdout, result)."""
    data = jmnist.synthesize_dataset(seed=0, **sizes)
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "load_datasets", lambda *a, **k: data)
        with contextlib.redirect_stdout(buf):
            res = jloop.run(jcfg)
    return buf.getvalue(), res


def costs(out: str) -> list:
    return [float(c) for c in re.findall(r"Cost: (\d+\.\d{4})", out)]


def steps_printed(out: str) -> list:
    return [int(s) for s in re.findall(r"^Step: (\d+),", out, flags=re.M)]


def close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max |diff| {err} > {rtol} x {scale}"


def npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def latest_npz(ckpt_dir) -> str:
    names = sorted(n for n in os.listdir(ckpt_dir) if n.endswith(".npz"))
    return os.path.join(ckpt_dir, names[-1])


SIZES = dict(train_size=400, test_size=100, input_size=784)
MLP_KW = dict(dataset="synthetic", batch_size=40, hidden_sizes=(16,),
              learning_rate=0.1, optimizer="momentum", frequency=4,
              summaries=False, training_epochs=1, seed=5)
# name: the flags both sides take beyond MLP_KW
CASES = {
    "fast": {},
    "host": dict(fast_loop=False),
    "local_fast": dict(sync_period=3),
    "local_host": dict(sync_period=3, fast_loop=False),
}
# a small top-2 MoE transformer whose balance loss weighs in the
# gradients (4 steps, a cost printed each)
MOE_AUX_KW = dict(model="transformer", input_size=64, seq_len=16,
                  d_model=16, n_heads=2, num_blocks=1, d_ff=32,
                  num_experts=4, moe_dispatch="dense", moe_topk=2,
                  moe_aux_weight=0.01, dataset="synthetic", batch_size=16,
                  learning_rate=0.1, optimizer="momentum", frequency=1,
                  eval_batch_size=16, summaries=False, training_epochs=1,
                  seed=3)
MOE_AUX_SIZES = dict(train_size=64, test_size=16, input_size=64)
# a tiny lm sampled after 2 steps: 3 prompts (odd, so one pad row at dp
# 2), greedy and at a temperature
LM_KW = dict(model="transformer", objective="lm", input_size=16,
             seq_len=16, vocab_size=32, d_model=16, n_heads=2, num_blocks=1,
             d_ff=32, dataset="synthetic", batch_size=8, learning_rate=0.1,
             optimizer="momentum", frequency=1, eval_batch_size=8,
             summaries=False, training_epochs=1, seed=3, sample_after=3,
             sample_temperature=0.0)
LM_SIZES = dict(train_size=16, test_size=4, input_size=16)
# --debug_nans on the blow-up (the MLP at learning rate 1e30) under each
# strategy that took no non-finite flag before; "nans_sync" is the
# synchronous step's, whose blame FSDP's must equal
NANS_KW = dict(MLP_KW, learning_rate=1e30, naive_ce=True, frequency=1,
               optimizer="sgd", fast_loop=False, debug_nans=True)
NANS = {"nans_sync": {}, "nans_fsdp": dict(fsdp=True),
        "nans_local": dict(sync_period=3), "nans_sites": dict(sites=2)}


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Every case once in the two port ranks (and ``--no_shard_data``,
    and the step checks), and in JAX at ``--data_parallel=2``."""
    tmp = tmp_path_factory.mktemp("dp")
    init = str(tmp / "init.npz")
    save_init(jconfig.Config(**MLP_KW), init)
    jobs = []
    for name, extra in dict(CASES, no_shard=dict(shard_data=False)).items():
        jobs.append(dict(name=name, init=init, sizes=SIZES, cfg=dict(
            MLP_KW, **extra, checkpoint_dir=str(tmp / f"torch_{name}"))))
    jobs.append(dict(steps=True, init=init, cfg=dict(
        MLP_KW, optimizer="sgd", learning_rate=0.05)))
    moe_init = str(tmp / "init_moe.npz")
    save_init(jconfig.Config(**MOE_AUX_KW), moe_init)
    jobs.append(dict(name="moe_aux", init=moe_init, sizes=MOE_AUX_SIZES,
                     cfg=dict(MOE_AUX_KW,
                              checkpoint_dir=str(tmp / "torch_moe_aux"))))
    lm_init = str(tmp / "init_lm.npz")
    save_init(jconfig.Config(**LM_KW), lm_init)
    pp_init = str(tmp / "init_pp.npz")
    save_init(jconfig.Config(**dict(LM_KW, num_blocks=2)), pp_init)
    for name, extra in (("lm_greedy", {}),
                        ("lm_temp", dict(sample_temperature=0.7))):
        jobs.append(dict(name=name, init=lm_init, sizes=LM_SIZES, cfg=dict(
            LM_KW, **extra, logs_path=str(tmp / f"torch_logs_{name}"))))
    for name, extra in NANS.items():
        jobs.append(dict(name=name, init=init, sizes=SIZES,
                         cfg=dict(NANS_KW, **extra)))
    # the scopes that run only across ranks: the site round's outer sync
    # and its int8 compression, the pipeline's stage hops
    jobs.append(dict(name="scopes_sites", init=init, sizes=SIZES,
                     scopes=True, cfg=dict(MLP_KW, fast_loop=False,
                                           sites=2, outer_quant="int8")))
    jobs.append(dict(name="scopes_pp", init=pp_init, sizes=LM_SIZES,
                     scopes=True, cfg=dict(
                         LM_KW, num_blocks=2, fast_loop=False,
                         pipeline_parallel=2, microbatches=2,
                         sample_after=0)))
    # JAX's --debug_nans runs, each in its own process, beside the ranks
    nans = {}
    for name, extra in NANS.items():
        if name == "nans_sync":
            continue
        cfg = dict(NANS_KW, **extra, compilation_cache="",
                   data_parallel=1 if "sites" in extra else 2)
        job = dict(cfg=cfg, sizes=SIZES, out=str(tmp / f"jax_{name}.json"))
        nans[name] = subprocess.Popen(
            [sys.executable, "-c", JAX_NANS_SCRIPT, json.dumps(job)],
            cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        port = launch_ranks(dict(out=str(tmp / "out"), jobs=jobs), tmp)
    finally:
        for proc in nans.values():
            if proc.poll() is None and sys.exc_info()[0] is not None:
                proc.kill()
    jax_runs = {}
    for name, proc in nans.items():
        _out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err[-3000:]
        with open(tmp / f"jax_{name}.json") as f:
            got = json.load(f)
        jax_runs[name] = (got["stdout"], got["error"], None)
    for name, extra in CASES.items():
        jcfg = jconfig.Config(**MLP_KW, **extra, data_parallel=2,
                              compilation_cache="",
                              checkpoint_dir=str(tmp / f"jax_{name}"))
        jax_runs[name] = run_jax(jcfg, SIZES) + (jcfg,)
    jcfg = jconfig.Config(**MOE_AUX_KW, data_parallel=2,
                          compilation_cache="",
                          checkpoint_dir=str(tmp / "jax_moe_aux"))
    jax_runs["moe_aux"] = run_jax(jcfg, MOE_AUX_SIZES) + (jcfg,)
    jcfg = jconfig.Config(**LM_KW, data_parallel=2, compilation_cache="",
                          logs_path=str(tmp / "jax_logs_lm_greedy"))
    jax_runs["lm_greedy"] = run_jax(jcfg, LM_SIZES) + (jcfg,)
    return dict(port=port, jax=jax_runs, tmp=tmp)


def _final_params(ckpt_dir, stacked: bool) -> dict:
    z = npz(latest_npz(ckpt_dir))
    out = {k: v for k, v in z.items() if k.startswith(".params/")}
    if stacked:     # local SGD's replicas [dp, ...]: their mean
        out = {k: v.mean(axis=0, dtype=np.float32) for k, v in out.items()}
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_equal_jax_data_parallel_2(dp_runs, name):
    """Each case: both ranks print the same costs, at the same steps, as
    JAX's dp=2 run (local SGD's steps advance by dp, as JAX's), the
    chief the same test accuracy; the path taken is JAX's; the final
    params (the replicas' mean under local SGD) within 1e-5 of JAX's."""
    j_out, j_res, jcfg = dp_runs["jax"][name]
    chief = dp_runs["port"][name, 0]
    worker = dp_runs["port"][name, 1]
    assert chief["error"] is None and worker["error"] is None, \
        (chief["error"], worker["error"])
    t_res = chief["result"]
    assert t_res["fast_loop"] == j_res["fast_loop"] == (
        CASES[name].get("fast_loop", True))
    for k in ("steps", "global_batch", "devices", "examples_seen",
              "epochs_completed"):
        assert t_res[k] == j_res[k], k
    jc, tc = costs(j_out), costs(chief["stdout"])
    assert len(tc) == len(jc) >= 3
    assert np.allclose(tc, jc, rtol=0, atol=1e-4), (tc, jc)
    assert costs(worker["stdout"]) == tc[:-1]      # no Final Cost line
    assert steps_printed(chief["stdout"]) == steps_printed(j_out)
    assert t_res["test_accuracy"] == j_res["test_accuracy"]
    assert "Test-Accuracy" not in worker["stdout"]
    stacked = jcfg.sync_period > 1
    tp = _final_params(dp_runs["tmp"] / f"torch_{name}", stacked)
    jp = _final_params(jcfg.checkpoint_dir, stacked)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        close(tp[k], jp[k], 1e-5, f"{name} {k}")


def test_local_sgd_checkpoint_stacks_the_replicas(dp_runs):
    """Under --sync_period the checkpoint holds the replicas stacked
    [dp, ...] (JAX's layout, Adam's count included), both sides; after
    the last step (10, not a multiple of 3) the replicas differ."""
    for name in ("local_fast", "local_host"):
        t = npz(latest_npz(dp_runs["tmp"] / f"torch_{name}"))
        j = npz(latest_npz(dp_runs["jax"][name][2].checkpoint_dir))
        assert sorted(t) == sorted(j)
        for k in j:
            assert t[k].shape == j[k].shape, k
        w = t[".params/W1"]
        assert w.shape[0] == 2 and np.abs(w[0] - w[1]).max() > 0


def test_moe_balance_loss_is_global_over_the_data_axis(dp_runs):
    """A top-2 MoE transformer at dp 2 under ``--moe_aux_weight`` 0.01:
    the balance loss combines f and P averaged over the data axis (JAX's
    ``pmean`` over ``aux_axes``), so every printed cost (the first
    step's included) is JAX's within 1e-4 and the final params within
    1e-5 of each leaf's scale, the router's among them.  Each rank
    adding its own local ``E * sum f * P`` moves the router's leaves
    past that bound."""
    j_out, j_res, jcfg = dp_runs["jax"]["moe_aux"]
    chief = dp_runs["port"]["moe_aux", 0]
    assert chief["error"] is None and \
        dp_runs["port"]["moe_aux", 1]["error"] is None
    assert chief["result"]["fast_loop"] == j_res["fast_loop"]
    jc, tc = costs(j_out), costs(chief["stdout"])
    assert len(tc) == len(jc) == 5          # 4 steps and the final cost
    assert np.allclose(tc, jc, rtol=0, atol=1e-4), (tc, jc)
    assert chief["result"]["test_accuracy"] == j_res["test_accuracy"]
    tp = _final_params(dp_runs["tmp"] / "torch_moe_aux", False)
    jp = _final_params(jcfg.checkpoint_dir, False)
    assert sorted(tp) == sorted(jp)
    assert any(k.endswith("_Wr") for k in jp)
    for k in jp:
        close(tp[k], jp[k], 1e-5, f"moe_aux {k}")


def test_no_shard_data_takes_the_host_path_as_jax(dp_runs):
    """``--no_shard_data`` at dp=2: JAX's gate sends it to the host path,
    where its one process draws the whole global batch either way; so
    the port's ranks train exactly as their ``--no_fast_loop`` run."""
    ns, host = dp_runs["port"]["no_shard", 0], dp_runs["port"]["host", 0]
    assert ns["error"] is None
    assert ns["result"]["fast_loop"] is False
    assert costs(ns["stdout"]) == costs(host["stdout"])
    a = _final_params(dp_runs["tmp"] / "torch_no_shard", False)
    b = _final_params(dp_runs["tmp"] / "torch_host", False)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_local_sgd_k1_equals_sync_and_k3_syncs_at_boundaries(dp_runs):
    """In the ranks: local SGD averaged after every step equals the
    synchronous step (SGD, 2 steps, within 1e-6 of scale; JAX's
    ``test_psum_equiv``); at K=3 the two replicas differ after steps 1,
    2, 4, 5 and are bitwise equal after 3 and 6."""
    out = dp_runs["tmp"] / "out"
    s = [npz(out / f"steps.{r}.npz") for r in range(2)]
    for k in [k for k in s[0] if k.startswith("k1_sync/")]:
        leaf = k.split("/", 1)[1]
        for r in range(2):
            close(s[r][f"k1_local/{leaf}"], s[r][k], 1e-6, leaf)
    for i in range(1, 7):
        a, b = s[0][f"k3/{i}"], s[1][f"k3/{i}"]
        if i % 3:
            assert np.abs(a - b).max() > 0, i
        else:
            np.testing.assert_array_equal(a, b)


def test_compilation_cache_prints_the_note_and_trains(capsys):
    """``--compilation_cache=auto`` is accepted: a one-line NOTE (the
    port compiles nothing at run time) before the run, which trains."""
    rc = tmain.main(["--device", "cpu", "--compilation_cache=auto",
                     "--dataset=synthetic", "--synthetic_train_size=200",
                     "--synthetic_test_size=50", "--hidden_sizes=8",
                     "--training_epochs=1", "--no_summaries",
                     "--frequency=10"])
    out = capsys.readouterr().out
    assert rc == 0
    lines = out.strip().split("\n")
    assert lines[0].startswith("NOTE: --compilation_cache is a no-op")
    assert "build/kernels/" in lines[0]
    assert lines[1] == "Variables initialized ..." and lines[-1] == "done"


def test_chip_smoke_phase_5d_rehearsed_on_the_cpu(monkeypatch):
    """``chip_smoke.py`` phase 5d at tiny widths on the CPU (a one-rank
    gloo group in its own process, as NCCL's on the card): every
    strategy's run ends bitwise at the plain run's params on its path,
    and the FSDP step's profiler window names the all-gather, the
    reduce-scatter and the all-reduce."""
    sys.path.insert(0, REPO)
    import chip_smoke

    # the phase's process: one intra-op thread (the suite runs beside
    # other test workers)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    base = dict(chip_smoke.DP_BASE, hidden_sizes=(32, 32), batch_size=64,
                synthetic_train_size=8 * 64, synthetic_test_size=200)
    runs = chip_smoke.phase_dp("cpu", base=base, device="cpu")
    assert sorted(runs) == sorted(chip_smoke.DP_RUNS)
    for name, r in runs.items():
        assert r["bitwise"] and r["max_rel_err"] == 0, name
        assert r["steps"] == 8 and r["step_ms"] > 0, name
    assert sorted(runs["fsdp_host"]["collectives_ms"]) == sorted(
        chip_smoke.DP_COLLECTIVES)
    assert runs["zero"]["fast_loop"] is False


def test_sample_after_decodes_a_data_shard_and_equals_jax(dp_runs):
    """``--sample_after=3`` greedy at dp 2 (``generate_dp``): the three
    prompts padded with a copy of the first to four, each rank decodes
    the two rows of its data index, and the gathered ``samples.npz`` the
    chief writes equals JAX's ``--data_parallel=2`` run's, bitwise."""
    for r in range(2):
        run = dp_runs["port"]["lm_greedy", r]
        assert run["error"] is None, run["error"]
        assert run["decodes"] == [{"rows": 2, "seed": None}]
    t = npz(dp_runs["tmp"] / "torch_logs_lm_greedy" / "samples.npz")
    jcfg = dp_runs["jax"]["lm_greedy"][2]
    j = npz(os.path.join(jcfg.logs_path, "samples.npz"))
    assert sorted(t) == sorted(j) and t["samples"].shape == (3, 16)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])


def test_sample_temperature_draws_per_data_index(dp_runs):
    """At ``--sample_temperature=0.7`` each rank seeds its generator from
    the run's seed folded with its data index (so the ranks are seeded
    apart), and the gathered samples keep the prompt columns and stay in
    the vocabulary."""
    from distributed_tensorflow_example_tpu_torch.parallel import step

    seeds = []
    for r in range(2):
        run = dp_runs["port"]["lm_temp", r]
        assert run["error"] is None, run["error"]
        (decode,) = run["decodes"]
        assert decode["rows"] == 2
        seeds.append(decode["seed"])
    assert seeds == [step._fold(LM_KW["seed"], i) for i in range(2)]
    assert seeds[0] != seeds[1]
    t = npz(dp_runs["tmp"] / "torch_logs_lm_temp" / "samples.npz")
    greedy = npz(dp_runs["tmp"] / "torch_logs_lm_greedy" / "samples.npz")
    p = int(t["prompt_len"])
    assert t["samples"].shape == (3, 16)
    np.testing.assert_array_equal(t["samples"][:, :p],
                                  greedy["samples"][:, :p])
    assert 0 <= t["samples"].min() and t["samples"].max() < 32


@pytest.mark.parametrize("name", ["nans_fsdp", "nans_local", "nans_sites"])
def test_debug_nans_raises_on_every_rank_at_jax_step(dp_runs, name):
    """``--debug_nans`` on the blow-up under ``--fsdp``,
    ``--sync_period=3`` and ``--sites=2``: both ranks print JAX's steps
    and raise ``FloatingPointError`` at the step JAX's run raises at (the
    one after its last print), with one message; FSDP's blame (its
    gradient shards' counts summed) is the synchronous step's."""
    j_out, j_err, _ = dp_runs["jax"][name]
    assert j_err and j_err.startswith("FloatingPointError"), j_err
    want = len(steps_printed(j_out)) + 1
    errs = []
    for r in range(2):
        run = dp_runs["port"][name, r]
        assert steps_printed(run["stdout"]) == steps_printed(j_out)
        assert run["error"].startswith(
            f"FloatingPointError: --debug_nans: step {want} "), run["error"]
        errs.append(run["error"])
    assert errs[0] == errs[1] and "['W1']" in errs[0]
    if name == "nans_fsdp":
        assert errs[0] == dp_runs["port"]["nans_sync", 0]["error"]


def test_named_scopes_of_the_multi_rank_modes(dp_runs):
    """A CPU profiler over each rank's run sees the scopes that run only
    across ranks: ``outer_sync`` and ``quant`` in a site round under
    ``--outer_quant=int8``, ``pp_comm`` (and ``ln``) in a pipeline run."""
    for r in range(2):
        sites = dp_runs["port"]["scopes_sites", r]
        pp = dp_runs["port"]["scopes_pp", r]
        assert sites["error"] is None and pp["error"] is None
        assert {"outer_sync", "quant"} <= set(sites["scopes"])
        assert {"pp_comm", "ln"} <= set(pp["scopes"])


# ---------------------------------------------------------------------------
# generate_dp and dp_samples_host in this process (no rank launch)
# ---------------------------------------------------------------------------

# layouts of 8 ranks: (the flags, the mesh's axes)
ROUTES = {"dp": ({}, {}), "tp": (dict(model_parallel=2), dict(mp=2)),
          "pp_tp": (dict(model_parallel=2, pipeline_parallel=2),
                    dict(mp=2, pp=2)),
          "fsdp_tp": (dict(model_parallel=2, fsdp=True), dict(mp=2)),
          "ep_tp": (dict(model_parallel=2, expert_parallel=2,
                         num_experts=4), dict(mp=2, ep=2)),
          "sp_tp": (dict(model_parallel=2, sequence_parallel=2),
                    dict(mp=2, sp=2)),
          "local": (dict(sync_period=3), {}),
          "sites": (dict(sites=2), dict(sites=2))}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_sample_route_is_jax(name):
    """``--sample_after``'s route is JAX's ``train/loop.py`` condition,
    letter for letter: ``generate_sharded`` where TP is live and the run
    is neither PP, FSDP nor async (sites refuse TP), ``generate_dp``
    everywhere else."""
    from distributed_tensorflow_example_tpu.parallel import mesh as jmesh
    from distributed_tensorflow_example_tpu_torch.config import Config
    from distributed_tensorflow_example_tpu_torch.parallel import mesh

    flags, axes = ROUTES[name]
    cfg = Config(model="transformer", objective="lm", **flags)
    lay = mesh.Mesh(dp=8 // math.prod(axes.values()), rank=0, **axes)
    jcfg = jconfig.Config(model="transformer", objective="lm", **flags)
    want = bool(jmesh.tp_axis(jloop.make_spec(jcfg), jcfg.model_parallel)
                and not (jcfg.pipeline_parallel > 1 or jcfg.fsdp
                         or jcfg.sync_period > 1))
    assert tloop.tp_decode(cfg, lay) is want
    assert want is (name in ("tp", "ep_tp", "sp_tp"))


def _tiny_lm():
    from distributed_tensorflow_example_tpu_torch.models import (
        transformer as ttfm)

    spec = ttfm.TransformerSpec(input_size=12, seq_len=12, vocab_size=16,
                                d_model=16, n_heads=2, num_blocks=1,
                                d_ff=32, objective="lm", causal=True)
    params = ttfm.init(spec, seed=0, device="cpu")
    prompts = torch.randint(0, 16, (5, 3),
                            generator=torch.Generator().manual_seed(1))
    return ttfm, spec, params, prompts


def test_generate_dp_pads_with_row_0_and_counts():
    """``generate_dp`` at dp 3 over 5 prompts: padded to 6 with a copy of
    row 0, rank r decodes rows [2r, 2r + 2) of the padded batch (equal to
    ``generate`` on them), ``n`` is 5; ``dp_samples_host`` at dp 1 takes
    ``[:n]`` as int32 with no collective."""
    from distributed_tensorflow_example_tpu_torch.parallel import mesh

    ttfm, spec, params, prompts = _tiny_lm()
    padded = torch.cat([prompts, prompts[:1]])
    for r in range(3):
        got, n = ttfm.generate_dp(spec, params, prompts,
                                  mesh.build_mesh(-1, world=3, rank=r))
        assert n == 5
        assert torch.equal(got, ttfm.generate(spec, params,
                                              padded[2 * r:2 * r + 2]))
    one = mesh.build_mesh(-1)
    rows, n = ttfm.generate_dp(spec, params, prompts, one)
    host = ttfm.dp_samples_host(torch.cat([rows, rows[:1]]), n, one)
    assert host.dtype == torch.int32
    assert torch.equal(host, rows.to(torch.int32))


def test_generate_dp_equals_generate_at_dp_1():
    """At dp 1 ``generate_dp`` is ``generate`` over every prompt, greedy
    and, at a temperature, with the generator seeded ``_fold(seed, 0)``."""
    from distributed_tensorflow_example_tpu_torch.parallel import mesh, step

    ttfm, spec, params, prompts = _tiny_lm()
    one = mesh.build_mesh(-1)
    got, n = ttfm.generate_dp(spec, params, prompts, one)
    assert n == 5 and torch.equal(got, ttfm.generate(spec, params, prompts))
    got, _ = ttfm.generate_dp(spec, params, prompts, one, generator_seed=7,
                              temperature=0.8)
    gen = torch.Generator().manual_seed(step._fold(7, 0))
    assert torch.equal(got, ttfm.generate(spec, params, prompts,
                                          generator=gen, temperature=0.8))


def test_generate_dp_model_axis_is_generate_sharded():
    """With ``model_axis`` (a one-rank gloo group in this process) each
    data shard decodes tensor-parallel: at dp 1 the tokens are
    ``generate_sharded``'s over the same group."""
    from distributed_tensorflow_example_tpu_torch.parallel import mesh

    ttfm, spec, params, prompts = _tiny_lm()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        got, n = ttfm.generate_dp(spec, params, prompts,
                                  mesh.build_mesh(-1), model_axis=group)
        want = ttfm.generate_sharded(spec, params, prompts, group)
    finally:
        dist.destroy_process_group()
    assert n == 5 and torch.equal(got, want)

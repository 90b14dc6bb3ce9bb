"""Multi-site local SGD in the port against the JAX package's
``('site', 'data')`` mesh, on the CPU.

Two gloo rank subprocesses (niced, one intra-op thread), launched once
for the file.  Rank r plays device r of JAX's ``build_site_mesh(2, 1)``
(site r, data index 0) on two of the eight CPU devices, so both sides
train the same rows from the same initial params (the JAX init, carried
across with ``convert``) on the same synthetic data; the JAX runs go on
in this process meanwhile.

- pure: the outer optimizer (sgd and nesterov, mu 0 and 0.9, three
  updates), ``ef_compress_int8`` (with the telescoping identity of
  ``tests/test_quant.py``) and the delayed-scaling helpers against
  JAX's; the site mesh's positions, rows and messages; the
  ``validate_local_sgd_config`` matrix and the ``--outer_quant`` leg of
  ``validate_quant_config`` with JAX's exception types and messages;
- runs at ``--sites 2``: the MLP under ``--pallas`` (relu; JAX's kernel
  in interpret mode) at ``--inner_steps 4`` with a Nesterov outer step
  and momentum inner steps, the same under ``--outer_quant int8`` with
  Adam inner steps, and a 1-block lm transformer under ``--sample_after``
  (momentum inner steps: Adam's first update would turn the rounding
  noise of the key bias's zero gradient into full-size updates),
  each against JAX's run: every round's printed cost, the test
  accuracy, the checkpoint's ``[sites, ...]`` leaves, the outer momentum
  and the residual, the samples; the ``round`` phase spans;
- in the ranks' own script: ``--inner_steps 1`` with outer SGD at lr 1
  against ``--data_parallel 2``, ``--inner_steps 4`` the same way
  against ``--sync_period 4``, and rounds that end with both sites'
  params bitwise equal while the inner momentum stays per site;
- checkpoints: the port's resumed by JAX and JAX's by the port, each
  written back bitwise; ``--ckpt_every`` and ``--resume=auto`` continuing
  a site run exactly; a mismatched ``--sites``, outer momentum or
  ``--outer_quant`` refused with JAX's message.

Tolerances (f32; the sums run in other orders): printed costs as parsed
numbers within 1e-4 (one unit in their last printed place), test
accuracies and greedy samples equal (the lm's accuracy, a sum of
per-example fractions, within 1e-6), params and optimizer leaves after a
run within 1e-5 of their scale (JAX's bound for local SGD against its
own references, ``tests/test_multi_site.py``, is 2e-5), the pure outer
optimizer and quantizers bitwise, the equivalences within 2e-5 of scale
(JAX's ``test_h1_outer_sgd_equals_sync_dp`` bound).  Under int8 a
compressed value that lands within rounding of a half step can round to
the neighbouring int8 on the other side; the residual carries the
difference into the next round, so those leaves are held within one
quantization step of the pseudo-gradient (amax / 127) times the outer
step's ``lr * (1 + mu)``.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.ops import quant as jquant
from distributed_tensorflow_example_tpu.parallel import local_sgd as jls
from distributed_tensorflow_example_tpu.parallel import mesh as jmesh
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch.ops import quant as tquant
from distributed_tensorflow_example_tpu_torch.parallel import (
    local_sgd as tls)
from distributed_tensorflow_example_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_example_tpu_torch.utils import (
    checkpoint as tckpt)
from test_torch_data_parallel import (costs, free_port, latest_npz, npz,
                                      run_jax, save_init, start_ranks,
                                      wait_ranks)

# one intra-op thread: the suite runs six test workers (and the rank
# processes) on the machine's cores, where torch would start one a core
torch.set_num_threads(1)

# ---- pure: the outer optimizer, the quantizers, the mesh, the config ----


def _tree(seed, shapes=((3, 4), (5,))):
    rng = np.random.RandomState(seed)
    return {f"p{i}": rng.randn(*s).astype(np.float32)
            for i, s in enumerate(shapes)}


@pytest.mark.parametrize("name,mu", [("sgd", 0.0), ("sgd", 0.9),
                                     ("nesterov", 0.0), ("nesterov", 0.9)])
def test_outer_optimizer_equals_jax(name, mu):
    """Three outer updates from the same params and pseudo-gradients:
    the params and the momentum bitwise JAX's (``()`` state where mu is
    0 or pinned to 0 by sgd)."""
    j = jls.make_outer_optimizer(name, 0.7, mu)
    t = tls.make_outer_optimizer(name, 0.7, mu)
    assert (t.name, t.lr, t.momentum) == (j.name, j.lr, j.momentum)
    jp = _tree(0)
    tp = {k: torch.from_numpy(v) for k, v in jp.items()}
    js, ts = j.init(jp), t.init(tp)
    assert (js == ()) == (ts == ())
    for i in range(3):
        d = _tree(10 + i)
        jp, js = j.update(d, js, jp)
        tp, ts = t.update({k: torch.from_numpy(v) for k, v in d.items()},
                          ts, tp)
        for k in jp:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
            if js != ():
                np.testing.assert_array_equal(ts["m"][k].numpy(),
                                              np.asarray(js["m"][k]))


def test_outer_optimizer_rejects_unknown_as_jax():
    with pytest.raises(ValueError) as j:
        jls.make_outer_optimizer("adam", 0.1)
    with pytest.raises(ValueError) as t:
        tls.make_outer_optimizer("adam", 0.1)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("axis", [None, -1])
def test_ef_compress_int8_bitwise_and_telescopes(axis):
    """40 rounds of error feedback from the same inputs: every
    transmitted value and residual bitwise JAX's, and the sum of the
    inputs less the sum of the transmitted values is the final residual
    (``tests/test_quant.py``'s identity), bounded by one step."""
    rng = np.random.RandomState(1)
    jef = jnp.zeros((4, 12))
    tef = torch.zeros((4, 12))
    tot_in = np.zeros((4, 12), np.float64)
    tot_out = np.zeros((4, 12), np.float64)
    for _ in range(40):
        d = rng.randn(4, 12).astype(np.float32)
        jdq, jef = jquant.ef_compress_int8(jnp.asarray(d), jef, axis)
        tdq, tef = tquant.ef_compress_int8(torch.from_numpy(d), tef, axis)
        np.testing.assert_array_equal(tdq.numpy(), np.asarray(jdq))
        np.testing.assert_array_equal(tef.numpy(), np.asarray(jef))
        tot_in += d
        tot_out += tdq.numpy()
    np.testing.assert_allclose(tot_in - tot_out, tef.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert float(tef.abs().max()) < 0.1


def test_delayed_scaling_helpers_equal_jax():
    """The amax history (roll, newest first) and its pow2 scale bitwise
    JAX's, through amaxes either side of 448 x 2^k; length 0 refused
    with JAX's message."""
    jh, th = jquant.amax_history_init(3), tquant.amax_history_init(3)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    for mag in (1.0, 5.0, 2.0, 448.0, 448.00006, 3.0, 0.0, 0.1):
        x = np.asarray([mag, -0.5 * mag], np.float32)
        jh = jquant.amax_history_update(jh, jnp.asarray(x))
        th = tquant.amax_history_update(th, torch.from_numpy(x))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        assert float(tquant.scale_from_history(th)) == float(
            jquant.scale_from_history(jh))
    with pytest.raises(ValueError) as j:
        jquant.amax_history_init(0)
    with pytest.raises(ValueError) as t:
        tquant.amax_history_init(0)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("sites,dp", [(2, 1), (2, 2), (4, 2), (2, 4)])
def test_site_mesh_places_rank_r_at_jax_device_r(sites, dp):
    """Rank r sits where JAX's ``build_site_mesh(sites, dp)`` puts device
    r ('site' outermost: site r // dp, data index r % dp) and takes
    shard ``site x dp + data`` of the global batch, JAX's
    ``P(('site', 'data'))`` rows."""
    devices = jax.devices()[:sites * dp]
    jm = jmesh.build_site_mesh(sites, dp, devices=devices)
    assert jm.axis_names == ("site", "data")
    b = 4 * sites * dp
    for r in range(sites * dp):
        tm = tmesh.build_site_mesh(sites, dp, world=sites * dp, rank=r)
        pos = tuple(np.argwhere(jm.devices == devices[r])[0])
        assert (tm.site_index, tm.data_index) == pos
        assert tm.devices == sites * dp and tm.model_index == 0
        assert tmesh.batch_layout(tm, b) == slice(4 * r, 4 * (r + 1))


@pytest.mark.parametrize("sites,dp,n", [(0, 1, 2), (2, 2, 2), (3, 0, 4)])
def test_site_mesh_messages_equal_jax(sites, dp, n):
    """A bad degree or too few devices: JAX's messages."""
    with pytest.raises(ValueError) as j:
        jmesh.build_site_mesh(sites, dp, devices=jax.devices()[:n])
    with pytest.raises(ValueError) as t:
        tmesh.build_site_mesh(sites, dp, world=n, rank=0)
    assert str(t.value) == str(j.value)


def test_site_layout_stacks_leaves_over_sites():
    """The checkpoint layout of a site state (JAX's ``site_specs``): the
    params, the inner slots and the residual ``[sites, ...]`` with rank
    r's block at row r // dp, written by data index 0; the outer state
    and the step whole."""
    mesh = tmesh.build_site_mesh(2, 2, world=4, rank=3)
    layout = tckpt.Layout(mesh, tls.site_block)
    leaf = torch.zeros(5, 3)
    for key in (".params/W1", ".opt_state/inner/mu/W1", ".opt_state/ef/W1"):
        b = layout.block(key, leaf)
        assert layout.global_shape(b, leaf.shape) == [2, 5, 3]
        assert layout.bounds(b, leaf.shape, 3).tolist() == [
            [1, 2], [0, 5], [0, 3]]
        assert [layout.writes(b, r) for r in range(4)] == [
            True, False, True, False]
    for key in (".opt_state/outer/m/W1", ".step"):
        assert layout.block(key, leaf) is None


# the refusals of JAX's validate_local_sgd_config, with the flags that
# reach each (every case is also refused through the port's
# validate_train_config, first, with the same message)
SITE_REFUSALS = {
    "sites0": dict(sites=0),
    "inner0": dict(inner_steps=0),
    "outer_opt": dict(outer_optimizer="adam"),
    "inner_one_site": dict(inner_steps=2),
    "tp": dict(sites=2, model_parallel=2),
    "sync_period": dict(sites=2, sync_period=3),
    "fsdp": dict(sites=2, fsdp=True),
    "zero": dict(sites=2, zero_opt=True),
    "outer_lr": dict(sites=2, outer_lr=0.0),
    "momentum": dict(sites=2, outer_momentum=1.0),
    "dropout": dict(sites=2, model="transformer", dropout_rate=0.1),
    "histograms": dict(sites=2, histograms=True),
    "skip": dict(sites=2, on_anomaly="skip"),
}


@pytest.mark.parametrize("case", sorted(SITE_REFUSALS))
def test_validate_local_sgd_config_equals_jax(case):
    kw = SITE_REFUSALS[case]
    with pytest.raises(ValueError) as j:
        jconfig.validate_local_sgd_config(jconfig.Config(**kw))
    with pytest.raises(ValueError) as t:
        tconfig.validate_local_sgd_config(tconfig.Config(**kw))
    assert type(t.value) is type(j.value)
    assert str(t.value) == str(j.value)
    if case not in ("tp", "sync_period", "fsdp", "zero", "histograms",
                    "skip", "dropout"):
        # the strategy matrix refuses these combinations first, each
        # with JAX's message for it
        with pytest.raises(ValueError) as t2:
            tconfig.validate_train_config(tconfig.Config(**kw))
        assert str(t2.value) == str(j.value)


@pytest.mark.parametrize("kw", [dict(outer_quant="int4"),
                                dict(outer_quant="int8"),
                                dict(outer_quant="int8", sites=1)])
def test_outer_quant_leg_equals_jax(kw):
    """``--outer_quant``'s value check and its need of ``--sites`` > 1:
    JAX's ``validate_quant_config`` messages, in both front doors'
    validation; with ``--sites 2`` it passes."""
    with pytest.raises(ValueError) as j:
        jconfig.validate_quant_config(jconfig.Config(**kw))
    with pytest.raises(ValueError) as t:
        tconfig.validate_quant_config(tconfig.Config(**kw))
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError) as t2:
        tconfig.validate_train_config(tconfig.Config(**kw))
    assert str(t2.value) == str(j.value)
    if kw["outer_quant"] == "int8":
        ok = dict(kw, sites=2)
        jconfig.validate_quant_config(jconfig.Config(**ok))
        tconfig.validate_quant_config(tconfig.Config(**ok))
        tconfig.validate_train_config(tconfig.Config(**ok))


def test_site_flags_parse_with_jax_names_and_defaults():
    """The six flags in both of the port's parsers with JAX's defaults,
    types and choices; a JAX multi-site command line parses to JAX's
    values."""
    names = ("sites", "inner_steps", "outer_optimizer", "outer_lr",
             "outer_momentum", "outer_quant")
    jax_args = vars(jconfig.build_parser().parse_args([]))
    line = ["--sites=2", "--inner_steps=4", "--outer_optimizer=sgd",
            "--outer_lr=1.0", "--outer_momentum=0.5", "--outer_quant=int8"]
    jl = vars(jconfig.build_parser().parse_args(line))
    for cfg in (tconfig.parse_train_config([]), tconfig.parse_config([])):
        for name in names:
            assert getattr(cfg, name) == jax_args[name], name
            assert type(getattr(cfg, name)) is type(jax_args[name]), name
    for cfg in (tconfig.parse_train_config(line),
                tconfig.parse_config(line)):
        for name in names:
            assert getattr(cfg, name) == jl[name], name
    with pytest.raises(SystemExit):
        tconfig.parse_train_config(["--outer_optimizer=adam"])


# ---- the runs: two gloo ranks against JAX's ('site', 'data') mesh ----

# the ranks' program: join the gloo world, run each job of the plan
# (train/loop.run with the plan's data and initial params, or the step
# checks), write what pytest compares, leave
RANK_SCRIPT = r'''
import contextlib, datetime, io, json, os, shutil, sys, time
me, plan_path = int(sys.argv[1]), sys.argv[2]
# below the suite's other workers: their timing-bound tests keep the cores
os.nice(10)
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.data import mnist as tmnist
from distributed_tensorflow_example_tpu_torch.models import transformer
from distributed_tensorflow_example_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_example_tpu_torch.parallel import step as tstep
from distributed_tensorflow_example_tpu_torch.train import loop as tloop
from distributed_tensorflow_example_tpu_torch.train import optim as toptim
from distributed_tensorflow_example_tpu_torch.train import state as tstate

with open(plan_path) as f:
    plan = json.load(f)
out_dir = plan["out"]
dist.init_process_group(
    "gloo", init_method=f"tcp://127.0.0.1:{plan['port']}", world_size=2,
    rank=me, timeout=datetime.timedelta(seconds=60))


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


def config(kw):
    kw = dict(kw)
    if "hidden_sizes" in kw:
        kw["hidden_sizes"] = tuple(kw["hidden_sizes"])
    return tconfig.Config(**kw, device="cpu")


def run_job(job):
    cfg = config(job["cfg"])
    data = tmnist.synthesize_dataset(seed=0, **job["sizes"])
    tloop.load_datasets = lambda *a, **k: data
    tloop.create_train_state = port_init(job["init"])
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            res = tloop.run(cfg)
        err = None
    except Exception as e:
        res, err = None, f"{type(e).__name__}: {e}"
    with open(os.path.join(out_dir, f"{job['name']}.{me}.json"), "w") as f:
        json.dump({"stdout": buf.getvalue(), "result": res, "error": err},
                  f, default=str)


def strategy(cfg, mesh, init):
    spec = tloop.make_spec(cfg)
    opt = toptim.make_optimizer(cfg)
    return tloop.setup_strategy(cfg, spec, opt, init(spec, opt), mesh,
                                fast=False)


def step_checks(job):
    """The equivalences and the per-round consensus on seeded batches:
    H=1 outer SGD(lr 1) rounds vs data-parallel steps, one H=4 round vs
    four --sync_period 4 steps, and three Nesterov rounds (int8, momentum
    inner) recording each round's params and inner momentum."""
    init = port_init(job["init"])
    rng = np.random.RandomState(7)
    b = job["batch"]
    batches = []
    for _ in range(4):
        x = rng.rand(b, job["cfg"]["input_size"]).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, b)]
        batches.append((torch.from_numpy(x[me * b // 2:(me + 1) * b // 2]),
                        torch.from_numpy(y[me * b // 2:(me + 1) * b // 2])))
    site = tmesh.build_site_mesh(2)
    data = tmesh.build_mesh(-1)
    sgd1 = dict(job["cfg"], sites=2, outer_optimizer="sgd", outer_lr=1.0)
    out = {}
    # H = 1 against the synchronous step at dp 2
    s_site = strategy(config(dict(sgd1, inner_steps=1)), site, init)
    s_dp = strategy(config(job["cfg"]), data, init)
    st_site, st_dp = s_site.state, s_dp.state
    for x, y in batches[:3]:
        st_site, c_site, _a = s_site.body(st_site, x, y)
        st_dp, c_dp, _a = s_dp.body(st_dp, x, y)
    out["h1_cost"], out["dp_cost"] = c_site.numpy(), c_dp.numpy()
    for k in st_dp.params:
        out[f"h1/{k}"] = st_site.params[k].numpy()
        out[f"dp/{k}"] = st_dp.params[k].numpy()
    # H = 4 (one round over the four batches' rows) against --sync_period 4
    s_site = strategy(config(dict(sgd1, inner_steps=4)), site, init)
    s_sp = strategy(config(dict(job["cfg"], sync_period=4)), data, init)
    st_site, _c, _a = s_site.body(
        s_site.state, torch.cat([x for x, _y in batches]),
        torch.cat([y for _x, y in batches]))
    st_sp = s_sp.state
    for x, y in batches:
        st_sp, _c, _a = s_sp.body(st_sp, x, y)
    st_sp = tstep.param_sync(st_sp)
    for k in st_sp.params:
        out[f"h4/{k}"] = st_site.params[k].numpy()
        out[f"sp4/{k}"] = st_sp.params[k].numpy()
    assert int(st_site.step) == 4
    # three Nesterov rounds under int8 with momentum inner steps
    s = strategy(config(dict(job["cfg"], sites=2, inner_steps=2,
                             optimizer="momentum", outer_quant="int8")),
                 site, init)
    st = s.state
    for i in range(3):
        x = torch.cat([batches[i][0], batches[i + 1][0]])
        y = torch.cat([batches[i][1], batches[i + 1][1]])
        st, c, _a = s.body(st, x, y)
        out[f"round{i}/cost"] = c.numpy()
        for k in st.params:
            out[f"round{i}/{k}"] = st.params[k].numpy()
        out[f"round{i}/inner_m"] = st.opt_state["inner"]["m"]["W1"].numpy()
        out[f"round{i}/ef"] = st.opt_state["ef"]["W1"].numpy()
    np.savez(os.path.join(out_dir, f"steps.{me}.npz"), **out)


for job in plan["jobs"]:
    if job.get("wait_for") and me == 0:
        # a file the test process writes once the JAX side is ready
        while not os.path.exists(job["wait_for"]):
            time.sleep(0.05)
    if job.get("copy_from") and me == 0:
        shutil.copytree(*job["copy_from"])
    if job.get("copy_from") or job.get("wait_for"):
        dist.barrier()
    (step_checks if job.get("steps") else run_job)(job)
    dist.barrier()
dist.destroy_process_group()
'''


def launch(plan: dict, tmp, timeout: float = 120, meanwhile=None) -> dict:
    """Run ``plan`` (``{"out": dir, "jobs": [...]}``) in two gloo rank
    subprocesses; ``meanwhile()`` runs in this process while they do.  A
    rank that exits non-zero fails the test at once, with its log; one
    past ``timeout`` is killed.  Returns ``{(job, rank): its json}`` for
    the run jobs."""
    os.makedirs(plan["out"], exist_ok=True)
    plan = dict(plan, port=free_port())
    plan_path = os.path.join(str(tmp), "site_plan.json")
    script = os.path.join(str(tmp), "site_rank.py")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    with open(script, "w") as f:
        f.write(RANK_SCRIPT)
    ps, logs = start_ranks([[script, str(r), plan_path] for r in range(2)],
                           tmp, "site_rank")
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
    for job in plan["jobs"]:
        if job.get("steps"):
            continue
        for r in range(2):
            with open(os.path.join(plan["out"],
                                   f"{job['name']}.{r}.json")) as f:
                out[job["name"], r] = json.load(f)
    return out


RUN_RTOL = 1e-5
EQUIV_RTOL = 2e-5
SIZES = dict(train_size=256, test_size=64, input_size=64)
MLP_KW = dict(dataset="synthetic", input_size=64, batch_size=32,
              hidden_sizes=(16, 16), activation="relu", pallas=True,
              learning_rate=0.05, optimizer="momentum", frequency=2,
              summaries=False, training_epochs=1, seed=5, sites=2,
              inner_steps=4, outer_optimizer="nesterov", outer_lr=0.7,
              outer_momentum=0.9)
LM_KW = dict(model="transformer", objective="lm", input_size=16,
             vocab_size=32, d_model=16, n_heads=2, num_blocks=1, d_ff=32,
             dataset="synthetic", batch_size=16, optimizer="momentum",
             learning_rate=0.05, frequency=1, summaries=False,
             training_epochs=1, seed=3, sites=2, inner_steps=2,
             sample_after=2, sample_temperature=0.0, eval_batch_size=16)
LM_SIZES = dict(train_size=64, test_size=8, input_size=16)
# name: (flags, sizes) of the runs both sides make
RUNS = {
    "mlp": (dict(MLP_KW, training_epochs=2, trace_spans=True), SIZES),
    "int8": (dict(MLP_KW, outer_quant="int8", optimizer="adam",
                  learning_rate=0.01, metrics=True, on_anomaly="dump",
                  log_every=4), SIZES),
    "lm": (LM_KW, LM_SIZES),
}
# resumes of JAX's int8 checkpoint that must be refused, with the flags
# each changes
MISMATCH = {
    "sites": dict(sites=1, inner_steps=1, outer_quant="",
                  data_parallel=2),
    "momentum": dict(outer_optimizer="sgd"),
    "quant": dict(outer_quant=""),
}


def _jcfg(kw, tmp, name, **extra):
    return jconfig.Config(**dict(kw, **extra), compilation_cache="",
                          logs_path=str(tmp / f"jax_logs_{name}"),
                          checkpoint_dir=str(tmp / f"jax_{name}"))


@pytest.fixture(scope="module")
def site(tmp_path_factory):
    """Every port run in one launch of two ranks; JAX's runs meanwhile
    (its int8 run first: the ranks' resume jobs wait for its
    checkpoint); then JAX resumes the port's int8 checkpoint."""
    tmp = tmp_path_factory.mktemp("site")
    inits = {}
    for name, (kw, _sizes) in RUNS.items():
        inits[name] = str(tmp / f"init_{name}.npz")
        save_init(jconfig.Config(**kw), inits[name])
    ready = str(tmp / "jax_int8.ready")
    int8_kw = RUNS["int8"][0]
    jobs = [dict(name=name, init=inits[name], sizes=sizes, cfg=dict(
        kw, logs_path=str(tmp / f"torch_logs_{name}"),
        checkpoint_dir=str(tmp / f"torch_{name}")))
        for name, (kw, sizes) in RUNS.items()]
    jobs.append(dict(steps=True, init=inits["mlp"], batch=16, cfg=dict(
        MLP_KW, optimizer="sgd", sites=1, inner_steps=1)))
    # --ckpt_every snapshots over the first epoch, then --resume=auto
    # continues to the end of the second: the mlp run's costs exactly
    ck = str(tmp / "torch_ckpt_every")
    jobs.append(dict(name="ckpt_every", init=inits["mlp"], sizes=SIZES,
                     cfg=dict(MLP_KW, ckpt_every=3, checkpoint_dir=ck,
                              logs_path=str(tmp / "torch_logs_ck"))))
    jobs.append(dict(name="auto", init=inits["mlp"], sizes=SIZES,
                     cfg=dict(MLP_KW, training_epochs=2, ckpt_every=3,
                              resume="auto", checkpoint_dir=ck,
                              logs_path=str(tmp / "torch_logs_ck"))))
    # JAX's int8 checkpoint, resumed with no epoch left (written back)
    jobs.append(dict(name="resume_jax", init=inits["int8"], sizes=SIZES,
                     wait_for=ready,
                     copy_from=[str(tmp / "jax_int8"),
                                str(tmp / "torch_resume_jax")],
                     cfg=dict(int8_kw, resume="latest", checkpoint_dir=str(
                         tmp / "torch_resume_jax"))))
    for name, extra in MISMATCH.items():
        jobs.append(dict(name=f"mismatch_{name}", init=inits["int8"],
                         sizes=SIZES, cfg=dict(
                             int8_kw, **extra, resume="latest",
                             checkpoint_dir=str(tmp / "jax_int8"))))
    jax_runs, jax_refusals = {}, {}

    def jax_side():
        for name in ("int8", "mlp", "lm"):
            kw, sizes = RUNS[name]
            jcfg = _jcfg(kw, tmp, name, data_parallel=1)
            jax_runs[name] = run_jax(jcfg, sizes) + (jcfg,)
            if name == "int8":
                open(ready, "w").close()
                for mname, extra in MISMATCH.items():
                    mcfg = _jcfg(dict(kw, **extra), tmp, "int8",
                                 resume="latest", **(
                                     {} if "data_parallel" in extra
                                     else dict(data_parallel=1)))
                    with pytest.raises(ValueError) as e:
                        run_jax(mcfg, sizes)
                    jax_refusals[mname] = str(e.value)

    port = launch(dict(out=str(tmp / "out"), jobs=jobs), tmp,
                  meanwhile=jax_side)
    # the port's int8 checkpoint, resumed by JAX with no epoch left
    shutil.copytree(tmp / "torch_int8", tmp / "jax_resume_torch")
    kw, sizes = RUNS["int8"]
    run_jax(_jcfg(kw, tmp, "resume_torch", data_parallel=1,
                                resume="latest"), sizes)
    return dict(port=port, jax=jax_runs, refusals=jax_refusals, tmp=tmp)


def _leaves(path) -> dict:
    return {k: v for k, v in npz(path).items() if not k.startswith("__")}


def _held(tk, t, j, name, outer_step=0.0):
    """``t`` within RUN_RTOL of ``j``'s scale, or under int8 (``outer_step``
    = the outer lr x (1 + mu)) within that times one quantization step
    of the largest pseudo-gradient leaf."""
    t, j = np.asarray(t, np.float32), np.asarray(j, np.float32)
    assert t.shape == j.shape, (name, tk, t.shape, j.shape)
    err = float(np.abs(t - j).max())
    bound = RUN_RTOL * max(float(np.abs(j).max()), 1e-6) + outer_step
    assert err <= bound, f"{name} {tk}: max |diff| {err} > {bound}"


@pytest.mark.parametrize("name", sorted(RUNS))
def test_site_run_equals_jax_site_mesh(site, name):
    """Each run at ``--sites 2``: both ranks print JAX's per-round costs
    at its rounds, the chief JAX's test accuracy; the host path, the
    rounds and the devices are JAX's; the checkpoint has JAX's keys and
    shapes (``[sites, ...]`` params, inner slots and residual; the outer
    momentum whole), its sites bitwise equal, every leaf within the run
    bound of JAX's."""
    j_out, j_res, jcfg = site["jax"][name]
    for r in range(2):
        assert site["port"][name, r]["error"] is None, \
            site["port"][name, r]["error"]
    chief = site["port"][name, 0]
    t_res = chief["result"]
    assert t_res["fast_loop"] is False and j_res["fast_loop"] is False
    for k in ("steps", "global_batch", "devices", "examples_seen",
              "epochs_completed"):
        assert t_res[k] == j_res[k], k
    assert t_res["devices"] == 2
    jc, tc = costs(j_out), costs(chief["stdout"])
    assert len(tc) == len(jc) >= 3
    assert np.allclose(tc, jc, rtol=0, atol=1e-4), (tc, jc)
    assert costs(site["port"][name, 1]["stdout"]) == tc[:-1]
    # the lm's accuracy sums per-example fractions, in another order
    assert abs(t_res["test_accuracy"] - j_res["test_accuracy"]) <= (
        1e-6 if name == "lm" else 0.0)
    t = _leaves(latest_npz(site["tmp"] / f"torch_{name}"))
    j = _leaves(latest_npz(jcfg.checkpoint_dir))
    assert sorted(t) == sorted(j)
    kw = RUNS[name][0]
    quant = kw.get("outer_quant") == "int8"
    step = 0.0
    if quant:
        # one int8 step of the largest pseudo-gradient leaf, the
        # residual's own bound, times the outer step's lr (1 + mu)
        step = float(max(np.abs(v).max() for k, v in j.items()
                         if k.startswith(".opt_state/ef/"))) * 2 * (
            kw["outer_lr"] * (1 + kw["outer_momentum"]))
    for k in j:
        assert t[k].shape == j[k].shape, k
        if k.startswith(".params/"):
            assert t[k].shape[0] == 2
            np.testing.assert_array_equal(t[k][0], t[k][1])
        if k == ".step":
            # the inner optimizer steps: rounds x inner_steps
            assert int(t[k]) == int(j[k]) == t_res["steps"]
        elif k.startswith((".params/", ".opt_state/outer/")):
            _held(k, t[k], j[k], name, step)
        elif k.startswith(".opt_state/ef/"):
            _held(k, t[k], j[k], name, step / (kw["outer_lr"] * (
                1 + kw["outer_momentum"])))
        else:
            _held(k, t[k], j[k], name, step)


def test_lm_samples_equal_jax(site):
    """``--sample_after 2`` at sites 2: the consensus params decode the
    same greedy tokens as JAX's."""
    jcfg = site["jax"]["lm"][2]
    assert "Sampled 2 sequences" in site["port"]["lm", 0]["stdout"]
    t = npz(site["tmp"] / "torch_logs_lm" / "samples.npz")
    j = npz(os.path.join(jcfg.logs_path, "samples.npz"))
    np.testing.assert_array_equal(t["samples"], j["samples"])


def test_round_spans_and_metrics_rows(site):
    """``--trace_spans`` writes one ``round`` phase span a round on each
    rank, as JAX's run does; ``--metrics`` and ``--on_anomaly=dump``
    write their rows and events under site mode."""
    def rounds(logs, proc):
        with open(os.path.join(logs, f"spans.{proc}.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        return [r["step"] for r in rows if r.get("phase") == "round"]

    want = rounds(site["jax"]["mlp"][2].logs_path, 0)
    assert want == list(range(1, len(want) + 1)) and len(want) == 16
    for r in range(2):
        assert rounds(str(site["tmp"] / "torch_logs_mlp"), r) == want
    logs = site["tmp"] / "torch_logs_int8"
    with open(logs / "metrics.0.jsonl") as f:
        rows = [json.loads(line) for line in f]
    windows = [r for r in rows if r["kind"] == "window"]
    assert len(windows) == 2 and all(np.isfinite(r["cost"])
                                     for r in windows)
    assert [r["step"] for r in windows] == [4, 8]
    assert [r["event"] for r in rows if r["kind"] == "event"][-1] == \
        "run_end"


def test_h1_sgd_outer_lr1_equals_data_parallel_2(site):
    """``--inner_steps 1`` with outer SGD at lr 1 over two sites is the
    synchronous step at dp 2: three rounds against three steps on the
    same rows, params within 2e-5 of scale and the third cost within
    2e-5 of itself (the rounds' outer step rounds the params)."""
    for r in range(2):
        s = npz(site["tmp"] / "out" / f"steps.{r}.npz")
        assert abs(float(s["h1_cost"]) - float(s["dp_cost"])) <= (
            EQUIV_RTOL * abs(float(s["dp_cost"])))
        for k in [k for k in s if k.startswith("dp/")]:
            got, want = s["h1/" + k[3:]], s[k]
            scale = float(np.abs(want).max())
            assert float(np.abs(got - want).max()) <= EQUIV_RTOL * scale, k


def test_h4_sgd_outer_lr1_equals_sync_period_4(site):
    """One round of 4 inner steps with outer SGD at lr 1 is four
    ``--sync_period 4`` steps and the average: params within 2e-5 of
    scale."""
    for r in range(2):
        s = npz(site["tmp"] / "out" / f"steps.{r}.npz")
        for k in [k for k in s if k.startswith("sp4/")]:
            got, want = s["h4/" + k[4:]], s[k]
            scale = float(np.abs(want).max())
            assert float(np.abs(got - want).max()) <= EQUIV_RTOL * scale, k


def test_rounds_end_in_consensus_inner_state_per_site(site):
    """After every round both sites' params are bitwise equal and the
    cost is the same on both; the inner momentum and the int8 residual
    stay per site and differ."""
    a, b = (npz(site["tmp"] / "out" / f"steps.{r}.npz") for r in range(2))
    for i in range(3):
        for k in [k for k in a if k.startswith(f"round{i}/")]:
            if k.endswith(("/inner_m", "/ef")):
                assert np.abs(a[k] - b[k]).max() > 0, k
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert np.isfinite(a[f"round{i}/cost"])


def test_checkpoints_resume_across_packages_bitwise(site):
    """JAX's int8 site checkpoint resumed by the port with no epoch left
    is written back bitwise (params, inner slots, outer momentum,
    residual, step), and the port's resumed by JAX the same way."""
    tmp = site["tmp"]
    assert site["port"]["resume_jax", 0]["error"] is None
    assert "Resumed from" in site["port"]["resume_jax", 0]["stdout"]
    for written, original in ((tmp / "torch_resume_jax", tmp / "jax_int8"),
                              (tmp / "jax_resume_torch", tmp / "torch_int8")):
        w = _leaves(latest_npz(written))
        o = _leaves(latest_npz(original))
        assert sorted(w) == sorted(o)
        assert any(k.startswith(".opt_state/ef/") for k in o)
        assert any(k.startswith(".opt_state/outer/m/") for k in o)
        for k in o:
            np.testing.assert_array_equal(w[k], o[k], err_msg=k)


def test_ckpt_every_and_auto_resume_continue_a_site_run(site):
    """``--ckpt_every 3`` over the first epoch, then ``--resume=auto`` to
    the end of the second: the second epoch's printed costs and the test
    accuracy are exactly the uninterrupted two-epoch run's."""
    whole = site["port"]["mlp", 0]
    auto = site["port"]["auto", 0]
    assert auto["error"] is None and site["port"]["ckpt_every", 0][
        "error"] is None
    assert "Resumed from" in auto["stdout"]
    # 8 rounds an epoch, a print every 2: the second epoch's four costs
    # and the final one
    assert costs(auto["stdout"]) == costs(whole["stdout"])[4:]
    assert auto["result"]["test_accuracy"] == whole["result"][
        "test_accuracy"]


@pytest.mark.parametrize("name", sorted(MISMATCH))
def test_mismatched_resume_refused_with_jax_message(site, name):
    """Resuming JAX's int8 site checkpoint with another ``--sites``, no
    outer momentum or no ``--outer_quant``: both ranks raise JAX's
    ValueError, word for word but the checkpoint's path."""
    want = site["refusals"][name]
    for r in range(2):
        err = site["port"][f"mismatch_{name}", r]["error"]
        assert err.startswith("ValueError: ")
        assert err[len("ValueError: "):] == want


def test_chip_smoke_phase_5f_rehearsed_on_the_cpu():
    """``chip_smoke.py``'s phase 5f at narrow widths on the CPU (two gloo
    ranks, each in its own process as on the card): the MLP runs with
    and without int8 and the transformer cut end with both sites'
    params bitwise equal after every round, the outer sync's payload is
    ``obs/flops``' f32 pseudo-gradient, and the two equivalences hold
    within the phase's bound."""
    import chip_smoke

    mlp = dict(chip_smoke.SITE_MLP, hidden_sizes=(32, 32), batch_size=64,
               compute_dtype="float32", synthetic_train_size=8 * 64,
               synthetic_test_size=100)
    keep = ("--model", "--attention", "--causal", "--fused_ln",
            "--optimizer", "--learning_rate", "--dataset", "--no_summaries",
            "--frequency", "--training_epochs")
    tfm = [f for f in chip_smoke.WIDE_LONG_FLAGS if f.startswith(keep)]
    tfm += ["--input_size=64", "--seq_len=16", "--d_model=32",
            "--n_heads=2", "--d_ff=64"] + chip_smoke.SITE_TFM_CUTS
    runs = {"site_mlp": mlp, "site_mlp_int8": dict(mlp, outer_quant="int8"),
            "site_tfm": tfm}
    out = chip_smoke.phase_sites(
        "cpu", device="cpu", runs=runs, timeout=120,
        equiv=dict(chip_smoke.WIDE_TRAIN, hidden_sizes=(32, 32),
                   batch_size=64, compute_dtype="float32"))
    for rank in out["ranks"]:
        assert rank["site_mlp"]["rounds"] == 8
        assert rank["site_tfm"]["rounds"] == 2
        assert rank["site_equiv"]["h1_vs_dp2"] <= chip_smoke.SITE_EQUIV_RTOL

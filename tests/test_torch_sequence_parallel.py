"""Sequence parallelism in the port against the JAX package's one-process
``('data', 'seq'[, 'model'])`` mesh, on the CPU.

Four gloo rank subprocesses (``OMP_NUM_THREADS=1``, niced), launched
once, in one world of four; the JAX side runs in this process meanwhile
on the first devices of the eight CPU devices.  Rank r plays device r of
JAX's mesh: data index ``r // (sp * mp)``, seq index ``(r // mp) % sp``,
model index ``r % mp``.

- the ops at sp 4 (the world as one seq axis), values and q/k/v
  gradients, causal and full: the dense ring against JAX's
  ``ring_attention``; the flash ring on the kernels' plain versions
  against JAX's ``_ring_flash_diff`` with ``fa._xla_stats`` and
  ``fa._xla_backward_flat`` put in (as ``tests/test_ring_attention.py``
  does); Ulysses against JAX's ``ulysses_attention(use_flash=False)``,
  and on the flash kernels' plain versions; the rotation by
  ``batch_isend_irecv`` and by the zero-split ``all_to_all_single``
  (gloo's route on the card) equal;
- full runs against JAX's ``train.loop.run``: dp 2 x sp 2 ring on the
  lm objective (causal; 256-token blocks, so the port's flash ring on
  the plain versions against JAX's dense ring), sp 2 x mp 2 Ulysses
  classify, sp 4 ring
  classify with a top-2 MoE under ``--moe_aux_weight`` (the balance loss
  averaged over the token axes), dp 2 x sp 2 under ``--zero_opt``;
- properties: dropout at sp 2 x mp 2 (the seq shards draw different
  masks, the model ranks of one shard the same); ``build_seq_mesh``'s
  placement and messages, and the trainer's refusals, equal JAX's; the
  ZeRO run's sp 2 checkpoint resumed at sp 1 by the port and by JAX.

Tolerances (f32; the ring and the shards sum in other orders): the ops
within rtol/atol 2e-5 (dense ring, Ulysses), 1e-4/1e-5 for the flash
ring (the kernels' log2-domain math against JAX's natural-log XLA
stand-ins); runs: printed costs within 1e-4 (one unit in their last
printed place), final params within 1e-4 of each leaf's scale (the TP
tests' run bound).
"""

import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.ops import flash_attention as jfa
from distributed_tensorflow_example_tpu.ops import ring_attention as jra
from distributed_tensorflow_example_tpu.ops import ulysses_attention as jua
from distributed_tensorflow_example_tpu.parallel import mesh as jmesh
from distributed_tensorflow_example_tpu.train import loop as jloop
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_example_tpu_torch.train import loop as tloop
from test_torch_data_parallel import (costs, free_port, latest_npz, npz,
                                      run_jax, save_init, start_ranks,
                                      wait_ranks)

torch.set_num_threads(1)

RANK_SCRIPT = r'''
import contextlib, datetime, io, json, os, sys
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
from distributed_tensorflow_example_tpu_torch.ops import ring_attention as ra
from distributed_tensorflow_example_tpu_torch.ops import ulysses_attention
from distributed_tensorflow_example_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_example_tpu_torch.train import loop as tloop
from distributed_tensorflow_example_tpu_torch.train import optim as toptim
from distributed_tensorflow_example_tpu_torch.train import state as tstate

with open(plan_path) as f:
    plan = json.load(f)
out_dir = plan["out"]


def port_init(init_path):
    with np.load(init_path) as z:
        init_np = {k: z[k] for k in z.files}

    def init(spec, optimizer, seed=1, device=None):
        params = convert.params_from_numpy(init_np, spec, device="cpu")
        return tstate.TrainState(torch.zeros((), dtype=torch.int32),
                                 params, optimizer.init(params))
    return init


def ops_job(job):
    """Each op on this rank's token block of the plan's inputs: the
    output block and the q/k/v gradients of sum(out * w)."""
    axis = tmesh.SeqAxis(dist.group.WORLD, world, me, tuple(range(world)))
    fns = {"ring": ra.ring_attention, "flash_ring": ra.ring_flash_attention,
           "ulysses": ulysses_attention.ulysses_attention,
           "ulysses_flash": lambda q, k, v, a, c: (
               ulysses_attention.ulysses_attention(q, k, v, a, c,
                                                   use_flash=True))}
    out = {}
    for case in job["cases"]:
        with np.load(case["inputs"]) as z:
            arrs = {k: z[k] for k in z.files}
        lb = arrs["q"].shape[1] // axis.size
        cols = slice(axis.index * lb, (axis.index + 1) * lb)
        q, k, v = (torch.from_numpy(arrs[n][:, cols]).requires_grad_(True)
                   for n in "qkv")
        o = fns[case["op"]](q, k, v, axis, case["causal"])
        torch.sum(o * torch.from_numpy(arrs["w"][:, cols])).backward()
        name = case["name"]
        out[name + "/o"] = o.detach().numpy()
        for n, t in zip("qkv", (q, k, v)):
            out[f"{name}/d{n}"] = t.grad.numpy()
    t = torch.arange(6, dtype=torch.float32) + 10 * axis.index
    for shift in (1, -1):
        for how in ("p2p", "a2a"):
            out[f"rotate/{shift}/{how}"] = tmesh.rotate_start(
                [t], axis, shift, transport=how).wait()[0].numpy()
    np.savez(os.path.join(out_dir, f"ops.{me}.npz"), **out)


def run_job(job):
    kw = dict(job["cfg"])
    cfg = tconfig.Config(**kw, device="cpu")
    data = tmnist.synthesize_dataset(seed=0, **job["sizes"])
    tloop.load_datasets = lambda *a, **k: data
    tloop.create_train_state = port_init(job["init"])
    if job.get("peak"):
        from distributed_tensorflow_example_tpu_torch.obs import flops
        flops.chip_peak_flops = lambda dev: job["peak"]
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


def dropout_job(job):
    """One step at the plan's mesh with dropout: each site's mask, as
    drawn on this rank."""
    cfg = tconfig.Config(**job["cfg"], device="cpu")
    spec = tloop.make_spec(cfg)
    opt = toptim.make_optimizer(cfg)
    mesh = tmesh.build_seq_mesh(cfg.data_parallel, cfg.sequence_parallel,
                                model_parallel=cfg.model_parallel)
    strat = tloop.setup_strategy(cfg, spec, opt, port_init(job["init"])(
        spec, opt), mesh, fast=False)
    masks = {}
    drop = transformer._dropout

    def keep(h, spec_, rng, salt):
        o = drop(h, spec_, rng, salt)
        masks[f"salt{salt}"] = (o == 0).numpy()
        return o

    transformer._dropout = keep
    with np.load(job["batch"]) as z:
        x, y = z["x"], z["y"]
    rows = tmesh.batch_layout(mesh, x.shape[0])
    cols = tmesh.seq_columns(mesh, x.shape[1])
    strat.body(strat.state, torch.from_numpy(x[rows][:, cols]),
               torch.from_numpy(y[rows]))
    transformer._dropout = drop
    np.savez(os.path.join(out_dir, f"dropout.{me}.npz"), **masks)


for job in plan["jobs"]:
    if job["kind"] != "ops":
        # the initial params, which the test process writes meanwhile
        import time
        while not os.path.exists(plan["ready"]):
            time.sleep(0.05)
    {"ops": ops_job, "run": run_job, "dropout": dropout_job}[job["kind"]](job)
    dist.barrier()
dist.destroy_process_group()
'''

WORLD = 4
TFM_KW = dict(model="transformer", input_size=64, seq_len=16, d_model=32,
              n_heads=4, num_blocks=2, d_ff=64, optimizer="momentum",
              learning_rate=0.01, seed=3, batch_size=8, frequency=1,
              eval_batch_size=8, dataset="synthetic", summaries=False,
              training_epochs=1, fast_loop=False)
TFM_SIZES = dict(train_size=32, test_size=12, input_size=64)
# the lm run's local block is 256 tokens, so the port's ring takes the
# flash kernels (their plain versions here) where JAX's CPU backend
# takes its dense ring
LM_KW = dict(TFM_KW, objective="lm", input_size=512, seq_len=512,
             vocab_size=32, attention="flash", n_heads=2, d_model=16,
             d_ff=32)
LM_SIZES = dict(train_size=32, test_size=8, input_size=512)
# name: (flags, sizes) of the full runs, each on all four ranks
RUNS = {
    "lm_ring": (dict(LM_KW, data_parallel=2, sequence_parallel=2,
                     sp_impl="ring"), LM_SIZES),
    "cls_ulysses": (dict(TFM_KW, model_parallel=2, sequence_parallel=2,
                         data_parallel=1, sp_impl="ulysses"), TFM_SIZES),
    "moe_ring": (dict(TFM_KW, sequence_parallel=4, data_parallel=1,
                      sp_impl="ring",
                      num_experts=4, moe_dispatch="dense", moe_topk=2,
                      moe_aux_weight=0.01, d_ff=48), TFM_SIZES),
    "zero": (dict(TFM_KW, data_parallel=2, sequence_parallel=2,
                  sp_impl="ring", zero_opt=True), TFM_SIZES),
}
DROPOUT_KW = dict(TFM_KW, model_parallel=2, sequence_parallel=2,
                  data_parallel=1, dropout_rate=0.3)
OP_RTOL = {"ring": 2e-5, "ulysses": 2e-5, "flash_ring": 1e-4,
           "ulysses_flash": 1e-4}
OP_ATOL = {"ring": 2e-5, "ulysses": 2e-5, "flash_ring": 1e-5,
           "ulysses_flash": 1e-5}
RUN_RTOL = 1e-4
PEAK = 1e9
# the dense ops' shape (JAX's ring test: 4 shards of 16), the flash
# ring's (4 local blocks of 256, the kernels' tile)
DENSE_SHAPE = (2, 64, 4, 8)
FLASH_SHAPE = (1, 1024, 2, 8)
OPS = [(op, causal) for op in ("ring", "flash_ring", "ulysses",
                               "ulysses_flash")
       for causal in (False, True)]


def _op_inputs(path, shape, seed):
    rng = np.random.RandomState(seed)
    np.savez(path, **{n: rng.randn(*shape).astype(np.float32)
                      for n in ("q", "k", "v", "w")})


def _xla_stats(q, k, v, causal, blk):
    return jfa._xla_stats(q, k, v, causal)


def _jax_op(op, causal, arrs, devices):
    """JAX's op on a 4-device 'seq' mesh: the output and the q/k/v
    gradients of sum(out * w)."""
    mesh = JMesh(np.array(devices[:WORLD]), ("seq",))
    if op == "ring":
        fn = lambda q, k, v: jra.ring_attention(q, k, v, "seq", causal)
    elif op == "flash_ring":
        fn = lambda q, k, v: jra._ring_flash_diff(q, k, v, "seq", causal)
    else:
        fn = lambda q, k, v: jua.ulysses_attention(q, k, v, "seq", causal,
                                                   use_flash=False)
    sharded = jax.shard_map(fn, mesh=mesh, in_specs=(P(None, "seq"),) * 3,
                            out_specs=P(None, "seq"))
    w = jnp.asarray(arrs["w"])

    def loss(q, k, v):
        o = sharded(q, k, v)
        return jnp.sum(o * w), o

    q, k, v = (jnp.asarray(arrs[n]) for n in "qkv")
    (_l, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(o), [np.asarray(g) for g in grads]


def launch(plan, tmp, meanwhile, timeout: float = 240):
    os.makedirs(plan["out"], exist_ok=True)
    plan_path = os.path.join(str(tmp), "sp_plan.json")
    script = os.path.join(str(tmp), "sp_rank.py")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    with open(script, "w") as f:
        f.write(RANK_SCRIPT)
    port = free_port()
    ps, logs = start_ranks([[script, str(r), str(WORLD), str(port),
                             plan_path] for r in range(WORLD)], tmp,
                           "sp_rank")
    try:
        meanwhile()
        wait_ranks(ps, logs, timeout)
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """The ranks' ops, runs and dropout step; JAX's ops and runs."""
    tmp = tmp_path_factory.mktemp("sp")
    dense_in, flash_in = str(tmp / "dense.npz"), str(tmp / "flash.npz")
    _op_inputs(dense_in, DENSE_SHAPE, 5)
    _op_inputs(flash_in, FLASH_SHAPE, 17)
    cases = [dict(name=f"{op}_{'causal' if c else 'full'}", op=op, causal=c,
                  inputs=flash_in if op == "flash_ring" else dense_in)
             for op, c in OPS]
    # one init a model: the runs that share a model share its file
    models = dict({name: kw for name, (kw, _sizes) in RUNS.items()},
                  dropout=DROPOUT_KW)
    keys = {name: repr(jloop.make_spec(jconfig.Config(**dict(
        kw, dropout_rate=0.0)))) for name, kw in models.items()}
    files = {key: str(tmp / f"init_{i}.npz")
             for i, key in enumerate(dict.fromkeys(keys.values()))}
    inits = {name: files[key] for name, key in keys.items()}
    ready = str(tmp / "inits_ready")
    rng = np.random.RandomState(11)
    batch = str(tmp / "batch.npz")
    np.savez(batch, x=rng.rand(8, 64).astype(np.float32),
             y=np.eye(10, dtype=np.float32)[rng.randint(0, 10, 8)])
    jobs = [dict(kind="ops", cases=cases)]
    jobs += [dict(kind="run", name=name, init=inits[name], sizes=sizes,
                  cfg=dict(kw, checkpoint_dir=str(tmp / f"torch_{name}")))
             for name, (kw, sizes) in RUNS.items()]
    # the ZeRO run also writes --metrics rows, the card's peak stubbed
    jobs[-1]["cfg"].update(metrics=True, log_every=2,
                           logs_path=str(tmp / "logs_zero"))
    jobs[-1]["peak"] = PEAK
    jobs.append(dict(kind="dropout", init=inits["dropout"], batch=batch,
                     cfg=DROPOUT_KW))
    plan = dict(out=str(tmp / "out"), jobs=jobs, ready=ready)
    jax_ops, jax_runs = {}, {}

    def jax_ops_side():
        # the runs below take JAX's dense ring on the CPU and never reach
        # the two stand-ins, so this thread can overlap them
        devices = jax.devices()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jfa, "_flash_stats", _xla_stats)
            mp.setattr(jfa, "_flash_backward_flat", jfa._xla_backward_flat)
            for case in cases:
                if case["op"] == "ulysses_flash":
                    continue
                with np.load(case["inputs"]) as z:
                    arrs = {k: z[k] for k in z.files}
                jax_ops[case["name"]] = _jax_op(case["op"], case["causal"],
                                                arrs, devices)

    def jax_side():
        ops = threading.Thread(target=jax_ops_side)
        ops.start()
        # JAX's initial params, which the ranks' runs wait for while they
        # run the ops
        for name, kw in models.items():
            if not os.path.exists(inits[name]):
                save_init(jconfig.Config(**kw), inits[name])
        open(ready, "w").close()
        for name, (kw, sizes) in RUNS.items():
            jcfg = jconfig.Config(**kw, compilation_cache="",
                                  checkpoint_dir=str(tmp / f"jax_{name}"))
            jax_runs[name] = run_jax(jcfg, sizes) + (jcfg,)
        ops.join()

    launch(plan, tmp, jax_side)
    port = {}
    for name in RUNS:
        for r in range(WORLD):
            with open(tmp / "out" / f"{name}.{r}.json") as f:
                port[name, r] = json.load(f)
    return dict(tmp=tmp, port=port, jax_ops=jax_ops, jax_runs=jax_runs,
                ops=[npz(tmp / "out" / f"ops.{r}.npz")
                     for r in range(WORLD)],
                dropout=[npz(tmp / "out" / f"dropout.{r}.npz")
                         for r in range(WORLD)])


# ---- the ops at sp 4 ----


@pytest.mark.parametrize("op,causal", OPS)
def test_op_values_and_grads_equal_jax(sp, op, causal):
    """The four ranks' output blocks and q/k/v gradient blocks,
    concatenated, against JAX's sharded op (Ulysses on the flash
    kernels' plain versions against JAX's dense Ulysses)."""
    name = f"{op}_{'causal' if causal else 'full'}"
    want_o, want_g = sp["jax_ops"][
        name.replace("ulysses_flash", "ulysses")]
    got = {k: np.concatenate([sp["ops"][r][f"{name}/{k}"]
                              for r in range(WORLD)], axis=1)
           for k in ("o", "dq", "dk", "dv")}
    rtol, atol = OP_RTOL[op], OP_ATOL[op]
    np.testing.assert_allclose(got["o"], want_o, rtol=rtol, atol=atol)
    for k, g in zip(("dq", "dk", "dv"), want_g):
        np.testing.assert_allclose(got[k], g, rtol=rtol, atol=atol,
                                   err_msg=k)


def test_rotation_routes_agree(sp):
    """The rotation by ``batch_isend_irecv`` and by the zero-split
    ``all_to_all_single`` deliver the same tensor: rank r holds rank
    r - shift's."""
    for r in range(WORLD):
        for shift in (1, -1):
            src = (r - shift) % WORLD
            want = np.arange(6, dtype=np.float32) + 10 * src
            for how in ("p2p", "a2a"):
                np.testing.assert_array_equal(
                    sp["ops"][r][f"rotate/{shift}/{how}"], want)


# ---- full runs ----


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_equals_jax_seq_mesh(sp, name):
    """Each run on four ranks against JAX's run of the same flags: the
    host path, the devices, the steps, every rank's printed costs, the
    chief's test accuracy, and the final params (and slots) of the
    chief's checkpoint within the run bound."""
    j_out, j_res, jcfg = sp["jax_runs"][name]
    for r in range(WORLD):
        assert sp["port"][name, r]["error"] is None, sp["port"][name, r]
    chief = sp["port"][name, 0]
    t_res = chief["result"]
    assert t_res["fast_loop"] is j_res["fast_loop"] is False
    for k in ("steps", "global_batch", "devices", "examples_seen"):
        assert t_res[k] == j_res[k], k
    assert t_res["devices"] == WORLD
    jc, tc = costs(j_out), costs(chief["stdout"])
    assert len(tc) == len(jc) >= 4
    assert np.allclose(tc, jc, rtol=0, atol=1e-4), (tc, jc)
    for r in range(1, WORLD):
        assert costs(sp["port"][name, r]["stdout"]) == tc[:-1]
    assert t_res["test_accuracy"] == j_res["test_accuracy"]
    t = npz(latest_npz(sp["tmp"] / f"torch_{name}"))
    j = npz(latest_npz(jcfg.checkpoint_dir))
    keys = sorted(k for k in j if not k.startswith("__"))
    assert sorted(k for k in t if not k.startswith("__")) == keys
    for k in keys:
        if k.startswith((".params/", ".opt_state/")):
            np.testing.assert_allclose(
                t[k], j[k], rtol=0,
                atol=RUN_RTOL * max(float(np.abs(j[k]).max()), 1e-6),
                err_msg=f"{name} {k}")


def test_metrics_rows_divide_by_dp_sp_mp(sp):
    """Under ``--metrics`` at dp 2 x sp 2 (the card's peak stubbed) every
    window row's MFU is its model FLOP/s over the peak of the four
    devices of the mesh, as JAX's ``n_devices`` counts them."""
    rows = [json.loads(line) for line in open(
        sp["tmp"] / "logs_zero" / "metrics.0.jsonl")]
    windows = [r for r in rows if "mfu" in r]
    assert windows
    batch = RUNS["zero"][0]["batch_size"]
    for r in windows:
        want = r["model_flops_per_step"] * (
            r["examples_per_sec"] / batch) / (PEAK * WORLD)
        assert abs(r["mfu"] - want) <= 2e-6 + 1e-3 * want, (r, want)


def test_sp_checkpoint_resumes_at_sp1_and_in_jax(sp, tmp_path):
    """The MoE run's checkpoint, written at sp 4 (the chief's; the state
    is replicated over 'seq'), resumed for a second epoch at sp 1 by the
    port (one process) and by JAX (one device): the same printed costs,
    and final params within the run bound."""
    import contextlib
    import io

    from distributed_tensorflow_example_tpu_torch.data import mnist as tmnist

    kw, sizes = RUNS["moe_ring"]
    src = sp["tmp"] / "torch_moe_ring"
    resumed = dict(kw, sequence_parallel=1, training_epochs=2, resume=True)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    shutil.copytree(src, jdir)
    shutil.copytree(src, tdir)
    j_out, _j_res = run_jax(jconfig.Config(
        **resumed, compilation_cache="", checkpoint_dir=str(jdir)), sizes)
    data = tmnist.synthesize_dataset(seed=0, **sizes)
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tloop, "load_datasets", lambda *a, **k: data)
        with contextlib.redirect_stdout(buf):
            tloop.run(tconfig.Config(**resumed, device="cpu",
                                     checkpoint_dir=str(tdir)))
    tc, jc = costs(buf.getvalue()), costs(j_out)
    assert len(tc) == len(jc) >= 4
    assert np.allclose(tc, jc, rtol=0, atol=1e-4), (tc, jc)
    t, j = npz(latest_npz(tdir)), npz(latest_npz(jdir))
    assert int(t[".step"]) == int(j[".step"]) == 8
    for k in j:
        if k.startswith(".params/"):
            np.testing.assert_allclose(
                t[k], j[k], rtol=0,
                atol=RUN_RTOL * max(float(np.abs(j[k]).max()), 1e-6),
                err_msg=k)


def test_dropout_seq_shards_differ_model_ranks_agree(sp):
    """``--dropout_rate`` at sp 2 x mp 2: ranks 0 and 1 (seq 0, model 0
    and 1) draw the same masks at every site, as do ranks 2 and 3 (seq
    1); the two seq shards draw different ones."""
    d = sp["dropout"]
    sites = sorted(d[0])
    assert len(sites) == 1 + 2 * TFM_KW["num_blocks"]
    for s in sites:
        np.testing.assert_array_equal(d[0][s], d[1][s])
        np.testing.assert_array_equal(d[2][s], d[3][s])
        assert d[0][s].shape == d[2][s].shape
        assert not np.array_equal(d[0][s], d[2][s]), s



# (seed, step, data index, seq index) against (0, 5, 0, 0): each field
# on its own, the step 2^15 and 2^48 apart (a packing cut to the sites'
# 63-bit seeds loses the high bits of the step and the seed)
RNG_FIELDS = {"seed": (1, 5, 0, 0), "seed_2_40": (1 << 40, 5, 0, 0),
              "step_2_15": (0, 5 + (1 << 15), 0, 0),
              "step_2_48": (0, 5 + (1 << 48), 0, 0),
              "data": (0, 5, 1, 0), "seq": (0, 5, 0, 1)}


@pytest.mark.parametrize("name", sorted(RNG_FIELDS))
def test_every_step_rng_field_reaches_the_masks(name):
    """``make_step_rng``'s seed, step, data index and seq index each
    change the dropout mask; the same four fields draw the same one."""
    from distributed_tensorflow_example_tpu_torch.models import transformer
    from distributed_tensorflow_example_tpu_torch.parallel import step

    def mask(seed, at, data, seq):
        cfg = tconfig.Config(model="transformer", dropout_rate=0.3,
                             seed=seed)
        spec = tloop.make_spec(cfg)
        rng = step.make_step_rng(cfg, spec, data, seq)(None, at)
        return transformer._dropout(torch.ones(64, 64), spec, rng, 1) == 0

    base = mask(0, 5, 0, 0)
    assert torch.equal(base, mask(0, 5, 0, 0))
    assert not torch.equal(base, mask(*RNG_FIELDS[name]))


# ---- the mesh and the refusals ----


@pytest.mark.parametrize("dp,sp_,mp", [(1, 2, 1), (2, 2, 1), (1, 4, 1),
                                       (1, 2, 2), (2, 2, 2), (1, 4, 2)])
def test_rank_plays_jax_seq_mesh_position(dp, sp_, mp):
    """Rank r sits where JAX's ``build_seq_mesh`` puts device r: data
    index r // (sp mp), seq index (r // mp) % sp, model index r % mp."""
    n = dp * sp_ * mp
    devices = jax.devices()[:n]
    jm = jmesh.build_seq_mesh(dp, sp_, devices=devices, model_parallel=mp)
    for r in range(n):
        tm = tmesh.build_seq_mesh(dp, sp_, world=n, rank=r,
                                  model_parallel=mp)
        pos = tuple(np.argwhere(jm.devices == devices[r])[0])
        want = pos if mp > 1 else pos + (0,)
        assert (tm.data_index, tm.seq_index, tm.model_index) == want
        assert tm.devices == n


@pytest.mark.parametrize("dp,sp_,mp,n", [(0, 2, 1, 4), (4, 2, 1, 4),
                                         (2, 2, 2, 4)])
def test_build_seq_mesh_messages_equal_jax(dp, sp_, mp, n):
    """A degree below 1 or a mesh larger than the world raises JAX's
    message."""
    with pytest.raises(ValueError) as j:
        jmesh.build_seq_mesh(dp, sp_, devices=jax.devices()[:n],
                             model_parallel=mp)
    with pytest.raises(ValueError) as t:
        tmesh.build_seq_mesh(dp, sp_, world=n, model_parallel=mp)
    assert str(t.value) == str(j.value)


REFUSALS = {
    "mlp": dict(sequence_parallel=2),
    "seq_len": dict(TFM_KW, sequence_parallel=3),
    "lm_seq_len": dict(LM_KW, input_size=510, sequence_parallel=4),
    "heads": dict(TFM_KW, sequence_parallel=8, sp_impl="ulysses",
                  seq_len=16),
    "heads_tp": dict(TFM_KW, sequence_parallel=4, sp_impl="ulysses",
                     model_parallel=2),
    "fsdp": dict(TFM_KW, sequence_parallel=2, fsdp=True),
    "sync_period": dict(TFM_KW, sequence_parallel=2, sync_period=2),
    "sites": dict(TFM_KW, sequence_parallel=2, sites=2),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_equal_jax(name):
    """The trainer refuses what JAX's refuses, with its message: the
    MLP, a sequence that does not split, Ulysses' head count (per model
    shard), FSDP, local SGD and the multi-site layout."""
    kw = REFUSALS[name]
    with pytest.raises(ValueError) as j:
        jloop.run(jconfig.Config(**kw, compilation_cache=""))
    with pytest.raises(ValueError) as t:
        tloop.run(tconfig.Config(**kw, device="cpu"))
    assert str(t.value) == str(j.value)


def test_trainer_parses_the_sp_flags_with_jax_defaults():
    """``--sequence_parallel`` and ``--sp_impl`` parse with JAX's
    defaults and choices; a bad layout exits 2."""
    d, jd = tconfig.parse_train_config([]), jconfig.Config()
    assert (d.sequence_parallel, d.sp_impl) == (jd.sequence_parallel,
                                                jd.sp_impl)
    cfg = tconfig.parse_train_config(["--sequence_parallel=2",
                                      "--sp_impl=ulysses"])
    assert (cfg.sequence_parallel, cfg.sp_impl) == (2, "ulysses")
    with pytest.raises(SystemExit) as e:
        tconfig.parse_train_config(["--sp_impl=tree"])
    assert e.value.code == 2


def test_ops_are_local_attention_without_an_axis():
    """Without a seq axis the ring (dense and flash) and Ulysses are
    plain attention over the block, and the seq collectives pass their
    inputs through."""
    from distributed_tensorflow_example_tpu_torch.ops import (
        ring_attention as tra, ulysses_attention as tua)

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 256, 2, 8), generator=g) for _ in range(3))
    want = tra.attention(q, k, v, causal=True)
    for fn in (tra.ring_attention, tra.ring_flash_attention,
               tua.ulysses_attention):
        torch.testing.assert_close(fn(q, k, v, None, True), want,
                                   rtol=1e-4, atol=1e-5)
    assert tmesh.seq_rotate(q, None) is q
    assert tmesh.seq_all_to_all(q, None) is q
    assert tmesh.pmean_seq(q, None) is q and tmesh.psum_seq(q, None) is q
    assert tmesh.pmean_tokens(q, None) is q

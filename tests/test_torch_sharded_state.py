"""ZeRO-1 and FSDP in the port against the JAX package, on the CPU: the
sharded layouts, two gloo ranks against JAX's ``--data_parallel=2``
runs, checkpoints crossing between the packages, and the strategies'
flag matrix.

- ``shard_state_host``/``unshard_state_host`` bitwise equal to JAX's on
  the same numpy state; ZeRO-1's initial slot rows bitwise JAX's
  ``zero_opt_state`` rows;
- ``--zero_opt --optimizer=adam`` (host path, as in JAX) in two ranks:
  within 1e-5 of JAX's dp=2 run and of the port's one-process plain
  run; its ``[dp, chunk]`` slots within 1e-5 of JAX's; a JAX checkpoint
  restored in the port and re-saved bitwise, and the port's in JAX; a
  ``zero_dp`` mismatch raises JAX's message;
- ``--fsdp --optimizer=adam`` on the fast and the host path in two
  ranks, within 1e-5 of JAX's dp=2 runs; under
  ``--sharded_checkpoints`` each rank writes its 1/dp row of every float
  leaf; that 2-rank checkpoint resumes at one rank in the port and in
  JAX (the same next epoch within 1e-5), and JAX's 2-device one
  restores in the port's ranks and re-saves bitwise;
- one tiny transformer under ``--fsdp --attention=flash`` (the port's
  plain flash on the CPU, JAX's interpret-mode kernels) within 1e-4;
- every strategy combination JAX refuses, refused by the port with
  JAX's message; ``--data_parallel`` layout errors; ``hard_sync`` on CPU
  leaves.

Tolerances (f32, sums in other orders): params and slots within 1e-5
of their scale (the transformer's Adam run 1e-4), printed costs within
1e-4, test accuracies equal.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.parallel import fsdp as jfsdp
from distributed_tensorflow_example_tpu.parallel import mesh as jmesh
from distributed_tensorflow_example_tpu.parallel import zero as jzero
from distributed_tensorflow_example_tpu.train import loop as jloop
from distributed_tensorflow_example_tpu.train import optim as joptim
from distributed_tensorflow_example_tpu.train import state as jstate
from distributed_tensorflow_example_tpu.utils import checkpoint as jckpt
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.data import mnist as tmnist
from distributed_tensorflow_example_tpu_torch.parallel import fsdp as tfsdp
from distributed_tensorflow_example_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_example_tpu_torch.parallel import zero as tzero
from distributed_tensorflow_example_tpu_torch.train import loop as tloop
from distributed_tensorflow_example_tpu_torch.train import optim as toptim
from distributed_tensorflow_example_tpu_torch.train import state as tstate
from distributed_tensorflow_example_tpu_torch.utils import checkpoint as tckpt
from distributed_tensorflow_example_tpu_torch.utils.sync import hard_sync
from test_torch_data_parallel import (close, costs, latest_npz, launch_ranks,
                                      npz, run_jax, save_init)

# one intra-op thread: the suite runs six test workers (and the rank
# processes) on the machine's cores, where torch would start one a core
torch.set_num_threads(1)

SIZES = dict(train_size=400, test_size=100, input_size=784)
ADAM_KW = dict(dataset="synthetic", batch_size=40, hidden_sizes=(16,),
               learning_rate=0.01, optimizer="adam", frequency=4,
               summaries=False, training_epochs=1, seed=5)
TFM_SIZES = dict(train_size=32, test_size=12, input_size=64)
TFM_KW = dict(model="transformer", input_size=64, seq_len=16, d_model=32,
              n_heads=2, num_blocks=2, d_ff=64, optimizer="adam",
              learning_rate=1e-3, seed=3, batch_size=8, frequency=2,
              eval_batch_size=8, dataset="synthetic", summaries=False,
              training_epochs=1, attention="flash", fsdp=True,
              fast_loop=False)
# name: (the flags both sides take, sizes); every one at dp=2
RUNS = {
    "zero": (dict(ADAM_KW, zero_opt=True, fast_loop=False), SIZES),
    "plain_host": (dict(ADAM_KW, fast_loop=False), SIZES),
    "fsdp_fast": (dict(ADAM_KW, fsdp=True), SIZES),
    "fsdp_host": (dict(ADAM_KW, fsdp=True, fast_loop=False,
                       sharded_checkpoints=True), SIZES),
    "tfm_fsdp": (TFM_KW, TFM_SIZES),
}


def _copy_ckpt(src_dir, dst_dir) -> str:
    """The newest checkpoint of ``src_dir`` alone in a fresh
    ``dst_dir``; returns its name."""
    names = sorted(n for n in os.listdir(src_dir) if n.startswith("ckpt-"))
    os.makedirs(dst_dir)
    src = os.path.join(src_dir, names[-1])
    dst = os.path.join(dst_dir, names[-1])
    (shutil.copytree if os.path.isdir(src) else shutil.copy)(src, dst)
    return names[-1]


def _arrays(path) -> dict:
    """A checkpoint's logical leaves (either format) as numpy."""
    if os.path.isdir(path):
        return jckpt.restore_sharded_arrays(path)[0]
    return {k: v for k, v in npz(path).items() if not k.startswith("__")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's dp=2 runs; then the port's two ranks: the same runs, a
    restore of JAX's ZeRO-1 and sharded FSDP checkpoints (no epoch
    left: restore, eval, re-save); then JAX restoring the port's."""
    tmp = tmp_path_factory.mktemp("sharded")
    inits = {"mlp": str(tmp / "init_mlp.npz"),
             "tfm": str(tmp / "init_tfm.npz")}
    save_init(jconfig.Config(**ADAM_KW), inits["mlp"])
    save_init(jconfig.Config(**TFM_KW), inits["tfm"])
    jax_runs = {}
    for name, (kw, sizes) in RUNS.items():
        jcfg = jconfig.Config(**kw, data_parallel=2, compilation_cache="",
                              checkpoint_dir=str(tmp / f"jax_{name}"))
        jax_runs[name] = run_jax(jcfg, sizes) + (jcfg,)
    restores = {"zero": "ckpt_from_jax_zero",
                "fsdp_host": "ckpt_from_jax_fsdp"}
    for name, d in restores.items():
        _copy_ckpt(tmp / f"jax_{name}", tmp / d)
    jobs = []
    for name, (kw, sizes) in RUNS.items():
        init = inits["tfm" if kw.get("model") == "transformer" else "mlp"]
        jobs.append(dict(name=name, init=init, sizes=sizes, cfg=dict(
            kw, checkpoint_dir=str(tmp / f"torch_{name}"))))
    for name, d in restores.items():
        jobs.append(dict(name=d, init=inits["mlp"], sizes=SIZES, cfg=dict(
            RUNS[name][0], checkpoint_dir=str(tmp / d), resume="latest")))
    port = launch_ranks(dict(out=str(tmp / "out"), jobs=jobs), tmp)
    # JAX restores the port's ZeRO-1 checkpoint and re-saves it
    _copy_ckpt(tmp / "torch_zero", tmp / "ckpt_from_torch_zero")
    run_jax(jconfig.Config(**RUNS["zero"][0], data_parallel=2,
                           compilation_cache="", resume="latest",
                           checkpoint_dir=str(tmp / "ckpt_from_torch_zero")),
            SIZES)
    return dict(port=port, jax=jax_runs, tmp=tmp, inits=inits)


def _port_ok(runs, name):
    for r in range(2):
        rec = runs["port"][name, r]
        assert rec["error"] is None, rec["error"]
    return runs["port"][name, 0]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_two_ranks_equal_jax_dp2(runs, name):
    """ZeRO-1, FSDP (fast and host) and the FSDP flash transformer: the
    path JAX takes, the same printed costs and test accuracy, the final
    params (FSDP's gathered, ZeRO's replicated) within 1e-5 of JAX's
    (1e-4 for the transformer)."""
    j_out, j_res, jcfg = runs["jax"][name]
    chief = _port_ok(runs, name)
    t_res = chief["result"]
    assert t_res["fast_loop"] == j_res["fast_loop"]
    for k in ("steps", "global_batch", "devices", "epochs_completed"):
        assert t_res[k] == j_res[k], k
    tc, jc = costs(chief["stdout"]), costs(j_out)
    assert len(tc) == len(jc) >= 3
    assert np.allclose(tc, jc, rtol=0, atol=1e-4), (tc, jc)
    assert t_res["test_accuracy"] == j_res["test_accuracy"]
    tdir, jdir = runs["tmp"] / f"torch_{name}", jcfg.checkpoint_dir
    t_names = sorted(os.listdir(tdir))
    assert t_names == sorted(os.listdir(jdir))
    ta = _arrays(os.path.join(tdir, t_names[-1]))
    ja = _arrays(os.path.join(jdir, t_names[-1]))
    assert sorted(ta) == sorted(ja)
    tol = 1e-4 if name == "tfm_fsdp" else 1e-5
    steps = j_res["steps"]
    for k in ja:
        assert ta[k].shape == ja[k].shape and ta[k].dtype == ja[k].dtype, k
        t, j = ta[k], ja[k]
        if k.endswith("_bqkv"):
            # the key bias (row 1): softmax is invariant to it, so its
            # true gradient is 0 and both sides step on f32 noise, up to
            # lr a step (tests/test_torch_transformer_train.py)
            if k.startswith(".params"):
                assert np.abs(t[1] - j[1]).max() <= \
                    2 * TFM_KW["learning_rate"] * steps, k
            t, j = t[0::2], j[0::2]
        if k.startswith((".params", ".opt_state/mu", ".opt_state/nu")):
            close(t, j, tol, f"{name} {k}")
        else:
            np.testing.assert_array_equal(t, j, err_msg=k)


def test_zero_equals_the_port_plain_runs(runs, tmp_path):
    """ZeRO-1 in two ranks: its params bitwise those of the plain
    (replicated-slot) run in two ranks, the same all-reduced gradients
    updated chunk by chunk; and within 1e-4 of the port's plain
    one-process run over the same global batches.  Not 1e-5 there: one
    process's batch-40 mean gradient and two ranks' summed batch-20
    means round differently, and Adam's division by sqrt(nu) enlarges
    the difference where gradients are small (4.2e-5 of the scale at
    W1 after 10 steps)."""
    cfg = tconfig.Config(**dict(ADAM_KW, fast_loop=False), device="cpu",
                         checkpoint_dir=str(tmp_path / "plain"))
    data = tmnist.synthesize_dataset(seed=0, **SIZES)
    with np.load(runs["inits"]["mlp"]) as z:
        init_np = {k: z[k] for k in z.files}

    def init(spec, optimizer, seed=1, device=None):
        params = convert.mlp_params_from_numpy(init_np, spec, device="cpu")
        return tstate.TrainState(torch.zeros((), dtype=torch.int32), params,
                                 optimizer.init(params))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tloop, "load_datasets", lambda *a, **k: data)
        mp.setattr(tloop, "create_train_state", init)
        tloop.run(cfg)
    plain = npz(latest_npz(tmp_path / "plain"))
    zero = npz(latest_npz(runs["tmp"] / "torch_zero"))
    two = npz(latest_npz(runs["tmp"] / "torch_plain_host"))
    for k in [k for k in plain if k.startswith(".params")]:
        np.testing.assert_array_equal(zero[k], two[k], err_msg=k)
        close(zero[k], plain[k], 1e-4, k)
    # the slots: ZeRO's [dp, chunk] rows are the plain run's, flattened
    # and zero-padded
    for k in [k for k in plain if k.startswith(".opt_state/mu")]:
        flat = np.zeros(zero[k].size, np.float32)
        flat[:two[k].size] = two[k].reshape(-1)
        np.testing.assert_array_equal(zero[k].reshape(-1), flat, err_msg=k)
        assert not zero[k].reshape(-1)[plain[k].size:].any()


def test_zero_initial_slot_rows_are_jax_zero_opt_state_rows():
    """Each rank's ``zero_opt_state`` (Adam, dp=3: padded chunks) is
    bitwise row r of JAX's ``[dp, chunk]`` slots, dtype included (bf16
    moments too); the count stays a scalar."""
    jcfg = jconfig.Config(**dict(ADAM_KW, hidden_sizes=(13,)))
    jspec = jloop.make_spec(jcfg)
    mesh = jmesh.build_mesh(3, 1, devices=jax.devices()[:3])
    for moments in ("float32", "bfloat16"):
        opt = joptim.make_optimizer(
            jconfig.Config(**dict(ADAM_KW, adam_moments_dtype=moments)))
        params = jstate.create_train_state(jax.random.PRNGKey(5), jspec,
                                           opt).params
        j_state, _ = jzero.zero_opt_state(
            opt, params, jmesh.param_pspecs(jspec, 1), mesh, 3)
        tcfg = tconfig.Config(**dict(ADAM_KW, hidden_sizes=(13,),
                                     adam_moments_dtype=moments))
        topt = toptim.make_optimizer(tcfg)
        tparams = convert.mlp_params_from_numpy(
            {k: np.asarray(v) for k, v in params.items()},
            tloop.make_spec(tcfg), device="cpu")
        for r in range(3):
            t_state = tzero.zero_opt_state(topt, tparams, 3)
            assert t_state["count"].shape == ()
            for slot in ("mu", "nu"):
                for k, jv in j_state[slot].items():
                    jrow = np.asarray(jax.device_get(jv))[r]
                    trow = t_state[slot][k]
                    assert tuple(trow.shape) == jrow.shape, k
                    assert str(trow.dtype).split(".")[-1] == \
                        jrow.dtype.name, k
                    np.testing.assert_array_equal(
                        trow.to(torch.float32).numpy(),
                        jrow.astype(np.float32))


def test_zero_checkpoints_cross_both_ways(runs):
    """JAX's dp=2 ZeRO-1 checkpoint, restored in the port's two ranks
    and re-saved with no epoch left, is bitwise the one JAX wrote; the
    port's, restored in JAX and re-saved, bitwise the port's."""
    tmp = runs["tmp"]
    _port_ok(runs, "ckpt_from_jax_zero")
    for src, dst in (("jax_zero", "ckpt_from_jax_zero"),
                     ("torch_zero", "ckpt_from_torch_zero")):
        a, b = npz(latest_npz(tmp / src)), npz(latest_npz(tmp / dst))
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{src} {k}")
        assert int(a["__x_zero_dp__"]) == 2


def test_zero_dp_mismatch_raises_jax_message(runs, tmp_path):
    """Resuming a dp=2 ZeRO-1 checkpoint without --zero_opt raises the
    message JAX raises (the same checkpoint path in both)."""
    d = str(tmp_path / "ck")
    _copy_ckpt(runs["tmp"] / "torch_zero", d)
    kw = dict(ADAM_KW, fast_loop=False, resume="latest", checkpoint_dir=d)
    with pytest.raises(ValueError) as j_err:
        run_jax(jconfig.Config(**kw, data_parallel=1, compilation_cache=""),
                SIZES)
    data = tmnist.synthesize_dataset(seed=0, **SIZES)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tloop, "load_datasets", lambda *a, **k: data)
        with pytest.raises(ValueError) as t_err:
            tloop.run(tconfig.Config(**kw, device="cpu"))
    assert str(t_err.value) == str(j_err.value)
    assert "zero_dp=2" in str(t_err.value)


def test_shard_state_host_matches_jax():
    """``shard_state_host`` on the same numpy Adam state (dp=3, so every
    leaf pads) is bitwise JAX's, integer leaves replicated; each rank's
    row is 1/dp of every float leaf; ``unshard_state_host`` inverts it
    bitwise."""
    jcfg = jconfig.Config(**dict(ADAM_KW, hidden_sizes=(13,)))
    jspec = jloop.make_spec(jcfg)
    opt = joptim.make_optimizer(jcfg)
    j_full = jax.tree.map(np.asarray, jstate.create_train_state(
        jax.random.PRNGKey(5), jspec, opt))
    rng = np.random.RandomState(0)
    j_full = jstate.TrainState(
        step=np.asarray(7, np.int32), params=j_full.params,
        opt_state={"count": np.asarray(7, np.int32),
                   "mu": {k: rng.randn(*v.shape).astype(np.float32)
                          for k, v in j_full.params.items()},
                   "nu": {k: rng.rand(*v.shape).astype(np.float32)
                          for k, v in j_full.params.items()}})
    t_full = tstate.TrainState(
        torch.tensor(7, dtype=torch.int32),
        {k: torch.from_numpy(np.array(v)) for k, v in j_full.params.items()},
        {"count": torch.tensor(7, dtype=torch.int32),
         "mu": {k: torch.from_numpy(v.copy())
                for k, v in j_full.opt_state["mu"].items()},
         "nu": {k: torch.from_numpy(v.copy())
                for k, v in j_full.opt_state["nu"].items()}})
    j_sh = jfsdp.shard_state_host(j_full, 3)
    t_sh = tfsdp.shard_state_host(t_full, 3)
    j_flat = dict(jckpt._flatten_with_keys(j_sh))
    t_flat = tckpt.flatten_state(t_sh)
    assert sorted(j_flat) == sorted(t_flat)
    for k, jv in j_flat.items():
        np.testing.assert_array_equal(t_flat[k].numpy(), np.asarray(jv),
                                      err_msg=k)
    for r in range(3):
        rows = tckpt.flatten_state(tfsdp.local_rows(t_sh, r))
        full = tckpt.flatten_state(t_full)
        for k, v in rows.items():
            if full[k].dim():
                assert v.numel() == -(-full[k].numel() // 3), k
            else:
                assert v.shape == () and int(v) == 7, k
    back = tckpt.flatten_state(tfsdp.unshard_state_host(t_sh, t_full))
    for k, v in tckpt.flatten_state(t_full).items():
        assert torch.equal(back[k], v), k


def test_fsdp_sharded_checkpoint_rows_and_restore_from_jax(runs):
    """Under --sharded_checkpoints each of the two ranks writes row r of
    every float leaf ([1, chunk] at bounds [[r, r+1], [0, chunk]]), the
    integer leaves on rank 0 only; JAX's 2-device FSDP checkpoint,
    restored in the port's ranks and re-saved, reassembles bitwise."""
    tmp = runs["tmp"]
    d = tmp / "torch_fsdp_host"
    ck = os.path.join(d, sorted(os.listdir(d))[-1])
    parts = [npz(os.path.join(ck, f"proc-{r:05d}.npz")) for r in range(2)]
    full = _arrays(ck)
    for k, v in full.items():
        if v.ndim == 2:         # [dp, chunk] float leaves
            for r in range(2):
                np.testing.assert_array_equal(parts[r][f"{k}§0§idx"],
                                              [[r, r + 1], [0, v.shape[1]]])
                assert parts[r][f"{k}§0"].shape == (1, v.shape[1])
        else:
            assert f"{k}§0" in parts[0] and f"{k}§0" not in parts[1], k
    _port_ok(runs, "ckpt_from_jax_fsdp")
    a = _arrays(os.path.join(tmp / "jax_fsdp_host",
                             sorted(os.listdir(tmp / "jax_fsdp_host"))[-1]))
    b = _arrays(os.path.join(tmp / "ckpt_from_jax_fsdp",
                             sorted(os.listdir(tmp / "ckpt_from_jax_fsdp"))[-1]))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_fsdp_two_rank_checkpoint_resumes_at_one_rank_in_both(runs,
                                                              tmp_path):
    """The port's 2-rank sharded FSDP checkpoint resumed at one process
    (dp=1: unsharded, re-sharded) for one more epoch, in the port and in
    JAX: the same printed costs, final params within 1e-5."""
    kw = dict(RUNS["fsdp_host"][0], training_epochs=2, resume="latest")
    out = {}
    for side in ("jax", "torch"):
        d = str(tmp_path / side)
        _copy_ckpt(runs["tmp"] / "torch_fsdp_host", d)
        if side == "jax":
            out[side] = run_jax(jconfig.Config(
                **kw, data_parallel=1, compilation_cache="",
                checkpoint_dir=d), SIZES)[0]
        else:
            data = tmnist.synthesize_dataset(seed=0, **SIZES)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tloop, "load_datasets", lambda *a, **k: data)
                import contextlib
                import io
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    tloop.run(tconfig.Config(**kw, device="cpu",
                                             checkpoint_dir=d))
                out[side] = buf.getvalue()
    assert "Resumed from" in out["torch"]
    tc, jc = costs(out["torch"]), costs(out["jax"])
    assert len(tc) == len(jc) >= 3
    assert np.allclose(tc, jc, rtol=0, atol=1e-4), (tc, jc)
    ja = _arrays(os.path.join(tmp_path / "jax", sorted(os.listdir(
        tmp_path / "jax"))[-1]))
    ta = _arrays(os.path.join(tmp_path / "torch", sorted(os.listdir(
        tmp_path / "torch"))[-1]))
    for k in ja:
        assert ta[k].shape == ja[k].shape, k
        if ja[k].dtype.kind == "f":
            close(ta[k], ja[k], 1e-5, k)


# every strategy combination the JAX trainer refuses (its run's checks
# and validate_resilience_config's --fsdp cases)
REFUSED = [
    dict(fsdp=True, sync_period=2),
    dict(zero_opt=True, fsdp=True),
    dict(zero_opt=True, sync_period=2),
    dict(model="transformer", dropout_rate=0.1, sync_period=2),
    dict(histograms=True, fsdp=True),
    dict(histograms=True, sync_period=2),
    dict(on_anomaly="skip", fsdp=True),
    dict(on_anomaly="skip", sync_period=2),
    dict(grad_accum=2, fsdp=True),
    dict(grad_accum=2, sync_period=2),
    dict(ckpt_every=2, checkpoint_dir="/tmp/x", fsdp=True),
    dict(resume="auto", fsdp=True),
]


@pytest.mark.parametrize("kw", REFUSED)
def test_strategy_matrix_refused_with_jax_message(kw):
    """Each combination raises ValueError with the JAX trainer's
    message, before any training, in both packages."""
    with pytest.raises(ValueError) as j_err:
        jloop.run(jconfig.Config(**kw))
    with pytest.raises(ValueError) as t_err:
        tloop.run(tconfig.Config(**kw, device="cpu"))
    assert str(t_err.value) == str(j_err.value)


def test_data_parallel_layout_errors():
    """-1 takes the world; above it JAX's message; below it the port's
    own (a rank cannot sit out the collectives); the rows of each rank."""
    assert tmesh.build_mesh(-1, world=4, rank=2) == tmesh.Mesh(dp=4, rank=2)
    with pytest.raises(ValueError) as e:
        tmesh.build_mesh(3, world=2)
    with pytest.raises(ValueError) as j:
        jmesh.build_mesh(3, 1, devices=jax.devices()[:2])
    assert str(e.value) == str(j.value) == "mesh 3x1 needs 3 devices, have 2"
    with pytest.raises(ValueError, match="must be -1 or the world size 4"):
        tmesh.build_mesh(2, world=4)
    mesh = tmesh.build_mesh(-1, model_parallel=2, world=4, rank=3)
    assert (mesh.dp, mesh.mp, mesh.data_index, mesh.model_index) == (
        2, 2, 1, 1)
    with pytest.raises(ValueError) as e:
        tmesh.build_mesh(-1, model_parallel=3, world=4)
    with pytest.raises(ValueError) as j:
        jmesh.build_mesh(-1, 3, devices=jax.devices()[:4])
    assert str(e.value) == str(j.value) == (
        "model_parallel=3 must divide device count 4")
    mesh = tmesh.build_mesh(-1, world=4, rank=1)
    assert tmesh.batch_layout(mesh, 40) == slice(10, 20)
    assert tmesh.layer_styles(tloop.make_spec(tconfig.Config(
        hidden_sizes=(8, 8)))) == ["rep"] * 3


def test_hard_sync_returns_on_cpu_leaves():
    """``hard_sync`` over CPU tensors (nested, with non-tensor leaves)
    returns at once and leaves them as they were."""
    tree = {"a": torch.ones(3), "b": (torch.zeros(2, 2), 5), "c": None}
    assert hard_sync(tree) is None
    assert torch.equal(tree["a"], torch.ones(3))

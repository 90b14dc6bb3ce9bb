"""FSDP x TP, ZeRO-1 x TP and the checkpoints of tensor parallelism in
the port against the JAX package, on the CPU.

- ``shard_state_host``/``unshard_state_host`` at dp 2 x mp 2 bitwise
  equal to JAX's on the same numpy Adam state (the ``[mp, dp, chunk]``
  layout), each rank's ``local_rows`` its ``[m, d]`` row;
- four gloo ranks (``OMP_NUM_THREADS=1``, one launch; the rank script of
  ``tests/test_torch_tensor_parallel.py``) at dp 2 x mp 2 against JAX's
  ``--data_parallel=2 --model_parallel=2`` runs: ``--fsdp`` on the fast
  path and ``--zero_opt`` (the host path), both under
  ``--sharded_checkpoints`` (one rank a distinct block writes it: the
  split params, the ``[mp, dp, chunk]`` and ``[dp, chunk]`` slots), and
  the plain TP step on the host path under ``--metrics``;
- the checkpoints crossing: JAX's FSDP x TP and ZeRO-1 x TP checkpoints
  restored in the ranks and re-saved (bitwise JAX's), the port's in
  JAX; the port's sharded FSDP x TP checkpoint resumed at dp 2 x mp 1 in
  two ranks and in JAX (the same next epoch), and its TP run's
  single-file checkpoint and resilience store (``--ckpt_every``; JAX's
  global layout: the split leaves whole) resumed at mp 1 the same way;
- the metrics rows' ``devices`` and MFU divide by dp x mp;
- the refusals with JAX's messages: ``--sync_period=2`` and ``--fp8_ffn``
  under ``--model_parallel=2``, n_heads or d_ff not divisible by it.

Tolerances (f32, sums in other orders): params and slots within 1e-5
of their scale after a run (the MLP under Adam, whose biases carry real
gradients), printed costs within 1e-4, test accuracies equal;
re-saved checkpoints bitwise.
"""

import json
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.parallel import fsdp as jfsdp
from distributed_tensorflow_example_tpu.parallel import mesh as jmesh
from distributed_tensorflow_example_tpu.train import loop as jloop
from distributed_tensorflow_example_tpu.train import optim as joptim
from distributed_tensorflow_example_tpu.train import state as jstate
from distributed_tensorflow_example_tpu.utils import checkpoint as jckpt
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch.parallel import fsdp as tfsdp
from distributed_tensorflow_example_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_example_tpu_torch.train import loop as tloop
from distributed_tensorflow_example_tpu_torch.train import optim as toptim
from distributed_tensorflow_example_tpu_torch.train import state as tstate
from distributed_tensorflow_example_tpu_torch.utils import checkpoint as tckpt
from test_torch_data_parallel import costs, run_jax, save_init
from test_torch_sharded_state import _arrays, _copy_ckpt
from test_torch_tensor_parallel import TFM_KW, close, launch

# one intra-op thread: the suite runs six test workers (and the rank
# processes) on the machine's cores, where torch would start one a core
torch.set_num_threads(1)

SIZES = dict(train_size=64, test_size=16, input_size=784)
KW = dict(dataset="synthetic", batch_size=16, hidden_sizes=(16, 16),
          learning_rate=0.01, optimizer="adam", frequency=2,
          summaries=False, training_epochs=1, seed=5)
PEAK = 1e9
# dp 2 x mp 2: name -> flags
RUNS = {
    "fsdp": dict(KW, fsdp=True, sharded_checkpoints=True),
    "zero": dict(KW, zero_opt=True, fast_loop=False,
                 sharded_checkpoints=True),
    "tp": dict(KW, fast_loop=False, ckpt_every=2, checkpoint_every=4),
}
RTOL = 1e-5


def _latest(ckpt_dir) -> str:
    names = sorted(n for n in os.listdir(ckpt_dir) if n.startswith("ckpt-"))
    return os.path.join(str(ckpt_dir), names[-1])


def _final(ckpt_dir) -> dict:
    """The newest state a run left in ``ckpt_dir``: its classic
    checkpoint, or the newest snapshot of its resilience store."""
    if any(n.startswith("ckpt-") for n in os.listdir(ckpt_dir)):
        return _arrays(_latest(ckpt_dir))
    from distributed_tensorflow_example_tpu_torch.resilience import (
        resume as tresume)

    _plan, flat = tresume.auto_resume(str(ckpt_dir))
    return {k: np.asarray(v) for k, v in flat.items()}


@pytest.fixture(scope="module")
def st(tmp_path_factory):
    """The port's four ranks: the dp 2 x mp 2 runs, two 2-rank worlds
    resuming the port's FSDP and TP checkpoints at mp 1, and restores of
    JAX's FSDP and ZeRO checkpoints; meanwhile JAX's dp 2 x mp 2 runs;
    then JAX restoring and resuming the port's."""
    tmp = tmp_path_factory.mktemp("tp_state")
    init = str(tmp / "init.npz")
    save_init(jconfig.Config(**KW), init)
    jax_runs = {}
    ready = str(tmp / "jax_ready")

    def jax_side():
        for name, kw in RUNS.items():
            jcfg = jconfig.Config(**kw, data_parallel=2, model_parallel=2,
                                  compilation_cache="",
                                  checkpoint_dir=str(tmp / f"jax_{name}"))
            jax_runs[name] = run_jax(jcfg, SIZES) + (jcfg,)
        for name in ("fsdp", "zero"):
            _copy_ckpt(tmp / f"jax_{name}", tmp / f"from_jax_{name}")
        open(ready, "w").close()

    def job(name, kw, **extra):
        return dict(name=name, init=init, sizes=SIZES,
                    cfg=dict(kw, **extra))

    four = [job(name, kw, data_parallel=2, model_parallel=2,
                checkpoint_dir=str(tmp / f"torch_{name}"))
            for name, kw in RUNS.items()]
    four[-1]["cfg"].update(metrics=True, log_every=2,
                           logs_path=str(tmp / "logs_tp"))
    four[-1]["peak"] = PEAK
    # the last phase restores JAX's checkpoints, once JAX wrote them
    restores = [job(f"restore_{name}", RUNS[name], data_parallel=2,
                    model_parallel=2, resume=True,
                    checkpoint_dir=str(tmp / f"from_jax_{name}"))
                for name in ("fsdp", "zero")]
    restores[0]["wait_for"] = ready
    # the second phase resumes what the first wrote: its dirs are copies
    # the fixture makes between the phases (the rank script's first
    # phase ends before the second begins)
    # name: (the run it resumes, --resume): bare --resume reads the
    # newest classic checkpoint (FSDP's sharded one, TP's single file),
    # --resume=auto the TP run's resilience store
    resume = {"fsdp_mp1": ("fsdp", True), "tp_file_mp1": ("tp", True),
              "tp_mp1": ("tp", "auto")}
    two = {n: job(n, RUNS[src], data_parallel=2, model_parallel=1,
                  resume=how, training_epochs=2,
                  checkpoint_dir=str(tmp / f"torch_{n}"))
           for n, (src, how) in resume.items()}
    for n, (src, _how) in resume.items():
        two[n]["copy_from"] = [str(tmp / f"torch_{src}"),
                               str(tmp / f"torch_{n}")]
    plan = dict(out=str(tmp / "out"), phases=[
        [dict(ranks=[0, 1, 2, 3], jobs=four)],
        [dict(ranks=[0, 1], jobs=[two["fsdp_mp1"], two["tp_file_mp1"]]),
         dict(ranks=[2, 3], jobs=[two["tp_mp1"]])],
        [dict(ranks=[0, 1, 2, 3], jobs=restores)]])
    port = launch(plan, tmp, meanwhile=jax_side)
    # JAX restoring the port's: ZeRO and FSDP re-saved (no epoch left),
    # the FSDP and TP ones resumed at mp 1 for one more epoch
    for name in ("fsdp", "zero"):
        _copy_ckpt(tmp / f"torch_{name}", tmp / f"jrestore_{name}")
        jcfg = jconfig.Config(**RUNS[name], data_parallel=2,
                              model_parallel=2, compilation_cache="",
                              resume=True,
                              checkpoint_dir=str(tmp / f"jrestore_{name}"))
        jax_runs[f"restore_{name}"] = run_jax(jcfg, SIZES) + (jcfg,)
    for n, (src, how) in resume.items():
        shutil.copytree(tmp / f"torch_{src}", tmp / f"j{n}")
        jcfg = jconfig.Config(**dict(RUNS[src], training_epochs=2),
                              data_parallel=2, model_parallel=1,
                              compilation_cache="", resume=how,
                              checkpoint_dir=str(tmp / f"j{n}"))
        jax_runs[n] = run_jax(jcfg, SIZES) + (jcfg,)
    return dict(port=port, jax=jax_runs, tmp=tmp)


def _ok(st, name, world=4):
    for r in range(world):
        assert st["port"][name, r]["error"] is None, st["port"][name, r]
    return st["port"][name, 0]


def _params(path) -> dict:
    return {k: v for k, v in _arrays(path).items()
            if k.startswith(".params/")}


def _adam_state(spec_kw, mp):
    """A numpy Adam state of the MLP and the transformer after one
    update of random gradients (every slot nonzero), JAX's spec and the
    TP specs at ``mp``."""
    jcfg = jconfig.Config(**spec_kw)
    jspec = jloop.make_spec(jcfg)
    jopt = joptim.make_optimizer(jcfg)
    state = jstate.create_train_state(jax.random.PRNGKey(0), jspec, jopt)
    rng = np.random.RandomState(1)
    grads = {k: rng.randn(*np.shape(v)).astype(np.float32)
             for k, v in state.params.items()}
    new_p, new_o = jopt.update(grads, state.opt_state, state.params)
    full = jax.tree.map(np.asarray, jstate.TrainState(state.step, new_p,
                                                      new_o))
    return full, jspec, jmesh.state_pspecs(jspec, jopt, mp)


@pytest.mark.parametrize("spec_kw", [dict(KW, hidden_sizes=(16, 13)),
                                     dict(TFM_KW, optimizer="adam")],
                         ids=["mlp", "transformer"])
def test_fsdp_tp_layout_bitwise_jax(spec_kw):
    """``shard_state_host`` at dp 2 x mp 2 (the model shards of each
    float leaf flattened, padded and stacked ``[mp, dp, chunk]``, the
    replicated leaves duplicated) bitwise JAX's; ``unshard_state_host``
    inverts it; ``local_rows`` gives rank (d, m) row ``[m, d]``."""
    full, jspec, tp_specs = _adam_state(spec_kw, 2)
    j_sh = jfsdp.shard_state_host(full, 2, 2, tp_specs)
    tspec = tloop.make_spec(tconfig.Config(**spec_kw))
    dims = tmesh.state_pspecs(tmesh.param_pspecs(tspec, 2))
    topt = toptim.make_optimizer(tconfig.Config(**spec_kw))
    t_full = tckpt.rebuild_tree_validated(
        {k: torch.from_numpy(np.array(v))
         for k, v in dict(jckpt._flatten_with_keys(full)).items()},
        tstate.create_train_state(tspec, topt, device="cpu"))
    t_sh = tfsdp.shard_state_host(t_full, 2, 2, dims)
    j_flat = dict(jckpt._flatten_with_keys(j_sh))
    t_flat = tckpt.flatten_state(t_sh)
    assert sorted(j_flat) == sorted(t_flat)
    for k in j_flat:
        np.testing.assert_array_equal(t_flat[k].numpy(),
                                      np.asarray(j_flat[k]), err_msg=k)
    for d in range(2):
        for m in range(2):
            rows = tckpt.flatten_state(tfsdp.local_rows(t_sh, d, m, 2))
            for k, v in rows.items():
                want = np.asarray(j_flat[k])
                want = want[m, d] if want.ndim == 3 else want
                np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
    back = tckpt.flatten_state(tfsdp.unshard_state_host(
        t_sh, t_full, 2, dims))
    for k, v in dict(jckpt._flatten_with_keys(full)).items():
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(v),
                                      err_msg=k)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_dp2_mp2_strategies_equal_jax(st, name):
    """FSDP x TP (fast path), ZeRO-1 x TP and plain TP (host path) at dp
    2 x mp 2: JAX's costs, test accuracy, path and devices; the final
    checkpoint's leaves (the ZeRO slots in JAX's layout, FSDP's
    reassembled from its shards) within 1e-5 of JAX's."""
    j_out, j_res, jcfg = st["jax"][name]
    chief = _ok(st, name)
    t_res = chief["result"]
    for k in ("fast_loop", "steps", "devices", "global_batch"):
        assert t_res[k] == j_res[k], k
    assert t_res["devices"] == 4
    assert t_res["fast_loop"] is (name == "fsdp")
    jc, tc = costs(j_out), costs(chief["stdout"])
    assert len(tc) == len(jc) >= 2
    assert np.allclose(tc, jc, rtol=0, atol=1e-4), (tc, jc)
    assert t_res["test_accuracy"] == j_res["test_accuracy"]
    t = _final(st["tmp"] / f"torch_{name}")
    j = _final(jcfg.checkpoint_dir)
    assert sorted(t) == sorted(j)
    for k in j:
        assert tuple(t[k].shape) == tuple(np.shape(j[k])), k
        if k.startswith((".params/", ".opt_state/")) and np.ndim(j[k]):
            close(np.asarray(t[k], np.float32), j[k], RTOL, 0, k)
    if name == "zero":
        # JAX's slot layout: [mp, dp, chunk] for a split leaf, [dp,
        # chunk] for one replicated over 'model' (W3/b3, b2)
        assert np.shape(t[".opt_state/mu/W1"])[:2] == (2, 2)
        assert np.shape(t[".opt_state/mu/b2"])[0] == 2
        assert np.ndim(t[".opt_state/mu/b2"]) == 2


@pytest.mark.parametrize("name", ["fsdp", "zero"])
def test_jax_checkpoints_restore_in_the_ranks_bitwise(st, name):
    """JAX's dp 2 x mp 2 FSDP (sharded) and ZeRO-1 checkpoints restored
    by the ranks (no epoch left) and re-saved: bitwise JAX's; and JAX
    restores the port's, re-saving it bitwise."""
    _ok(st, f"restore_{name}")
    mine = _arrays(_latest(st["tmp"] / f"from_jax_{name}"))
    theirs = _arrays(_latest(st["jax"][name][2].checkpoint_dir))
    assert sorted(mine) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(np.asarray(mine[k]),
                                      np.asarray(theirs[k]), err_msg=k)
    j_again = _arrays(_latest(st["tmp"] / f"jrestore_{name}"))
    t_orig = _arrays(_latest(st["tmp"] / f"torch_{name}"))
    for k in t_orig:
        np.testing.assert_array_equal(np.asarray(j_again[k]),
                                      np.asarray(t_orig[k]), err_msg=k)


@pytest.mark.parametrize("name", ["fsdp_mp1", "tp_file_mp1", "tp_mp1"])
def test_tp_checkpoints_resume_at_mp1_as_in_jax(st, name):
    """The port's sharded FSDP x TP checkpoint (``fsdp_mp`` 2), its
    single-file TP checkpoint and the resilience store of its TP run
    (``--resume=auto``; both in the full layout) resume at dp 2 x mp 1
    in two ranks and in JAX: the same second epoch, its costs within
    1e-4 and its final params within 1e-5."""
    j_out, j_res, jcfg = st["jax"][name]
    chief = _ok(st, name, world=2)
    resumed = {"fsdp_mp1": ".shards", "tp_file_mp1": ".npz",
               "tp_mp1": "snap-"}[name]
    assert re.search(r"^Resumed from \S*" + re.escape(resumed),
                     chief["stdout"], flags=re.M), chief["stdout"]
    assert chief["result"]["steps"] == j_res["steps"] == 8
    jc, tc = costs(j_out), costs(chief["stdout"])
    assert len(tc) == len(jc) >= 2
    assert np.allclose(tc, jc, rtol=0, atol=1e-4), (tc, jc)
    tp = {k: v for k, v in _final(st["tmp"] / f"torch_{name}").items()
          if k.startswith(".params/")}
    jp = {k: v for k, v in _final(jcfg.checkpoint_dir).items()
          if k.startswith(".params/")}
    for k in jp:
        close(tp[k], jp[k], RTOL, 0, f"{name} {k}")


def test_fsdp_tp_sharded_checkpoint_records_mp(st):
    """The sharded FSDP x TP checkpoint says ``fsdp_mp`` 2 and holds
    ``[mp, dp, chunk]`` leaves, every rank writing its block."""
    path = _latest(st["tmp"] / "torch_fsdp")
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["extras"]["fsdp_mp"] == 2
    assert man["leaves"][".params/W1"]["shape"][:2] == [2, 2]
    assert len(man["files"]) == 4
    for i in range(4):
        with np.load(os.path.join(path, f"proc-{i:05d}.npz")) as z:
            assert any(e.startswith(".params/W1§") for e in z.files)


def test_metrics_rows_divide_by_dp_times_mp(st):
    """Under ``--metrics`` at dp 2 x mp 2 (the card's peak stubbed) every
    window row's MFU is its model FLOP/s over the peak of four devices,
    and the result's ``devices`` is 4."""
    chief = _ok(st, "tp")
    assert chief["result"]["devices"] == 4
    rows = [json.loads(line) for line in open(
        st["tmp"] / "logs_tp" / "metrics.0.jsonl")]
    windows = [r for r in rows if r.get("kind", r.get("type")) == "window"
               or "mfu" in r]
    assert windows
    for r in windows:
        assert r["mfu"] is not None
        want = r["model_flops_per_step"] * (
            r["examples_per_sec"] / 16) / (PEAK * 4)
        assert abs(r["mfu"] - want) <= 2e-6 + 1e-3 * want, (r, want)


@pytest.mark.parametrize("extra,mp", [
    (dict(sync_period=2), 2),
    (dict(model="transformer", fp8_ffn=True), 2),
    (dict(model="transformer", n_heads=3, d_model=24), 2),
    (dict(model="transformer", d_ff=66), 4)])
def test_tp_refusals_carry_jax_messages(extra, mp):
    """Each raises ValueError before training, with JAX's message, in
    both packages."""
    kw = dict(KW, **extra, model_parallel=mp)
    with pytest.raises(ValueError) as j_err:
        jloop.run(jconfig.Config(**kw, compilation_cache=""))
    with pytest.raises(ValueError) as t_err:
        tloop.run(tconfig.Config(**kw, device="cpu"))
    assert str(t_err.value) == str(j_err.value)


def test_zero_slot_layout_is_jax_for_every_leaf():
    """ZeRO-1 x TP's slots for the MLP at dp 2 x mp 2: JAX's
    ``zero_opt_state`` shapes (``[mp, dp, chunk]`` of the local size for
    a split leaf, ``[dp, chunk]`` for a replicated one) are the global
    shapes of the port's blocks."""
    from distributed_tensorflow_example_tpu.parallel import zero as jzero

    jcfg = jconfig.Config(**KW)
    jspec = jloop.make_spec(jcfg)
    jopt = joptim.make_optimizer(jcfg)
    params = jstate.create_train_state(jax.random.PRNGKey(0), jspec,
                                       jopt).params
    mesh = jmesh.build_mesh(2, 2, devices=jax.devices()[:4])
    j_state, _ = jzero.zero_opt_state(
        jopt, params, jmesh.param_pspecs(jspec, 2), mesh, 2)
    tcfg = tconfig.Config(**KW, zero_opt=True, fast_loop=False,
                          model_parallel=2, data_parallel=2)
    tspec = tloop.make_spec(tcfg)
    topt = toptim.make_optimizer(tcfg)
    for r in range(4):
        tm = tmesh.build_mesh(2, 2, world=4, rank=r)
        t_state = tloop.create_train_state(tspec, topt, seed=0,
                                           device="cpu")
        strat = tloop.setup_strategy(tcfg, tspec, topt, t_state, tm,
                                     fast=False)
        flat = tckpt.flatten_state(strat.state)
        for k, v in dict(jckpt._flatten_with_keys(jstate.TrainState(
                0, params, j_state))).items():
            if not k.startswith(".opt_state") or not np.ndim(v):
                continue
            b = strat.layout.block(k, flat[k])
            assert strat.layout.global_shape(b, flat[k].shape) == list(
                np.shape(v)), k

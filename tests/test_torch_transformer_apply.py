"""The port's transformer forward (``apply``) against the JAX package's,
on the CPU: classify and lm, dense and flash attention, with and without
the fused LayerNorms, at 2 blocks, d_model 32, 2 heads, d_ff 64 and
S 256.  Params come from the JAX package's seeded init, carried across
with ``convert.params_from_numpy``.  The JAX side runs its Pallas
kernels in interpret mode.  f32 throughout: the sides sum in other
orders, so logits agree within 1e-5 of their scale.

Also here: the attention dispatch on ``spec.attention`` (the flash
kernels are reached under ``attention="flash"``), dropout's own
properties (JAX's bits cannot be reproduced), the trainer's refusals of
the transformer flags it has not ported, ``num_params`` and
``flops_per_step`` at the ``transformer_wide_long`` width, and the
serving engine under a flash spec (``--pallas``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.models import transformer as jtfm
from distributed_tensorflow_example_tpu.serving.engine import (
    DecodeEngine as JaxEngine)
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch import main as tmain
from distributed_tensorflow_example_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_example_tpu_torch.ops import flash_attention as tfa
from distributed_tensorflow_example_tpu_torch.serving import cli as tcli
from distributed_tensorflow_example_tpu_torch.serving.engine import (
    DecodeEngine)

# one intra-op thread: the suite runs six test workers (and the rank
# processes) on the machine's cores, where torch would start one a core
torch.set_num_threads(1)

TOL = 1e-5
_SIZES = dict(num_classes=10, d_model=32, n_heads=2, num_blocks=2,
              d_ff=64, vocab_size=32)
_OBJECTIVES = {
    "classify": dict(input_size=512, seq_len=256, objective="classify",
                     causal=False),
    "lm": dict(input_size=256, seq_len=256, objective="lm", causal=True),
}


def _pair(**kw):
    jspec = jtfm.TransformerSpec(**kw)
    tspec = ttfm.TransformerSpec(**kw)
    jp = jtfm.init(jax.random.PRNGKey(0), jspec)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   tspec, device="cpu")
    return jspec, jp, tspec, tp


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} x {scale}"


@pytest.mark.parametrize("fused_ln", [False, True], ids=["ln", "fused_ln"])
@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("objective", sorted(_OBJECTIVES))
def test_apply_matches_jax(objective, attention, fused_ln):
    kw = dict(_SIZES, **_OBJECTIVES[objective], attention=attention,
              fused_ln=fused_ln)
    jspec, jp, tspec, tp = _pair(**kw)
    x = np.random.RandomState(1).rand(2, kw["input_size"]).astype(
        np.float32)
    want = jax.jit(lambda p, xx: jtfm.apply(jspec, p, xx))(jp, x)
    got = ttfm.apply(tspec, tp, torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got.detach().numpy(), want, TOL, f"{objective} {attention}")
    logits, aux = ttfm.apply(tspec, tp, torch.from_numpy(x), with_aux=True)
    assert float(aux) == 0.0 and torch.equal(logits, got)


def test_block_forward_dispatches_on_spec_attention():
    """``attention="flash"`` reaches ``flash_attention`` (here through a
    counting sentinel around it); ``"dense"`` does not; an unknown
    backend raises.  The flash block output matches the JAX
    ``_block_forward`` under ``attention="flash"``."""
    kw = dict(_SIZES, **_OBJECTIVES["lm"], attention="flash")
    jspec, jp, tspec, tp = _pair(**kw)
    h = np.random.RandomState(2).randn(2, 256, 32).astype(np.float32)
    calls = []
    orig = tfa.flash_attention

    def sentinel(q, k, v, causal=False):
        calls.append(causal)
        return orig(q, k, v, causal)

    act = jax.nn.gelu
    bp_j = {k[3:]: v for k, v in jp.items() if k.startswith("L0_")}
    want, _ = jax.jit(lambda b, hh: jtfm._block_forward(
        jspec, b, hh, act, jnp.float32))(bp_j, h)
    bp_t = ttfm._block_params(tp, 0)
    tact = ttfm._ACTIVATIONS["gelu"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfa, "flash_attention", sentinel)
        got, _ = ttfm._block_forward(tspec, bp_t, torch.from_numpy(h),
                                     tact, torch.float32)
        assert calls == [True]
        ttfm._block_forward(dataclasses.replace(tspec, attention="dense"),
                            bp_t, torch.from_numpy(h), tact, torch.float32)
        assert calls == [True]
    _close(got.detach().numpy(), want, TOL, "block")
    with pytest.raises(ValueError, match="attention"):
        ttfm._block_forward(dataclasses.replace(tspec, attention="ring"),
                            bp_t, torch.from_numpy(h), tact, torch.float32)


def test_tokenize_matches_jax():
    spec_kw = dict(_SIZES, **_OBJECTIVES["lm"])
    x = np.random.RandomState(3).rand(3, 256).astype(np.float32)
    x[0, :4] = [0.0, 1.0, 0.5 / 31, 1.5 / 31]    # the ends and two ties
    want = np.asarray(jtfm.tokenize(jtfm.TransformerSpec(**spec_kw), x))
    got = ttfm.tokenize(ttfm.TransformerSpec(**spec_kw), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dropout_properties():
    """Eval (no rng) never drops; the kept share is near 1 - rate and
    kept values are scaled by 1/(1 - rate); the same (seed, site) gives
    the same mask, other seeds and other sites other masks; a forward
    with dropout differs from one without only through the masks."""
    spec = ttfm.TransformerSpec(**_SIZES, **_OBJECTIVES["lm"],
                                dropout_rate=0.25)
    h = torch.ones(64, 256)
    assert ttfm._dropout(h, spec, None, 0) is h
    a = ttfm._dropout(h, spec, 7, 1)
    kept = float((a != 0).float().mean())
    assert abs(kept - 0.75) < 0.01                 # 16k draws: ~7 sigma
    assert torch.all((a == 0) | (a == 1 / 0.75))
    assert torch.equal(a, ttfm._dropout(h, spec, 7, 1))
    assert not torch.equal(a, ttfm._dropout(h, spec, 7, 2))
    assert not torch.equal(a, ttfm._dropout(h, spec, 8, 1))
    params = ttfm.init(spec, seed=0, device="cpu")
    x = torch.rand(2, 256)
    plain = ttfm.apply(dataclasses.replace(spec, dropout_rate=0.0),
                       params, x)
    torch.testing.assert_close(ttfm.apply(spec, params, x), plain,
                               rtol=0, atol=0)
    dropped = ttfm.apply(spec, params, x, dropout_rng=5)
    assert not torch.allclose(dropped, plain)
    torch.testing.assert_close(ttfm.apply(spec, params, x, dropout_rng=5),
                               dropped, rtol=0, atol=0)


WIDE_LONG = dict(input_size=32768, seq_len=8192, d_model=1024, n_heads=8,
                 num_blocks=4, d_ff=4096, attention="flash", causal=True,
                 fused_ln=True)


def test_num_params_and_flops_match_jax_at_transformer_wide_long():
    """The bench configuration this slice trains: 58,790,922 params and
    35.19 TFLOP per step of batch 8 (JAX ``flops_per_step``)."""
    jspec = jtfm.TransformerSpec(**WIDE_LONG)
    tspec = ttfm.TransformerSpec(**WIDE_LONG)
    assert ttfm.num_params(tspec) == jtfm.num_params(jspec) == 58_790_922
    assert ttfm.flops_per_step(tspec, 8) == jtfm.flops_per_step(jspec, 8)
    assert round(ttfm.flops_per_step(tspec, 8) / 1e12, 2) == 35.19


@pytest.mark.parametrize("argv", [
    ["--expert_parallel=2"], ["--virtual_stages=2"], ["--pp_schedule=1f1b"],
    ["--mnist_mirrors=https://example.invalid/"],
    ["--model_parallel=2", "--pipeline_parallel=2"],
    ["--pipeline_parallel=2"],
    ["--sequence_parallel=2", "--num_experts=4", "--expert_parallel=2"]])
def test_cli_refuses_unported_transformer_flags(argv, capsys):
    """Each exits 2 before training: ``--mnist_mirrors`` with a message
    naming ROADMAP.md; the parallelism flags (``--sequence_parallel``,
    ``--sp_impl``, ``--expert_parallel``, ``--pipeline_parallel``,
    ``--virtual_stages``, ``--pp_schedule`` parse since their axes were
    ported) with JAX's messages: no MoE to shard, sequence parallelism
    beside the expert axis, virtual stages or 1F1B without stages, and a
    pipeline mesh larger than the one process."""
    try:
        rc = tmain.main(["--model=transformer", "--device", "cpu",
                         "--training_epochs=0"] + argv)
    except SystemExit as e:
        rc = e.code
    assert rc == 2
    want = ("--expert_parallel composes with data and tensor parallelism "
            "only" if "--sequence_parallel=2" in argv
            else "--expert_parallel requires --num_experts > 0"
            if "--expert_parallel=2" in argv
            else "--virtual_stages > 1 needs --pipeline_parallel > 1"
            if "--virtual_stages=2" in argv
            else "--pp_schedule=1f1b requires --pipeline_parallel > 1"
            if "--pp_schedule=1f1b" in argv
            else "mesh 1x2x2 over ('data', 'stage', 'model') needs 4 "
                 "devices, have 1" if "--model_parallel=2" in argv
            else "mesh 1x2 over ('data', 'stage') needs 2 devices, have 1"
            if "--pipeline_parallel=2" in argv else "ROADMAP")
    assert want in capsys.readouterr().err


def test_serving_spec_pallas_selects_flash_and_engine_matches_jax():
    """``--pallas`` (or ``--attention=flash``) gives the serving spec
    flash attention, as the JAX ``dtx-serve``; the port's engine on a
    flash spec is token-identical to the JAX engine on the same spec
    (both prefill and decode with dense attention)."""
    argv = ["--model=transformer", "--objective=lm", "--input_size=32",
            "--vocab_size=50", "--d_model=32", "--n_heads=2",
            "--num_blocks=2", "--d_ff=64"]
    assert tcli.spec_from_cfg(tconfig.parse_config(
        argv + ["--pallas"])).attention == "flash"
    assert tcli.spec_from_cfg(tconfig.parse_config(
        argv + ["--attention=flash"])).attention == "flash"
    assert tcli.spec_from_cfg(tconfig.parse_config(argv)).attention == \
        "dense"
    kw = dict(input_size=32, num_classes=10, seq_len=32, d_model=32,
              n_heads=2, num_blocks=2, d_ff=64, objective="lm",
              vocab_size=50, causal=True, attention="flash")
    jspec, jp, tspec, tp = _pair(**kw)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 50, size=n).tolist() for n in (5, 7, 3)]
    jeng = JaxEngine(jspec, jp, page_size=8, max_batch=2)
    teng = DecodeEngine(tspec, tp, page_size=8, max_batch=2, device="cpu")
    jr = [jeng.submit(p, 5) for p in prompts]
    tr = [teng.submit(p, 5) for p in prompts]
    jeng.run_until_idle()
    teng.run_until_idle()
    assert [teng.result(r)["tokens"] for r in tr] == \
        [jeng.result(r)["tokens"] for r in jr]

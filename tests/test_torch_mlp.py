"""The port's MLP, its losses and metrics, and the B1 wrapper
(``ops.fused.mlp_forward``) against the JAX package, on the CPU.

The same numpy inputs and the JAX package's own initial params (carried
across by ``convert.mlp_params_from_numpy``) go through the JAX function
and the port on ``device="cpu"``, where ``mlp_forward`` runs its plain
version; the JAX ``pallas_fused.mlp_forward`` runs its Pallas kernel in
interpret mode, as the JAX package's tests run it.  Tolerances:

- f32: the two sides sum the products in different orders, so 1e-5
  relative to the output's scale (gradients 1e-4, as in
  ``tests/test_pallas.py``);
- bf16: a hidden value whose two f32 pre-activations straddle a bf16
  rounding boundary lands one bf16 ulp (2^-8 relative) apart, and the
  next layer carries that on, so 1e-2 of the output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.models import mlp as jmlp
from distributed_tensorflow_example_tpu.ops import losses as jlosses
from distributed_tensorflow_example_tpu.ops import metrics as jmetrics
from distributed_tensorflow_example_tpu.ops import pallas_fused as jpf
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.models import mlp as tmlp
from distributed_tensorflow_example_tpu_torch.ops import fused
from distributed_tensorflow_example_tpu_torch.ops import losses as tlosses
from distributed_tensorflow_example_tpu_torch.ops import metrics as tmetrics

# one intra-op thread: the suite runs six test workers (and the rank
# processes) on the machine's cores, where torch would start one a core
torch.set_num_threads(1)

# (hidden sizes, activation, compute dtype name, relative tolerance)
CASES = {
    "sigmoid1_f32": ((24,), "sigmoid", "float32", 1e-5),
    "relu2_bf16": ((24, 20), "relu", "bfloat16", 1e-2),
}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _specs(case):
    hidden, act, cdt, _tol = CASES[case]
    jspec = jmlp.MLPSpec(input_size=40, hidden_sizes=hidden, num_classes=6,
                         activation=act, compute_dtype=jnp.dtype(cdt))
    tspec = tmlp.MLPSpec(input_size=40, hidden_sizes=hidden, num_classes=6,
                         activation=act, compute_dtype=TORCH_DT[cdt])
    return jspec, tspec


def _inputs(jspec, tspec, n=21, seed=0):
    jparams = jmlp.init(jax.random.PRNGKey(seed), jspec)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    tparams = convert.mlp_params_from_numpy(np_params, tspec, device="cpu")
    rng = np.random.RandomState(seed)
    x = rng.rand(n, jspec.input_size).astype(np.float32)
    y = np.eye(jspec.num_classes, dtype=np.float32)[
        rng.randint(0, jspec.num_classes, n)]
    return jparams, tparams, x, y


def _close(got, want, rtol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max |diff| {err} > {rtol} x {scale}"


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("case", CASES)
def test_apply_matches_jax(case):
    jspec, tspec = _specs(case)
    jparams, tparams, x, _ = _inputs(jspec, tspec)
    want = jax.jit(lambda p, xx: jmlp.apply(jspec, p, xx))(jparams, x)
    got = tmlp.apply(tspec, tparams, torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(_np(got), want, CASES[case][3], "logits")


@pytest.mark.parametrize("case", CASES)
def test_mlp_forward_matches_jax_pallas(case):
    """Logits and hiddens of the wrapper's plain version against the JAX
    Pallas kernel (interpret mode) and its residual outputs."""
    jspec, tspec = _specs(case)
    jparams, tparams, x, _ = _inputs(jspec, tspec)
    want_logits, want_hiddens = jpf._forward_pallas(jspec, jparams, x)
    got = fused.mlp_forward(tspec, tparams, torch.from_numpy(x))
    _close(_np(got), want_logits, CASES[case][3], "logits")
    ref_logits, ref_hiddens = fused.mlp_forward_reference(
        tspec, tparams, torch.from_numpy(x))
    assert torch.equal(ref_logits, got)
    assert len(ref_hiddens) == len(want_hiddens)
    for h, w in zip(ref_hiddens, want_hiddens):
        assert h.dtype == tspec.compute_dtype
        _close(_np(h), w, CASES[case][3], "hidden")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fwd", ["mlp_forward", "apply"])
def test_gradients_match_jax(case, fwd):
    """d(cross-entropy)/d(params, x) through the wrapper's autograd
    backward (the JAX ``_bwd``) and through the plain ``apply``, against
    ``jax.grad`` of the same JAX forward; f32 within 1e-4 of each
    gradient's scale, bf16 within 2e-2 (the bf16 rounding of the delta
    chain's matmul operands on top of the forward's)."""
    jspec, tspec = _specs(case)
    jparams, tparams, x, y = _inputs(jspec, tspec)
    tol = 1e-4 if CASES[case][2] == "float32" else 2e-2
    jfwd = (jpf.mlp_forward if fwd == "mlp_forward"
            else lambda s, p, xx: jmlp.apply(s, p, xx))
    tfwd = fused.mlp_forward if fwd == "mlp_forward" else tmlp.apply

    def jloss(p, xx):
        return jlosses.stable_cross_entropy(jfwd(jspec, p, xx), y)

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jparams, x)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tlosses.stable_cross_entropy(tfwd(tspec, leaves, tx),
                                 torch.from_numpy(y)).backward()
    for k in jg:
        assert leaves[k].grad.dtype == tspec.param_dtype
        _close(_np(leaves[k].grad), jg[k], tol, k)
    _close(_np(tx.grad), jgx, tol, "dx")


def test_init_is_seeded_and_counts_params():
    """N(0, 1) weights and zero biases in the param dtype, the JAX
    layout, the same bits for the same seed, the JAX parameter count."""
    spec = tmlp.MLPSpec(hidden_sizes=(64, 32), param_dtype=torch.bfloat16)
    a = tmlp.init(spec, seed=3, device="cpu")
    b = tmlp.init(spec, seed=3, device="cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == tmlp.param_shapes(
        spec)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(v.dtype == torch.bfloat16 for v in a.values())
    assert not any(a[k].any() for k in ("b1", "b2", "b3"))
    w = a["W1"].float()
    assert abs(float(w.mean())) < 0.02 and abs(float(w.std()) - 1) < 0.02
    jspec = jmlp.MLPSpec(hidden_sizes=(64, 32))
    assert tmlp.num_params(spec) == jmlp.num_params(jspec)
    assert not torch.equal(a["W1"], tmlp.init(spec, seed=4,
                                              device="cpu")["W1"])


def test_tensor_parallel_styles_are_refused():
    """Tensor-parallel styles reduce over the model group of
    ``parallel/mesh.build_mesh``: a JAX mesh axis name in its place is
    refused (the styles themselves run; ``tests/test_torch_tensor_
    parallel.py`` holds them against JAX)."""
    spec = tmlp.MLPSpec(input_size=4, hidden_sizes=(3,), num_classes=2)
    p = tmlp.init(spec, device="cpu")
    with pytest.raises(TypeError, match="process group"):
        tmlp.apply(spec, p, torch.zeros(2, 4), styles=("col", "row"),
                   model_axis="model")


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_losses_and_accuracy_match_jax(smoothing):
    """Stable and naive CE (with label smoothing) and accuracy, f32,
    within 1e-6 relative (one log-sum-exp in a different order)."""
    rng = np.random.RandomState(5)
    logits = (rng.randn(33, 10) * 4).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 33)]
    tl, ty = torch.from_numpy(logits), torch.from_numpy(y)
    for naive in (False, True):
        want = float(jlosses.cross_entropy(logits, y, naive=naive,
                                           label_smoothing=smoothing))
        got = float(tlosses.cross_entropy(tl, ty, naive=naive,
                                          label_smoothing=smoothing))
        assert got == pytest.approx(want, rel=1e-6)
    assert float(tmetrics.accuracy(tl, ty)) == float(
        jmetrics.accuracy(logits, y))


def test_mlp_params_from_numpy_checks_names_and_shapes():
    spec = tmlp.MLPSpec(input_size=4, hidden_sizes=(3,), num_classes=2)
    good = {k: np.zeros(s, np.float32)
            for k, s in tmlp.param_shapes(spec).items()}
    out = convert.mlp_params_from_numpy(good, spec, device="cpu")
    assert set(out) == {"W1", "b1", "W2", "b2"}
    with pytest.raises(ValueError, match="missing"):
        convert.mlp_params_from_numpy(
            {k: v for k, v in good.items() if k != "b2"}, spec, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.mlp_params_from_numpy(
            dict(good, W1=np.zeros((3, 4), np.float32)), spec, device="cpu")

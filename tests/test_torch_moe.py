"""The port's mixture of experts against the JAX package's, on the CPU.

B8's training form (``want_z1``) and the custom VJPs of
``moe_grouped_matmul`` / ``fp8_grouped_matmul`` / ``fp8_dense_ffn``
against ``jax.vjp`` of the JAX functions (their Pallas kernel in
interpret mode, as the JAX package's own tests run it); the router and
slotting (``_sparse_route``) with its integers held exactly; sparse
dispatch at ample capacity against dense dispatch; ``apply(with_aux=
True)`` for classify and lm with the einsum, grouped and fp8 expert
paths and dense dispatch, the routing of every block compared exactly
before the logits; ``num_params``/``flops_per_step`` at the ``moe_wide``
width.  Sizes: E 4, d_model 32, d_ff 64, 2 heads, 2 blocks, S 16,
batch 4; inputs from numpy seeds; params from the JAX package's init
(``convert.params_from_numpy``).

Tolerances: 1e-5 of each output's scale in f32 (the sides sum in other
orders) and 1e-2 in bf16 (a bf16 rounding of a hidden or of a backward
operand may land one ulp, 2^-8, apart where the f32 sums before it
differ); routing integers (``idx``, ``slot``, ``keep``) exactly, so a
flipped choice shows as a routing mismatch, not as a tolerance miss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.models import transformer as jtfm
from distributed_tensorflow_example_tpu.ops import pallas_fused as jpf
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_example_tpu_torch.ops import fused

TOL = {jnp.float32: 1e-5, jnp.bfloat16: 1e-2}
_TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
MOE = dict(num_classes=10, d_model=32, n_heads=2, num_blocks=2, d_ff=64,
           vocab_size=32, num_experts=4, moe_dispatch="alltoall",
           capacity_factor=1.25, moe_topk=2)
_OBJECTIVES = {
    "classify": dict(input_size=64, seq_len=16, objective="classify"),
    "lm": dict(input_size=16, seq_len=16, objective="lm", causal=True),
}


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} x {scale}"


def _ffn_inputs(seed, e, c, d, ff):
    rng = np.random.RandomState(seed)
    return (rng.randn(e, c, d).astype(np.float32),
            (rng.randn(e, d, ff) / np.sqrt(d)).astype(np.float32),
            (0.1 * rng.randn(e, ff)).astype(np.float32),
            (rng.randn(e, ff, d) / np.sqrt(ff)).astype(np.float32),
            (0.1 * rng.randn(e, d)).astype(np.float32))


# ---------------------------------------------------------------------------
# B8's training form and the VJPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cdt", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_grouped_z1_forward_matches_jax(cdt):
    """``moe_grouped_matmul_z1`` (out, z1) against the JAX
    ``_moe_grouped_forward(want_z1=True)`` (the Pallas kernel in
    interpret mode) at E 4 and a ragged C of 20."""
    args = _ffn_inputs(0, 4, 20, 32, 64)
    want_out, want_z1 = jax.jit(
        lambda *a: jpf._moe_grouped_forward("gelu", cdt, *a, want_z1=True)
    )(*map(jnp.asarray, args))
    out, z1 = fused.moe_grouped_matmul_z1(
        "gelu", _TORCH_DT[cdt], *map(torch.from_numpy, args))
    _close(_np(out), want_out, TOL[cdt], "out")
    # z1 is the f32 pre-activation of cdt-rounded operands: only the sum
    # order differs, in either compute dtype
    _close(_np(z1), want_z1, 1e-5, "z1")


# name: (JAX function, port function, E, dense)
VJP_CASES = {
    "moe_grouped_matmul": (jpf.moe_grouped_matmul,
                           fused.moe_grouped_matmul, 4, False),
    "fp8_grouped_matmul": (jpf.fp8_grouped_matmul,
                           fused.fp8_grouped_matmul, 4, False),
    "fp8_dense_ffn": (jpf.fp8_dense_ffn, fused.fp8_dense_ffn, 1, True),
}


@pytest.mark.parametrize("cdt", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(VJP_CASES))
def test_grouped_vjp_matches_jax(case, cdt):
    """The output and all five cotangents of the port's autograd
    Function against ``jax.vjp`` of the JAX custom VJP, for one
    cotangent drawn from a seed; each cotangent in its primal's
    dtype.  Under fp8 the cotangents land on the unrounded masters
    (straight through)."""
    jfn, tfn, e, dense = VJP_CASES[case]
    args = _ffn_inputs(1, e, 20, 32, 64)
    if dense:
        args = tuple(a[0] for a in args)
    g = np.random.RandomState(2).randn(*args[0].shape).astype(np.float32)

    def jax_side(*a):
        out, vjp = jax.vjp(lambda *p: jfn("gelu", cdt, *p), *a)
        return out, vjp(jnp.asarray(g))

    want_out, want_cts = jax.jit(jax_side)(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = tfn("gelu", _TORCH_DT[cdt], *leaves)
    cts = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    _close(_np(out), want_out, TOL[cdt], "out")
    for name, got, want in zip(("x", "w1", "b1", "w2", "b2"), cts,
                               want_cts):
        assert got.dtype == torch.float32, name
        _close(_np(got), want, TOL[cdt], name)


def test_grouped_forward_form_follows_the_need_for_a_gradient():
    """With a gradient to take the Function runs the training form;
    without one (no input requires grad, or ``torch.no_grad``) the
    primal form: on the CPU both give the plain version's output."""
    args = [torch.from_numpy(a) for a in _ffn_inputs(3, 2, 9, 16, 24)]
    want = fused.grouped_ffn_reference("relu", torch.float32, *args)[0]
    plain = fused.moe_grouped_matmul("relu", torch.float32, *args)
    assert plain.grad_fn is None
    leaves = [a.clone().requires_grad_(True) for a in args]
    trained = fused.moe_grouped_matmul("relu", torch.float32, *leaves)
    assert type(trained.grad_fn).__name__ == "_GroupedFFNBackward"
    with torch.no_grad():
        assert fused.moe_grouped_matmul("relu", torch.float32,
                                        *leaves).grad_fn is None
    torch.testing.assert_close(plain, want, rtol=0, atol=0)
    torch.testing.assert_close(trained.detach(), want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tie", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("k", [1, 2])
def test_sparse_route_matches_jax(k, cf, tie):
    """``_sparse_route`` at 64 tokens over E 4: ``idx``, ``slot`` and
    ``keep`` equal to JAX's exactly, ``gates``, ``probs`` and ``buf``
    within 1e-5; cf 1.25 drops units (the tokens share an offset that
    skews the router), cf 4 (= E) none.  ``tied`` gives
    experts 1 and 2 the same router column, so their probabilities tie
    exactly on every token and the lower index must come first."""
    spec_kw = dict(MOE, **_OBJECTIVES["classify"], moe_topk=k,
                   capacity_factor=cf)
    rng = np.random.RandomState(10 + k)
    # a shared offset skews the router, so that cf 1.25 overflows
    x = (rng.randn(64, 32) + 0.5).astype(np.float32)
    wr = (rng.randn(32, 4) / np.sqrt(32)).astype(np.float32)
    if tie:
        wr[:, 2] = wr[:, 1]
    want = jax.jit(lambda a, w: jtfm._sparse_route(
        jtfm.TransformerSpec(**spec_kw), a, w, jnp.float32))(x, wr)
    got = ttfm._sparse_route(ttfm.TransformerSpec(**spec_kw),
                             torch.from_numpy(x), torch.from_numpy(wr),
                             torch.float32)
    buf, slot, gates, keep, probs, idx = got
    w_buf, w_slot, w_gates, w_keep, w_probs, w_idx = map(np.asarray, want)
    np.testing.assert_array_equal(idx.numpy(), w_idx)
    np.testing.assert_array_equal(keep.numpy(), w_keep)
    np.testing.assert_array_equal(slot.numpy(), w_slot)
    if tie:
        assert (w_idx == 1).any() and not (
            (w_idx[:, :-1] == 2) & (w_idx[:, 1:] == 1)).any()
    dropped = int((~keep).sum())
    assert (dropped > 0) == (cf < 4.0), dropped
    _close(_np(gates), w_gates, 1e-5, "gates")
    _close(_np(probs), w_probs, 1e-5, "probs")
    _close(_np(buf), w_buf, 1e-5, "buf")


@pytest.mark.parametrize("k", [1, 2])
def test_sparse_at_ample_capacity_equals_dense_dispatch(k):
    """With ``capacity_factor >= E`` nothing drops, and the sparse MoE
    FFN equals dense dispatch (output and balance loss) within 1e-5."""
    spec = ttfm.TransformerSpec(**dict(MOE, **_OBJECTIVES["classify"],
                                       moe_topk=k, capacity_factor=4.0))
    params = ttfm.init(spec, seed=k, device="cpu")
    bp = ttfm._block_params(params, 0)
    bp["be1"] = 0.1 * torch.randn(bp["be1"].shape)
    a = torch.from_numpy(np.random.RandomState(k).randn(4, 16, 32)
                         .astype(np.float32))
    act = ttfm._ACTIVATIONS["gelu"]
    sparse, aux_s = ttfm._moe_ffn_sparse(spec, bp, a, act, torch.float32)
    dense, aux_d = ttfm._moe_ffn(spec, bp, a, act, torch.float32)
    _close(_np(sparse), _np(dense), 1e-5, "out")
    assert float(aux_s) == pytest.approx(float(aux_d), rel=1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _recorder(calls, fn):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        calls.append(out)
        return out
    return wrapped


# name: (spec fields over MOE, compute dtype)
APPLY_CASES = {
    "classify_einsum_top2": (dict(**_OBJECTIVES["classify"]), jnp.float32),
    "classify_grouped_top1": (dict(**_OBJECTIVES["classify"], moe_topk=1,
                                   grouped_moe=True), jnp.float32),
    "lm_grouped_top2": (dict(**_OBJECTIVES["lm"], grouped_moe=True),
                        jnp.float32),
    "lm_fp8_top2_bf16": (dict(**_OBJECTIVES["lm"], grouped_moe=True,
                              fp8_ffn=True), jnp.bfloat16),
    "classify_dense_dispatch": (dict(**_OBJECTIVES["classify"],
                                     moe_dispatch="dense"), jnp.float32),
}


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_apply_with_aux_matches_jax(case):
    """``apply(with_aux=True)``: every block's routing (``idx``,
    ``slot``, ``keep``) equal to JAX's, then the logits and the
    per-block mean of the balance loss within the dtype's tolerance.
    The JAX side's routing is read out of its jitted forward as extra
    outputs."""
    fields, cdt = APPLY_CASES[case]
    kw = dict(MOE, **fields)
    jspec = jtfm.TransformerSpec(**kw, compute_dtype=cdt)
    tspec = ttfm.TransformerSpec(**kw, compute_dtype=_TORCH_DT[cdt])
    jp = jtfm.init(jax.random.PRNGKey(0), jspec)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   tspec, device="cpu")
    x = np.random.RandomState(4).rand(4, kw["input_size"]).astype(
        np.float32)
    j_routes, t_routes = [], []

    def jax_fwd(p, xx):
        logits, aux = jtfm.apply(jspec, p, xx, with_aux=True)
        return logits, aux, list(j_routes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtfm, "_sparse_route",
                   _recorder(j_routes, jtfm._sparse_route))
        mp.setattr(ttfm, "_sparse_route",
                   _recorder(t_routes, ttfm._sparse_route))
        want_logits, want_aux, j_routes = jax.jit(jax_fwd)(
            jp, jnp.asarray(x))
        logits, aux = ttfm.apply(tspec, tp, torch.from_numpy(x),
                                 with_aux=True)
    n_routes = 0 if kw["moe_dispatch"] == "dense" else kw["num_blocks"]
    assert len(j_routes) == len(t_routes) == n_routes
    for i, (jr, tr) in enumerate(zip(j_routes, t_routes)):
        for name, pos in (("idx", 5), ("slot", 1), ("keep", 3)):
            np.testing.assert_array_equal(
                tr[pos].numpy(), np.asarray(jr[pos]),
                err_msg=f"block {i} {name}")
    tol = TOL[cdt]
    _close(_np(logits), want_logits, tol, "logits")
    assert float(aux) == pytest.approx(float(want_aux), rel=tol)
    assert float(aux) > 0.5


MOE_WIDE = dict(input_size=4096, seq_len=1024, d_model=1024, n_heads=8,
                num_blocks=2, d_ff=2048, num_experts=64,
                moe_dispatch="alltoall", moe_topk=1, capacity_factor=1.25,
                attention="flash", causal=True, grouped_moe=True)


@pytest.mark.parametrize("fp8", [False, True])
def test_num_params_and_flops_match_jax_at_moe_wide(fp8):
    """The bench configuration this slice trains: 546,866,186 params,
    and the JAX ``flops_per_step`` at batch 32; dense dispatch and top-2
    count their own FFN work the same way on both sides."""
    kw = dict(MOE_WIDE, fp8_ffn=fp8)
    jspec, tspec = jtfm.TransformerSpec(**kw), ttfm.TransformerSpec(**kw)
    assert ttfm.num_params(tspec) == jtfm.num_params(jspec) == 546_866_186
    assert ttfm.flops_per_step(tspec, 32) == jtfm.flops_per_step(jspec, 32)
    for change in (dict(moe_dispatch="dense"), dict(moe_topk=2)):
        assert ttfm.flops_per_step(dataclasses.replace(tspec, **change),
                                   32) == jtfm.flops_per_step(
            dataclasses.replace(jspec, **change), 32)

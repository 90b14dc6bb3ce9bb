"""The port's flash attention and LayerNorm backward against the JAX
package, on the CPU.

The same numpy inputs go through the JAX ``flash_attention`` (its Pallas
kernels in interpret mode, as ``tests/test_flash_attention.py`` runs
them) and the port's ``flash_attention``, whose wrappers run their plain
versions on CPU tensors; gradients are ``jax.vjp`` against the port's
autograd.  Tolerances, relative to each output's largest magnitude: f32
1e-5 (sums in other orders; the JAX kernel tiles the keys by up to 1024
where the plain version takes whole rows), bf16 1e-2 (p is rounded to
bf16 against the running max of a tile in JAX and against the row's
max here, one bf16 ulp per element, and o itself is bf16).  The
LayerNorm backward is held to ``jax.grad`` of the JAX fused functions
within 1e-5 (f32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.ops import flash_attention as jfa
from distributed_tensorflow_example_tpu.ops import pallas_fused as jpf
from distributed_tensorflow_example_tpu_torch.ops import flash_attention as tfa
from distributed_tensorflow_example_tpu_torch.ops import fused

# one intra-op thread: the suite runs six test workers (and the rank
# processes) on the machine's cores, where torch would start one a core
torch.set_num_threads(1)

TOL = {"f32": 1e-5, "bf16": 1e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} x {scale}"


def _np(t):
    return t.detach().to(torch.float32).numpy()


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_fwd_vjp(q, k, v, g, causal):
    o, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, causal),
                     q, k, v)
    return (o, *vjp(g))


def _inputs(shape, dt, seed, k_len=None):
    rng = np.random.RandomState(seed)
    k_shape = shape if k_len is None else (shape[0], k_len) + shape[2:]
    arrs = [rng.randn(*shape), rng.randn(*k_shape), rng.randn(*k_shape),
            rng.randn(*shape)]
    # round once to the working dtype so both sides see the same values
    jx = [jnp.asarray(a.astype(np.float32), JDT[dt]) for a in arrs]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(TDT[dt])
          for a in jx]
    return jx, tx


CASES = {
    # name: (shape [B, S, H, D], dtype, causal, k length or None)
    "f32_causal": ((2, 256, 2, 16), "f32", True, None),
    "f32_full": ((2, 256, 2, 16), "f32", False, None),
    "f32_causal_3x3_tiles": ((1, 1536, 2, 16), "f32", True, None),
    "bf16_causal_ragged": ((1, 300, 2, 16), "bf16", True, None),
    "f32_full_ragged_dense": ((1, 300, 2, 16), "f32", False, None),
    "f32_cross_length_dense": ((1, 64, 2, 16), "f32", False, 96),
    # wide heads (the kernels' 128 < D <= 256 instantiations on the card;
    # JAX takes its square 512 tiles above D 128)
    "f32_causal_d256": ((1, 512, 1, 256), "f32", True, None),
    "bf16_causal_ragged_d256": ((1, 300, 1, 256), "bf16", True, None),
    "f32_full_d192": ((1, 256, 2, 192), "f32", False, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_and_its_gradients_match_jax(case):
    """Forward and dq/dk/dv of the port's ``flash_attention`` against
    the JAX one.  The kernel cases leave one launch count each at 0 (CPU
    tensors run the plain versions); the two dense cases (non-causal
    ragged S, cross-length) never reach a flash wrapper."""
    shape, dt, causal, k_len = CASES[case]
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(shape, dt, 0, k_len)
    jo, jdq, jdk, jdv = _jax_fwd_vjp(jq, jk, jv, jg, causal)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    fused.reset_launch_counts()
    calls = []
    orig = tfa.flash_forward

    def spy(*a, **kw):
        calls.append(kw.get("stats", False))
        return orig(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfa, "flash_forward", spy)
        to = tfa.flash_attention(*leaves, causal)
        grads = torch.autograd.grad(to, leaves, tg)
    assert to.dtype == TDT[dt] and all(g.dtype == TDT[dt] for g in grads)
    dense = k_len is not None or (shape[1] % 256 and not causal)
    assert calls == ([] if dense else [True])
    assert all(v == 0 for v in fused.launch_counts().values())
    tol = TOL[dt]
    _close(_np(to), jo, tol, "o")
    for got, want, name in zip(grads, (jdq, jdk, jdv), ("dq", "dk", "dv")):
        _close(_np(got), want, tol, name)


def _check_forms(shape, causal):
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(shape, "f32", 1)
    acc, m, l = jfa._flash_stats(jq, jk, jv, causal, 256)
    tacc, tm, tl = tfa.flash_forward(tq, tk, tv, causal, stats=True)
    assert tm.shape == tl.shape == shape[:3]
    _close(_np(tacc), acc, 1e-5, "acc")
    _close(_np(tm), m[..., 0], 1e-6, "m")
    _close(_np(tl), l[..., 0], 1e-5, "l")
    with torch.no_grad():
        to = tfa.flash_attention(tq, tk, tv, causal)
    _close(_np(to), jfa._flash_forward(jq, jk, jv, causal, 256), 1e-5, "o")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_stats_and_normalized_forms_match_jax(causal):
    """B5's two forms: the stats ``(acc, m, l)`` against JAX
    ``_flash_stats`` (m in the natural log domain) and the normalized
    output against ``_flash_forward`` (the no-grad path)."""
    _check_forms((2, 512, 2, 16), causal)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_stats_and_normalized_forms_match_jax_d256(causal):
    """The same at a head dim of 256, the wide kernels' cap (f32: the
    tolerances above)."""
    _check_forms((1, 512, 1, 256), causal)


def _check_flat_backward(shape):
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(shape, "f32", 2)
    acc, m, l = jfa._flash_stats(jq, jk, jv, True, 256)
    o = (acc / jnp.maximum(l, 1e-30)).astype(jq.dtype)
    jdq, jdk, jdv = jfa._flash_backward(jq, jk, jv, o, m, l, jg, True, 256)
    to = torch.from_numpy(np.array(o))
    dlt = torch.sum(tg * to, dim=-1)
    tm, tl = (torch.from_numpy(np.array(a[..., 0])) for a in (m, l))
    got = tfa.flash_backward_reference(tq, tk, tv, tg, tm, tl, dlt, True)
    assert torch.equal(tfa.flash_dq(tq, tk, tv, tg, tm, tl, dlt, True),
                       got[0])
    for t, want, name in zip(got, (jdq, jdk, jdv), ("dq", "dk", "dv")):
        _close(_np(t), want, 1e-5, name)


def test_flash_backward_reference_matches_jax_flat_backward():
    """The plain backward on given statistics against the JAX kernels'
    ``_flash_backward`` (interpret mode), the residuals taken from JAX's
    own forward."""
    _check_flat_backward((1, 512, 2, 16))


def test_flash_backward_reference_matches_jax_flat_backward_d256():
    """The same at a head dim of 256 (f32, 1e-5 of scale)."""
    _check_flat_backward((1, 512, 1, 256))


@pytest.mark.parametrize("shape", [(64, 32), (2, 37, 32)])
def test_layer_norm_backward_matches_jax_grad(shape):
    """Gradients of the port's ``fused_layer_norm`` and
    ``fused_layer_norm_residual`` (autograd over the plain
    ``layer_norm_backward``) against ``jax.grad`` of the JAX fused
    functions (their Pallas backward in interpret mode), f32, rank 2
    and 3, ragged rows (not a multiple of the JAX kernel's 128)."""
    rng = np.random.RandomState(sum(shape))
    x, r, w1, w2 = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    d = shape[-1]
    g = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32)

    def jloss(x_, r_, g_, b_):
        y1 = jpf.fused_layer_norm(x_, g_, b_)
        y2, s2 = jpf.fused_layer_norm_residual(x_, r_, g_, b_)
        return jnp.sum(y1 * w1) + jnp.sum(y2 * w2) + jnp.sum(s2 * s2)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(x, r, g, b)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, r, g, b)]
    xt, rt, gt, bt = leaves
    y1 = fused.fused_layer_norm(xt, gt, bt)
    y2, s2 = fused.fused_layer_norm_residual(xt, rt, gt, bt)
    loss = (torch.sum(y1 * torch.from_numpy(w1))
            + torch.sum(y2 * torch.from_numpy(w2)) + torch.sum(s2 * s2))
    got = torch.autograd.grad(loss, leaves)
    for t, w, name in zip(got, want, "xrgb"):
        _close(_np(t), w, 1e-5, name)


def test_layer_norm_backward_reference_matches_jax_rows():
    """``layer_norm_backward_reference`` is the JAX ``_ln_bwd_rows``
    plus the row sums of ``dy * xh`` and ``dy``."""
    rng = np.random.RandomState(5)
    dy, x = (rng.randn(33, 24).astype(np.float32) for _ in range(2))
    g = (1 + 0.1 * rng.randn(24)).astype(np.float32)
    jdx, jxh = jpf._ln_bwd_rows(jnp.asarray(dy), jnp.asarray(x),
                                jnp.asarray(g))
    dx, dg, db = fused.layer_norm_backward_reference(
        torch.from_numpy(dy), torch.from_numpy(x), torch.from_numpy(g))
    _close(_np(dx), jdx, 1e-6, "dx")
    _close(_np(dg), jnp.sum(dy * jxh, axis=0), 1e-6, "dg")
    _close(_np(db), dy.sum(0), 1e-6, "db")

"""The PyTorch port's ops against the JAX package's, on the CPU.

Each test feeds the same numpy inputs (from a seed) to the JAX
function — Pallas kernels in interpret mode, as the JAX package's own
tests run them — and to the port on ``device="cpu"``, where each
kernel wrapper runs its plain version.  Tolerances are stated per
test.  The CUDA kernels themselves are held against their plain
versions on the card by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_tensorflow_example_tpu.ops import paged_attention as jpa
from distributed_tensorflow_example_tpu.ops import pallas_fused as jpf
from distributed_tensorflow_example_tpu.ops import quant as jquant
from distributed_tensorflow_example_tpu.ops import ring_attention as jring
from distributed_tensorflow_example_tpu_torch import device as tdevice
from distributed_tensorflow_example_tpu_torch.models.mlp import MLPSpec
from distributed_tensorflow_example_tpu_torch.models.mlp import init as mlp_init
from distributed_tensorflow_example_tpu_torch.ops import fused
from distributed_tensorflow_example_tpu_torch.ops import paged_attention as tpa
from distributed_tensorflow_example_tpu_torch.ops import quant as tquant
from distributed_tensorflow_example_tpu_torch.ops import ring_attention as tring

# one intra-op thread: the suite runs six test workers (and the rank
# processes) on the machine's cores, where torch would start one a core
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().cpu().float() if x.dtype == torch.bfloat16
                      else x.detach().cpu())


@pytest.mark.parametrize("shape", [(6, 32), (2, 5, 48)])
def test_fused_layer_norm_matches_jax(shape):
    """B2: f32 LayerNorm, rank 2 and 3, within 1e-5 absolute (the two
    sides sum the row in different orders)."""
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32) * 3 + 1
    g = rng.randn(shape[-1]).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    want = np.asarray(jpf.fused_layer_norm(jnp.asarray(x), jnp.asarray(g),
                                           jnp.asarray(b)))
    got = fused.fused_layer_norm(_t(x), _t(g), _t(b))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5)


def test_fused_layer_norm_residual_matches_jax():
    """B3: y within 1e-5 absolute, the residual sum s bitwise."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 7, 40).astype(np.float32)
    r = rng.randn(3, 7, 40).astype(np.float32)
    g = rng.randn(40).astype(np.float32)
    b = rng.randn(40).astype(np.float32)
    jy, js = jpf.fused_layer_norm_residual(*map(jnp.asarray, (x, r, g, b)))
    ty, ts = fused.fused_layer_norm_residual(_t(x), _t(r), _t(g), _t(b))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=0, atol=1e-5)


def test_pow2_scale_matches_jax_at_the_edges():
    """pow2_scale bitwise: amax exactly at 448*2^k and three f32 ulps on
    either side of it for k in [-40, 80) (where an exact log2, or
    frexp, disagrees with the JAX package's rounding in both
    directions), zero, and a log-uniform spread of magnitudes."""
    vals = [0.0]
    for k in range(-40, 80):
        edge = np.float32(448.0 * 2.0 ** k)
        vals.append(edge)
        for toward in (np.float32(np.inf), np.float32(0)):
            v = edge
            for _ in range(3):
                v = np.nextafter(v, toward)
                vals.append(v)
    rng = np.random.RandomState(9)
    vals += list(rng.rand(4000) * 10.0 ** rng.uniform(-30, 30, 4000))
    amax = np.asarray(vals, np.float32)
    want = np.asarray(jquant.pow2_scale(jnp.asarray(amax)))
    got = _np(tquant.pow2_scale(_t(amax)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("axis", [None, (1, 2), -1])
def test_fp8_round_matches_jax_bitwise(axis):
    """fp8_round bitwise, over a spread of magnitudes, with a row pinned
    to the edge amax 448*2^3 and one just above it."""
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 8, 16) * np.exp(rng.randn(3, 8, 16) * 2)).astype(
        np.float32)
    x[0, 0, 0] = 448.0 * 8
    x[1, 0, 0] = np.nextafter(np.float32(448.0 * 8), np.float32(np.inf))
    x[2] = 0.0
    want = np.asarray(jquant.fp8_round(jnp.asarray(x), axis=axis))
    got = _np(tquant.fp8_round(_t(x), axis=axis))
    np.testing.assert_array_equal(got, want)


def test_fp8_round_bf16_input_matches_jax():
    """bf16 in, bf16 out, bitwise."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 32).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jquant.fp8_round(jx, axis=(1, 2)).astype(jnp.float32))
    got = tquant.fp8_round(_t(x).to(torch.bfloat16), axis=(1, 2))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), want)


def _ffn_inputs(seed, e, c, d, ff):
    rng = np.random.RandomState(seed)
    return (rng.randn(e, c, d).astype(np.float32),
            (rng.randn(e, d, ff) / np.sqrt(d)).astype(np.float32),
            (0.1 * rng.randn(e, ff)).astype(np.float32),
            (rng.randn(e, ff, d) / np.sqrt(ff)).astype(np.float32),
            (0.1 * rng.randn(e, d)).astype(np.float32))


@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_moe_grouped_matmul_matches_jax_f32(activation):
    """B8 forward, E=2 groups, f32: within 1e-5 relative to the
    output's scale."""
    args = _ffn_inputs(4, 2, 20, 32, 64)
    want = np.asarray(jpf.moe_grouped_matmul(
        activation, jnp.float32, *map(jnp.asarray, args)))
    got = _np(fused.moe_grouped_matmul(activation, torch.float32,
                                       *map(_t, args)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_fp8_dense_ffn_matches_jax_f32():
    """The fp8 dense FFN (fp8_round x3 + B8 at E=1), f32 compute:
    within 1e-5 relative to the output's scale (the rounded operands
    agree bitwise; only the f32 sum order differs)."""
    x, w1, b1, w2, b2 = (a[0] for a in _ffn_inputs(5, 1, 24, 32, 64))
    want = np.asarray(jpf.fp8_dense_ffn(
        "gelu", jnp.float32, *map(jnp.asarray, (x, w1, b1, w2, b2))))
    got = _np(fused.fp8_dense_ffn("gelu", torch.float32,
                                  *map(_t, (x, w1, b1, w2, b2))))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_fp8_dense_ffn_matches_jax_bf16():
    """bf16 compute: the fp8-rounded operands are exact in bf16 on both
    sides; the hidden is rounded to bf16 after an f32 pre-activation
    whose sum order differs, so a few hidden values may land one bf16
    ulp apart (2^-8 relative).  Bound: 1e-2 of the output's scale, and
    the median error under 1e-4 of it."""
    x, w1, b1, w2, b2 = (a[0] for a in _ffn_inputs(6, 1, 24, 32, 64))
    want = np.asarray(jpf.fp8_dense_ffn(
        "gelu", jnp.bfloat16, *map(jnp.asarray, (x, w1, b1, w2, b2))))
    got = _np(fused.fp8_dense_ffn("gelu", torch.bfloat16,
                                  *map(_t, (x, w1, b1, w2, b2))))
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= 1e-2 * scale
    assert np.median(err) <= 1e-4 * scale


def test_attention_matches_jax():
    """Dense attention, causal and full, f32: within 1e-6 absolute."""
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(2, 9, 3, 8).astype(np.float32) for _ in range(3))
    for causal in (False, True):
        want = np.asarray(jring.attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=causal))
        got = _np(tring.attention(_t(q), _t(k), _t(v), causal=causal))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert tring.NEG_INF == jring.NEG_INF


def test_paged_primitives_match_jax():
    """All six paged-cache primitives: exact equality (pure indexing),
    including a scatter that writes in place."""
    rng = np.random.RandomState(8)
    pool = rng.randn(7, 4, 2, 3).astype(np.float32)
    bt = np.asarray([[1, 2, 0], [3, 4, 5]], np.int32)
    pos = np.asarray([5, 9], np.int32)
    jpid, jrow = jpa.page_row_index(jnp.asarray(pos), jnp.asarray(bt), 4)
    tpid, trow = tpa.page_row_index(_t(pos), _t(bt), 4)
    np.testing.assert_array_equal(_np(tpid), np.asarray(jpid))
    np.testing.assert_array_equal(_np(trow), np.asarray(jrow))
    vals = rng.randn(2, 2, 3).astype(np.float32)
    want = np.asarray(jpa.scatter_kv_rows(jnp.asarray(pool), jpid, jrow,
                                          jnp.asarray(vals)))
    tpool = _t(pool)
    out = tpa.scatter_kv_rows(tpool, tpid, trow, _t(vals))
    assert out is tpool                        # in place
    np.testing.assert_array_equal(_np(tpool), want)
    np.testing.assert_array_equal(
        _np(tpa.gather_kv(tpool, _t(bt))),
        np.asarray(jpa.gather_kv(jnp.asarray(want), jnp.asarray(bt))))
    np.testing.assert_array_equal(
        _np(tpa.length_mask(12, _t(pos))),
        np.asarray(jpa.length_mask(12, jnp.asarray(pos))))
    jpages, jrows = jpa.prefill_page_rows(6, jnp.asarray(bt), 4)
    tpages, trows = tpa.prefill_page_rows(6, _t(bt), 4)
    np.testing.assert_array_equal(_np(tpages), np.asarray(jpages))
    np.testing.assert_array_equal(_np(trows), np.asarray(jrows))
    pvals = rng.randn(2, 6, 2, 3).astype(np.float32)
    want = np.asarray(jpa.scatter_prefill_rows(
        jnp.asarray(pool), jpages, jrows, jnp.asarray(pvals)))
    tpool = _t(pool)
    tpa.scatter_prefill_rows(tpool, tpages, trows, _t(pvals))
    np.testing.assert_array_equal(_np(tpool), want)


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    """On CPU tensors a wrapper computes its plain version and never
    touches the kernel library or its launch counter."""
    fused.reset_launch_counts()
    x = torch.randn(4, 16)
    g, b = torch.ones(16), torch.zeros(16)
    torch.testing.assert_close(fused.fused_layer_norm(x, g, b),
                               fused.layer_norm_reference(x, g, b),
                               rtol=0, atol=0)
    fused.fused_layer_norm_residual(x, x, g, b)
    fused.moe_grouped_matmul("gelu", torch.float32, x[None],
                             torch.randn(1, 16, 8), torch.zeros(1, 8),
                             torch.randn(1, 8, 16), torch.zeros(1, 16))
    spec = MLPSpec(input_size=16, hidden_sizes=(8,), num_classes=4)
    params = mlp_init(spec, device="cpu")
    torch.testing.assert_close(
        fused.mlp_forward(spec, params, x),
        fused.mlp_forward_reference(spec, params, x)[0], rtol=0, atol=0)
    assert fused.launch_counts() == {
        "fused_layer_norm": 0, "fused_layer_norm_residual": 0,
        "layer_norm_backward": 0, "moe_grouped_matmul": 0,
        "moe_grouped_matmul_z1": 0, "mlp_forward": 0, "flash_forward": 0, "flash_dq": 0,
        "flash_dkv": 0}


def test_wrappers_refuse_mixed_or_foreign_devices():
    """No silent dispatch: tensors off the CPU and off CUDA (here the
    meta device) raise instead of reaching either path."""
    x = torch.empty(4, 16, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        fused.fused_layer_norm(x, torch.ones(16), torch.zeros(16))


def test_resolve_device_never_falls_back_to_cpu():
    """Asking for the card where none exists raises; the CPU must be
    asked for by name."""
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert tdevice.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdevice.resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdevice.resolve_device("cuda")
    with pytest.raises(ValueError):
        tdevice.resolve_device("meta")


# the bf16 grouped FFN's launch plans on an H100 (132 SMs) at the paths'
# shapes, as grouped_ffn.cu's header lists them: (halves, splits) of
# launch 1 and launch 2, and their CTAs
PATH_PLANS = [
    # decode: E 1, C 8, d 1024, ff 4096
    ((1, 8, 1024, 4096), ((1, 4), (1, 16)), (128, 128)),
    # prefill: C 512
    ((1, 512, 1024, 4096), ((1, 1), (1, 4)), (128, 128)),
    # moe_wide training: E 64, C 640, d 1024, ff 2048
    ((64, 640, 1024, 2048), ((2, 1), (2, 1)), (2560, 1280)),
    # moe_wide eval: C 160
    ((64, 160, 1024, 2048), ((2, 1), (2, 1)), (1024, 512)),
]


@pytest.mark.parametrize("shape,plan,ctas", PATH_PLANS,
                         ids=["decode", "prefill", "moe_wide", "moe_eval"])
def test_grouped_ffn_plan_at_the_paths_shapes(shape, plan, ctas):
    """The plan ``grouped_ffn_plan`` picks at each path's shape on 132
    SMs, and the CTAs each launch then has."""
    e, c, d, ff = shape
    got = fused.grouped_ffn_plan(e, c, d, ff, 132)
    assert got == plan
    assert fused.grouped_ffn_ctas(got, e, c, d, ff) == ctas


@pytest.mark.parametrize("sms", [132, 114, 8])
def test_grouped_ffn_plan_fills_one_wave_with_equal_shares(sms):
    """Over a grid of shapes: 256-wide tiles only where they give at
    least one CTA an SM, 128-wide where those do; a split only where
    even the 128-wide tiles are fewer than the SMs, then no more CTAs
    than one wave, each share of K nonempty and none larger than the
    first, and a split of 2 or more wherever two shares fit in one
    wave (an empty buffer, C 0, included)."""
    for e in (1, 2, 8, 64):
        for c in (0, 1, 8, 70, 129, 512, 640):
            for n, k in ((4096, 1024), (1024, 4096), (200, 96), (201, 98)):
                halves, splits = fused._product_plan(e, c, n, k, sms)
                wide = fused.product_ctas(e, c, n, 2, 1)
                narrow = fused.product_ctas(e, c, n, 1, 1)
                slices = -(-k // 64)
                assert (halves == 2) == (wide >= sms)
                if halves == 2 or narrow >= sms:
                    assert splits == 1
                    continue
                assert halves == 1 and 1 <= splits <= slices
                assert narrow * splits <= max(sms, narrow)
                per = -(-slices // splits)
                assert (splits - 1) * per < slices      # last share nonempty
                if 2 * narrow <= sms and slices >= 2:
                    assert splits >= 2


# B4 (the LayerNorm backward) at the transformer trainer's 65,536 x 1024
# rows, and at the row counts the card tests run, on cards of 132, 114
# and 8 SMs holding 3 of its register-path CTAs an SM: (rows, sms) ->
# (route, CTAs = dg/db partial rows)
LN_BWD_PLANS = [
    ((65536, 132), ("warp", 396)),
    ((65536, 114), ("warp", 342)),
    ((65536, 8), ("warp", 24)),
    ((1, 132), ("warp", 1)),
    ((7, 132), ("warp", 2)),
    ((129, 132), ("warp", 33)),
]


@pytest.mark.parametrize("shape,plan", LN_BWD_PLANS,
                         ids=[f"{r}x{s}" for (r, s), _ in LN_BWD_PLANS])
def test_layer_norm_backward_plan_at_the_paths_shapes(shape, plan):
    """The register path's persistent grid at d 1024: one wave of the
    CTAs the card holds (a few hundred partial rows where the old
    CTA-a-row kernel wrote 1056), fewer where the rows are fewer."""
    rows, sms = shape
    assert fused.layer_norm_backward_plan(rows, 1024, True, sms, 3) == plan


@pytest.mark.parametrize("sms", [132, 114, 8])
def test_layer_norm_backward_plan_fills_one_wave(sms):
    """Over a grid of shapes: the register path exactly where d is at
    most 1024, a multiple of 4 and the tensors aligned; there, no more
    CTAs than one wave holds, none without a row (4 rows in flight a
    CTA) and a full wave wherever the rows fill it; elsewhere the
    CTA-a-row kernel on at most 8 CTAs an SM and one row a CTA at
    least."""
    for per_sm in (1, 3, 4):
        for rows in (1, 3, 4, 5, 129, 1000, 65539):
            for d in (1, 96, 1000, 1020, 1024, 1028, 1536):
                for aligned in (True, False):
                    route, ctas = fused.layer_norm_backward_plan(
                        rows, d, aligned, sms, per_sm)
                    reg = aligned and d <= 1024 and d % 4 == 0
                    assert route == ("warp" if reg else "block")
                    assert 1 <= ctas <= rows
                    if reg:
                        assert ctas <= sms * per_sm
                        assert 4 * (ctas - 1) < rows
                        if rows >= 4 * sms * per_sm:
                            assert ctas == sms * per_sm
                    else:
                        assert ctas == min(rows, 8 * sms)


# B1's f32 layers at the reference MLP's shapes on 132 SMs: (M, N, K) ->
# (splits of K, CTAs) for the training step's 100 rows and eval's 2000
MLP_F32_PLANS = [
    ((100, 100, 784), (7, 112)),
    ((100, 10, 100), (4, 16)),
    ((2000, 100, 784), (3, 756)),
    ((2000, 10, 100), (4, 252)),
]


@pytest.mark.parametrize("shape,plan", MLP_F32_PLANS,
                         ids=["train_l1", "train_l2", "eval_l1", "eval_l2"])
def test_mlp_f32_plan_at_the_paths_shapes(shape, plan):
    """At 100 rows the first layer's 16 tiles split K 7 ways (112 CTAs
    where 64 x 64 tiles gave 4), the logits layer's 4 tiles 4 ways; at
    2000 rows 252 tiles split 3 ways."""
    assert fused.mlp_f32_plan(*shape, 132) == plan


@pytest.mark.parametrize("sms", [132, 114, 8])
def test_mlp_f32_plan_splits_k_in_equal_shares(sms):
    """Over a grid of shapes: 1 to 8 shares (a cluster), no more than
    the 32-deep slices, each nonempty and none larger than the first;
    one share fewer would leave the card under 4 CTAs an SM, none where
    the tiles alone reach that; as many as the slices allow where even 8
    do not; CTAs = tiles x splits."""
    for m in (0, 1, 100, 129, 2000, 8192):
        for n in (1, 10, 37, 100, 4096):
            for k in (1, 31, 33, 100, 784, 4096):
                splits, ctas = fused.mlp_f32_plan(m, n, k, sms)
                tiles = -(-m // 32) * -(-n // 32)
                slices = -(-k // 32)
                per = -(-slices // splits)
                assert 1 <= splits <= min(8, slices)
                assert (splits - 1) * per < slices
                assert ctas == tiles * splits
                assert tiles * (splits - 1) < 4 * sms
                if tiles >= 4 * sms:
                    assert splits == 1
                if tiles * min(8, slices) <= 4 * sms:
                    cap = min(8, slices)
                    assert splits == -(-slices // -(-slices // cap))

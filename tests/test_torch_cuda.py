"""The PyTorch port's CUDA kernels against their plain versions, on
the card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false (the kernels have no CPU mode).
The file imports nothing of JAX, so it runs on the card's machine,
which has none:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

The shapes are ragged (rows and C not multiples of the kernels' tiles)
and cover both dtypes each kernel takes; the path's own shapes are
checked by ``chip_smoke.py``.
"""

import pytest
import torch

from distributed_tensorflow_example_tpu_torch.models import mlp
from distributed_tensorflow_example_tpu_torch.ops import fused
from distributed_tensorflow_example_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_kernels_match_plain_on_card(card, dtype):
    """Both LayerNorm kernels against their plain versions on the card
    (y within 1e-4 absolute; s bitwise)."""
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(37, 1024, generator=gen, device=card).to(dtype)
    r = torch.randn(37, 1024, generator=gen, device=card).to(dtype)
    g = torch.randn(1024, generator=gen, device=card)
    b = torch.randn(1024, generator=gen, device=card)
    torch.testing.assert_close(fused.fused_layer_norm(x, g, b),
                               fused.layer_norm_reference(x, g, b),
                               rtol=0, atol=1e-4)
    y, s = fused.fused_layer_norm_residual(x, r, g, b)
    y_ref, s_ref = fused.layer_norm_residual_reference(x, r, g, b)
    assert torch.equal(s, s_ref)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_grouped_ffn_kernel_matches_plain_on_card(card, cdt):
    """The grouped FFN kernel against its plain version on the card at a
    ragged shape (E=2, C=70, d=96, ff=200): 1e-3 of the output scale.
    f32 runs the CUDA-core GEMM; bf16 the tensor-core GEMM with every
    operand by TMA and, on a 132-SM card, K split in both products."""
    gen = torch.Generator(device=card).manual_seed(1)
    e, c, d, ff = 2, 70, 96, 200
    args = (torch.randn(e, c, d, generator=gen, device=card),
            torch.randn(e, d, ff, generator=gen, device=card) / d ** 0.5,
            torch.randn(e, ff, generator=gen, device=card),
            torch.randn(e, ff, d, generator=gen, device=card) / ff ** 0.5,
            torch.randn(e, d, generator=gen, device=card))
    got = fused.moe_grouped_matmul("gelu", cdt, *args)
    want = fused.grouped_ffn_reference("gelu", cdt, *args)[0]
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-3 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(1, 1000), (129, 96), (3, 12256)])
def test_layer_norm_kernel_odd_shapes_on_card(card, rows, d):
    """Row widths that are not multiples of the block (1000, 96), one
    row, and the kernel's widest row (12256: the 48 KB of shared memory
    a launch gets without an opt-in): y within 1e-4."""
    gen = torch.Generator(device=card).manual_seed(rows)
    x = 3 * torch.randn(rows, d, generator=gen, device=card) + 1
    g = torch.randn(d, generator=gen, device=card)
    b = torch.randn(d, generator=gen, device=card)
    torch.testing.assert_close(fused.fused_layer_norm(x, g, b),
                               fused.layer_norm_reference(x, g, b),
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_register_path_edges_on_card(card, dtype, rows):
    """B2 and B3 at the register path's widest row (one warp a row, 32
    values a lane at 1024) and 4 past it (one block a row), at 1 and 8
    rows: y within 1e-4, s bitwise."""
    from distributed_tensorflow_example_tpu_torch.ops import _build

    limit = _build.load().dtx_layer_norm_reg_max_d()
    for d in (limit, limit + 4):
        gen = torch.Generator(device=card).manual_seed(rows + d)
        x = (3 * torch.randn(rows, d, generator=gen, device=card)
             + 1).to(dtype)
        r = torch.randn(rows, d, generator=gen, device=card).to(dtype)
        g = torch.randn(d, generator=gen, device=card)
        b = torch.randn(d, generator=gen, device=card)
        torch.testing.assert_close(fused.fused_layer_norm(x, g, b),
                                   fused.layer_norm_reference(x, g, b),
                                   rtol=0, atol=1e-4)
        y, s_ = fused.fused_layer_norm_residual(x, r, g, b)
        y_ref, s_ref = fused.layer_norm_residual_reference(x, r, g, b)
        assert torch.equal(s_, s_ref), d
        torch.testing.assert_close(y, y_ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ["relu", "tanh", "sigmoid"])
def test_grouped_ffn_activations_on_card(card, activation):
    gen = torch.Generator(device=card).manual_seed(2)
    args = (torch.randn(1, 9, 64, generator=gen, device=card),
            torch.randn(1, 64, 130, generator=gen, device=card) / 8,
            torch.randn(1, 130, generator=gen, device=card),
            torch.randn(1, 130, 64, generator=gen, device=card) / 11,
            torch.randn(1, 64, generator=gen, device=card))
    got = fused.moe_grouped_matmul(activation, torch.float32, *args)
    want = fused.grouped_ffn_reference(activation, torch.float32,
                                       *args)[0]
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-3 * float(want.abs().max()))


def _ffn_args(card, seed, e, c, d, ff):
    gen = torch.Generator(device=card).manual_seed(seed)
    return (torch.randn(e, c, d, generator=gen, device=card),
            torch.randn(e, d, ff, generator=gen, device=card) / d ** 0.5,
            0.1 * torch.randn(e, ff, generator=gen, device=card),
            torch.randn(e, ff, d, generator=gen, device=card) / ff ** 0.5,
            0.1 * torch.randn(e, d, generator=gen, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("e,c", [(3, 70), (1, 129)])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_grouped_ffn_z1_form_matches_plain_on_card(card, cdt, e, c):
    """B8's training form (``want_z1``) against its plain version at a
    ragged C and at E = 1 (the dense fp8 case): ``out`` within 1e-3 of
    its scale (a bf16 hidden may round one ulp apart, as for the primal
    form) and the f32 pre-activation ``z1`` within 1e-5 of its scale
    (the same products, summed in another order); one counted call."""
    args = _ffn_args(card, 10 + c, e, c, 96, 200)
    fused.reset_launch_counts()
    out, z1 = fused.moe_grouped_matmul_z1("gelu", cdt, *args)
    torch.cuda.synchronize()
    counts = fused.launch_counts()
    assert counts["moe_grouped_matmul_z1"] == 1
    assert counts["moe_grouped_matmul"] == 0
    want_out, want_z1 = fused.grouped_ffn_reference("gelu", cdt, *args)
    assert z1.shape == (e, c, 200) and z1.dtype == torch.float32
    torch.testing.assert_close(out, want_out, rtol=0,
                               atol=1e-3 * float(want_out.abs().max()))
    torch.testing.assert_close(z1, want_z1, rtol=0,
                               atol=1e-5 * float(want_z1.abs().max()))


# bf16 B8 on the tensor cores: (E, C, d, ff) and the routes it takes.
# x [E, C, d] and h1 [E, C, ff] are read with rows of d and ff, W1 with
# rows of ff, W2 with rows of d: TMA where the width is a multiple of 8,
# 4-byte cp.async pairs where it is even, scalar loads where it is odd.
# The plans are those of a 132-SM H100 (grouped_ffn_plan): (halves,
# splits) of launch 1 and launch 2.
TC_FFN_CASES = [
    # ragged C: TMA everywhere; plans ((1, 1), (1, 2)), ((2, 1), (1, 1)),
    # ((1, 1), (1, 2)): a 129-row C spans two 128-row tiles, a 300-row C
    # three; 1024-wide rows, 2048-wide hidden
    pytest.param(3, 129, 1024, 2048, id="tma-C129"),
    pytest.param(8, 300, 1024, 2048, id="tma-C300-wide-tiles"),
    pytest.param(2, 70, 256, 512, id="tma-C70"),
    # E 1 at the serve's decode and prefill rows: the split-K plans
    # ((1, 4), (1, 16)) and ((1, 1), (1, 4)), TMA everywhere
    pytest.param(1, 8, 1024, 4096, id="tma-decode-split"),
    pytest.param(1, 512, 1024, 4096, id="tma-prefill-split"),
    # d 96 by TMA, ff 202: W1 and h1 by 4-byte pairs (a ragged K of 96
    # in launch 1, zero-filled past the last column in both)
    pytest.param(2, 70, 96, 202, id="pairs-ff202"),
    # d 98: x and W2 by pairs; ff 201: W1 and h1 by scalar loads
    pytest.param(2, 70, 98, 201, id="pairs-d98-scalar-ff201"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,ff", TC_FFN_CASES)
def test_grouped_ffn_tensor_core_path_matches_plain_on_card(card, e, c, d,
                                                            ff):
    """B8 in bf16 (both forms) on the tensor cores against its plain
    version, at ragged C, at E 1 where the plan splits K, and at widths
    TMA cannot take: out within 1e-3 of its scale (a bf16 hidden may
    round one ulp apart where the two f32 pre-activations straddle a
    boundary) and the f32 z1 within 1e-5 of its scale (the same exact
    bf16 products summed in another order)."""
    bf16 = torch.bfloat16
    args = _ffn_args(card, 30 + c + d, e, c, d, ff)
    want_out, want_z1 = fused.grouped_ffn_reference("gelu", bf16, *args)
    out, z1 = fused.moe_grouped_matmul_z1("gelu", bf16, *args)
    primal = fused.moe_grouped_matmul("gelu", bf16, *args)
    torch.cuda.synchronize()
    assert z1.shape == (e, c, ff) and z1.dtype == torch.float32
    for got, want, tol, name in ((out, want_out, 1e-3, "out"),
                                 (primal, want_out, 1e-3, "primal out"),
                                 (z1, want_z1, 1e-5, "z1")):
        _close_scaled(got, want, tol, f"{name} [{e}, {c}, {d}] x {ff}")


@pytest.mark.cuda
def test_grouped_ffn_split_k_is_deterministic_on_card(card):
    """At decode rows the plan splits K in both products, and the f32
    shares are summed in a fixed order by a second launch, with no
    atomics: two calls give the same bits, out and z1."""
    e, c, d, ff = 1, 8, 1024, 4096
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = fused.grouped_ffn_plan(e, c, d, ff, sms)
    assert plan[0][1] > 1 and plan[1][1] > 1, plan
    args = _ffn_args(card, 40, e, c, d, ff)
    out_a, z1_a = fused.moe_grouped_matmul_z1("gelu", torch.bfloat16, *args)
    out_b, z1_b = fused.moe_grouped_matmul_z1("gelu", torch.bfloat16, *args)
    primal_a = fused.moe_grouped_matmul("gelu", torch.bfloat16, *args)
    primal_b = fused.moe_grouped_matmul("gelu", torch.bfloat16, *args)
    torch.cuda.synchronize()
    assert torch.equal(out_a, out_b) and torch.equal(z1_a, z1_b)
    assert torch.equal(primal_a, primal_b) and torch.equal(primal_a, out_a)


@pytest.mark.cuda
@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_grouped_ffn_gradients_on_card_match_cpu(card, cdt, fp8):
    """Autograd through ``moe_grouped_matmul`` / ``fp8_grouped_matmul``
    on the card (the training form, then the plain backward products on
    the tensor cores) against the same function on the CPU: output and
    all five cotangents within 1e-4 of their scale in f32 and 2e-2 in
    bf16 (bf16 roundings of the hidden and of the backward's operands
    land one ulp apart where the sums run in other orders)."""
    args = _ffn_args(card, 20, 2, 70, 96, 200)
    fn = fused.fp8_grouped_matmul if fp8 else fused.moe_grouped_matmul

    def run(dev):
        leaves = [a.detach().to(dev).clone().requires_grad_(True)
                  for a in args]
        out = fn("gelu", cdt, *leaves)
        out.square().mean().backward()
        return [out.detach().cpu()] + [a.grad.cpu() for a in leaves]

    fused.reset_launch_counts()
    on_card = run(card)
    counts = fused.launch_counts()
    assert counts["moe_grouped_matmul_z1"] == 1
    assert counts["moe_grouped_matmul"] == 0
    on_cpu = run("cpu")
    tol = 1e-4 if cdt == torch.float32 else 2e-2
    for name, got, want in zip(("out", "buf", "we1", "be1", "we2", "be2"),
                               on_card, on_cpu):
        assert got.dtype == want.dtype == torch.float32, name
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=tol * float(want.abs().max()),
                                   msg=name)


@pytest.mark.cuda
def test_fp8_dense_ffn_on_card_matches_plain(card):
    """The path's composition (fp8_round x3 + B8, bf16) on the card
    against the same composition over the plain version."""
    gen = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(17, 256, generator=gen, device=card)
    w1 = torch.randn(256, 512, generator=gen, device=card) / 16
    b1 = torch.randn(512, generator=gen, device=card)
    w2 = torch.randn(512, 256, generator=gen, device=card) / 23
    b2 = torch.randn(256, generator=gen, device=card)
    got = fused.fp8_dense_ffn("gelu", torch.bfloat16, x, w1, b1, w2, b2)
    bq, w1q, w2q = fused._fp8_operands(x[None], w1[None], w2[None])
    want = fused.grouped_ffn_reference("gelu", torch.bfloat16, bq, w1q,
                                       b1[None], w2q, b2[None])[0][0]
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-3 * float(want.abs().max()))


@pytest.mark.cuda
def test_wrappers_count_launches_and_refuse_bad_input_on_card(card):
    """Each kernel launch adds one to its wrapper's count; a
    non-contiguous, mixed-device or too-wide input raises instead of
    reaching the kernel or a plain version."""
    fused.reset_launch_counts()
    x = torch.randn(4, 64, device=card)
    g, b = torch.ones(64, device=card), torch.zeros(64, device=card)
    fused.fused_layer_norm(x, g, b)
    fused.fused_layer_norm_residual(x, x, g, b)
    fused.moe_grouped_matmul("gelu", torch.float32, x[None],
                             torch.randn(1, 64, 32, device=card),
                             torch.zeros(1, 32, device=card),
                             torch.randn(1, 32, 64, device=card),
                             torch.zeros(1, 64, device=card))
    torch.cuda.synchronize()
    assert fused.launch_counts() == {
        "fused_layer_norm": 1, "fused_layer_norm_residual": 1,
        "layer_norm_backward": 0, "moe_grouped_matmul": 1,
        "moe_grouped_matmul_z1": 0, "mlp_forward": 0, "flash_forward": 0, "flash_dq": 0,
        "flash_dkv": 0}
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_layer_norm(torch.randn(64, 4, device=card).t(), g, b)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        fused.fused_layer_norm(x, g.cpu(), b)
    wide = torch.randn(2, 12257, device=card)
    with pytest.raises(ValueError, match="limit"):
        fused.fused_layer_norm(wide, torch.ones(12257, device=card),
                               torch.zeros(12257, device=card))
    assert fused.launch_counts()["fused_layer_norm"] == 1


# (rows, hidden sizes, activation, compute dtype): rows not a multiple
# of the 64-row tile, the reference's 784 input width (not a multiple
# of the 32-deep K slice) and narrow 100/10 layers, both dtypes
MLP_SHAPES = [
    (1, (100,), "sigmoid", torch.float32),
    (100, (100,), "sigmoid", torch.float32),
    (130, (37, 65), "tanh", torch.float32),
    (257, (100,), "relu", torch.bfloat16),
    (70, (300, 129), "relu", torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,hidden,act,cdt", MLP_SHAPES)
def test_mlp_forward_kernel_matches_plain_on_card(card, n, hidden, act,
                                                  cdt):
    """B1 against its plain version on the card.  f32: each
    pre-activation sums 784 products in another order (~1e-5 absolute
    at these magnitudes), which tanh passes on with slope up to 1, so
    hiddens and logits within 1e-4 of max(1, their scale).  bf16: a
    hidden whose pre-activations straddle a bf16 rounding boundary lands
    one bf16 ulp apart (hiddens within 2^-7 of their scale, logits
    1e-3)."""
    spec = mlp.MLPSpec(hidden_sizes=hidden, activation=act,
                       compute_dtype=cdt)
    params = mlp.init(spec, seed=n, device=card)
    gen = torch.Generator(device=card).manual_seed(n)
    for k in params:
        if k.startswith("b"):
            params[k] = 0.1 * torch.randn(params[k].shape, generator=gen,
                                          device=card)
    x = torch.rand(n, 784, generator=gen, device=card)
    logits, hiddens = fused._mlp_forward_cuda(spec, params, x)
    want, want_h = fused.mlp_forward_reference(spec, params, x)
    tol, tol_h = (1e-4, 1e-4) if cdt == torch.float32 else (1e-3, 2 ** -7)
    atol = tol * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(logits, want, rtol=0, atol=atol)
    # the wrapper the trainer calls: the same launches, the same logits
    torch.testing.assert_close(fused.mlp_forward(spec, params, x), logits,
                               rtol=0, atol=0)
    assert [h.dtype for h in hiddens] == [cdt] * len(hidden)
    for h, w in zip(hiddens, want_h):
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(h.float(), w.float(), rtol=0,
                                   atol=tol_h * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [(256,), (4096, 136)])
def test_mlp_tensor_core_copy_routes_agree_on_card(card, hidden):
    """B1's bf16 GEMM takes a tile by TMA where the operand's rows are a
    multiple of 16 bytes and the tensor 16-byte aligned, and by 4-byte
    cp.async copies where it is only 4-byte aligned: the same values land
    in the same swizzled places of shared memory, so the two routes give
    the same bits.  x and every W shifted by 2 elements take the second
    route (N 136: TMA boxes past the last column, zero-filled)."""
    bf16 = torch.bfloat16
    spec = mlp.MLPSpec(hidden_sizes=hidden, activation="relu",
                       compute_dtype=bf16)
    params = mlp.init(spec, seed=3, device=card)
    gen = torch.Generator(device=card).manual_seed(3)
    for k in params:
        params[k] = (params[k].to(bf16) if k.startswith("W") else
                     0.1 * torch.randn(params[k].shape, generator=gen,
                                       device=card))
    x = torch.rand(300, 784, generator=gen, device=card).to(bf16)

    def shifted(t):
        buf = torch.empty(t.numel() + 2, dtype=t.dtype, device=card)
        view = buf[2:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4
        return view

    logits, hiddens = fused._mlp_forward_cuda(spec, params, x)
    moved = {k: shifted(v) if k.startswith("W") else v
             for k, v in params.items()}
    logits2, hiddens2 = fused._mlp_forward_cuda(spec, moved, shifted(x))
    assert torch.equal(logits, logits2)
    for h, h2 in zip(hiddens, hiddens2):
        assert torch.equal(h, h2)
    # and neither is wrong: the wide MLP's bf16 logits bound
    # (chip_smoke.MLP_RTOL), as 4096 hiddens sum their rounding flips
    want = fused.mlp_forward_reference(spec, params, x)[0]
    torch.testing.assert_close(logits, want, rtol=0,
                               atol=1e-2 * max(1.0, float(want.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_mlp_forward_gradients_on_card_match_cpu(card, cdt):
    """The autograd backward on the card (the kernel's hiddens; bf16
    products on the tensor cores with f32 output) against the same
    function on the CPU: 1e-4 of each gradient's scale in f32, 2e-2 in
    bf16.  One call is one counted launch."""
    spec = mlp.MLPSpec(hidden_sizes=(48, 20), activation="relu",
                       compute_dtype=cdt)
    params = mlp.init(spec, seed=0, device=card)
    x = torch.rand(70, 784, device=card)

    def grads(dev):
        leaves = {k: v.detach().to(dev).clone().requires_grad_(True)
                  for k, v in params.items()}
        xx = x.detach().to(dev).clone().requires_grad_(True)
        fused.mlp_forward(spec, leaves, xx).square().mean().backward()
        return {**{k: v.grad.cpu() for k, v in leaves.items()},
                "x": xx.grad.cpu()}

    fused.reset_launch_counts()
    on_card = grads(card)
    assert fused.launch_counts()["mlp_forward"] == 1
    on_cpu = grads("cpu")
    tol = 1e-4 if cdt == torch.float32 else 2e-2
    for k, want in on_cpu.items():
        torch.testing.assert_close(on_card[k], want, rtol=0,
                                   atol=tol * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_plain_mlp_gradients_on_card_match_cpu(card, act):
    """The plain ``mlp.apply`` in bf16 (the step without ``--pallas``,
    and gelu with it), differentiated by autograd through ``dot_f32``'s
    tensor-core products on the card, against the same function on the
    CPU: logits within 1e-2 and gradients within 2e-2 of their scale.
    The tensor cores sum each product in another order than the CPU, so
    a bf16 hidden whose two f32 pre-activations straddle a rounding
    boundary lands one ulp (2^-8) apart; the logits sum such flips:
    1.1e-3 to 1.3e-3 of their scale measured at the wide MLP
    (``chip_smoke.py`` phase 2b, which holds them to 1e-2), and 1.9e-3
    and 2.6e-3 seen here at a few of 700 logits.  The input comes from a
    seeded generator, so every run draws the same one."""
    spec = mlp.MLPSpec(hidden_sizes=(48, 20), activation=act,
                       compute_dtype=torch.bfloat16)
    params = mlp.init(spec, seed=1, device=card)
    x = torch.rand(70, 784,
                   generator=torch.Generator().manual_seed(7)).to(card)

    def run(dev):
        leaves = {k: v.detach().to(dev).clone().requires_grad_(True)
                  for k, v in params.items()}
        logits = mlp.apply(spec, leaves, x.to(dev))
        logits.square().mean().backward()
        return {"logits": logits.detach().cpu(),
                **{k: v.grad.cpu() for k, v in leaves.items()}}

    on_card, on_cpu = run(card), run("cpu")
    assert on_card["logits"].dtype == torch.float32
    assert on_card["W1"].dtype == torch.float32
    for k, want in on_cpu.items():
        tol = 1e-2 if k == "logits" else 2e-2
        torch.testing.assert_close(on_card[k], want, rtol=0,
                                   atol=tol * float(want.abs().max()))


@pytest.mark.cuda
def test_mlp_forward_refuses_what_the_kernel_does_not_take(card):
    spec = mlp.MLPSpec(hidden_sizes=(16,), activation="gelu")
    params = mlp.init(spec, device=card)
    with pytest.raises(ValueError, match="activation"):
        fused.mlp_forward(spec, params, torch.rand(4, 784, device=card))
    spec = mlp.MLPSpec(hidden_sizes=(16,))
    params = mlp.init(spec, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        fused.mlp_forward(spec, params,
                          torch.rand(784, 4, device=card).t())


def _close_scaled(got, want, tol, what, floor=1e-6):
    scale = max(float(want.float().abs().max()), floor)
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} x {scale}"


# kernel vs plain version on the same inputs: f32 sums in other orders
# (1e-4 of scale); bf16: the forward rounds p against the running max of
# its 64-key tiles where the plain version rounds against the row's
# final max, one bf16 ulp (2^-8) per element, and o itself is bf16
# (1e-2 of scale); the backward recomputes p from the same saved
# statistics on both sides, so only f32 sum orders and the rare bf16
# rounding flip of ds differ (1e-2 of scale in bf16 all the same).  The
# gradients' scale is floored at 1, the size of the N(0, 1) terms they
# sum: at S = 1 the one key has p = 1, so ds = dp - dlt is exactly 0 and
# dq and dk are the rounding noise of two O(1) sums on either side
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _check_flash_kernels(q, k, v, do, causal, tol, what):
    """B5 (both forms), B6 and B7 against their plain versions on the
    same inputs, the backward fed the plain forward's statistics."""
    _close_scaled(fa.flash_forward(q, k, v, causal),
                  fa.flash_attention_reference(q, k, v, causal), tol,
                  f"o {what}")
    acc, m, l = fa.flash_forward(q, k, v, causal, stats=True)
    acc_r, m_r, l_r = fa.flash_stats_reference(q, k, v, causal)
    for got, want, name in ((acc, acc_r, "acc"), (m, m_r, "m"),
                            (l, l_r, "l")):
        _close_scaled(got, want, tol, f"{name} {what}")
    o = fa.flash_attention_reference(q, k, v, causal)
    dlt = torch.sum(do.float() * o.float(), dim=-1)
    want = fa.flash_backward_reference(q, k, v, do, m_r, l_r, dlt, causal)
    got = (fa.flash_dq(q, k, v, do, m_r, l_r, dlt, causal),
           *fa.flash_dkv(q, k, v, do, m_r, l_r, dlt, causal))
    for g_, w_, name in zip(got, want, ("dq", "dk", "dv")):
        _close_scaled(g_, w_, tol, f"{name} {what}", floor=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 63, 65, 127, 129, 300, 1024])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain_on_card(card, dtype, causal, s):
    """B5 (both forms), B6 and B7 against their plain versions at head
    dims 16, 20, 64, 96 and 128, batch 2 and 3 heads.  S 65, 127 and 129
    straddle the 64-row tiles' edges; D 20 (not a multiple of 8) takes
    the bf16 kernels' scalar loads, the others their 16-byte
    asynchronous copies; 16 and 20 pad the head dim to the MMA depth."""
    for d in (16, 20, 64, 96, 128):
        gen = torch.Generator(device=card).manual_seed(s * 1000 + d)
        q, k, v, do = (torch.randn(2, s, 3, d, generator=gen,
                                   device=card).to(dtype)
                       for _ in range(4))
        _check_flash_kernels(q, k, v, do, causal, FLASH_TOL[dtype],
                             f"{dtype} causal={causal} S={s} D={d}")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_large_score_spread_on_card(card, dtype, causal):
    """q and k scaled by 4 (log2-domain scores with a spread of ~16 x
    log2(e) per row), so a row's running max moves across key tiles and
    the accumulator's rescale by alpha = exp2(m_old - m_new) carries
    real weight: S 1000 over 16 key tiles, D 128."""
    gen = torch.Generator(device=card).manual_seed(4)
    q, k, v, do = (torch.randn(2, 1000, 2, 128, generator=gen, device=card)
                   for _ in range(4))
    q, k, v, do = ((4 * q).to(dtype), (4 * k).to(dtype), v.to(dtype),
                   do.to(dtype))
    _check_flash_kernels(q, k, v, do, causal, FLASH_TOL[dtype],
                         f"{dtype} causal={causal} spread x4")


def _sass_functions(lib_path):
    """{mangled kernel name: its SASS} of the built kernel library."""
    import os
    import subprocess

    from distributed_tensorflow_example_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            cur = line.split("Function : ", 1)[1].strip()
            funcs[cur] = []
        elif cur is not None:
            funcs[cur].append(line)
    return {name: "\n".join(body) for name, body in funcs.items()}


@pytest.mark.cuda
def test_flash_bf16_kernels_use_tensor_cores(card):
    """The bf16 forward (4 instantiations: causal x stats), dq (2) and
    dk/dv (2), and the bf16 tensor-core GEMM that B1's layers and B8's
    two products share (8: B1's hidden and logits outputs; B8's bf16
    hidden with and without z1 and its f32 output or split-K shares,
    each at 256- and 128-wide tiles), issue
    tensor-core MMAs (HMMA or HGMMA in their SASS; HGMMA for dk/dv and
    the GEMM, which are wgmma only); the f32 forward (4), dq (2) and
    dk/dv (2) and the CUDA-core GEMM ``gemm_bias_act_kernel`` (the f32
    MLP layers and the f32 grouped FFN) issue none (f32 attention, the
    f32 MLP and the f32 FFN stay on f32 FMA: TF32 would break their 1e-4
    and 1e-3); no bf16 instantiation of the CUDA-core forward, dq, dk/dv
    or GEMM is left."""
    from distributed_tensorflow_example_tpu_torch.ops import _build

    funcs = _sass_functions(_build.build())
    tensor_ops = ("HMMA", "HGMMA")
    tc = {n: f for n, f in funcs.items()
          if "flash_fwd_tc_kernel" in n or "flash_dq_tc_kernel" in n
          or "flash_dkv_tc_kernel" in n or "gemm_bias_act_tc_kernel" in n}
    assert sum("flash_fwd_tc_kernel" in n for n in tc) == 4, sorted(funcs)
    assert sum("flash_dq_tc_kernel" in n for n in tc) == 2, sorted(funcs)
    assert sum("flash_dkv_tc_kernel" in n for n in tc) == 2, sorted(funcs)
    # each source that includes gemm_tc.cuh has its own copy (internal
    # linkage): B1's two in mlp_forward.cu; B8's six in grouped_ffn.cu,
    # bf16 out at both widths with and without z1, f32 out at both
    gemm = sorted(n for n in tc if "gemm_bias_act_tc_kernel" in n)
    assert len(gemm) == 8, gemm
    for src, frags in (("mlp_forward_cu", ("I13__nv_bfloat16Li2ELb0E",
                                           "IfLi2ELb0E")),
                       ("grouped_ffn_cu", ("I13__nv_bfloat16Li2ELb0E",
                                           "I13__nv_bfloat16Li2ELb1E",
                                           "I13__nv_bfloat16Li1ELb0E",
                                           "I13__nv_bfloat16Li1ELb1E",
                                           "IfLi2ELb0E", "IfLi1ELb0E"))):
        mine = [n for n in gemm if src in n]
        assert len(mine) == len(frags), (src, gemm)
        for frag in frags:
            assert sum(frag in n for n in mine) == 1, (src, frag, gemm)
    for name, sass in tc.items():
        assert any(op in sass for op in tensor_ops), name
        if "flash_dkv_tc_kernel" in name or "gemm_bias_act_tc_kernel" in name:
            assert "HGMMA" in sass, name
    plain = {n: f for n, f in funcs.items()
             if "flash_fwd_kernel" in n or "flash_dq_kernel" in n
             or "flash_dkv_kernel" in n}
    assert len(plain) == 8, sorted(funcs)
    for name, sass in plain.items():
        assert "__nv_bfloat16" not in name, name
        assert not any(op in sass for op in tensor_ops), name
    fma_gemm = {n: f for n, f in funcs.items()
                if "gemm_bias_act_kernel" in n}
    assert fma_gemm, sorted(funcs)
    for name, sass in fma_gemm.items():
        assert "__nv_bfloat16" not in name, name
        assert not any(op in sass for op in tensor_ops), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gradients_on_card_match_cpu(card, dtype):
    """``flash_attention`` under autograd (B5 stats, B6, B7) on the card
    against the same function on the CPU (plain versions), causal at a
    ragged S of 300: one launch of each kernel per call."""
    gen = torch.Generator(device=card).manual_seed(7)
    q, k, v, g = (torch.randn(2, 300, 2, 64, generator=gen, device=card)
                  .to(dtype) for _ in range(4))

    def run(dev):
        leaves = [t.detach().to(dev).clone().requires_grad_(True)
                  for t in (q, k, v)]
        o = fa.flash_attention(*leaves, True)
        return (o.detach().cpu(), *torch.autograd.grad(o, leaves,
                                                       g.to(dev)))

    fused.reset_launch_counts()
    on_card = run(card)
    torch.cuda.synchronize()
    counts = fused.launch_counts()
    assert (counts["flash_forward"], counts["flash_dq"],
            counts["flash_dkv"]) == (1, 1, 1)
    for got, want, name in zip(on_card, run("cpu"), ("o", "dq", "dk", "dv")):
        assert got.dtype == dtype
        _close_scaled(got.cpu(), want, FLASH_TOL[dtype], name)


@pytest.mark.cuda
def test_flash_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.randn(1, 64, 2, 130, device=card)
    with pytest.raises(ValueError, match="ROADMAP"):
        fa.flash_forward(q, q, q, True)
    q = torch.randn(1, 64, 2, 16, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_forward(q.transpose(1, 2), q.transpose(1, 2),
                         q.transpose(1, 2), True)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_forward(q, q.to(torch.bfloat16), q, True)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 129, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_backward_kernel_matches_plain_on_card(card, dtype,
                                                          rows):
    """B4 against its plain version at d 1024 and 96: dx, dg and db
    within 1e-4 of their scale (f32 sums in other orders; dg and db sum
    over up to 1000 rows)."""
    for d in (1024, 96):
        gen = torch.Generator(device=card).manual_seed(rows + d)
        x = (3 * torch.randn(rows, d, generator=gen, device=card)
             + 1).to(dtype)
        dy = torch.randn(rows, d, generator=gen, device=card)
        g = 1 + 0.1 * torch.randn(d, generator=gen, device=card)
        got = fused.layer_norm_backward(dy, x, g)
        want = fused.layer_norm_backward_reference(dy, x, g)
        for a, b, name in zip(got, want, ("dx", "dg", "db")):
            _close_scaled(a, b, 1e-4, f"{name} rows={rows} d={d} {dtype}")


@pytest.mark.cuda
def test_layer_norm_gradients_on_card_match_cpu(card):
    """``fused_layer_norm`` and ``fused_layer_norm_residual`` under
    autograd (B2/B3 forward, B4 backward) on the card against the CPU
    path, rank 3: 1e-4 of each gradient's scale."""
    gen = torch.Generator(device=card).manual_seed(3)
    x, r = (torch.randn(2, 37, 96, generator=gen, device=card)
            for _ in range(2))
    g = 1 + 0.1 * torch.randn(96, generator=gen, device=card)
    b = 0.1 * torch.randn(96, generator=gen, device=card)

    def run(dev):
        xs, rs, gs, bs = (t.detach().to(dev).clone().requires_grad_(True)
                          for t in (x, r, g, b))
        y1 = fused.fused_layer_norm(xs, gs, bs)
        y2, s2 = fused.fused_layer_norm_residual(xs, rs, gs, bs)
        loss = (y1 * y1).sum() + (y2 * torch.cos(y1)).sum() \
            + (s2 * s2).sum()
        return torch.autograd.grad(loss, (xs, rs, gs, bs))

    fused.reset_launch_counts()
    on_card = run(card)
    torch.cuda.synchronize()
    assert fused.launch_counts()["layer_norm_backward"] == 2
    for got, want, name in zip(on_card, run("cpu"), "xrgb"):
        _close_scaled(got.cpu(), want, 1e-4, name)

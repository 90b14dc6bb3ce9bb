"""The PyTorch port's CUDA kernels against their plain versions, on
the card; and the trainer's device-resident epoch there: the MLP's
step as a CUDA graph against the same epoch run eagerly, the launch
counts across replays, the epoch permutation card against CPU, the
pinned copy-stream prefetch against blocking copies, and the
data-parallel strategies' steps in a one-rank NCCL group (ZeRO-1, FSDP,
local SGD against the plain step; their graph epochs against the eager
ones, the collectives captured).

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


# B1's f32 layers at the reference MLP's rows (1, a training step's 100,
# eval's 2000), its 784-100-10 and a 4096-wide hidden layer
MLP_F32_SHAPES = [(n, hidden, act) for n in (1, 100, 2000)
                  for hidden, act in (((100,), "sigmoid"), ((100,), "relu"),
                                      ((100,), "tanh"), ((4096,), "relu"))]


def _mlp_f32_case(card, n, hidden, act):
    spec = mlp.MLPSpec(hidden_sizes=hidden, activation=act,
                       compute_dtype=torch.float32)
    params = mlp.init(spec, seed=n, device=card)
    gen = torch.Generator(device=card).manual_seed(n)
    for k in params:
        if k.startswith("b"):
            params[k] = 0.1 * torch.randn(params[k].shape, generator=gen,
                                          device=card)
    x = torch.rand(n, 784, generator=gen, device=card)
    return spec, params, x


@pytest.mark.cuda
@pytest.mark.parametrize("n,hidden,act", MLP_F32_SHAPES)
def test_mlp_f32_split_k_matches_plain_on_card(card, n, hidden, act):
    """B1's f32 layers (K split over a cluster, the shares summed in
    rank order) against the plain version: logits and hiddens within
    1e-4 of max(1, their scale) (f32 sums of 784 or 4096 products in
    another order), the same bits over two calls, and each layer's
    split the plan's."""
    spec, params, x = _mlp_f32_case(card, n, hidden, act)
    logits, hiddens = fused._mlp_forward_cuda(spec, params, x)
    sizes = spec.layer_sizes
    assert fused.mlp_forward.last_plan == ("fma", tuple(
        fused.mlp_f32_plan(n, sizes[i], sizes[i - 1], fused._sm_count(0))
        for i in range(1, len(sizes))))
    again, hiddens2 = fused._mlp_forward_cuda(spec, params, x)
    assert torch.equal(logits, again)
    assert all(torch.equal(a, b) for a, b in zip(hiddens, hiddens2))
    want, want_h = fused.mlp_forward_reference(spec, params, x)
    torch.testing.assert_close(
        logits, want, rtol=0, atol=1e-4 * max(1.0, float(want.abs().max())))
    for h, w in zip(hiddens, want_h):
        assert h.dtype == torch.float32 and h.shape == w.shape
        torch.testing.assert_close(
            h, w, rtol=0, atol=1e-4 * max(1.0, float(w.abs().max())))


@pytest.mark.cuda
def test_mlp_f32_load_routes_agree_on_card(card):
    """B1's f32 GEMM loads a row by 16-byte vectors where its width is a
    multiple of 4 and its base 16-byte aligned, else by guarded scalar
    loads: the same values reach the same places, so x and the weights
    moved one float off the boundary give the same bits."""
    spec, params, x = _mlp_f32_case(card, 100, (100,), "sigmoid")

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4
        return view

    logits, hiddens = fused._mlp_forward_cuda(spec, params, x)
    moved = {k: shifted(v) if k.startswith("W") else v
             for k, v in params.items()}
    logits2, hiddens2 = fused._mlp_forward_cuda(spec, moved, shifted(x))
    assert torch.equal(logits, logits2)
    assert torch.equal(hiddens[0], hiddens2[0])


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
    dk/dv (2) and the CUDA-core GEMMs, ``gemm_bias_act_kernel`` (the f32
    grouped FFN) and ``fma_gemm_kernel`` (the f32 MLP layers, its 4 load
    routes), issue none (f32 attention, the f32 MLP and the f32 FFN stay
    on f32 FMA: TF32 would break their 1e-4 and 1e-3); no bf16
    instantiation of the CUDA-core forward, dq, dk/dv or GEMMs is
    left."""
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
                if "gemm_bias_act_kernel" in n or "fma_gemm_kernel" in n}
    assert sum("fma_gemm_kernel" in n for n in fma_gemm) == 4, sorted(funcs)
    assert any("gemm_bias_act_kernel" in n for n in fma_gemm), sorted(funcs)
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


# B4's routes by row width at aligned tensors: the register path up to
# 1024 wide where the width is a multiple of 4 (96, 1000, 1024), the
# CTA-a-row kernel for 1001 (not a multiple of 4) and 1536 (wider than
# the registers hold)
LN_BWD_ROUTE_BY_D = {96: "warp", 1000: "warp", 1001: "block", 1024: "warp",
                     1536: "block"}


def _ln_bwd_expected_plan(rows, d, dtype, aligned=True):
    return fused.layer_norm_backward_plan(
        rows, d, aligned, fused._sm_count(0),
        fused._ln_bwd_ctas_per_sm(fused._DTYPE_CODES[dtype]))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 129, 1000, 65539])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_backward_kernel_matches_plain_on_card(card, dtype,
                                                          rows):
    """B4 against its plain version at d 96, 1000, 1001, 1024 and 1536,
    on both routes (fewer rows than the warps in flight included): dx, dg
    and db within 1e-4 of their scale (f32 sums in other orders; dg and
    db sum over up to 65,539 rows), and the route and CTA count the
    wrapper records are the plan's."""
    for d, route in LN_BWD_ROUTE_BY_D.items():
        gen = torch.Generator(device=card).manual_seed(rows + d)
        x = (3 * torch.randn(rows, d, generator=gen, device=card)
             + 1).to(dtype)
        dy = torch.randn(rows, d, generator=gen, device=card)
        g = 1 + 0.1 * torch.randn(d, generator=gen, device=card)
        got = fused.layer_norm_backward(dy, x, g)
        assert fused.layer_norm_backward.last_plan == \
            _ln_bwd_expected_plan(rows, d, dtype)
        assert fused.layer_norm_backward.last_plan[0] == route
        want = fused.layer_norm_backward_reference(dy, x, g)
        for a, b, name in zip(got, want, ("dx", "dg", "db")):
            _close_scaled(a, b, 1e-4, f"{name} rows={rows} d={d} {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1024, 1536])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_backward_is_deterministic_on_card(card, dtype, d):
    """dx, dg and db are the same bits over two calls on either route:
    each warp walks its rows in order, the CTA adds its warps in order
    and the partial rows are summed in a fixed order, with no atomics."""
    gen = torch.Generator(device=card).manual_seed(d)
    x = (2 * torch.randn(65539, d, generator=gen, device=card)).to(dtype)
    dy = torch.randn(65539, d, generator=gen, device=card)
    g = 1 + 0.1 * torch.randn(d, generator=gen, device=card)
    first = fused.layer_norm_backward(dy, x, g)
    second = fused.layer_norm_backward(dy, x, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_backward_misaligned_rows_take_the_block_route(card,
                                                                   dtype):
    """x or dy whose base is off its vector's boundary (a view one
    element into a buffer) goes to the CTA-a-row kernel, with the same
    result as the aligned call within 1e-4 of scale."""
    gen = torch.Generator(device=card).manual_seed(5)
    rows, d = 300, 1024
    x = (2 * torch.randn(rows, d, generator=gen, device=card)).to(dtype)
    dy = torch.randn(rows, d, generator=gen, device=card)
    g = 1 + 0.1 * torch.randn(d, generator=gen, device=card)
    want = fused.layer_norm_backward(dy, x, g)
    assert fused.layer_norm_backward.last_plan[0] == "warp"
    for moved in ("x", "dy"):
        t = x if moved == "x" else dy
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        args = (dy, view, g) if moved == "x" else (view, x, g)
        got = fused.layer_norm_backward(*args)
        assert fused.layer_norm_backward.last_plan == \
            _ln_bwd_expected_plan(rows, d, dtype, aligned=False)
        assert fused.layer_norm_backward.last_plan[0] == "block"
        for a, b, name in zip(got, want, ("dx", "dg", "db")):
            _close_scaled(a, b, 1e-4, f"{name} {moved} moved")


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


# ---------------------------------------------------------------------------
# the device-resident epoch: the MLP step as a CUDA graph
# ---------------------------------------------------------------------------


def _mlp_epoch_setup(card, cdt, n=8 * 96, batch=96):
    from distributed_tensorflow_example_tpu_torch.config import Config
    from distributed_tensorflow_example_tpu_torch.data import mnist
    from distributed_tensorflow_example_tpu_torch.parallel import epoch
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)

    cfg = Config(hidden_sizes=(96, 48), activation="relu",
                 compute_dtype=cdt, pallas=True, optimizer="adam",
                 learning_rate=0.01, batch_size=batch, device="cuda")
    spec = loop.make_spec(cfg)
    opt = optim.make_optimizer(cfg, 16)
    split = mnist.synthesize_split(n + 5, seed=2)
    img, lbl, spe = epoch.shard_dataset(split.images, split.labels, batch,
                                        card)
    assert img.dtype == torch.uint8 and spe == n // batch
    state = create_train_state(spec, opt, seed=4, device=card)
    return cfg, spec, opt, img, lbl, spe, state


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_graph_epoch_matches_eager_epoch_on_card(card, cdt):
    """Two epochs of the MLP step replayed as a CUDA graph against the
    same device-resident epoch run eagerly, from one state: the same
    kernels in the same order, so the per-step costs and accuracies and
    the final params and Adam slots agree bitwise."""
    from distributed_tensorflow_example_tpu_torch.parallel import epoch
    from distributed_tensorflow_example_tpu_torch.train.optim import (
        tree_leaves)
    from distributed_tensorflow_example_tpu_torch.utils import prng

    cfg, spec, opt, img, lbl, spe, state = _mlp_epoch_setup(card, cdt)
    assert epoch.captures(spec, card)
    key = prng.PRNGKey(cfg.seed + epoch.SHUFFLE_SALT)
    outs = []
    for cls in (epoch._GraphRunner, epoch._EagerRunner):
        st = epoch._clone_state(state)
        run = cls(cfg, spec, opt, spe, 2)
        st, costs, accs = run(st, img, lbl, key, 0)
        outs.append((st, costs, accs))
    (g, gc, ga), (e, ec, ea) = outs
    assert torch.equal(gc, ec) and torch.equal(ga, ea)
    assert torch.isfinite(gc).all() and int(g.step) == int(e.step) == 2 * spe
    for a, b in zip(tree_leaves(g.params) + tree_leaves(g.opt_state),
                    tree_leaves(e.params) + tree_leaves(e.opt_state),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_graph_replays_raise_the_launch_counts_on_card(card):
    """``launch_counts()`` stays true across replays: the warm-up's real
    launches plus one captured step's launches per replay (the capture
    itself launches nothing); a second call of the same runner replays
    without capturing again."""
    from distributed_tensorflow_example_tpu_torch.ops import fused
    from distributed_tensorflow_example_tpu_torch.parallel import epoch
    from distributed_tensorflow_example_tpu_torch.utils import prng

    cfg, spec, opt, img, lbl, spe, state = _mlp_epoch_setup(card,
                                                            "bfloat16")
    key = prng.PRNGKey(1)
    run = epoch.build_epoch_runner(cfg, spec, opt, spe, card)
    fused.reset_launch_counts()
    state, costs, _ = run(state, img, lbl, key, 0)
    torch.cuda.synchronize()
    graph = run.run1.graphs[False]      # the one (non-averaging) step
    assert run.run1.delta == {False: {"mlp_forward": 1}}
    assert fused.launch_counts()["mlp_forward"] == epoch.WARMUP_STEPS + spe
    state, costs2, _ = run(state, img, lbl, key, 1)
    torch.cuda.synchronize()
    assert run.run1.graphs == {False: graph}
    assert fused.launch_counts()["mlp_forward"] == (epoch.WARMUP_STEPS
                                                    + 2 * spe)
    assert int(state.step) == 2 * spe
    assert not torch.equal(costs, costs2)


@pytest.fixture
def one_rank_group(card):
    """A one-rank NCCL group on the card for the test's duration (as
    ``cluster.bootstrap`` sets one up from ``--coordinator_address``
    with ``--num_processes=1``)."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _strategy(cfg, spec, opt, card, flags):
    import dataclasses

    from distributed_tensorflow_example_tpu_torch.parallel import mesh
    from distributed_tensorflow_example_tpu_torch.train import loop
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)

    cfg = dataclasses.replace(cfg, **flags)
    return cfg, loop.setup_strategy(
        cfg, spec, opt, create_train_state(spec, opt, seed=4, device=card),
        mesh.build_mesh(-1), fast=cfg.fast_loop)


ONE_RANK_STRATEGIES = {"zero": dict(zero_opt=True, fast_loop=False),
                       "fsdp": dict(fsdp=True),
                       "local_sgd": dict(sync_period=2)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ONE_RANK_STRATEGIES))
def test_one_rank_group_strategy_steps_match_plain_on_card(
        card, one_rank_group, name):
    """In a one-rank NCCL group, two steps of ZeRO-1 (chunked Adam, the
    params all-gathered), FSDP (params all-gathered, gradients
    reduce-scattered) and local SGD (the local step, then the average)
    from one state on the same batches give the synchronous step's
    params bitwise: at one rank each collective is a copy or the
    identity, and Adam runs elementwise on the same values."""
    from distributed_tensorflow_example_tpu_torch.parallel import step
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)

    cfg, spec, opt, img, lbl, spe, _state = _mlp_epoch_setup(card,
                                                             "bfloat16")
    plain = create_train_state(spec, opt, seed=4, device=card)
    sync = step.make_sync_step_body(cfg, spec, opt)
    cfg, strat = _strategy(cfg, spec, opt, card, ONE_RANK_STRATEGIES[name])
    state = strat.state
    for i in range(2):
        x = img[i * 96:(i + 1) * 96].to(torch.float32) / 255.0
        y = lbl[i * 96:(i + 1) * 96]
        plain = sync(plain, x, y)[0]
        state = strat.body(state, x, y)[0]
        if strat.sync_period:
            state = step.param_sync(state)
    got = strat.get_params(state) if strat.get_params else state.params
    for k, v in plain.params.items():
        assert torch.equal(got[k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["plain", "fsdp", "local_sgd"])
def test_one_rank_group_graph_epoch_matches_eager_on_card(
        card, one_rank_group, name):
    """The device-resident epoch in a one-rank NCCL group, its step a
    CUDA graph with the collectives captured (the sync step's
    all-reduce; FSDP's all-gather and reduce-scatter; local SGD's two
    graphs, the average every second step), against the same epoch run
    eagerly: costs and params bitwise."""
    from distributed_tensorflow_example_tpu_torch.parallel import epoch
    from distributed_tensorflow_example_tpu_torch.utils import prng

    cfg, spec, opt, img, lbl, spe, _state = _mlp_epoch_setup(card,
                                                             "bfloat16")
    flags = {} if name == "plain" else ONE_RANK_STRATEGIES[name]
    key = prng.PRNGKey(3)
    outs = []
    for cls in (epoch._GraphRunner, epoch._EagerRunner):
        cfg_s, strat = _strategy(cfg, spec, opt, card, flags)
        run = cls(cfg_s, spec, opt, spe, 1, body=strat.body,
                  sync_period=strat.sync_period)
        st, costs, _accs = run(strat.state, img, lbl, key, 0)
        outs.append((st, costs))
    (g, gc), (e, ec) = outs
    assert torch.equal(gc, ec) and torch.isfinite(gc).all()
    for k in g.params:
        assert torch.equal(g.params[k], e.params[k]), k


# a rank of the two-rank TP step: a gloo group on the card (NCCL refuses
# two ranks on one device), one SGD step of the Megatron-split state,
# the params gathered to the full layout, the flash kernels' head count
TP_RANK = r'''
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
from distributed_tensorflow_example_tpu_torch.config import Config
from distributed_tensorflow_example_tpu_torch.ops import flash_attention
from distributed_tensorflow_example_tpu_torch.parallel import mesh
from distributed_tensorflow_example_tpu_torch.train import loop, optim
from distributed_tensorflow_example_tpu_torch.train.state import (
    create_train_state)
from distributed_tensorflow_example_tpu_torch.utils import checkpoint

cfg = Config(**TP_CFG, model_parallel=2, device="cuda")
spec = loop.make_spec(cfg)
opt = optim.make_optimizer(cfg)
m = mesh.build_mesh(-1, 2)
strat = loop.setup_strategy(
    cfg, spec, opt, create_train_state(spec, opt, seed=4, device="cuda"),
    m, fast=False)
g = torch.Generator(device="cuda").manual_seed(9)
x = torch.rand((4, cfg.input_size), generator=g, device="cuda")
y = torch.eye(10, device="cuda")[torch.arange(4, device="cuda") % 10]
new, cost, _acc = strat.body(strat.state, x, y)
full = checkpoint.gather_global(new, strat.layout)
if rank == 0:
    np.savez(out, cost=cost.cpu().numpy(),
             heads=flash_attention.flash_forward.last_shape[2],
             **{k: v.cpu().numpy() for k, v in full.items()
                if k.startswith(".params/")})
dist.barrier()
dist.destroy_process_group()
'''
TP_CFG = dict(model="transformer", attention="flash", causal=True,
              fused_ln=True, input_size=512, seq_len=256, d_model=256,
              n_heads=4, num_blocks=2, d_ff=512, optimizer="sgd",
              learning_rate=0.1, batch_size=4)


@pytest.mark.cuda
def test_two_rank_tp_step_matches_one_rank_on_card(card, tmp_path):
    """Two gloo ranks at ``--model_parallel=2`` on the card: one SGD step
    of a small f32 transformer (flash, fused LayerNorms) over the
    Megatron shards, gathered, within 1e-4 of each leaf's scale of the
    one-rank step from the same state on the same batch (the row-split
    products add two f32 partial sums); B5 saw 2 of the 4 heads."""
    import socket
    import subprocess
    import sys

    import numpy as np

    from distributed_tensorflow_example_tpu_torch.config import Config
    from distributed_tensorflow_example_tpu_torch.parallel import step
    from distributed_tensorflow_example_tpu_torch.train import loop, optim
    from distributed_tensorflow_example_tpu_torch.train.state import (
        create_train_state)

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = str(tmp_path / "tp.npz")
    prog = f"TP_CFG = {TP_CFG!r}\n" + TP_RANK
    procs = [subprocess.Popen([sys.executable, "-c", prog, str(r),
                               str(port), out], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    cfg = Config(**TP_CFG, device="cuda")
    spec = loop.make_spec(cfg)
    opt = optim.make_optimizer(cfg)
    state = create_train_state(spec, opt, seed=4, device=card)
    g = torch.Generator(device=card).manual_seed(9)
    x = torch.rand((4, cfg.input_size), generator=g, device=card)
    y = torch.eye(10, device=card)[torch.arange(4, device=card) % 10]
    new, cost, _acc = step.make_sync_step_body(cfg, spec, opt)(state, x, y)
    with np.load(out) as z:
        assert int(z["heads"]) == 2
        assert abs(float(z["cost"]) - float(cost)) <= 1e-4 * abs(float(cost))
        for k, v in new.params.items():
            want = v.cpu().numpy()
            scale = max(float(np.abs(want).max()), 1e-6)
            assert np.abs(z[".params/" + k] - want).max() <= 1e-4 * scale, k


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 100, 4099, 55000, 65536])
def test_permutation_on_card_matches_cpu(card, n):
    """The fast path's per-epoch permutation drawn on the card equals
    the one drawn on the CPU, bit for bit (the CPU one is held to
    ``jax.random.permutation`` by tests/test_torch_prng.py)."""
    from distributed_tensorflow_example_tpu_torch.utils import prng

    key = prng.fold_in(prng.fold_in(prng.PRNGKey(1 + 0x5EED), 0), 3)
    got = prng.permutation(key, n, card)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), prng.permutation(key, n, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["numpy", "pinned"])
def test_device_prefetch_batches_equal_blocking_copies_on_card(card,
                                                               source):
    """``DevicePrefetcher`` over ``CopyStreamCommit``: non-blocking
    copies from pinned memory on a copy stream (numpy batches pinned by
    the commit, or ``pinned_batches`` gathered straight into pinned
    memory, as the trainer's producer does), each batch taken on the
    current stream after its event, equal to the blocking copies."""
    from distributed_tensorflow_example_tpu_torch.data import (
        CopyStreamCommit, DevicePrefetcher, EpochIterator, mnist,
        pinned_batches, take)

    split = mnist.synthesize_split(300, seed=5)
    it = EpochIterator(split, batch_size=32, seed=1, shard=False)
    want = [(torch.from_numpy(x).to(card), torch.from_numpy(y).to(card))
            for x, y in it.epoch(0)]
    if source == "pinned":
        batches = list(pinned_batches(split, it.batch_indices(0)))
        assert all(x.is_pinned() and y.is_pinned() for x, y in batches)
    else:
        batches = it.epoch(0)
    feed = DevicePrefetcher(CopyStreamCommit(card), depth=3)
    got = []
    for item in feed.rewind(batches):
        assert item[0].device.type == "cuda" and item[2] is not None
        x, y = take(*item)
        got.append((x * 1, y * 1))      # used on the current stream
    feed.close()
    assert len(got) == len(want) == 300 // 32
    for (gx, gy), (wx, wy) in zip(got, want):
        assert torch.equal(gx, wx) and torch.equal(gy, wy)


def _lm(**kw):
    from distributed_tensorflow_example_tpu_torch.models import (
        transformer as tfm)

    spec = tfm.TransformerSpec(
        input_size=64, seq_len=64, d_model=64, n_heads=2, num_blocks=2,
        d_ff=128, objective="lm", vocab_size=64, causal=True,
        fused_ln=True, compute_dtype=torch.bfloat16, **kw)
    return spec, tfm.init(spec, seed=3, device="cpu")


@pytest.mark.cuda
def test_int8_paged_decode_on_card_matches_cpu(card):
    """Six chained int8 paged decode steps of 3 sequences (bf16, fused
    LayerNorms: B2 and B3 on the card) against the port's CPU path on
    the same params and tokens: logits within 5e-2 absolute (bf16 rows
    round apart where the two sides' f32 sums differ, and an int8 value
    then one step apart), the int8 pools within one step and the scale
    planes within 1e-2 relative."""
    from distributed_tensorflow_example_tpu_torch.serving import (
        kv_cache as kvc)

    spec, params = _lm()
    b, steps, ps = 3, 6, 4
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, 64, (steps, b), generator=gen)
    per = steps // ps + 1
    bt = torch.tensor([[1 + i * per + j for j in range(per)]
                       for i in range(b)])
    caches = {d: kvc.init_paged_cache(spec, 1 + b * per, ps, quant="int8",
                                      device=d) for d in ("cpu", card)}
    on_card = {k: v.to(card) for k, v in params.items()}
    fused.reset_launch_counts()
    for pos in range(steps):
        posv = torch.full((b,), pos)
        got, caches[card] = kvc.paged_decode_step(
            spec, on_card, caches[card], bt.to(card), toks[pos].to(card),
            posv.to(card))
        want, caches["cpu"] = kvc.paged_decode_step(
            spec, params, caches["cpu"], bt, toks[pos], posv)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=5e-2)
    assert fused.launch_counts()["fused_layer_norm"] > 0
    for k, want in caches["cpu"].items():
        got = caches[card][k].cpu()
        assert got.dtype == want.dtype, k
        if k.endswith("_s"):
            torch.testing.assert_close(got, want, rtol=1e-2, atol=0)
        else:
            assert int((got.int() - want.int()).abs().max()) <= 1, k


@pytest.mark.cuda
@pytest.mark.parametrize("topk", [1, 2])
def test_moe_decode_step_on_card_matches_cpu(card, topk):
    """Eight contiguous decode steps of a MoE lm (E 4, dense dispatch,
    bf16) on the card against the port's CPU path: logits within 5e-2
    absolute; no grouped-FFN launch (dense dispatch never reaches
    it)."""
    from distributed_tensorflow_example_tpu_torch.models import (
        transformer as tfm)

    spec, params = _lm(num_experts=4, moe_topk=topk,
                       moe_dispatch="alltoall")
    on_card = {k: v.to(card) for k, v in params.items()}
    gen = torch.Generator().manual_seed(topk)
    toks = torch.randint(0, 64, (8, 2), generator=gen)
    caches = {"cpu": tfm.init_decode_cache(spec, 2, device="cpu"),
              card: tfm.init_decode_cache(spec, 2, device=card)}
    fused.reset_launch_counts()
    for pos in range(8):
        got, caches[card] = tfm.decode_step(spec, on_card, caches[card],
                                            toks[pos].to(card), pos)
        want, caches["cpu"] = tfm.decode_step(spec, params, caches["cpu"],
                                              toks[pos], pos)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=5e-2)
    counts = fused.launch_counts()
    assert counts["moe_grouped_matmul"] == 0
    assert counts["fused_layer_norm"] > 0


@pytest.mark.cuda
def test_traced_engine_on_card_writes_a_valid_span_file(card, tmp_path):
    """A traced engine on the card (int8 pools, a SpanRecorder and SLO
    specs): every request completes, its lifecycle reconstructs
    complete, its waterfall tiles its wall, and every row of the span
    file validates."""
    from distributed_tensorflow_example_tpu_torch.obs import (
        schema, slo, spans, waterfall)
    from distributed_tensorflow_example_tpu_torch.serving.engine import (
        DecodeEngine)

    spec, params = _lm()
    rec = spans.SpanRecorder(str(tmp_path))
    eng = DecodeEngine(spec, params, page_size=4, max_batch=2,
                       kv_quant="int8", recorder=rec,
                       slos=slo.parse_specs("ttft_p99_ms<=60000"),
                       device=card)
    rids = [eng.submit(list(range(1, n)), 5) for n in (4, 9, 6)]
    eng.run_until_idle()
    eng.step()
    rec.close()
    assert all(eng.result(r)["status"] == "result" for r in rids)
    rows = spans.read_spans(rec.path)
    recs = spans.reconstruct(rows)
    assert all(recs[(0, r)]["complete"] for r in rids)
    docs = waterfall.waterfalls(rows)
    assert len(docs) == 3 and waterfall.summarize(docs)["sum_to_wall_ok"]
    assert schema.validate_span_file(rec.path) == []


@pytest.mark.cuda
def test_two_engines_on_card_sum_their_launch_counts(card):
    """Two engines over one params copy on the card, each in its own
    thread and each given the same requests before it starts: each
    engine's tokens equal a lone engine's, and the process-wide launch
    counters read the fleet's total, twice the lone engine's (B2, B3
    and B8 each launched)."""
    from distributed_tensorflow_example_tpu_torch.serving.engine import (
        DecodeEngine)

    spec, params = _lm(fp8_ffn=True)
    params = {k: v.to(card) for k, v in params.items()}
    prompts = [list(range(1, n)) for n in (4, 9, 6)]

    def run(n):
        engines = [DecodeEngine(spec, params, page_size=4, max_batch=2,
                                device=card) for _ in range(n)]
        assert all(e.params[k] is params[k] for e in engines for k in params)
        rids = [[e.submit(p, 5) for p in prompts] for e in engines]
        torch.cuda.synchronize()
        fused.reset_launch_counts()
        for e in engines:
            e.start()
        toks = [[e.result(r, timeout=120)["tokens"] for r in rs]
                for e, rs in zip(engines, rids)]
        for e in engines:
            e.stop()
        torch.cuda.synchronize()
        return toks, fused.launch_counts()

    one, alone = run(1)
    two, fleet = run(2)
    assert two == one * 2
    for name in ("fused_layer_norm", "fused_layer_norm_residual",
                 "moe_grouped_matmul"):
        assert alone[name] > 0, name
    assert fleet == {k: 2 * v for k, v in alone.items()}


@pytest.mark.cuda
def test_router_over_one_engine_on_card_is_bitwise_invisible(card):
    """Greedy and sampled requests submitted before the engine starts:
    through a router over that one engine on the card, the tokens equal
    the bare engine's."""
    from distributed_tensorflow_example_tpu_torch.serving import router
    from distributed_tensorflow_example_tpu_torch.serving.engine import (
        DecodeEngine)

    spec, params = _lm(fp8_ffn=True)
    prompts = [list(range(1, n)) for n in (4, 9, 6, 3)]
    temps = (0.0, 0.8, 0.0, 1.1)

    def run(routed):
        eng = DecodeEngine(spec, params, page_size=4, max_batch=2, seed=2,
                           device=card)
        front = router.Router([eng]) if routed else eng
        rids = [front.submit(p, 5, temperature=t)
                for p, t in zip(prompts, temps)]
        eng.start()
        out = [front.result(r, timeout=120)["tokens"] for r in rids]
        eng.stop()
        return out

    assert run(True) == run(False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_host_snapshot_on_card_is_pinned_and_exact(card, dtype, tmp_path):
    """The trainer's snapshot copy on the card: pinned host buffers
    filled by non-blocking copies, the event recorded after them; the
    writer waits on it, and the store restores the card's tensors
    bitwise, while later steps keep running on the card."""
    from distributed_tensorflow_example_tpu_torch.resilience import manifest
    from distributed_tensorflow_example_tpu_torch.resilience.writer import (
        CheckpointWriter)
    from distributed_tensorflow_example_tpu_torch.train import loop
    from distributed_tensorflow_example_tpu_torch.train.state import (
        TrainState)

    gen = torch.Generator(device=card).manual_seed(3)
    params = {"W1": torch.randn(777, 513, generator=gen,
                                device=card).to(dtype),
              "b1": torch.randn(513, generator=gen, device=card)}
    state = TrainState(torch.tensor(6, dtype=torch.int32, device=card),
                       params, ())
    loop._reserve_host_buffers(state, card)
    snap, ready = loop._host_snapshot(state, card)
    assert ready is not None and all(t.is_pinned() for t in snap.values())
    # the card keeps working after the copies were enqueued
    busy = params["W1"].float() @ params["W1"].float().T
    writer = CheckpointWriter(str(tmp_path))
    writer.submit(6, 0, snap, ready=ready)
    writer.close()
    found, _ = manifest.newest_valid_snapshot(str(tmp_path))
    data, step, _ = manifest.restore_arrays(str(tmp_path), found)
    assert step == 6 and busy.isfinite().all()
    assert torch.equal(data[".params/W1"], params["W1"].cpu())
    assert torch.equal(data[".params/b1"], params["b1"].cpu())
    assert data[".params/W1"].dtype == dtype


@pytest.mark.cuda
def test_resumed_wide_mlp_on_card_is_bitwise(card, tmp_path):
    """Four host-path steps of a 784-512-512-10 bf16 MLP under --pallas
    with a snapshot every 2 steps, and the same run resumed with
    --resume=auto from its step-2 snapshot: the final snapshots bitwise
    equal, B1 launched in both."""
    import contextlib
    import io
    import os

    from distributed_tensorflow_example_tpu_torch.config import (
        parse_train_config)
    from distributed_tensorflow_example_tpu_torch.resilience import manifest
    from distributed_tensorflow_example_tpu_torch.train import loop

    flags = ["--hidden_sizes=512,512", "--activation=relu",
             "--compute_dtype=bfloat16", "--batch_size=256", "--pallas",
             "--dataset=synthetic", "--synthetic_train_size=1024",
             "--synthetic_test_size=256", "--training_epochs=1",
             "--no_summaries", "--ckpt_every=2"]

    def run(name, extra=()):
        fused.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            loop.run(parse_train_config(flags + [
                f"--checkpoint_dir={tmp_path / name}",
                f"--logs_path={tmp_path / (name + '_logs')}"] + list(extra)))
        torch.cuda.synchronize()
        assert fused.launch_counts()["mlp_forward"] > 0
        found, _ = manifest.newest_valid_snapshot(str(tmp_path / name))
        return manifest.restore_arrays(str(tmp_path / name), found)[0]

    want = run("ref")
    run("cut")
    cut = str(tmp_path / "cut")
    for step, name in manifest.list_snapshots(cut):
        if step > 2:
            os.remove(os.path.join(cut, name))
    got = run("cut", ["--resume=auto"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

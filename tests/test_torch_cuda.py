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

from distributed_tensorflow_example_tpu_torch.ops import fused


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
    ragged shape (E=2, C=70, d=96, ff=200): 1e-3 of the output scale."""
    gen = torch.Generator(device=card).manual_seed(1)
    e, c, d, ff = 2, 70, 96, 200
    args = (torch.randn(e, c, d, generator=gen, device=card),
            torch.randn(e, d, ff, generator=gen, device=card) / d ** 0.5,
            torch.randn(e, ff, generator=gen, device=card),
            torch.randn(e, ff, d, generator=gen, device=card) / ff ** 0.5,
            torch.randn(e, d, generator=gen, device=card))
    got = fused.moe_grouped_matmul("gelu", cdt, *args)
    want = fused.grouped_ffn_reference("gelu", cdt, *args)
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
@pytest.mark.parametrize("activation", ["relu", "tanh", "sigmoid"])
def test_grouped_ffn_activations_on_card(card, activation):
    gen = torch.Generator(device=card).manual_seed(2)
    args = (torch.randn(1, 9, 64, generator=gen, device=card),
            torch.randn(1, 64, 130, generator=gen, device=card) / 8,
            torch.randn(1, 130, generator=gen, device=card),
            torch.randn(1, 130, 64, generator=gen, device=card) / 11,
            torch.randn(1, 64, generator=gen, device=card))
    got = fused.moe_grouped_matmul(activation, torch.float32, *args)
    want = fused.grouped_ffn_reference(activation, torch.float32, *args)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-3 * float(want.abs().max()))


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
                                       b1[None], w2q, b2[None])[0]
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
        "moe_grouped_matmul": 1}
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_layer_norm(torch.randn(64, 4, device=card).t(), g, b)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        fused.fused_layer_norm(x, g.cpu(), b)
    wide = torch.randn(2, 12257, device=card)
    with pytest.raises(ValueError, match="limit"):
        fused.fused_layer_norm(wide, torch.ones(12257, device=card),
                               torch.zeros(12257, device=card))
    assert fused.launch_counts()["fused_layer_norm"] == 1

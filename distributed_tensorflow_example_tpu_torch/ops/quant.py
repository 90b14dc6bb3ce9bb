"""Symmetric int8 quantization and fp8 (e4m3) rounding with power-of-two
scales (the JAX package's ``ops/quant.py``): the int8 paged KV pools, the
fp8 FFN and the multi-site outer sync's int8 error-feedback compression
use them.

int8 is symmetric per axis: ``q = clip(round(x / s), -127, 127)`` with
``s = amax / 127`` (1.0 for an all-zero tile), rounding half to even,
and ``dequantize`` is one multiply, bit for bit as the JAX package
computes them on the CPU.  Error feedback (``ef_compress_int8``) adds the
carried residual before quantizing and returns the new residual, so the
compressed outer sync of ``parallel/local_sgd.py`` stays unbiased over
rounds.

A pow2 scale only shifts the exponent, so ``x / s`` and ``q * s`` are
exact in any binary float format: the rounded values sit exactly on a
scaled fp8 grid that bf16 and f32 represent losslessly, and a matmul
over them computes what an fp8-input matmul with f32 accumulation
computes.  Plain PyTorch (elementwise ops and reductions): no kernel.
"""

from __future__ import annotations

import math

import torch

# symmetric int8: q in [-127, 127] (no -128, so dequantize is one
# multiply and the format is sign-stable)
INT8_MAX = 127.0

# largest finite float8_e4m3fn magnitude; the cast does not saturate
# to it (out-of-range values become nan), hence the explicit clip
FP8_E4M3_MAX = 448.0


def _amax(x: torch.Tensor, axis=None) -> torch.Tensor:
    """max |x| over ``axis`` (None = all) in f32, keepdims so the
    result broadcasts back over ``x``."""
    a = x.to(torch.float32).abs()
    if axis is None:
        axis = tuple(range(a.dim()))
    return torch.amax(a, dim=axis, keepdim=True)


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 scale of a tile whose largest magnitude is
    ``amax``: ``amax / 127``, 1.0 where the tile is all zero (q is then
    0 whatever the scale)."""
    amax = torch.as_tensor(amax, dtype=torch.float32)
    # a full tensor, not a scalar: a division by a scalar is a multiply
    # by its rounded reciprocal, which is not amax / 127 for every amax
    return torch.where(amax > 0.0, amax / torch.full_like(amax, INT8_MAX),
                       torch.ones_like(amax))


def quantize_int8(x: torch.Tensor, axis=None):
    """``(q int8, scale f32)``: ``axis`` is the axis or axes the scale
    reduces over (None = one scale for the tensor), kept as size-1 dims
    so ``q * scale`` broadcasts.  Rounds half to even, clipped to
    [-127, 127]."""
    scale = int8_scale(_amax(x, axis))
    q = torch.clamp(torch.round(x.to(torch.float32) / scale),
                    -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` in f32, cast to ``dtype``; ``scale`` must broadcast
    (``quantize_int8`` keeps its reduced dims)."""
    return (q.to(torch.float32) * scale).to(dtype)


def int8_roundtrip(x: torch.Tensor, axis=None) -> torch.Tensor:
    """``dequantize_int8(*quantize_int8(x, axis))`` in f32: the values an
    int8 wire carries, each within ``amax / 254`` of ``x``."""
    q, scale = quantize_int8(x, axis)
    return dequantize_int8(q, scale)


def ef_compress_int8(x: torch.Tensor, ef: torch.Tensor, axis=None):
    """One error-feedback compression step: ``c = x + ef`` in f32, then
    ``(int8_roundtrip(c), c - int8_roundtrip(c))``: the values the wire
    carries and the residual the next round adds back.  The sum of the
    carried values tracks the sum of the inputs to within one
    quantization step, however many rounds run."""
    c = x.to(torch.float32) + ef.to(torch.float32)
    dq = int8_roundtrip(c, axis)
    return dq, c - dq


def pow2_scale(amax: torch.Tensor, fmt_max: float = FP8_E4M3_MAX):
    """The smallest power of two ``s`` with ``amax / s <= fmt_max``
    (1.0 for an all-zero tile).  The exponent is
    ``ceil(log2(amax / fmt_max))`` taken in f32, exactly as the JAX
    package takes it (``frexp`` disagrees just above 448 * 2^k), and
    ``s`` is built with ``ldexp`` from the integer exponent, so it is
    exactly 2^e."""
    amax = torch.as_tensor(amax, dtype=torch.float32)
    # a full tensor, not a scalar: PyTorch divides by a scalar as a
    # multiply by its (inexact) reciprocal, which moves amax/448 by an
    # ulp and flips the ceiling at amax just above 448 * 2^k
    fmax = torch.full_like(amax, fmt_max)
    safe = torch.where(amax > 0.0, amax, fmax)
    e = torch.ceil(_log2_as_jax(safe / fmax)).to(torch.int32)
    s = _exp2_int(e)
    return torch.where(amax > 0.0, s, torch.ones_like(s))


# jnp.log2 is log(x) / log(2), which XLA evaluates as log(x) times the
# f32 reciprocal of log(2).  The rounding of that product, not the
# exact log2, decides the ceiling at amax = 448 * 2^k and one ulp above
# it (exact log2 differs there in both directions), so it is reproduced
_INV_LN2_F32 = float(1.0 / torch.tensor(math.log(2.0), dtype=torch.float32))


def _log2_as_jax(q: torch.Tensor) -> torch.Tensor:
    return torch.log(q) * torch.full_like(q, _INV_LN2_F32)


def _exp2_int(e: torch.Tensor) -> torch.Tensor:
    """Exactly 2**e in f32 for an int32 ``e``, from the exponent bits
    (``torch.ldexp`` goes through ``pow``, whose CUDA form is not
    promised exact).  Below 2^-126 it is a product of two normal
    powers of two, which rounds to the exact subnormal."""
    hi = torch.clamp(e, -126, 127)
    lo = torch.clamp(e - hi, -126, 0)

    def bits(k):
        return ((k + 127) << 23).view(torch.float32)

    return bits(hi) * bits(lo)


def fp8_round(x: torch.Tensor, axis=None, scale=None) -> torch.Tensor:
    """Round ``x`` onto the float8_e4m3 grid: divide by the pow2
    per-``axis`` scale (or the caller's ``scale``), clip to +-448,
    cast to e4m3 and back, multiply by the scale.  Returns
    ``x.dtype`` values that sit exactly on the scaled fp8 grid."""
    if scale is None:
        scale = pow2_scale(_amax(x, axis))
    x32 = x.to(torch.float32) / scale
    x32 = torch.clamp(x32, -FP8_E4M3_MAX, FP8_E4M3_MAX)
    q = x32.to(torch.float8_e4m3fn).to(torch.float32)
    return (q * scale).to(x.dtype)


def amax_history_init(length: int) -> torch.Tensor:
    """A fresh rolling amax history (all zero; the first update fills
    slot 0)."""
    if length < 1:
        raise ValueError(f"amax history length {length} must be >= 1")
    return torch.zeros((int(length),), dtype=torch.float32)


def amax_history_update(hist: torch.Tensor, x: torch.Tensor
                        ) -> torch.Tensor:
    """``max |x|`` written into the history's newest slot (0), the
    oldest evicted: a roll by one, then the write."""
    out = torch.roll(hist, 1)
    out[0] = torch.amax(x.to(torch.float32).abs())
    return out


def scale_from_history(hist: torch.Tensor,
                       fmt_max: float = FP8_E4M3_MAX) -> torch.Tensor:
    """The delayed-scaling scale: ``pow2_scale`` of the history's max
    (a length-1 history is just-in-time scaling)."""
    return pow2_scale(torch.amax(hist), fmt_max)


__all__ = ["INT8_MAX", "FP8_E4M3_MAX", "int8_scale", "quantize_int8",
           "dequantize_int8", "int8_roundtrip", "ef_compress_int8",
           "pow2_scale", "fp8_round", "amax_history_init",
           "amax_history_update", "scale_from_history"]

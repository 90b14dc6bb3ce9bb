"""Fused LayerNorm (+ residual add) with its backward, the grouped FFN
and the MLP forward: the wrappers of the port's hand-written Hopper
kernels, each beside its plain PyTorch version.

==========================  ==============================  ==========================
wrapper                     CUDA source (ops/csrc/)         TPU kernel it replaces
==========================  ==============================  ==========================
fused_layer_norm            layer_norm.cu                   pallas_fused._ln_fwd_kernel
fused_layer_norm_residual   layer_norm.cu                   pallas_fused._ln_res_fwd_kernel
layer_norm_backward         layer_norm.cu (two launches)    pallas_fused._ln_bwd_kernel
moe_grouped_matmul          grouped_ffn.cu (2-4 launches)   pallas_fused._moe_kernel
moe_grouped_matmul_z1       grouped_ffn.cu (2-4 launches)   the same, want_z1=True
mlp_forward                 mlp_forward.cu (one per layer)  pallas_fused._make_kernel
==========================  ==============================  ==========================

The flash-attention kernels have their wrappers in ``ops/
flash_attention.py``.  ``fp8_grouped_matmul`` and ``fp8_dense_ffn`` are
no kernels of their own: they round the operands with ``ops/
quant.fp8_round`` and run the grouped FFN's kernel, as in the JAX
package.

Dispatch is by the device of the tensors given: for CPU tensors a
wrapper computes its plain version (``*_reference``, the same op
sequence as the JAX package's ``_ln_rows`` / ``_ln_bwd_rows`` /
``_moe_kernel`` / ``_layer``); for CUDA tensors it checks device,
dtype, shape and contiguity, allocates its outputs with
``torch.empty``, launches on the current stream and raises if the
launch returns an error.  There is no fallback from the kernel to the
plain version.

Every wrapper carries ``launches``, a plain integer it raises by one
each time it launches its kernel (``moe_grouped_matmul``,
``moe_grouped_matmul_z1`` and ``layer_norm_backward`` count one per
call, which is two CUDA launches, or up to four for a grouped FFN whose
plan splits K;
``mlp_forward`` one per call, L launches for L layers);
``launch_counts`` and ``reset_launch_counts`` (from ``ops/_counts.py``)
read and zero them, the flash-attention wrappers' included, so a run
can show that its main path went through the kernels.  A CUDA graph's
replay runs no Python: the device-resident epoch (``parallel/
epoch.py``) counts the launches of the step it captures once and adds
them on each replay (``_counts.add_launches``).  The kernels capture as
they are: each launches on ``torch.cuda.current_stream()`` (the capture
stream), B1's bf16 tensor maps are encoded on the host at capture into
the launch's parameters, its f32 layers' ``cudaLaunchKernelEx`` with a
cluster dimension records as a graph node, and the graph pool's
addresses stay fixed across replays.

``fused_layer_norm`` and ``fused_layer_norm_residual`` are
differentiable (``torch.autograd.Function``): their backward is the
JAX package's ``_fused_ln_bwd`` / ``_fused_ln_res_bwd`` over
``layer_norm_backward`` (the residual form routes ``dx + ds`` to both
inputs).  ``mlp_forward`` is differentiable too: its backward is the
JAX package's ``_bwd``, plain matrix products as there (the TPU
package has no backward kernel for it).  ``moe_grouped_matmul`` and
``fp8_grouped_matmul`` (and through it ``fp8_dense_ffn``) are
differentiable (``_GroupedFFN``): with a gradient to take, the forward
runs B8's training form, ``moe_grouped_matmul_z1``, which also writes
the f32 pre-activation; without one, the primal form (eval, serving).
Their backward is the JAX package's ``_moe_grouped_bwd``, plain batched
products as there.
"""

from __future__ import annotations

import functools

import torch

from . import _build, _counts
from ._counts import launch_counts, reset_launch_counts
from ..models.mlp import _ACTIVATIONS, apply_with_hiddens, dot_f32

LN_EPS = 1e-6

# dtype and activation codes of the C interface (ops/csrc/*.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODES = {"gelu": 0, "relu": 1, "tanh": 2, "sigmoid": 3}
# activations whose derivative is a function of the saved activation
# output (the hiddens mlp_forward keeps); gelu needs the pre-activation,
# so the training step gates --pallas on this set (the JAX package's
# pallas_fused.SUPPORTED_ACTIVATIONS)
SUPPORTED_MLP_ACTIVATIONS = ("sigmoid", "tanh", "relu")


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, and the yardstick on the card)
# ---------------------------------------------------------------------------


def layer_norm_reference(x, g, b):
    """LayerNorm over the last axis with f32 statistics and f32 output
    (the JAX package's ``_ln_rows``)."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + LN_EPS) * g.to(torch.float32) \
        + b.to(torch.float32)


def layer_norm_backward_reference(dy, x, g):
    """``(dx f32 [x.shape], dg f32 [d], db f32 [d])``: the closed-form
    LayerNorm backward on f32 rows (the JAX package's ``_ln_bwd_rows``)
    with the statistics recomputed from ``x``, plus ``dg = sum dy*xh``
    and ``db = sum dy`` over every row."""
    x32, dy32 = x.to(torch.float32), dy.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    xh = (x32 - mu) * rstd
    w = dy32 * g.to(torch.float32)
    dx = rstd * (w - torch.mean(w, dim=-1, keepdim=True)
                 - xh * torch.mean(w * xh, dim=-1, keepdim=True))
    rows = tuple(range(dy.ndim - 1))
    return dx, torch.sum(dy32 * xh, dim=rows), torch.sum(dy32, dim=rows)


def layer_norm_residual_reference(x, r, g, b):
    """``s = x + r`` rounded to the result dtype, then ``(LN(s), s)``
    with the statistics taken from the rounded ``s``."""
    s = (x.to(torch.float32) + r.to(torch.float32)).to(
        torch.result_type(x, r))
    return layer_norm_reference(s, g, b), s


def grouped_ffn_reference(activation, cdt, buf, we1, be1, we2, be2):
    """``(out, z1)``: per expert the f32 pre-activation ``z1 = x @ W1 +
    b1``, ``act(z1)`` rounded to ``cdt``, then ``out = @ W2 + b2`` in
    f32.  Products take ``cdt`` operands with f32 accumulation: the
    operands are rounded to ``cdt`` and multiplied in f32, which is
    exact for bf16 inputs."""
    act = _ACTIVATIONS[activation]
    z1 = torch.bmm(buf.to(cdt).to(torch.float32),
                   we1.to(cdt).to(torch.float32)) \
        + be1.to(torch.float32)[:, None]
    h1 = act(z1).to(cdt)
    out = torch.bmm(h1.to(torch.float32), we2.to(cdt).to(torch.float32)) \
        + be2.to(torch.float32)[:, None]
    return out, z1


# ``(logits, hiddens)``: the plain MLP forward is the model's own
mlp_forward_reference = apply_with_hiddens


def _act_grad(name: str, h):
    """d act / dz from the activation output ``h`` (in h's dtype, as
    the JAX ``_act_grad``): sigmoid' = h(1-h), tanh' = 1-h^2,
    relu' = h > 0."""
    if name == "sigmoid":
        return h * (1.0 - h)
    if name == "tanh":
        return 1.0 - h * h
    if name == "relu":
        return (h > 0).to(h.dtype)
    raise NotImplementedError(name)


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain-version
    case); False when all are CUDA tensors; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors on {sorted(str(t.device) for t in tensors)}: "
                     f"expected all on the CPU or all on one CUDA device")


def _require(name: str, t: torch.Tensor, shape=None, dtypes=None):
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if dtypes is not None and t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected one of "
                         f"{list(dtypes)}")


def _launch(fn_name: str, *args) -> None:
    err = getattr(_build.load(), fn_name)(
        *args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with "
                           f"cudaError_t {err}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _f32_vector(name: str, v: torch.Tensor, n: int) -> torch.Tensor:
    _require(name, v, shape=(n,))
    return v.to(torch.float32)


# ---------------------------------------------------------------------------
# public wrappers (the JAX package's names and signatures)
# ---------------------------------------------------------------------------


def _ln_max_d(name: str, d: int) -> None:
    limit = _build.load().dtx_layer_norm_max_d()
    if d > limit:
        raise ValueError(f"{name}: d={d} exceeds the kernel's limit {limit}")


def _ln_forward(x, g, b):
    if _on_cpu(x, g, b):
        return layer_norm_reference(x, g, b)
    d = x.shape[-1]
    _require("x", x, dtypes=_DTYPE_CODES)
    g32, b32 = _f32_vector("g", g, d), _f32_vector("b", b, d)
    _ln_max_d("fused_layer_norm", d)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _launch("dtx_layer_norm_fwd", x.data_ptr(), g32.data_ptr(),
            b32.data_ptr(), y.data_ptr(), x.numel() // d, d,
            _DTYPE_CODES[x.dtype])
    _counts.count(fused_layer_norm)
    return y


def _ln_residual_forward(x, r, g, b):
    if _on_cpu(x, r, g, b):
        return layer_norm_residual_reference(x, r, g, b)
    d = x.shape[-1]
    _require("x", x, dtypes=_DTYPE_CODES)
    _require("r", r, shape=x.shape, dtypes=(x.dtype,))
    g32, b32 = _f32_vector("g", g, d), _f32_vector("b", b, d)
    _ln_max_d("fused_layer_norm_residual", d)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    s = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _launch("dtx_layer_norm_residual_fwd", x.data_ptr(), r.data_ptr(),
            g32.data_ptr(), b32.data_ptr(), y.data_ptr(), s.data_ptr(),
            x.numel() // d, d, _DTYPE_CODES[x.dtype])
    _counts.count(fused_layer_norm_residual)
    return y, s


# the LayerNorm backward's routes (layer_norm.cu's route codes): the
# register path, a warp a row, and the CTA-a-row kernel
_LN_BWD_ROUTES = {"block": 0, "warp": 1}
# the widest row of the register path (dtx_layer_norm_reg_max_d), its
# rows in flight a CTA (kLnBwdWarps), and the CTA-a-row kernel's CTAs an SM
_LN_REG_MAX_D, _LN_BWD_WARPS, _LN_BWD_BLOCK_CTAS_PER_SM = 1024, 4, 8


def layer_norm_backward_plan(rows: int, d: int, aligned: bool, sms: int,
                             per_sm: int):
    """``(route, ctas)`` of the LayerNorm backward at [rows, d] on a card
    of ``sms`` SMs: the register path ("warp") where d is at most 1024
    and a multiple of 4 and ``aligned`` (every row tensor on its
    vector's boundary), on a persistent grid of the CTAs the card holds
    at once (``per_sm`` an SM: the kernel's occupancy, from
    ``dtx_layer_norm_bwd_ctas_per_sm``) and no more than its rows fill;
    else the CTA-a-row kernel ("block") on 8 CTAs an SM and no more than
    the rows.  ``ctas`` is also the count of dg/db partial rows: the
    scratch is [2, ctas, d] f32."""
    if aligned and d <= _LN_REG_MAX_D and d % 4 == 0:
        return "warp", max(1, min(sms * per_sm, -(-rows // _LN_BWD_WARPS)))
    return "block", max(1, min(rows, _LN_BWD_BLOCK_CTAS_PER_SM * sms))


@functools.lru_cache(maxsize=None)
def _ln_bwd_ctas_per_sm(dtype_code: int) -> int:
    per_sm = _build.load().dtx_layer_norm_bwd_ctas_per_sm(dtype_code)
    if per_sm <= 0:
        raise RuntimeError(f"dtx_layer_norm_bwd_ctas_per_sm: cudaError_t "
                           f"{-per_sm}")
    return per_sm


def _vec_aligned(*tensors) -> bool:
    """Whether every tensor's base lies on a 4-element vector's boundary."""
    return all(t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors)


def layer_norm_backward(dy, x, g):
    """``(dx f32 [x.shape], dg f32 [d], db f32 [d])`` of LayerNorm at
    ``x`` (the forward's input, or its residual sum) for the cotangent
    ``dy`` of its f32 output.  CUDA: the backward of ``layer_norm.cu`` by
    the plan of ``layer_norm_backward_plan`` (recorded as ``last_plan``,
    ``(route, ctas)``): one pass over the rows, a warp a row in
    registers up to 1024 wide or a CTA a row beyond, leaving ``ctas``
    rows of dg/db partials, then a second launch that sums them in a
    fixed order; dy f32, x f32 or bf16, both contiguous, g [d]."""
    if _on_cpu(dy, x, g):
        return layer_norm_backward_reference(dy, x, g)
    d = x.shape[-1]
    _require("x", x, dtypes=_DTYPE_CODES)
    _require("dy", dy, shape=x.shape, dtypes=(torch.float32,))
    g32 = _f32_vector("g", g, d)
    _ln_max_d("layer_norm_backward", d)
    rows = x.numel() // d
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    dg = torch.empty((d,), dtype=torch.float32, device=x.device)
    db = torch.empty((d,), dtype=torch.float32, device=x.device)
    if rows == 0:
        return dx, dg.zero_(), db.zero_()
    code = _DTYPE_CODES[x.dtype]
    route, ctas = layer_norm_backward_plan(
        rows, d, _vec_aligned(dy, x, g32, dx), _sm_count(x.device.index),
        _ln_bwd_ctas_per_sm(code))
    part = torch.empty((2, ctas, d), dtype=torch.float32, device=x.device)
    _launch("dtx_layer_norm_bwd", dy.data_ptr(), x.data_ptr(),
            g32.data_ptr(), dx.data_ptr(), part.data_ptr(), dg.data_ptr(),
            db.data_ptr(), rows, d, ctas, _LN_BWD_ROUTES[route], code)
    _counts.count(layer_norm_backward)
    layer_norm_backward.last_plan = (route, ctas)
    return dx, dg, db


class _FusedLayerNorm(torch.autograd.Function):
    """Forward: the LayerNorm kernel (CUDA) or its plain version (CPU).
    Backward: the JAX ``_fused_ln_bwd`` — ``layer_norm_backward`` at
    the saved ``x``, each gradient cast to its input's dtype."""

    @staticmethod
    def forward(ctx, x, g, b):
        ctx.save_for_backward(x, g)
        ctx.b_dtype = b.dtype
        return _ln_forward(x, g, b)

    @staticmethod
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        dx, dg, db = layer_norm_backward(
            dy.to(torch.float32).contiguous(), x, g)
        return dx.to(x.dtype), dg.to(g.dtype), db.to(ctx.b_dtype)


class _FusedLayerNormResidual(torch.autograd.Function):
    """Forward: ``(LN(x + r), x + r)`` by the residual kernel (CUDA) or
    its plain version (CPU).  Backward: the JAX ``_fused_ln_res_bwd`` —
    ``layer_norm_backward`` at the saved sum s, ``dx + ds`` (f32) routed
    to both x and r."""

    @staticmethod
    def forward(ctx, x, r, g, b):
        y, s = _ln_residual_forward(x, r, g, b)
        ctx.save_for_backward(s, g)
        ctx.dtypes = (x.dtype, r.dtype, b.dtype)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        s, g = ctx.saved_tensors
        x_dt, r_dt, b_dt = ctx.dtypes
        dx, dg, db = layer_norm_backward(
            dy.to(torch.float32).contiguous(), s, g)
        d_sum = dx + ds.to(torch.float32)
        return d_sum.to(x_dt), d_sum.to(r_dt), dg.to(g.dtype), db.to(b_dt)


def fused_layer_norm(x, g, b):
    """LayerNorm of ``x`` (any rank, last axis ``d``) with f32
    statistics and f32 output, differentiable in x, g and b.  CUDA: the
    ``layer_norm.cu`` kernel, one warp a row held in registers up to
    1024 wide, one block a row beyond; x f32 or bf16, g/b [d]; the
    backward runs ``layer_norm_backward``."""
    return _FusedLayerNorm.apply(x, g, b)


def fused_layer_norm_residual(x, r, g, b):
    """``s = x + r`` (rounded to their dtype), ``y = LN(s)``; returns
    ``(y f32, s)``, differentiable in all four inputs.  CUDA: the
    residual form of the ``layer_norm.cu`` kernel, one pass over x and
    r; x and r of one dtype (f32 or bf16); the backward runs
    ``layer_norm_backward`` at s."""
    return _FusedLayerNormResidual.apply(x, r, g, b)


# the tensor-core GEMM's tile (gemm_tc.cuh): 128 rows, 128 x halves
# columns, K in 64-deep slices
_TC_ROWS, _TC_HALF, _TC_DEPTH = 128, 128, 64


def product_ctas(e: int, m: int, n: int, halves: int, splits: int) -> int:
    """CTAs of one batched product [E, M, K] x [E, K, N] on the
    tensor-core GEMM with 128 x (128 halves) tiles and K in ``splits``
    shares (``gemm_tc.cuh``'s grid)."""
    return e * -(-m // _TC_ROWS) * -(-n // (_TC_HALF * halves)) * splits


def _product_plan(e: int, m: int, n: int, k: int, sms: int):
    """``(halves, splits)`` of one batched product [E, M, K] x [E, K,
    N] on the tensor-core GEMM: 128 x 256 tiles (halves 2) where they
    give at least one CTA an SM, else 128 x 128 tiles; where those are
    still fewer than the SMs, K in ``splits`` equal shares of 64-deep
    slices so that tiles x splits fills one wave (splits as large as
    that allows, none of them empty)."""
    for halves in (2, 1):
        tiles = product_ctas(e, m, n, halves, 1)
        if tiles >= sms:
            return halves, 1
    slices = -(-k // _TC_DEPTH)
    splits = max(1, min(slices, sms // max(tiles, 1)))
    per = -(-slices // splits)
    return 1, -(-slices // per)


@functools.lru_cache(maxsize=None)
def grouped_ffn_plan(e: int, c: int, d: int, ff: int, sms: int):
    """The bf16 grouped FFN's launch plan on a card of ``sms`` SMs:
    ``((halves1, splits1), (halves2, splits2))`` for launch 1 (x [E, C,
    d] @ W1 [E, d, ff]) and launch 2 (h1 @ W2 [E, ff, d]), as
    ``_product_plan`` picks them (``grouped_ffn.cu``'s header lists the
    plans of the paths' shapes)."""
    return (_product_plan(e, c, ff, d, sms), _product_plan(e, c, d, ff, sms))


def grouped_ffn_ctas(plan, e: int, c: int, d: int, ff: int):
    """``(CTAs of launch 1, CTAs of launch 2)`` of the grouped FFN at
    [E, C, d] x ff under ``plan`` (a split launch's shares counted, its
    sum's launch not)."""
    (h1, s1), (h2, s2) = plan
    return product_ctas(e, c, ff, h1, s1), product_ctas(e, c, d, h2, s2)


def _grouped_forward(activation: str, cdt, buf, we1, be1, we2, be2,
                     want_z1: bool):
    """``(out [E, C, d] f32, z1 [E, C, ff] f32 or None)``: the JAX
    ``_moe_grouped_forward``.  CUDA: the two products of
    ``grouped_ffn.cu``, with an [E, C, ff] ``cdt`` hidden in between and,
    when ``want_z1`` (the training form), the f32 pre-activation written
    by the first product's epilogue; in bf16 on the tensor cores by the
    plan of ``grouped_ffn_plan`` (a split-K product adds its f32 shares
    in a scratch ``part`` in a second launch), in f32 on the CUDA cores;
    counted on ``moe_grouped_matmul`` (primal form) or
    ``moe_grouped_matmul_z1`` (training form)."""
    if _on_cpu(buf, we1, be1, we2, be2):
        out, z1 = grouped_ffn_reference(activation, cdt, buf, we1, be1,
                                        we2, be2)
        return out, (z1 if want_z1 else None)
    if activation not in _ACT_CODES:
        raise ValueError(f"activation {activation!r}: the kernel takes "
                         f"{sorted(_ACT_CODES)}")
    if cdt not in _DTYPE_CODES:
        raise ValueError(f"compute dtype {cdt}: the kernel takes "
                         f"{list(_DTYPE_CODES)}")
    e, c, d = buf.shape
    ff = we1.shape[-1]
    _require("buf", buf)
    _require("we1", we1, shape=(e, d, ff))
    _require("be1", be1, shape=(e, ff))
    _require("we2", we2, shape=(e, ff, d))
    _require("be2", be2, shape=(e, d))
    x, w1, w2 = buf.to(cdt), we1.to(cdt), we2.to(cdt)
    b1, b2 = be1.to(torch.float32), be2.to(torch.float32)
    dev = buf.device
    h1 = torch.empty((e, c, ff), dtype=cdt, device=dev)
    out = torch.empty((e, c, d), dtype=torch.float32, device=dev)
    z1 = (torch.empty((e, c, ff), dtype=torch.float32, device=dev)
          if want_z1 else None)
    plan = ((2, 1), (2, 1))             # the f32 form: FMA, no split
    if cdt == torch.bfloat16:
        plan = grouped_ffn_plan(e, c, d, ff, _sm_count(dev.index))
    shares = max(plan[0][1] * ff if plan[0][1] > 1 else 0,
                 plan[1][1] * d if plan[1][1] > 1 else 0)
    part = (torch.empty((shares * e * c,), dtype=torch.float32, device=dev)
            if shares else None)
    _launch("dtx_grouped_ffn_fwd", x.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), h1.data_ptr(),
            out.data_ptr(), z1.data_ptr() if want_z1 else None,
            part.data_ptr() if part is not None else None, e, c, d, ff,
            _ACT_CODES[activation], _DTYPE_CODES[cdt], *plan[0], *plan[1])
    counted = moe_grouped_matmul_z1 if want_z1 else moe_grouped_matmul
    _counts.count(counted)
    counted.last_plan = plan
    return out, z1


def _grouped_backward(activation: str, cdt, res, g):
    """The JAX ``_moe_grouped_bwd``: plain batched products (``cdt``
    operands, f32 accumulation, as XLA's einsums there; each operand,
    the f32 cotangent ``g`` and ``dz1`` included, rounded to ``cdt``),
    ``h1`` recomputed as ``act(z1)`` rounded to ``cdt``, the activation
    differentiated at the saved f32 ``z1``, the bias gradients f32 sums,
    each cotangent cast to its primal's dtype."""
    buf, we1, be1, we2, be2, z1 = res
    act = _ACTIVATIONS[activation]

    def mm(a, b):
        return dot_f32(a, b, cdt)

    h1 = act(z1).to(cdt)
    dwe2 = mm(h1.mT, g)
    dbe2 = torch.sum(g.to(torch.float32), dim=1)
    dh1 = mm(g, we2.mT)
    with torch.enable_grad():
        z = z1.detach().requires_grad_(True)
        (dz1,) = torch.autograd.grad(act(z), z, dh1)
    dwe1 = mm(buf.mT, dz1)
    dbe1 = torch.sum(dz1, dim=1)
    dbuf = mm(dz1, we1.mT)
    return tuple(dv.to(p.dtype) for dv, p in zip(
        (dbuf, dwe1, dbe1, dwe2, dbe2), (buf, we1, be1, we2, be2)))


class _GroupedFFN(torch.autograd.Function):
    """The custom VJP of ``moe_grouped_matmul`` (``fp8=False``) and of
    ``fp8_grouped_matmul`` (``fp8=True``).  Forward: the training form
    (``want_z1``), saving ``(buf, we1, be1, we2, be2, z1)``; under fp8
    the operands are rounded first and the ROUNDED ones are saved, so
    the backward differentiates what the forward ran and the cotangents
    land on the master tensors unrounded (``fp8_round`` is treated as
    the identity, straight through).  Backward: ``_grouped_backward``."""

    @staticmethod
    def forward(ctx, activation, cdt, fp8, buf, we1, be1, we2, be2):
        if fp8:
            buf, we1, we2 = _fp8_operands(buf, we1, we2)
        out, z1 = _grouped_forward(activation, cdt, buf, we1, be1, we2,
                                   be2, want_z1=True)
        ctx.save_for_backward(buf, we1, be1, we2, be2, z1)
        ctx.activation, ctx.cdt = activation, cdt
        return out

    @staticmethod
    def backward(ctx, g):
        grads = _grouped_backward(ctx.activation, ctx.cdt,
                                  ctx.saved_tensors, g)
        return (None, None, None, *grads)


def _grouped(activation: str, cdt, fp8: bool, buf, we1, be1, we2, be2):
    """``moe_grouped_matmul`` (``fp8`` False) or ``fp8_grouped_matmul``:
    the training form through ``_GroupedFFN`` when a gradient is to be
    taken, as the JAX custom VJP does, else the primal form."""
    args = (buf, we1, be1, we2, be2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _GroupedFFN.apply(activation, cdt, fp8, *args)
    if fp8:
        buf, we1, we2 = _fp8_operands(buf, we1, we2)
    return _grouped_forward(activation, cdt, buf, we1, be1, we2, be2,
                            want_z1=False)[0]


def moe_grouped_matmul(activation: str, cdt, buf, we1, be1, we2, be2):
    """Grouped FFN ``[E, C, d] -> [E, C, d]`` (f32 out): per expert
    ``act(buf @ We1 + be1)`` rounded to ``cdt``, then ``@ We2 + be2``.
    Matmul operands are cast to ``cdt`` (f32 or bf16), biases to f32.
    Differentiable (``_GroupedFFN``): when a gradient is needed the
    forward runs the training form (``want_z1``), otherwise the primal
    form."""
    return _grouped(activation, cdt, False, buf, we1, be1, we2, be2)


def moe_grouped_matmul_z1(activation: str, cdt, buf, we1, be1, we2, be2):
    """``(out, z1)``: the training form of the grouped FFN (B8 with
    ``want_z1``), which the backward of ``moe_grouped_matmul`` and
    ``fp8_grouped_matmul`` runs as its forward; z1 [E, C, ff] is the f32
    pre-activation."""
    return _grouped_forward(activation, cdt, buf, we1, be1, we2, be2,
                            want_z1=True)


def _mlp_names(spec):
    return [f"{p}{i}" for i in range(1, spec.num_layers + 1)
            for p in ("W", "b")]


# the f32 MLP layer's GEMM (mlp_forward.cu): 32 x 32 output tiles, K in
# 32-deep slices split over at most the 8 CTAs of a portable cluster,
# split until about 4 CTAs stand on every SM
_F32_TILE, _F32_DEPTH, _F32_MAX_SPLITS, _F32_CTAS_PER_SM = 32, 32, 8, 4


@functools.lru_cache(maxsize=None)
def mlp_f32_plan(m: int, n: int, k: int, sms: int):
    """``(splits, ctas)`` of one f32 MLP layer, [m, k] @ [k, n], on a
    card of ``sms`` SMs: the 32 x 32 output tiles, each with K split in
    ``splits`` equal shares of 32-deep slices (none empty; at most 8, the
    CTAs of a cluster, and at most the slices) as far as it takes to
    give the card 4 CTAs an SM; ``ctas`` = tiles x splits."""
    tiles = -(-m // _F32_TILE) * -(-n // _F32_TILE)
    slices = -(-k // _F32_DEPTH)
    want = -(-_F32_CTAS_PER_SM * sms // max(tiles, 1))
    splits = max(1, min(_F32_MAX_SPLITS, slices, want))
    per = -(-slices // splits)
    splits = -(-slices // per)
    return splits, tiles * splits


def _mlp_forward_cuda(spec, params, x):
    """The ``mlp_forward.cu`` kernel, one launch per layer; returns
    ``(logits, hiddens)`` like ``mlp_forward_reference``.  Records
    ``mlp_forward.last_plan``: ``("wgmma", ())`` in bf16, ``("fma",
    ((splits, ctas) per layer))`` in f32 (``mlp_f32_plan``)."""
    cdt = spec.compute_dtype
    if cdt not in _DTYPE_CODES:
        raise ValueError(f"compute dtype {cdt}: the kernel takes "
                         f"{list(_DTYPE_CODES)}")
    if spec.activation not in SUPPORTED_MLP_ACTIVATIONS:
        raise ValueError(f"activation {spec.activation!r}: the kernel "
                         f"takes {list(SUPPORTED_MLP_ACTIVATIONS)}")
    sizes = spec.layer_sizes
    n = x.shape[0]
    _require("x", x, shape=(n, sizes[0]))
    h = x.to(cdt)
    hiddens = []
    plans = []
    L = spec.num_layers
    for i in range(1, L + 1):
        w = params[f"W{i}"]
        _require(f"W{i}", w, shape=(sizes[i - 1], sizes[i]))
        w = w.to(cdt)
        b = _f32_vector(f"b{i}", params[f"b{i}"], sizes[i])
        last = i == L
        out = torch.empty((n, sizes[i]),
                          dtype=torch.float32 if last else cdt,
                          device=x.device)
        splits = 1
        if cdt == torch.float32:
            plans.append(mlp_f32_plan(n, sizes[i], sizes[i - 1],
                                      _sm_count(x.device.index)))
            splits = plans[-1][0]
        _launch("dtx_mlp_layer_fwd", h.data_ptr(), w.data_ptr(),
                b.data_ptr(), out.data_ptr(), n, sizes[i], sizes[i - 1],
                _ACT_CODES[spec.activation], _DTYPE_CODES[cdt], int(last),
                splits)
        if not last:
            hiddens.append(out)
            h = out
    _counts.count(mlp_forward)
    mlp_forward.last_plan = ("fma" if plans else "wgmma", tuple(plans))
    return out, tuple(hiddens)


class _MLPForward(torch.autograd.Function):
    """Forward: the kernel (CUDA) or its plain version (CPU), keeping
    the hiddens.  Backward: the JAX package's ``_bwd`` — products on
    cdt-rounded operands with f32 accumulation, the delta chain in f32,
    gradients cast to the params' dtype and dx (when x needs one) to
    x's."""

    @staticmethod
    def forward(ctx, spec, x, *flat):
        params = dict(zip(_mlp_names(spec), flat))
        if _on_cpu(x, *flat):
            logits, hiddens = mlp_forward_reference(spec, params, x)
        else:
            logits, hiddens = _mlp_forward_cuda(spec, params, x)
        ctx.spec = spec
        ctx.save_for_backward(x, *flat, *hiddens)
        return logits

    @staticmethod
    def backward(ctx, g):
        spec = ctx.spec
        cdt = spec.compute_dtype
        L = spec.num_layers
        names = _mlp_names(spec)
        x, *rest = ctx.saved_tensors
        params = dict(zip(names, rest[:2 * L]))
        hiddens = rest[2 * L:]
        acts = (x, *hiddens)            # the inputs of layers 1..L
        grads = {}
        delta = g.to(torch.float32)     # dL/dz_L; the chain stays f32
        for i in range(L, 0, -1):
            grads[f"W{i}"] = dot_f32(acts[i - 1].T, delta, cdt)
            grads[f"b{i}"] = torch.sum(delta, dim=0)
            if i > 1:
                da = dot_f32(delta, params[f"W{i}"].T, cdt)
                delta = da * _act_grad(spec.activation,
                                       hiddens[i - 2]).to(torch.float32)
        dx = (dot_f32(delta, params["W1"].T, cdt).to(x.dtype)
              if ctx.needs_input_grad[1] else None)
        return (None, dx, *(grads[k].to(params[k].dtype) for k in names))


def mlp_forward(spec, params, x):
    """f32 logits of the MLP ``spec`` (the drop-in for ``models.mlp.
    apply`` on the ``--pallas`` path), differentiable in ``params`` and
    ``x``.  CUDA: one ``mlp_forward.cu`` launch per layer, hiddens
    kept for the backward; x [N, s_0] contiguous, cdt f32 or bf16,
    activation sigmoid/tanh/relu."""
    return _MLPForward.apply(spec, x, *(params[k] for k in
                                        _mlp_names(spec)))


def _fp8_operands(buf, we1, we2):
    """Round the three matmul operands onto their per-expert fp8 grids
    (axis (1, 2): everything but the leading expert dim)."""
    from .quant import fp8_round

    return (fp8_round(buf, axis=(1, 2)), fp8_round(we1, axis=(1, 2)),
            fp8_round(we2, axis=(1, 2)))


def fp8_grouped_matmul(activation: str, cdt, buf, we1, be1, we2, be2):
    """``moe_grouped_matmul`` on fp8-e4m3-rounded operands (pow2
    per-expert scales; biases and accumulation stay f32), with
    straight-through gradients to the master ``buf``, ``we1``, ``we2``
    (``_GroupedFFN``)."""
    return _grouped(activation, cdt, True, buf, we1, be1, we2, be2)


def fp8_dense_ffn(activation: str, cdt, x2, w1, b1, w2, b2):
    """The dense FFN ``act(x @ W1 + b1) @ W2 + b2`` on fp8-rounded
    operands: ``x2`` [T, d] -> [T, d] f32, as a one-expert group."""
    out = fp8_grouped_matmul(activation, cdt, x2[None], w1[None],
                             b1[None], w2[None], b2[None])
    return out[0]


KERNEL_WRAPPERS = (fused_layer_norm, fused_layer_norm_residual,
                   layer_norm_backward, moe_grouped_matmul,
                   moe_grouped_matmul_z1, mlp_forward)
_counts.register(*KERNEL_WRAPPERS)


__all__ = ["fused_layer_norm", "fused_layer_norm_residual",
           "layer_norm_backward", "layer_norm_backward_reference",
           "moe_grouped_matmul", "moe_grouped_matmul_z1",
           "fp8_grouped_matmul", "fp8_dense_ffn",
           "mlp_forward", "layer_norm_reference",
           "layer_norm_residual_reference", "grouped_ffn_reference",
           "mlp_forward_reference", "grouped_ffn_plan", "grouped_ffn_ctas",
           "layer_norm_backward_plan", "mlp_f32_plan",
           "SUPPORTED_MLP_ACTIVATIONS",
           "launch_counts", "reset_launch_counts", "KERNEL_WRAPPERS"]

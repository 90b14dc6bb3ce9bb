"""Fused LayerNorm (+ residual add), the grouped FFN and the MLP
forward: the wrappers of the port's hand-written Hopper kernels, each
beside its plain PyTorch version.

=========================  ==============================  ==========================
wrapper                    CUDA source (ops/csrc/)         TPU kernel it replaces
=========================  ==============================  ==========================
fused_layer_norm           layer_norm.cu                   pallas_fused._ln_fwd_kernel
fused_layer_norm_residual  layer_norm.cu                   pallas_fused._ln_res_fwd_kernel
moe_grouped_matmul         grouped_ffn.cu (two launches)   pallas_fused._moe_kernel
mlp_forward                mlp_forward.cu (one per layer)  pallas_fused._make_kernel
=========================  ==============================  ==========================

``fp8_grouped_matmul`` and ``fp8_dense_ffn`` are no kernels of their
own: they round the operands with ``ops/quant.fp8_round`` and call
``moe_grouped_matmul``, as in the JAX package.

Dispatch is by the device of the tensors given: for CPU tensors a
wrapper computes its plain version (``*_reference``, the same op
sequence as the JAX package's ``_ln_rows`` / ``_moe_kernel`` /
``_layer``); for
CUDA tensors it checks device, dtype, shape and contiguity, allocates
its outputs with ``torch.empty``, launches on the current stream and
raises if the launch returns an error.  There is no fallback from the
kernel to the plain version.

Every wrapper carries ``launches``, a plain integer it raises by one
each time it launches its kernel (``moe_grouped_matmul`` counts one
per call, which is two CUDA launches; ``mlp_forward`` one per call, L
launches for L layers); ``launch_counts`` and ``reset_launch_counts``
read and zero them, so a run can show that its main path went through
the kernels.

``mlp_forward`` is differentiable (``torch.autograd.Function``): its
backward is the JAX package's ``_bwd``, plain matrix products as there
(the TPU package has no backward kernel for it).  The other wrappers
are forward only; their backward kernels come with the transformer
training slice.
"""

from __future__ import annotations

import torch

from . import _build
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


def layer_norm_residual_reference(x, r, g, b):
    """``s = x + r`` rounded to the result dtype, then ``(LN(s), s)``
    with the statistics taken from the rounded ``s``."""
    s = (x.to(torch.float32) + r.to(torch.float32)).to(
        torch.result_type(x, r))
    return layer_norm_reference(s, g, b), s


def grouped_ffn_reference(activation, cdt, buf, we1, be1, we2, be2):
    """Per expert: ``act(x @ W1 + b1)`` rounded to ``cdt``, then
    ``@ W2 + b2`` in f32.  Products take ``cdt`` operands with f32
    accumulation: the operands are rounded to ``cdt`` and multiplied
    in f32, which is exact for bf16 inputs."""
    act = _ACTIVATIONS[activation]
    z1 = torch.bmm(buf.to(cdt).to(torch.float32),
                   we1.to(cdt).to(torch.float32)) \
        + be1.to(torch.float32)[:, None]
    h1 = act(z1).to(cdt)
    return torch.bmm(h1.to(torch.float32), we2.to(cdt).to(torch.float32)) \
        + be2.to(torch.float32)[:, None]


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


def _f32_vector(name: str, v: torch.Tensor, n: int) -> torch.Tensor:
    _require(name, v, shape=(n,))
    return v.to(torch.float32)


# ---------------------------------------------------------------------------
# public wrappers (the JAX package's names and signatures, forward only)
# ---------------------------------------------------------------------------


def fused_layer_norm(x, g, b):
    """LayerNorm of ``x`` (any rank, last axis ``d``) with f32
    statistics and f32 output.  CUDA: the ``layer_norm.cu`` kernel,
    one block per row; x f32 or bf16, g/b [d]."""
    if _on_cpu(x, g, b):
        return layer_norm_reference(x, g, b)
    d = x.shape[-1]
    _require("x", x, dtypes=_DTYPE_CODES)
    g32, b32 = _f32_vector("g", g, d), _f32_vector("b", b, d)
    if d > _build.load().dtx_layer_norm_max_d():
        raise ValueError(f"fused_layer_norm: d={d} exceeds the kernel's "
                         f"limit {_build.load().dtx_layer_norm_max_d()}")
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _launch("dtx_layer_norm_fwd", x.data_ptr(), g32.data_ptr(),
            b32.data_ptr(), y.data_ptr(), x.numel() // d, d,
            _DTYPE_CODES[x.dtype])
    fused_layer_norm.launches += 1
    return y


def fused_layer_norm_residual(x, r, g, b):
    """``s = x + r`` (rounded to their dtype), ``y = LN(s)``; returns
    ``(y f32, s)``.  CUDA: the residual form of the ``layer_norm.cu``
    kernel, one pass over x and r; x and r of one dtype (f32 or
    bf16)."""
    if _on_cpu(x, r, g, b):
        return layer_norm_residual_reference(x, r, g, b)
    d = x.shape[-1]
    _require("x", x, dtypes=_DTYPE_CODES)
    _require("r", r, shape=x.shape, dtypes=(x.dtype,))
    g32, b32 = _f32_vector("g", g, d), _f32_vector("b", b, d)
    if d > _build.load().dtx_layer_norm_max_d():
        raise ValueError(f"fused_layer_norm_residual: d={d} exceeds the "
                         f"kernel's limit")
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    s = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _launch("dtx_layer_norm_residual_fwd", x.data_ptr(), r.data_ptr(),
            g32.data_ptr(), b32.data_ptr(), y.data_ptr(), s.data_ptr(),
            x.numel() // d, d, _DTYPE_CODES[x.dtype])
    fused_layer_norm_residual.launches += 1
    return y, s


def moe_grouped_matmul(activation: str, cdt, buf, we1, be1, we2, be2):
    """Grouped FFN ``[E, C, d] -> [E, C, d]`` (f32 out): per expert
    ``act(buf @ We1 + be1)`` rounded to ``cdt``, then ``@ We2 + be2``.
    Matmul operands are cast to ``cdt`` (f32 or bf16), biases to f32.
    CUDA: the two launches of ``grouped_ffn.cu`` with an [E, C, ff]
    ``cdt`` hidden in between."""
    if _on_cpu(buf, we1, be1, we2, be2):
        return grouped_ffn_reference(activation, cdt, buf, we1, be1, we2,
                                     be2)
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
    h1 = torch.empty((e, c, ff), dtype=cdt, device=buf.device)
    out = torch.empty((e, c, d), dtype=torch.float32, device=buf.device)
    _launch("dtx_grouped_ffn_fwd", x.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), h1.data_ptr(),
            out.data_ptr(), e, c, d, ff, _ACT_CODES[activation],
            _DTYPE_CODES[cdt])
    moe_grouped_matmul.launches += 1
    return out


def _mlp_names(spec):
    return [f"{p}{i}" for i in range(1, spec.num_layers + 1)
            for p in ("W", "b")]


def _mlp_forward_cuda(spec, params, x):
    """The ``mlp_forward.cu`` kernel, one launch per layer; returns
    ``(logits, hiddens)`` like ``mlp_forward_reference``."""
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
        _launch("dtx_mlp_layer_fwd", h.data_ptr(), w.data_ptr(),
                b.data_ptr(), out.data_ptr(), n, sizes[i], sizes[i - 1],
                _ACT_CODES[spec.activation], _DTYPE_CODES[cdt], int(last))
        if not last:
            hiddens.append(out)
            h = out
    mlp_forward.launches += 1
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
    per-expert scales; biases and accumulation stay f32)."""
    bq, w1q, w2q = _fp8_operands(buf, we1, we2)
    return moe_grouped_matmul(activation, cdt, bq, w1q, be1, w2q, be2)


def fp8_dense_ffn(activation: str, cdt, x2, w1, b1, w2, b2):
    """The dense FFN ``act(x @ W1 + b1) @ W2 + b2`` on fp8-rounded
    operands: ``x2`` [T, d] -> [T, d] f32, as a one-expert group."""
    out = fp8_grouped_matmul(activation, cdt, x2[None], w1[None],
                             b1[None], w2[None], b2[None])
    return out[0]


KERNEL_WRAPPERS = (fused_layer_norm, fused_layer_norm_residual,
                   moe_grouped_matmul, mlp_forward)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0


def launch_counts() -> dict:
    """``{wrapper name: launches}`` for every kernel wrapper."""
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0


__all__ = ["fused_layer_norm", "fused_layer_norm_residual",
           "moe_grouped_matmul", "fp8_grouped_matmul", "fp8_dense_ffn",
           "mlp_forward", "layer_norm_reference",
           "layer_norm_residual_reference", "grouped_ffn_reference",
           "mlp_forward_reference", "SUPPORTED_MLP_ACTIVATIONS",
           "launch_counts", "reset_launch_counts", "KERNEL_WRAPPERS"]

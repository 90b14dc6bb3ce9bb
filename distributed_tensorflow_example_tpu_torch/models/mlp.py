"""The MLP family (the reference's model) and the activation table every
model family shares.

The JAX package's ``models/mlp.py`` with torch dtypes: ``MLPSpec`` keeps
its field names and defaults, ``init`` draws ``W ~ N(0, 1)`` and zero
biases (the reference's ``tf.random_normal`` init), ``apply`` returns
logits (softmax is left to the loss).  Params are a dict
``{W1, b1, ..., WL, bL}`` with ``W_i`` of shape ``[s_{i-1}, s_i]``, the
JAX layout.

Mixed precision, as in the JAX ``apply``: each product takes operands
rounded to ``compute_dtype`` and accumulates in f32 (``dot_f32``); the
bias add and the activation run in f32; each hidden layer is rounded to
``compute_dtype``; the logits are f32.  ``jax.nn.gelu`` defaults to the
tanh approximation, so ``gelu`` here is ``F.gelu(x, approximate="tanh")``.

Tensor parallelism (``styles`` from ``parallel/mesh.layer_styles``,
``model_axis`` the model group): a ``col`` layer holds a column slice of
``W`` and ``b`` and its replicated input goes through ``model_copy``; a
``row`` layer holds a row slice of ``W`` and its f32 partial product goes
through ``model_psum`` before the bias, as JAX's ``apply`` psums it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]

_ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    input_size: int = 784
    hidden_sizes: Tuple[int, ...] = (100,)
    num_classes: int = 10
    activation: str = "sigmoid"
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    @property
    def layer_sizes(self) -> Tuple[int, ...]:
        return (self.input_size, *self.hidden_sizes, self.num_classes)

    @property
    def num_layers(self) -> int:
        return len(self.hidden_sizes) + 1


def dot_f32(a: torch.Tensor, b: torch.Tensor, cdt: torch.dtype
            ) -> torch.Tensor:
    """``a @ b`` (2-D, or batched 3-D ``[E, M, K] @ [E, K, N]``) on
    operands rounded to ``cdt``, accumulated and returned in f32 (JAX's
    ``preferred_element_type=float32``).  On the card a bf16 product
    runs on the tensor cores with an f32 output (``torch.mm`` /
    ``torch.bmm`` with ``out_dtype=float32``); elsewhere the rounded
    operands are multiplied as f32: a bf16 x bf16 product is exact in
    f32, so only the order of the f32 sums differs.  (``torch.matmul``
    of two bf16 tensors would round its result to bf16.)  f32 products
    on the card run without TF32, PyTorch's default."""
    if a.is_cuda and cdt == torch.bfloat16:
        return _MmBf16F32.apply(a.to(cdt), b.to(cdt))
    return torch.matmul(a.to(cdt).to(torch.float32),
                        b.to(cdt).to(torch.float32))


def _mm_out_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mm = torch.mm if a.ndim == 2 else torch.bmm
    return mm(a, b, out_dtype=torch.float32)


class _MmBf16F32(torch.autograd.Function):
    """``torch.mm`` / ``torch.bmm`` with ``out_dtype=float32`` on bf16
    operands, which have no autograd formula of their own; the
    gradients are the same kind of product, the f32 cotangent rounded to
    bf16, returned in bf16."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_out_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mm_out_f32(g, b.mT).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _mm_out_f32(a.mT, g).to(b.dtype)
        return da, db


def init(spec: MLPSpec, seed: int = 1, device: DeviceLike = None) -> Params:
    """Seeded init: ``W ~ N(0, 1)``, ``b = 0`` in ``spec.param_dtype``.
    The bits come from a ``torch.Generator`` seeded with ``seed``, so
    they differ from JAX's ``PRNGKey``; carry JAX params across with
    ``convert.mlp_params_from_numpy`` where the bits matter."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    sizes = spec.layer_sizes
    params: Params = {}
    for i in range(spec.num_layers):
        params[f"W{i + 1}"] = torch.randn(
            (sizes[i], sizes[i + 1]), generator=gen, device=dev).to(
                spec.param_dtype)
        params[f"b{i + 1}"] = torch.zeros((sizes[i + 1],),
                                          dtype=spec.param_dtype, device=dev)
    return params


def param_shapes(spec: MLPSpec) -> Dict[str, Tuple[int, ...]]:
    sizes = spec.layer_sizes
    out: Dict[str, Tuple[int, ...]] = {}
    for i in range(spec.num_layers):
        out[f"W{i + 1}"] = (sizes[i], sizes[i + 1])
        out[f"b{i + 1}"] = (sizes[i + 1],)
    return out


def apply(spec: MLPSpec, params: Params, x: torch.Tensor, styles=None,
          model_axis=None) -> torch.Tensor:
    """Forward pass to f32 logits (softmax left to the loss).  With
    ``styles`` the layers run tensor-parallel over ``model_axis``
    (module docstring); all-"rep" (or None) is the plain forward."""
    if not styles or all(st == "rep" for st in styles):
        return apply_with_hiddens(spec, params, x)[0]
    from ..parallel.mesh import model_copy, model_psum

    act = _ACTIVATIONS[spec.activation]
    cdt = spec.compute_dtype
    L = spec.num_layers
    h = x.to(cdt)
    for i in range(1, L + 1):
        if styles[i - 1] == "col":
            h = model_copy(h, model_axis)
        acc = dot_f32(h, params[f"W{i}"], cdt)
        if styles[i - 1] == "row":
            acc = model_psum(acc, model_axis)
        acc = acc + params[f"b{i}"].to(torch.float32)
        if i == L:
            return acc
        h = act(acc).to(cdt)


def apply_with_hiddens(spec: MLPSpec, params: Params, x: torch.Tensor):
    """``(logits f32 [N, s_L], (h_1, ..., h_{L-1}) in cdt)``: per layer
    ``acc = h @ W + b`` with cdt operands, f32 accumulation and an f32
    bias; a hidden layer is ``act(acc)`` rounded to cdt, the last
    layer's ``acc`` is the f32 logits (the JAX package's
    ``pallas_fused._layer`` chain, which ``apply`` shares).  The plain
    version of ``ops.fused.mlp_forward``."""
    act = _ACTIVATIONS[spec.activation]
    cdt = spec.compute_dtype
    L = spec.num_layers
    h = x.to(cdt)
    hiddens = []
    for i in range(1, L + 1):
        acc = dot_f32(h, params[f"W{i}"], cdt) \
            + params[f"b{i}"].to(torch.float32)
        if i == L:
            return acc, tuple(hiddens)
        h = act(acc).to(cdt)
        hiddens.append(h)


def num_params(spec: MLPSpec) -> int:
    sizes = spec.layer_sizes
    return sum(sizes[i] * sizes[i + 1] + sizes[i + 1]
               for i in range(spec.num_layers))

"""Transformer family: training (classify and lm objectives) and the
KV-cached decode, on one device.

The counterpart of the JAX package's ``models/transformer.py``:
``TransformerSpec`` (same field names and defaults, torch dtypes),
``param_shapes``/``init``, ``tokenize``, the LayerNorm dispatch
(``_ln``/``_ln_residual``: the fused CUDA kernels, forward and
backward, under ``spec.fused_ln``), the attention dispatch (``_attend``:
the flash kernels under ``spec.attention == "flash"``, the dense
``attention`` otherwise), ``_dropout``, ``_block_forward``/``_ffn_block``
(the dense FFN, the fp8 grouped-FFN kernel under ``spec.fp8_ffn``, or
the mixture of experts: ``_route_topk``, ``_load_balance_loss``, dense
dispatch ``_moe_ffn`` and the capacity-limited sparse dispatch
``_moe_ffn_sparse`` = ``_sparse_route`` -> ``_grouped_expert_ffn`` ->
``_sparse_combine``, whose expert FFN runs the grouped-FFN kernel under
``spec.grouped_moe`` or ``spec.fp8_ffn``), ``apply`` (logits and the
balance loss, differentiable by autograd), ``num_params``/
``flops_per_step``, and the KV-cached decode (``init_decode_cache``,
``_DenseKV``, ``_decode_forward``, ``decode_step``, ``generate``, and
``generate_dp``/``dp_samples_host``: the prompts sharded over the data
axis, the rows gathered back).

Params are a flat ``{name: tensor}`` dict with the JAX package's
names and layouts (``Wqkv`` is ``[d, 3, d]``), so ``convert.py``
carries weights across unchanged.

Mixed precision follows the JAX package's rounding points: matmuls
take ``compute_dtype`` operands with f32 accumulation
(``models.mlp.dot_f32``: on the card a bf16 product runs on the tensor
cores with an f32 output, elsewhere the rounded operands are multiplied
in f32), q/k/v are rounded to ``compute_dtype`` before attention and
the cache stores them so, the score product runs in ``compute_dtype``
and is cast to f32 after, the probabilities are cast back before the
value product, and the residual stream ``h`` is f32.

Dropout draws its masks from a ``torch.Generator`` seeded per site from
the step's seed and a salt (``_dropout``); JAX's ``fold_in``/
``bernoulli`` bits cannot be reproduced, so dropout > 0 is held to its
own properties, not to JAX's masks.

Routing follows the JAX package's integers exactly: top-k by a stable
descending sort (the lower expert index first on a tie, as
``jax.lax.top_k``), rank-major dispatch units, slots from a stable
argsort and ``searchsorted(side="left")``, dropped units in a trash row
past the buffer.

The decode routes a MoE spec by dense dispatch, as the JAX package's
does.

Megatron tensor parallelism (``model_axis``: the model group of
``parallel/mesh.py``, JAX's ``model_axis`` name): the block leaves
arrive as their model shards (``param_pspecs``: ``Wqkv``/``bqkv`` this
rank's heads, ``Wo`` their rows, ``W1``/``b1`` a hidden slice, ``W2``
its rows), the attention runs on the local heads (the flash kernels see
``[B, S, H/mp, Dh]``), the replicated input of each column-split
product goes through ``model_copy`` and each row-split product's f32
accumulator through ``model_psum`` before its bias (``_row_psum``), so
the LayerNorms and the residual stream stay replicated.  A MoE block
shards its attention only; the experts are not split over the model
axis (see expert parallelism below).  The decode
(``decode_step``, ``generate``, ``generate_sharded``) runs the same way
on a per-rank cache of the local heads.

Sequence parallelism (``seq_axis``: ``parallel/mesh.SeqAxis``, JAX's
``seq_axis`` name): ``x`` is this rank's contiguous block of the token
axis, ``pos`` is sliced at the block's global offset, the attention runs
the layout ``spec.sp_impl`` names (``ops/ring_attention``'s ring, dense
or on the flash kernels, or ``ops/ulysses_attention``), the token-wise
blocks need no collective, and the classifier's pooled mean is completed
with ``pmean_seq``, so the logits come out replicated over the axis.
The MoE balance loss averages its statistics over the token-sharding
axes (``aux_axes``: ``parallel/mesh.TokenAxes``, JAX's ``aux_axes``)
before it combines them.

Expert parallelism (``expert_axis``: ``parallel/mesh.ExpertAxis``, JAX's
``expert_axis`` name): each MoE block's expert leaves arrive as this
rank's ``El = E / ep`` experts (``expert_leaves``).  Dense dispatch runs
them on every token, the selection sliced at the rank's offset, and
sums the partial outputs over the axis (``expert_psum``); its replicated
input and selection enter through ``expert_copy``, so their gradients
are summed over the axis (the balance loss's path to the router stays
outside the copy).  Sparse dispatch routes locally, sends the ``[E, C,
d]`` buffers to their experts' ranks (``expert_all_to_all``), runs the
grouped FFN on ``[El, ep * C, d]`` and sends the rows back.

Pipeline parallelism (``stage_axis``: ``parallel/mesh.StageAxis``, JAX's
``stage_axis`` name): the block leaves stack into ``blk_*`` leaves with
a leading block dim (``pipeline_stack_params``, in JAX's order, the
interleaved permutation at ``virtual`` > 1) and each stage holds its
contiguous slice; ``apply_pipeline`` runs GPipe or the interleaved
schedule on it, its backward the same ticks in reverse, and
``pipeline_value_and_grad_1f1b`` the fused 1F1B family, both reading
this rank's row of ``parallel/pp_schedule``'s tick tables, running live
slots only and moving a microbatch's activations between stages with
``stage_hop_start``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..obs import tracer as tracer_lib
from ..ops.ring_attention import NEG_INF, attention, softmax
from ..parallel import pp_schedule
from ..parallel.mesh import (expert_all_to_all, expert_copy, expert_psum,
                             model_copy, model_psum, pmean_seq,
                             pmean_tokens, stage_hop_start,
                             stage_hop_transport, stage_psum)
from .mlp import _ACTIVATIONS, dot_f32

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TransformerSpec:
    input_size: int = 784
    num_classes: int = 10
    seq_len: int = 28
    d_model: int = 128
    n_heads: int = 4
    num_blocks: int = 2
    d_ff: int = 256
    activation: str = "gelu"
    objective: str = "classify"    # classify | lm (decode serves lm)
    vocab_size: int = 256
    attention: str = "dense"       # dense | flash (the flash kernels,
                                   # ops/flash_attention); decode and
                                   # the serving prefill run dense
    sp_impl: str = "ring"
    causal: bool = False
    num_experts: int = 0           # 0 = dense FFN; > 0 = MoE FFN
    moe_topk: int = 1              # 1 = Switch (raw top gate), > 1 =
                                   # GShard (gates renormalized)
    aux_loss_weight: float = 0.0
    dropout_rate: float = 0.0      # training-only dropout on the
                                   # embedded input and each block's
                                   # attention/FFN outputs
    moe_dispatch: str = "dense"    # dense (exact) | alltoall (capacity-
                                   # limited sparse dispatch)
    capacity_factor: float = 1.25  # alltoall: C = ceil(cf * T * k / E)
    fused_ln: bool = False         # LayerNorms run the fused CUDA kernel
                                   # (ops/fused.fused_layer_norm[_residual])
    grouped_moe: bool = False      # the sparse expert FFN through the
                                   # grouped-FFN kernel (ops/fused.
                                   # moe_grouped_matmul)
    fp8_ffn: bool = False          # FFN matmuls on fp8-e4m3-rounded
                                   # operands through the grouped-FFN
                                   # kernel (ops/fused.fp8_dense_ffn /
                                   # fp8_grouped_matmul)
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    @property
    def d_feature(self) -> int:
        if self.objective == "lm":
            if self.seq_len != self.input_size:
                raise ValueError(
                    f"objective='lm' tokenizes every input scalar: "
                    f"seq_len ({self.seq_len}) must equal input_size "
                    f"({self.input_size})")
            return 1
        if self.input_size % self.seq_len:
            raise ValueError(
                f"input_size={self.input_size} not divisible by "
                f"seq_len={self.seq_len}")
        return self.input_size // self.seq_len

    @property
    def d_head(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model={self.d_model} not divisible by "
                f"n_heads={self.n_heads}")
        return self.d_model // self.n_heads


def param_shapes(spec: TransformerSpec) -> Dict[str, tuple]:
    """Analytic ``{name: shape}`` map (the JAX package's layout)."""
    d, ff, f = spec.d_model, spec.d_ff, spec.d_feature
    if spec.objective == "lm":
        shapes: Dict[str, tuple] = {
            "W_emb": (spec.vocab_size, d), "pos": (spec.seq_len, d),
            "lnf_g": (d,), "lnf_b": (d,),
            "W_head": (d, spec.vocab_size), "b_head": (spec.vocab_size,),
        }
    else:
        shapes = {
            "W_in": (f, d), "b_in": (d,), "pos": (spec.seq_len, d),
            "lnf_g": (d,), "lnf_b": (d,),
            "W_head": (d, spec.num_classes),
            "b_head": (spec.num_classes,),
        }
    for i in range(spec.num_blocks):
        shapes.update({
            f"L{i}_ln1_g": (d,), f"L{i}_ln1_b": (d,),
            f"L{i}_Wqkv": (d, 3, d), f"L{i}_bqkv": (3, d),
            f"L{i}_Wo": (d, d), f"L{i}_bo": (d,),
            f"L{i}_ln2_g": (d,), f"L{i}_ln2_b": (d,),
        })
        if spec.num_experts:
            e = spec.num_experts
            shapes.update({
                f"L{i}_Wr": (d, e),                 # router
                f"L{i}_We1": (e, d, ff), f"L{i}_be1": (e, ff),
                f"L{i}_We2": (e, ff, d), f"L{i}_be2": (e, d),
            })
        else:
            shapes.update({
                f"L{i}_W1": (d, ff), f"L{i}_b1": (ff,),
                f"L{i}_W2": (ff, d), f"L{i}_b2": (d,),
            })
    return shapes


# the Megatron split of each block leaf (unprefixed name -> the dim split
# over the model axis); the others are replicated
_TP_DIMS = {"Wqkv": 2, "bqkv": 1, "Wo": 0, "bo": None,
            "W1": 1, "b1": 0, "W2": 0, "b2": None}


def check_tp(spec: TransformerSpec, model_parallel: int) -> None:
    """A Megatron TP degree against the spec's dims (JAX's messages).
    With a MoE FFN only the attention side splits, so d_ff's
    divisibility binds the dense FFN alone."""
    if model_parallel <= 1:
        return
    if spec.n_heads % model_parallel:
        raise ValueError(
            f"n_heads={spec.n_heads} must divide evenly over "
            f"model_parallel={model_parallel}")
    if not spec.num_experts and spec.d_ff % model_parallel:
        raise ValueError(
            f"d_ff={spec.d_ff} must divide evenly over "
            f"model_parallel={model_parallel}")


def param_pspecs(spec: TransformerSpec, model_axis=None
                 ) -> Dict[str, Optional[int]]:
    """``{name: the dim split over the model axis, or None}``: with
    ``model_axis`` (JAX's ``param_pspecs(model_axis=...)``) the block
    leaves of ``_TP_DIMS`` split — ``Wqkv [d, 3, d]`` on its last dim
    (whole heads a shard), ``Wo`` and ``W2`` on dim 0 (row-split + psum),
    ``W1``/``b1`` on the hidden dim — and the token-wise leaves (the
    LayerNorms, the embeddings, the head, the experts) replicate."""
    out = {}
    for name in param_shapes(spec):
        leaf = name.split("_", 1)[1] if name.startswith("L") else None
        out[name] = _TP_DIMS.get(leaf) if model_axis and leaf else None
    return out


# the per-expert leaves of a MoE block (dim 0 the expert), which expert
# parallelism splits; the router Wr stays whole on every rank
_EXPERT_LEAVES = ("We1", "be1", "We2", "be2")


def expert_leaves(spec: TransformerSpec) -> list:
    """The names of every MoE block's per-expert leaves (JAX's
    ``_EXPERT_LEAVES``; none for the dense FFN)."""
    return [n for n in param_shapes(spec)
            if n.startswith("L") and n.split("_", 1)[1] in _EXPERT_LEAVES]


def init(spec: TransformerSpec, seed: int = 0,
         device: DeviceLike = None) -> Params:
    """Seeded init with the JAX package's distributions: weights
    ``N(0,1)/sqrt(fan_in)`` (the fan-in is ``shape[-2]`` for the
    ``[E, fan_in, fan_out]`` expert weights, ``shape[0]`` otherwise),
    ``pos``/``W_emb`` ``0.02*N(0,1)``, zero
    biases, unit LayerNorm gains.  The bits come from a
    ``torch.Generator`` seeded with ``seed``, so they differ from
    JAX's; carry JAX params across with ``convert.params_from_numpy``
    where the bits matter."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    pd = spec.param_dtype
    p: Params = {}
    for name, shape in param_shapes(spec).items():
        if name in ("pos", "W_emb"):
            w = torch.randn(shape, generator=gen, device=dev) * 0.02
            p[name] = w.to(pd)
        elif "W" in name:
            w = torch.randn(shape, generator=gen, device=dev)
            fan_in = (shape[-2] if name.endswith(("We1", "We2"))
                      else shape[0])
            p[name] = (w / math.sqrt(fan_in)).to(pd)
        elif name.endswith("_g"):
            p[name] = torch.ones(shape, dtype=pd, device=dev)
        else:
            p[name] = torch.zeros(shape, dtype=pd, device=dev)
    return p


def _block_params(params: Params, i: int) -> Params:
    """Block ``i``'s leaves under their unprefixed names."""
    pre = f"L{i}_"
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _cast_mm(a: torch.Tensor, w: torch.Tensor, cdt) -> torch.Tensor:
    """``a @ w`` with ``cdt`` operands and f32 accumulation, for ``a``
    ``[..., K]`` and ``w`` ``[K, ...]`` (``models.mlp.dot_f32`` on the
    flattened operands)."""
    out = dot_f32(a.reshape(-1, a.shape[-1]), w.reshape(w.shape[0], -1),
                  cdt)
    return out.reshape(*a.shape[:-1], *w.shape[1:])


def _layer_norm(x, g, b):
    """Reference LayerNorm (f32 statistics and output, last axis)."""
    x = _f32(x)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * _f32(g) + _f32(b)


def _ln(spec: TransformerSpec, x, g, b):
    """The model's LayerNorm: the fused kernel under ``spec.fused_ln``,
    the reference otherwise, in the ``ln`` scope (as every LayerNorm of
    the model)."""
    with tracer_lib.scope("ln"):
        if spec.fused_ln:
            from ..ops.fused import fused_layer_norm

            return fused_layer_norm(x, g, b)
        return _layer_norm(x, g, b)


def _ln_residual(spec: TransformerSpec, h, branch, g, b):
    """``s = h + branch; return (LN(s), s)`` — one kernel pass under
    ``spec.fused_ln``."""
    with tracer_lib.scope("ln"):
        if spec.fused_ln:
            from ..ops.fused import fused_layer_norm_residual

            return fused_layer_norm_residual(h, branch, g, b)
        s = h + branch
        return _layer_norm(s, g, b), s


def _mm(params_or_bp: Params, a, w_name: str, b_name: str, cdt):
    """``a @ W + b`` with ``cdt`` operands and f32 out."""
    return _cast_mm(a, params_or_bp[w_name], cdt) \
        + _f32(params_or_bp[b_name])


def _row_psum(x, w, b, cdt, model_axis):
    """Row-split projection (JAX's ``_row_psum``): the local
    ``[.., k_local] @ [k_local, n]`` f32 accumulator summed over
    ``model_axis`` (``model_psum``), the bias added once after."""
    return model_psum(_cast_mm(x, w, cdt), model_axis) + _f32(b)


def tokenize(spec: TransformerSpec, x: torch.Tensor) -> torch.Tensor:
    """Discretize float inputs in [0, 1] to int64 tokens ``[B, S]``
    (from ``[B, S]`` or ``[B, S, 1]``): the lm objective's vocabulary,
    one token per input scalar (round half to even, as ``jnp.round``)."""
    v = spec.vocab_size
    flat = x.reshape(x.shape[0], -1).to(torch.float32)
    return torch.clamp(torch.round(flat * (v - 1)), 0, v - 1).long()


def _site_seed(rng: int, salt: int) -> int:
    """A 63-bit generator seed for one dropout site of one step."""
    return (int(rng) * 0x9E3779B97F4A7C15 + int(salt)) % (1 << 63)


def _dropout(h, spec: TransformerSpec, rng: Optional[int], salt: int):
    """Inverted dropout: keep-mask / keep_prob, only when a training
    ``rng`` (the step's integer seed) is given — eval passes None and
    never drops.  The mask comes from a ``torch.Generator`` seeded with
    (rng, salt), so ``salt`` decorrelates the sites within one forward
    and a recompute (``--remat``) draws the same mask."""
    if rng is None or not spec.dropout_rate:
        return h
    keep = 1.0 - spec.dropout_rate
    gen = torch.Generator(device=h.device).manual_seed(_site_seed(rng, salt))
    mask = torch.rand(h.shape, generator=gen, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype,
                                                   device=h.device)
                       ).to(h.dtype)


def _attend(spec: TransformerSpec, q, k, v, seq_axis=None):
    """[B, S(local), H, Dh] in/out by the backend ``spec.attention``
    names: the flash kernels (``ops/flash_attention.flash_attention``)
    or the dense ``ops/ring_attention.attention``.  With ``seq_axis``
    the layout ``spec.sp_impl`` names: the ring (``ring_flash_attention``
    on the flash kernels, ``ring_attention`` dense) or Ulysses
    (``ulysses_attention``, flash or dense on the full sequence)."""
    if seq_axis is not None:
        if spec.sp_impl == "ulysses":
            from ..ops.ulysses_attention import ulysses_attention

            return ulysses_attention(q, k, v, seq_axis, causal=spec.causal,
                                     use_flash=spec.attention == "flash")
        if spec.sp_impl != "ring":
            raise ValueError(
                f"unknown sp_impl {spec.sp_impl!r}: expected 'ring' or "
                f"'ulysses'")
        from ..ops.ring_attention import ring_attention, ring_flash_attention

        ring = (ring_flash_attention if spec.attention == "flash"
                else ring_attention)
        return ring(q, k, v, seq_axis, causal=spec.causal)
    if spec.attention == "flash":
        from ..ops.flash_attention import flash_attention

        return flash_attention(q, k, v, spec.causal)
    if spec.attention == "dense":
        return attention(q, k, v, causal=spec.causal)
    raise ValueError(f"unknown attention {spec.attention!r}: expected "
                     f"'dense' or 'flash'")


def _load_balance_loss(spec: TransformerSpec, probs, top1_idx,
                       axes=None):
    """Switch Transformer's load-balance loss for one MoE block,
    ``E * sum_e f_e * P_e``: ``f_e`` the fraction of tokens whose first
    choice is expert e (counts, no gradient), ``P_e`` the mean router
    probability on e.  ``probs`` is ``[..., E]``.  ``axes``
    (``parallel/mesh.TokenAxes``, JAX's ``aux_axes``): the ranks the
    tokens shard over; f and P are averaged over them before they
    combine (``pmean_tokens``), so every rank adds the global batch's
    loss, as JAX's ``pmean`` makes it."""
    e = spec.num_experts
    f = torch.mean(torch.nn.functional.one_hot(
        top1_idx.reshape(-1), e).to(torch.float32), dim=0)
    p = torch.mean(probs.reshape(-1, e), dim=0)
    f = pmean_tokens(f, axes, grad=False)
    p = pmean_tokens(p, axes)
    return e * torch.sum(f * p)


def _balance_stats(spec: TransformerSpec, probs, top1_idx):
    """Raw per-block load-balance statistics ``[2, E]`` = (f, P), the
    top-1 routing fraction and the mean router probability as LOCAL
    token means with no cross-rank mean (JAX's ``_balance_stats``): the
    pipeline sums them over microbatches and combines them once after
    its tick loop."""
    e = spec.num_experts
    f = torch.mean(torch.nn.functional.one_hot(
        top1_idx.reshape(-1), e).to(torch.float32), dim=0)
    p = torch.mean(probs.reshape(-1, e), dim=0)
    return torch.stack([f, p])


def _route_topk(spec: TransformerSpec, probs):
    """``(gates [..., k], idx [..., k])``, the router's top-k choices:
    a stable descending sort, so on a tie the lower expert index comes
    first, as in ``jax.lax.top_k`` (``torch.topk`` makes no such
    promise).  Top-1 keeps the raw winning probability as the gate
    (Switch); k > 1 renormalizes the gates among the chosen (GShard).
    Differentiable through the gate values."""
    k = spec.moe_topk
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :k], idx[..., :k]
    if k > 1:
        gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    return gates, idx


def _moe_ffn(spec: TransformerSpec, bp: Params, a, act, cdt, aux_axes=None,
             expert_axis=None, aux_stats: bool = False):
    """Top-k MoE FFN by dense dispatch: every expert on every token, the
    gate-weighted one-hot selection combines them (exact: no capacity,
    nothing dropped).  ``a`` [B, S, d] -> ``(out f32, aux)``.  Under
    ``expert_axis`` the rank runs its ``El`` experts only, on the
    selection's columns ``[index * El, (index + 1) * El)``, and the
    partial outputs are summed over the axis; ``a`` and the selection
    enter its experts through ``expert_copy`` (each rank's gradient
    covers its experts only), the balance loss reads ``probs`` beside
    it.  The router and the selection, then the combine, run in the
    ``moe_dispatch`` scope, the experts in ``moe_expert``."""
    e = spec.num_experts
    with tracer_lib.scope("moe_dispatch"):
        probs = softmax(_cast_mm(a, bp["Wr"], cdt), dim=-1)  # [B, S, E]
        gates, idx = _route_topk(spec, probs)                # [B, S, k]
        sel = torch.sum(torch.nn.functional.one_hot(idx, e).to(
            torch.float32) * gates[..., None], dim=-2)       # [B, S, E]
    el = bp["We1"].shape[0]
    if expert_axis is not None:
        off = expert_axis.index * el
        sel = expert_copy(sel, expert_axis)[..., off:off + el]
        a = expert_copy(a, expert_axis)
    b, s, _ = a.shape
    with tracer_lib.scope("moe_expert"):
        h1 = _cast_mm(a, bp["We1"].permute(1, 0, 2), cdt) \
            + _f32(bp["be1"])                               # [B, S, El, ff]
        h1 = act(h1).to(cdt)
        h2 = dot_f32(h1.reshape(b * s, el, -1).transpose(0, 1), bp["We2"],
                     cdt)
        h2 = h2.transpose(0, 1).reshape(b, s, el, -1) + _f32(bp["be2"])
    with tracer_lib.scope("moe_dispatch"):
        out = torch.einsum("bsed,bse->bsd", h2, sel)
    out = expert_psum(out, expert_axis)
    if aux_stats:
        return out, _balance_stats(spec, probs, idx[..., 0])
    return out, _load_balance_loss(spec, probs, idx[..., 0], aux_axes)


def _sparse_route(spec: TransformerSpec, x, wr, cdt):
    """Router, slotting and scatter: ``x`` [T, d] -> ``(buf [E, C, d]
    f32, slot [k*T], gates [T, k], keep [k*T], probs [T, E], idx [T,
    k])`` with ``C = ceil(capacity_factor * T * k / E)``.  Each
    (token, choice) pair is a unit, flattened rank-major, so every
    token's first choice claims a slot before any second choice; a
    unit's position in its expert's buffer is its rank in a stable sort
    by expert less its group's first rank; units past C (and only they)
    go to the trash row ``E * C``, which the buffer drops."""
    t, d = x.shape
    e, k = spec.num_experts, spec.moe_topk
    cap = max(1, math.ceil(spec.capacity_factor * t * k / e))
    probs = softmax(dot_f32(x, wr, cdt), dim=-1)            # [T, E]
    gates, idx = _route_topk(spec, probs)                   # [T, k]
    flat_e = idx.T.reshape(k * t)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    group_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_sorted = torch.arange(k * t, device=x.device) - group_start
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, e * cap))
    xk = _f32(x)[None].expand(k, t, d).reshape(k * t, d)
    buf = torch.zeros((e * cap + 1, d), dtype=torch.float32,
                      device=x.device).index_add(0, slot, xk)
    return (buf[:-1].reshape(e, cap, d), slot, gates, keep, probs, idx)


def _grouped_expert_ffn(spec: TransformerSpec, buf, we1, be1, we2, be2,
                        act, cdt):
    """The per-expert two-matmul FFN ``[E, C, d] -> [E, C, d]`` (f32):
    the grouped-FFN kernel on fp8-rounded operands under
    ``spec.fp8_ffn`` (``ops/fused.fp8_grouped_matmul``), the kernel
    under ``spec.grouped_moe`` (``ops/fused.moe_grouped_matmul``),
    else two batched products with the [E, C, ff] hidden between."""
    if spec.fp8_ffn:
        from ..ops.fused import fp8_grouped_matmul

        return fp8_grouped_matmul(spec.activation, cdt, buf, we1, be1,
                                  we2, be2)
    if spec.grouped_moe:
        from ..ops.fused import moe_grouped_matmul

        return moe_grouped_matmul(spec.activation, cdt, buf, we1, be1,
                                  we2, be2)
    h1 = act(dot_f32(buf, we1, cdt) + _f32(be1)[:, None]).to(cdt)
    return dot_f32(h1, we2, cdt) + _f32(be2)[:, None]


def _sparse_combine(h2, slot, gates, keep):
    """Each unit's output row gathered from its slot (the trash row
    reads 0), gate-weighted and summed over the k choices: [T, d].  The
    gather is ``index_select``, whose backward is one ``index_add`` (on
    the card an atomic add per row; kept slots are one to one, so each
    kept row gets exactly one); advanced indexing's backward sorts the
    indices first, which took ~22 ms a block at ``moe_wide`` on the
    H100."""
    t, k = gates.shape
    d = h2.shape[-1]
    h2_flat = torch.cat([h2.reshape(-1, d),
                         torch.zeros((1, d), dtype=h2.dtype,
                                     device=h2.device)])
    picked = h2_flat.index_select(0, slot).reshape(k, t, d)
    w = gates.T * keep.to(torch.float32).reshape(k, t)
    return torch.sum(picked * w[..., None], dim=0)


def _moe_ffn_sparse(spec: TransformerSpec, bp: Params, a, act, cdt,
                    aux_axes=None, expert_axis=None, aux_stats: bool = False):
    """Capacity-limited top-k MoE FFN (Switch/GShard): ``_sparse_route``
    -> ``_grouped_expert_ffn`` -> ``_sparse_combine``; dropped units add
    nothing and the residual carries their tokens.  ``a`` [B, S, d] ->
    ``(out f32, aux)``; with ``capacity_factor >= E`` nothing drops and
    it equals ``_moe_ffn`` up to the order of f32 sums.  Under
    ``expert_axis`` (with ``El < E`` experts here) the f32 buffers go to
    their experts' ranks and back (``expert_all_to_all``), and the
    grouped FFN runs on ``[El, ep * C, d]``; the capacity ``C`` is this
    shard's.  The route and the combine run in the ``moe_dispatch``
    scope, the grouped FFN in ``moe_expert``; the exchanges outside
    both."""
    b, s, d = a.shape
    with tracer_lib.scope("moe_dispatch"):
        buf, slot, gates, keep, probs, idx = _sparse_route(
            spec, a.reshape(b * s, d), bp["Wr"], cdt)
    exchange = (expert_axis is not None
                and bp["We1"].shape[0] != spec.num_experts)
    if exchange:
        buf = expert_all_to_all(buf, expert_axis)
    with tracer_lib.scope("moe_expert"):
        h2 = _grouped_expert_ffn(spec, buf, bp["We1"], bp["be1"],
                                 bp["We2"], bp["be2"], act, cdt)
    if exchange:
        h2 = expert_all_to_all(h2, expert_axis, reverse=True)
    with tracer_lib.scope("moe_dispatch"):
        out = _sparse_combine(h2, slot, gates, keep)
    if aux_stats:
        return out.reshape(b, s, d), _balance_stats(spec, probs, idx[:, 0])
    return out.reshape(b, s, d), _load_balance_loss(spec, probs, idx[:, 0],
                                                    aux_axes)


def _block_forward(spec: TransformerSpec, bp: Params, h, act, cdt,
                   kv_out: Optional[list] = None, dropout_rng=None,
                   block: int = 0, model_axis=None, seq_axis=None,
                   aux_axes=None, expert_axis=None, aux_stats: bool = False):
    """One pre-LN block on ``h`` [B, S, D] (f32): attention by
    ``_attend``, the attention residual add fused into ln2, then the
    FFN half, with dropout on both residual branches when
    ``dropout_rng`` is given (sites ``2 * block`` and ``2 * block + 1``).
    ``kv_out``: a list to append this block's ``(k, v)`` [B, S, H, Dh]
    (in ``cdt``) to — the prefill captures them for the paged cache.
    Returns ``(h, aux)``, aux the block's MoE balance loss (0 for the
    dense FFN).  Under ``model_axis`` the leaves are this rank's
    Megatron shards: the attention runs on its heads, with one
    ``model_psum`` after ``Wo`` (and one after ``W2``).  Under
    ``seq_axis`` ``h`` is this rank's token block and the attention runs
    the sequence-parallel layout; ``aux_axes`` reach the balance
    loss, ``expert_axis`` the MoE FFN.  ``aux_stats``: aux is the MoE
    block's raw ``[2, E]`` statistics instead (``_balance_stats``; the
    pipeline combines them)."""
    b, s, d = h.shape
    a = _ln(spec, h, bp["ln1_g"], bp["ln1_b"])
    qkv = _cast_mm(model_copy(a, model_axis), bp["Wqkv"], cdt) \
        + _f32(bp["bqkv"])                                  # [B, S, 3, e]
    q, k, v = (qkv[:, :, t].to(cdt) for t in range(3))
    shape = (b, s, bp["Wqkv"].shape[-1] // spec.d_head, spec.d_head)
    if kv_out is not None:
        kv_out.append((k.reshape(shape), v.reshape(shape)))
    att = _attend(spec, q.reshape(shape), k.reshape(shape),
                  v.reshape(shape), seq_axis)
    branch = _dropout(_row_psum(att.reshape(b, s, -1).to(cdt), bp["Wo"],
                                bp["bo"], cdt, model_axis),
                      spec, dropout_rng, 2 * block)
    a2, h = _ln_residual(spec, h, branch, bp["ln2_g"], bp["ln2_b"])
    return _ffn_block(spec, bp, h, act, cdt, a=a2, dropout_rng=dropout_rng,
                      block=block, model_axis=model_axis, aux_axes=aux_axes,
                      expert_axis=expert_axis, aux_stats=aux_stats)


def _ffn_block(spec: TransformerSpec, bp: Params, h, act, cdt, a=None,
               dropout_rng=None, block: int = 0, model_axis=None,
               aux_axes=None, expert_axis=None, aux_stats: bool = False):
    """The LN2 + FFN residual half of a block (dense, fp8 or MoE),
    shared by the training forward, the prefill and the decode step.
    ``h`` [B, S, D] -> ``(h, aux)``; ``a`` is the ln2 output when the
    caller already has it.  Under ``model_axis`` the dense FFN is
    column-split (``W1``) then row-split (``W2``, psummed); the MoE
    FFN's experts are not split over it (over ``expert_axis`` under
    expert parallelism); fp8 raises (JAX's guard)."""
    if a is None:
        a = _ln(spec, h, bp["ln2_g"], bp["ln2_b"])
    aux = torch.zeros((2, spec.num_experts) if aux_stats else (),
                      dtype=torch.float32, device=h.device)
    if spec.num_experts:
        if spec.moe_dispatch == "alltoall":
            moe = _moe_ffn_sparse
        elif spec.moe_dispatch == "dense":
            moe = _moe_ffn
        else:
            raise ValueError(
                f"unknown moe_dispatch {spec.moe_dispatch!r}: expected "
                f"'dense' or 'alltoall'")
        ffn, aux = moe(spec, bp, a, act, cdt, aux_axes, expert_axis,
                       aux_stats)
    elif spec.fp8_ffn:
        if model_axis is not None:
            raise ValueError("fp8_ffn does not compose with tensor "
                             "parallelism (the row-split FFN shards "
                             "the contraction its scales cover)")
        from ..ops.fused import fp8_dense_ffn

        bsz, s, d = a.shape
        ffn = fp8_dense_ffn(spec.activation, cdt, a.reshape(bsz * s, d),
                            bp["W1"], bp["b1"], bp["W2"],
                            bp["b2"]).reshape(bsz, s, -1)
    else:
        hid = act(_mm(bp, model_copy(a, model_axis), "W1", "b1", cdt))
        ffn = _row_psum(hid.to(cdt), bp["W2"], bp["b2"], cdt, model_axis)
    return h + _dropout(ffn, spec, dropout_rng, 2 * block + 1), aux


class _ScaleGrad(torch.autograd.Function):
    """Identity in the forward; the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _classify_head(spec: TransformerSpec, params: Params, h, seq_axis=None):
    """The classifier's head on ``h`` [B, S(local), D]: the final
    LayerNorm, the mean over tokens and ``W_head``; f32 ``[B,
    num_classes]``."""
    hl = _ln(spec, h, params["lnf_g"], params["lnf_b"])
    pooled = torch.mean(hl, dim=1)
    head = params
    if seq_axis is not None:
        # the global token mean (backward: JAX's transpose, g / n); the
        # head then runs on a value replicated over the axis, where JAX
        # sums its gradient over 'data' only: the step sums every
        # gradient over data x seq, so its local gradient counts 1 / n
        pooled = pmean_seq(pooled, seq_axis)
        head = {k: _ScaleGrad.apply(params[k], 1.0 / seq_axis.size)
                for k in ("W_head", "b_head")}
    return _f32(_mm(head, pooled, "W_head", "b_head", spec.compute_dtype))


def apply(spec: TransformerSpec, params: Params, x: torch.Tensor,
          with_aux: bool = False, dropout_rng=None, model_axis=None,
          seq_axis=None, aux_axes=None, expert_axis=None):
    """Forward to f32 logits, differentiable by autograd: ``[B,
    num_classes]`` (classify: the blocks' mean over tokens through the
    head) or ``[B, S, vocab]`` (lm: per-position vocab logits).  ``x``:
    ``[B, input_size]`` (viewed as ``seq_len`` tokens) or ``[B, S, F]``.
    ``dropout_rng``: the step's integer seed (training) or None (eval).
    ``with_aux`` also returns the per-block mean of the MoE balance
    loss (0 for the dense FFN).  ``model_axis``: the model group under
    Megatron TP (``params`` then this rank's shards); the logits come
    out replicated.  ``seq_axis`` (``parallel/mesh.SeqAxis``): ``x`` is
    this rank's block of the token axis (``[B, input_size / n]``),
    ``pos`` sliced at its offset, the lm logits this block's
    ``[B, S/n, vocab]`` and the classifier's replicated over the axis.
    ``aux_axes`` (``parallel/mesh.TokenAxes``): the ranks the tokens
    shard over, for the balance loss.  ``expert_axis``
    (``parallel/mesh.ExpertAxis``): ``params`` hold this rank's experts
    and the MoE blocks run expert-parallel."""
    cdt = spec.compute_dtype
    b = x.shape[0]
    s, f = spec.seq_len, spec.d_feature
    pos = _f32(params["pos"])
    if seq_axis is not None:
        s = spec.seq_len // seq_axis.size
        pos = pos[seq_axis.index * s:(seq_axis.index + 1) * s]
    if spec.objective == "lm":
        h = _f32(params["W_emb"])[tokenize(spec, x)] + pos[None]
    else:
        h = x.reshape(b, s, f).to(cdt)
        h = _mm(params, h, "W_in", "b_in", cdt) + pos[None]
    act = _ACTIVATIONS[spec.activation]
    h = _dropout(h, spec, dropout_rng, 0x9999)   # embedding dropout
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(spec.num_blocks):
        h, aux_i = _block_forward(spec, _block_params(params, i), h, act,
                                  cdt, dropout_rng=dropout_rng, block=i,
                                  model_axis=model_axis, seq_axis=seq_axis,
                                  aux_axes=aux_axes, expert_axis=expert_axis)
        aux = aux + aux_i
    if spec.objective == "lm":
        h = _ln(spec, h, params["lnf_g"], params["lnf_b"])
        logits = _f32(_mm(params, h, "W_head", "b_head", cdt))
    else:
        logits = _classify_head(spec, params, h, seq_axis)
    if with_aux:
        return logits, aux / spec.num_blocks
    return logits


def num_params(spec: TransformerSpec) -> int:
    return sum(math.prod(s) for s in param_shapes(spec).values())


def flops_per_step(spec: TransformerSpec, batch: int) -> float:
    """Analytic fwd+bwd matmul+attention FLOPs per training step (fwd
    2*MACs, bwd 4*MACs; attention 4*B*H*S^2*Dh forward, halved under
    causal, 3.5x for fwd+bwd): the JAX package's accounting.  The
    sparse MoE FFN counts ``capacity_factor * k`` tokens' worth of
    expert FFN per token, the dense-dispatch one every expert; both add
    the router."""
    d, ff, f, s = spec.d_model, spec.d_ff, spec.d_feature, spec.seq_len
    if spec.num_experts and spec.moe_dispatch == "alltoall":
        ffn = spec.capacity_factor * spec.moe_topk * (d * ff + ff * d) \
            + d * spec.num_experts
    elif spec.num_experts:
        ffn = spec.num_experts * (d * ff + ff * d) + d * spec.num_experts
    else:
        ffn = d * ff + ff * d
    macs_tok = f * d + spec.num_blocks * (3 * d * d + d * d + ffn)
    head = (s * d * spec.vocab_size if spec.objective == "lm"
            else d * spec.num_classes)
    macs = batch * (s * macs_tok + head)
    attn = 4.0 * batch * spec.n_heads * s * s * spec.d_head \
        * spec.num_blocks * (0.5 if spec.causal else 1.0)
    return 6.0 * macs + 3.5 * attn


# ---------------------------------------------------------------------------
# pipeline parallelism: the stacked layout and the schedules
# ---------------------------------------------------------------------------

_BLOCK_LEAVES = ("ln1_g", "ln1_b", "Wqkv", "bqkv", "Wo", "bo",
                 "ln2_g", "ln2_b", "W1", "b1", "W2", "b2")
_BLOCK_LEAVES_MOE = ("ln1_g", "ln1_b", "Wqkv", "bqkv", "Wo", "bo",
                     "ln2_g", "ln2_b", "Wr", "We1", "be1", "We2", "be2")


def _block_leaf_names(spec: TransformerSpec) -> tuple:
    """The per-block leaf set the pipeline stacks: dense FFN or MoE."""
    return _BLOCK_LEAVES_MOE if spec.num_experts else _BLOCK_LEAVES


def _pipeline_block_order(num_blocks: int, n_stages: int,
                          virtual: int) -> list:
    """Stacked position -> logical block (JAX's): the identity at
    ``virtual`` 1; with ``virtual`` > 1 (Megatron's interleaved stages)
    stage ``s`` runs chunks ``c * p + s``, each ``num_blocks / (p * v)``
    consecutive blocks, so stacked position ``s * K + c * k + i`` holds
    logical block ``(c * p + s) * k + i`` and each stage's contiguous
    slice holds its v chunks in the order it runs them."""
    if virtual <= 1:
        return list(range(num_blocks))
    k = num_blocks // (n_stages * virtual)
    order = []
    for s in range(n_stages):
        for c in range(virtual):
            j0 = (c * n_stages + s) * k
            order.extend(range(j0, j0 + k))
    return order


def pipeline_stack_params(spec: TransformerSpec, params: Params,
                          n_stages: int = 1, virtual: int = 1) -> Params:
    """The flat ``L{i}_*`` block leaves regrouped into ``blk_*`` leaves
    with a leading ``[num_blocks, ...]`` dim in ``_pipeline_block_order``
    (JAX's ``pipeline_stack_params``); the embedding, head and final
    LayerNorm leaves keep their names.  Checkpoints of interleaved runs
    are therefore pinned to their ``(n_stages, virtual)``."""
    out = {k: v for k, v in params.items() if not k.startswith("L")}
    order = _pipeline_block_order(spec.num_blocks, n_stages, virtual)
    for leaf in _block_leaf_names(spec):
        out[f"blk_{leaf}"] = torch.stack(
            [params[f"L{j}_{leaf}"] for j in order])
    return out


def pipeline_unstack_params(spec: TransformerSpec, stacked: Params,
                            n_stages: int = 1, virtual: int = 1) -> Params:
    """The inverse of ``pipeline_stack_params`` at the same ``(n_stages,
    virtual)`` (sampling, conversions and tests read the flat layout)."""
    out = {k: v for k, v in stacked.items() if not k.startswith("blk_")}
    order = _pipeline_block_order(spec.num_blocks, n_stages, virtual)
    for leaf in _block_leaf_names(spec):
        for pos, j in enumerate(order):
            out[f"L{j}_{leaf}"] = stacked[f"blk_{leaf}"][pos]
    return out


def pipeline_train_state(spec: TransformerSpec, optimizer, state,
                         n_stages: int = 1, virtual: int = 1):
    """A fresh ``TrainState`` re-laid out for pipeline parallelism: the
    stacked params, the optimizer's slots initialised on them (JAX's
    ``pipeline_train_state``)."""
    from ..train.state import TrainState

    stacked = pipeline_stack_params(spec, state.params, n_stages, virtual)
    return TrainState(step=state.step, params=stacked,
                      opt_state=optimizer.init(stacked))


def pipeline_param_shapes(spec: TransformerSpec) -> Dict[str, tuple]:
    """``{name: global shape}`` of the stacked layout."""
    shapes = param_shapes(spec)
    out = {k: v for k, v in shapes.items() if not k.startswith("L")}
    for leaf in _block_leaf_names(spec):
        out[f"blk_{leaf}"] = (spec.num_blocks,) + shapes[f"L0_{leaf}"]
    return out


def pipeline_param_pspecs(spec: TransformerSpec, model_axis=None
                          ) -> Dict[str, Optional[int]]:
    """``{stacked name: the dim split over the model axis, or None}``:
    each ``blk_*`` leaf's dim 0 splits over 'stage' (every stage its
    contiguous ``num_blocks / p`` slice) and its flat leaf's Megatron dim
    (``param_pspecs``) moves one dim in (JAX's ``pipeline_param_pspecs``,
    reduced to the model split; the expert leaves' dim 1 splits over
    'expert' under expert parallelism, ``pipeline_expert_leaves``)."""
    flat = param_pspecs(spec, model_axis=model_axis)
    out = {}
    for name in pipeline_param_shapes(spec):
        if name.startswith("blk_"):
            d = flat[f"L0_{name[len('blk_'):]}"]
            out[name] = None if d is None else d + 1
        else:
            out[name] = flat[name]
    return out


def pipeline_expert_leaves(spec: TransformerSpec) -> list:
    """The stacked expert leaves (dim 1 the expert); none for the dense
    FFN."""
    return [f"blk_{x}" for x in _EXPERT_LEAVES] if spec.num_experts else []


def _check_pipeline(spec: TransformerSpec, b: int, p: int, v: int,
                    m_cnt: int) -> None:
    """JAX's ``apply_pipeline`` checks, its messages."""
    if b % m_cnt:
        raise ValueError(
            f"local batch {b} must divide into microbatches={m_cnt}")
    if v < 1:
        raise ValueError(f"virtual={v} must be >= 1")
    if v > 1 and p < 2:
        raise ValueError(
            f"virtual={v} needs n_stages >= 2 (nothing to interleave "
            f"on one stage)")
    if v > 1 and m_cnt % p:
        raise ValueError(
            f"interleaved stages need microbatches ({m_cnt}) divisible "
            f"by n_stages ({p})")
    if spec.num_blocks % (p * v):
        raise ValueError(
            f"num_blocks={spec.num_blocks} must divide over "
            f"n_stages*virtual={p * v}")


class _Pipe:
    """What both schedules share on one rank: the stage's chunks of
    blocks, the slot (embed-or-consume, the chunk's blocks), the head,
    the live pairs of each hop and the hop itself.  ``params`` are this
    rank's leaves (``blk_*`` its stage's ``[K / p, ...]`` slice)."""

    def __init__(self, spec, params, x, stage_axis, n_stages, m_cnt,
                 virtual, model_axis, seq_axis, expert_axis, head_fn,
                 head_width, dropout_rng, aux_stats, need_grad):
        from ..parallel.step import microbatch_rng

        p, v = n_stages, virtual
        b = x.shape[0]
        _check_pipeline(spec, b, p, v, m_cnt)
        self.spec, self.p, self.v, self.m_cnt = spec, p, v, m_cnt
        self.axis = stage_axis
        self.sidx = stage_axis.index if stage_axis is not None else 0
        self.mb = b // m_cnt
        self.kc = spec.num_blocks // (p * v)
        self.model_axis, self.seq_axis = model_axis, seq_axis
        self.expert_axis = expert_axis
        self.aux_stats = aux_stats
        self.rng = lambda m: microbatch_rng(dropout_rng, m)
        self.act = _ACTIVATIONS[spec.activation]
        s = spec.seq_len // (seq_axis.size if seq_axis is not None else 1)
        self.s = s
        self.hshape = (self.mb, s, spec.d_model)
        self.device = x.device
        # this rank's leaves, cut off the caller's graph: each slot's
        # backward runs against them (autograd.grad), and the blocks one
        # leaf a block, so a slot's gradient covers its chunk's blocks
        self.prm = {k: t.detach().requires_grad_(need_grad)
                    for k, t in params.items() if not k.startswith("blk_")}
        stacked = {k[len("blk_"):]: t for k, t in params.items()
                   if k.startswith("blk_")}
        k_local = next(iter(stacked.values())).shape[0]
        self.blocks = [{n: t[j].detach().requires_grad_(need_grad)
                        for n, t in stacked.items()} for j in range(k_local)]
        if spec.objective == "lm":
            self.micro = tokenize(spec, x).reshape(m_cnt, self.mb, s)
        else:
            self.micro = x.reshape(m_cnt, self.mb, s, spec.d_feature)
        if head_fn is None:
            head_width = spec.num_classes

            def head_fn(prm, h, m):
                return _classify_head(spec, prm, h, seq_axis)
        elif head_width is None:
            raise ValueError("custom head_fn needs an explicit head_width")
        self.head_fn, self.head_width = head_fn, head_width
        self.transport = (stage_hop_transport(stage_axis, x.device)
                          if stage_axis is not None and p > 1 else None)

    def enters(self, c: int) -> bool:
        """Whether a slot of chunk ``c`` embeds its microbatch."""
        return self.sidx == 0 and c == 0

    def head_slot(self, c: int) -> bool:
        return self.sidx == self.p - 1 and c == self.v - 1

    def embed(self, m: int):
        spec, prm = self.spec, self.prm
        pos = _f32(prm["pos"])
        if self.seq_axis is not None:
            pos = pos[self.seq_axis.index * self.s:
                      (self.seq_axis.index + 1) * self.s]
        if spec.objective == "lm":
            h = _f32(prm["W_emb"])[self.micro[m]] + pos[None]
        else:
            h = _mm(prm, self.micro[m].to(spec.compute_dtype), "W_in",
                    "b_in", spec.compute_dtype) + pos[None]
        return _dropout(h, spec, self.rng(m), 0x9999)

    def chunk_blocks(self, c: int) -> list:
        return self.blocks[c * self.kc:(c + 1) * self.kc]

    def slot(self, h_in, c: int, m: int):
        """One (stage, chunk, microbatch) unit: ``h_in`` (None: embed
        microbatch ``m``) through chunk ``c``'s blocks, the dropout and
        MoE salts ``base + i`` by stacked position (JAX's
        ``_chunk_select``).  Returns ``(h_out, stats)``, stats the
        chunk's ``[K / (p v), 2, E]`` balance statistics (None when not
        asked for)."""
        h = self.embed(m) if h_in is None else h_in
        base = self.sidx * (self.spec.num_blocks // self.p) + c * self.kc
        rng_m, stats = self.rng(m), []
        for i, bp in enumerate(self.chunk_blocks(c)):
            h, aux = _block_forward(
                self.spec, bp, h, self.act, self.spec.compute_dtype,
                dropout_rng=rng_m, block=base + i,
                model_axis=self.model_axis, seq_axis=self.seq_axis,
                expert_axis=self.expert_axis, aux_stats=self.aux_stats)
            stats.append(aux)
        return h, (torch.stack(stats) if self.aux_stats else None)

    def inputs(self, h_in, c: int) -> list:
        """The leaves a slot's backward differentiates: its input (when it
        did not embed), its chunk's blocks and the non-block leaves."""
        leaves = [] if h_in is None else [h_in]
        for bp in self.chunk_blocks(c):
            leaves.extend(bp.values())
        return leaves + list(self.prm.values())

    def accumulate(self, acc: dict, grads, h_in, c: int):
        """Add one slot's parameter gradients into the f32 accumulators
        ``acc`` (keyed by the leaf's id); returns the input's gradient
        (None for an embedding slot)."""
        grads = list(grads)
        dh = None if h_in is None else grads.pop(0)
        leaves = self.inputs(None, c)
        for leaf, g in zip(leaves, grads):
            if g is None:
                continue
            key = id(leaf)
            g = g.to(torch.float32)
            acc[key] = g if key not in acc else acc[key] + g
        return dh

    def grads_out(self, acc: dict, params: Params) -> Params:
        """The accumulated gradients in ``params``' layout and dtypes
        (zeros for a leaf no slot of this rank reached)."""
        out = {}
        for k, t in params.items():
            if k.startswith("blk_"):
                n = k[len("blk_"):]
                rows = [acc.get(id(bp[n])) for bp in self.blocks]
                g = torch.stack([r if r is not None else torch.zeros(
                    bp[n].shape, dtype=torch.float32, device=t.device)
                    for r, bp in zip(rows, self.blocks)])
            else:
                g = acc.get(id(self.prm[k]))
                if g is None:
                    g = torch.zeros(t.shape, dtype=torch.float32,
                                    device=t.device)
            out[k] = g.to(t.dtype)
        return out

    def hop(self, send, receive: bool, reverse: bool = False):
        """Post one hop over the stage axis (``parallel/mesh.
        stage_hop_start``): ``send`` to the next stage (previous under
        ``reverse``) and, with ``receive``, a ``[mb, S, D]`` f32 buffer
        from the other side, in the ``pp_comm`` scope."""
        like = (torch.empty(self.hshape, dtype=torch.float32,
                            device=self.device) if receive else None)
        with tracer_lib.scope("pp_comm"):
            return stage_hop_start(send, like, self.axis, reverse=reverse,
                                   transport=self.transport,
                                   device=self.device)


class _GPipeRun:
    """The GPipe / interleaved schedule on one rank: the forward tick
    loop over the rank's row of ``pp_schedule.gpipe_table`` (live slots
    only), and its explicit transpose, the same ticks in reverse (see
    ``apply_pipeline``)."""

    def __init__(self, pipe: _Pipe, slot_remat: bool, aux_axes):
        self.pipe, self.slot_remat, self.aux_axes = pipe, slot_remat, aux_axes
        self.table = pp_schedule.gpipe_table(pipe.p, pipe.v, pipe.m_cnt)

    def row(self, t: int):
        """This rank's forward sub-slot at tick ``t`` (None: idle)."""
        if not 0 <= t < self.table.ticks or self.table.fwd[t] is None:
            return None
        e = self.table.fwd[t][self.pipe.sidx]
        return e if e.live else None

    def forward(self, need_grad: bool):
        pipe = self.pipe
        p, v, m_cnt, mb = pipe.p, pipe.v, pipe.m_cnt, pipe.mb
        dev = pipe.device
        keep = need_grad and not self.slot_remat
        collected = torch.zeros((m_cnt, mb, pipe.head_width),
                                dtype=torch.float32, device=dev)
        want_aux = pipe.aux_stats
        stats_sum = (torch.zeros((v, pipe.kc, 2, pipe.spec.num_experts),
                                 dtype=torch.float32, device=dev)
                     if want_aux else None)
        self.slots = {}
        pending = None
        for t in range(self.table.ticks):
            recv = pending.wait()[0] if pending is not None else None
            pending = None
            e = self.row(t)
            h_out = None
            if e is not None:
                c, m = e.chunk, e.microbatch
                h_in = None
                if not pipe.enters(c):
                    h_in = recv.requires_grad_(keep)
                with torch.set_grad_enabled(keep):
                    h_out, st = pipe.slot(h_in, c, m)
                    vals = (pipe.head_fn(pipe.prm, h_out, m).to(torch.float32)
                            if pipe.head_slot(c) else None)
                if vals is not None:
                    collected[m] = vals.detach()
                if want_aux:
                    stats_sum[c] += st.detach()
                if keep:
                    self.slots[t] = dict(h_in=h_in, c=c, m=m, h_out=h_out,
                                         st=st, vals=vals)
                elif need_grad:
                    # per-slot remat: the input alone, the slot recomputed
                    self.slots[t] = dict(h_in=h_in, c=c, m=m)
            if p > 1 and t < self.table.ticks - 1:
                send = (h_out.detach() if e is not None
                        and not pipe.head_slot(e.chunk) else None)
                nxt = self.row(t + 1)
                pending = pipe.hop(send, nxt is not None
                                   and not pipe.enters(nxt.chunk))
        out = stage_psum(collected, pipe.axis).reshape(
            m_cnt * mb, pipe.head_width)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        self.stats_leaf = self.aux_graph = None
        if want_aux:
            with torch.set_grad_enabled(need_grad):
                leaf = stats_sum.requires_grad_(need_grad)
                stats = leaf / m_cnt
                f = pmean_tokens(stats[:, :, 0], self.aux_axes, grad=False)
                pr = pmean_tokens(stats[:, :, 1], self.aux_axes)
                local = pipe.spec.num_experts * torch.sum(f * pr)
                aux = stage_psum(local, pipe.axis) / pipe.spec.num_blocks
            self.stats_leaf, self.aux_graph = leaf, aux
            aux = aux.detach()
        return out, aux

    def backward(self, g_out, g_aux, params: Params) -> Params:
        """The transpose of ``forward``: the head's and the balance
        loss's cotangents first, then for t from the last tick down to 0
        on every rank the gradient hop from the next stage, the slot's
        backward, the input's gradient posted to the previous stage."""
        pipe = self.pipe
        p, m_cnt, mb = pipe.p, pipe.m_cnt, pipe.mb
        g_vals = g_out.reshape(m_cnt, mb, pipe.head_width)
        g_stats = None
        if self.aux_graph is not None:
            g_stats = torch.autograd.grad(self.aux_graph, self.stats_leaf,
                                          g_aux)[0]
        acc: dict = {}
        dh = None
        for t in reversed(range(self.table.ticks)):
            g_recv = None
            if p > 1 and t < self.table.ticks - 1:
                e = self.row(t)
                receive = e is not None and not pipe.head_slot(e.chunk)
                g_recv = pipe.hop(dh, receive, reverse=True).wait()[0]
            dh = None
            rec = self.slots.pop(t, None)
            if rec is None:
                continue
            c, m, h_in = rec["c"], rec["m"], rec["h_in"]
            head = pipe.head_slot(c)
            if self.slot_remat:
                with torch.enable_grad():
                    if h_in is not None:
                        h_in = h_in.detach().requires_grad_(True)
                    h_out, st = pipe.slot(h_in, c, m)
                    vals = (pipe.head_fn(pipe.prm, h_out, m).to(
                        torch.float32) if head else None)
            else:
                h_out, st, vals = rec["h_out"], rec["st"], rec["vals"]
            outs = [vals if head else h_out]
            cots = [g_vals[m] if head else g_recv]
            if g_stats is not None:
                outs.append(st)
                cots.append(g_stats[c])
            grads = torch.autograd.grad(outs, pipe.inputs(h_in, c), cots,
                                        allow_unused=True)
            dh = pipe.accumulate(acc, grads, h_in, c)
            if dh is not None:
                dh = dh.detach()
        return pipe.grads_out(acc, params)


class _GPipeFunction(torch.autograd.Function):
    """``apply_pipeline``'s values, with the reverse-tick schedule as
    their backward."""

    @staticmethod
    def forward(ctx, run, names, *leaves):
        need_grad = any(ctx.needs_input_grad[2:])
        out, aux = run.forward(need_grad)
        ctx.run, ctx.names = run, names
        ctx.params = dict(zip(names, leaves))
        return out, aux

    @staticmethod
    def backward(ctx, g_out, g_aux):
        grads = ctx.run.backward(g_out, g_aux, ctx.params)
        ctx.run = ctx.params = None
        return (None, None) + tuple(grads[k] for k in ctx.names)


def apply_pipeline(spec: TransformerSpec, params: Params, x: torch.Tensor,
                   stage_axis, n_stages: int, num_microbatches: int,
                   model_axis=None, virtual: int = 1, head_fn=None,
                   head_width: Optional[int] = None, seq_axis=None,
                   expert_axis=None, with_aux: bool = False, aux_axes=None,
                   dropout_rng=None, slot_remat: bool = False):
    """The pipeline-parallel forward (JAX's ``apply_pipeline``): GPipe at
    ``virtual`` 1, Megatron's interleaved virtual stages at ``virtual`` >
    1, on this rank's stage ``stage_axis.index`` (``parallel/mesh.
    StageAxis``) of ``n_stages``.  ``params`` is the stacked layout
    (``pipeline_stack_params`` at the same ``(n_stages, virtual)``) with
    ``blk_*`` cut to this stage's ``[num_blocks / p, ...]`` slice, read
    as ``[v, num_blocks / (p v), ...]`` chunks.  The local batch splits
    into ``num_microbatches``; the rank runs its row of
    ``pp_schedule.gpipe_table``: at tick t the live slot ``ts = t - s``
    runs chunk ``(ts // p) % v`` of microbatch ``(ts // (p v)) p + ts %
    p``; stage 0 embeds the microbatches entering chunk 0 (embedding
    dropout salt 0x9999 on the microbatch's seed), every other slot
    consumes the activations the previous stage (or the chunk wrap from
    the last stage) handed it one tick earlier (``stage_hop_start``), and
    the last stage's last chunk runs ``head_fn(params, h [mb, S, D], m)
    -> [mb, head_width]`` (default: the pooled classify logits).  Only
    live slots run (JAX's lockstep program computes dead ones on garbage
    and masks them).  The head's values are summed over the stage group
    (``stage_psum``: every stage returns the same ``[B, head_width]``).

    ``with_aux`` also returns the per-block mean MoE balance loss:
    every slot's raw ``[K / (p v), 2, E]`` statistics summed over the
    microbatches, divided by M, averaged over ``aux_axes``, combined
    ``E * sum(f * P)`` per block, summed over the stage group and divided
    by ``num_blocks`` (JAX's).

    Differentiable by autograd, but not by one ``autograd.backward``
    over the tick loop: the engine would order the microbatches'
    branches as it likes, and the hops' and the chunks' collectives
    would run in other orders on other ranks.  The backward is the
    explicit transpose of the loop instead (``_GPipeRun.backward``):
    every live slot keeps its graph (under ``slot_remat``, JAX's
    per-slot ``--remat``, its input alone, the slot recomputed), and for
    t from the last tick down to 0 every rank takes the gradient hop
    from the next stage, back-propagates that slot and posts its input's
    gradient to the previous stage; the parameter gradients of the slots
    are summed in f32.  The non-block leaves' gradients are this stage's
    share (the embedding on stage 0, the head on the last): the step
    sums them over the stage group."""
    pipe = _Pipe(spec, params, x, stage_axis, n_stages, num_microbatches,
                 virtual, model_axis, seq_axis, expert_axis, head_fn,
                 head_width, dropout_rng,
                 bool(with_aux and spec.num_experts),
                 torch.is_grad_enabled() and any(
                     t.requires_grad for t in params.values()))
    run = _GPipeRun(pipe, slot_remat, aux_axes)
    names = sorted(params)
    out, aux = _GPipeFunction.apply(run, names,
                                    *[params[k] for k in names])
    return (out, aux) if with_aux else out


def pipeline_value_and_grad_1f1b(spec: TransformerSpec, params: Params,
                                 x: torch.Tensor, stage_axis, n_stages: int,
                                 num_microbatches: int, loss_of,
                                 head_fn=None, head_width=None,
                                 model_axis=None, dropout_rng=None,
                                 virtual: int = 1):
    """The fused 1F1B schedule family (JAX's
    ``pipeline_value_and_grad_1f1b``) at any ``virtual``, read literally
    from this rank's row of ``pp_schedule.interleaved_1f1b_table``:
    warm-up ticks are forward-only and drain ticks backward-only.  A
    forward sub-slot runs without autograd and stashes only its input
    (``stash_cap`` buffers, slot ``unit % cap``; an embedding slot
    stashes nothing and re-embeds); the backward sub-slot re-runs the
    slot under autograd from the stash (the per-microbatch seed is
    recomputed, so the dropout masks are the forward's) and
    back-propagates it: the head unit's output cotangent is 0 and its
    loss cotangent 1, every other unit's the gradient hop's.  The
    activation hop posts after the forward sub-slot and joins after the
    backward; the gradient hop posts after the backward and joins after
    the next tick's forward.  Dead slots run nothing.

    ``loss_of(vals [mb, W], m) -> scalar`` is one microbatch's share of
    the objective (classify: CE / M; lm: nll_sum / (B (S - 1))).
    Returns ``((loss, stats [B, W]), grads)``: the loss and the head's
    values summed over the stage group, and this rank's gradients in f32
    sums, cast to each leaf's dtype (the non-block leaves' this stage's
    share, summed over the stage group by the step, as it sums every
    leaf over its batch group).  Scope DP x PP x TP, as in JAX."""
    pipe = _Pipe(spec, params, x, stage_axis, n_stages, num_microbatches,
                 virtual, model_axis, None, None, head_fn, head_width,
                 dropout_rng, False, True)
    table = pp_schedule.interleaved_1f1b_table(pipe.p, pipe.v, pipe.m_cnt)
    s, cap, ticks = pipe.sidx, table.stash_cap, table.ticks

    def live(rows, t):
        if not 0 <= t < ticks or rows[t] is None:
            return None
        e = rows[t][s]
        return e if e.live else None

    collected = torch.zeros((pipe.m_cnt, pipe.mb, pipe.head_width),
                            dtype=torch.float32, device=pipe.device)
    stash = [None] * cap
    acc: dict = {}
    loss_sum = torch.zeros((), dtype=torch.float32, device=pipe.device)
    pend_f = pend_b = None
    for t in range(ticks):
        recv_f = pend_f.wait()[0] if pend_f is not None else None
        pend_f = None
        ef, h1 = live(table.fwd, t), None
        if ef is not None:
            c, m = ef.chunk, ef.microbatch
            h_in = None if pipe.enters(c) else recv_f
            with torch.no_grad():
                h1, _ = pipe.slot(h_in, c, m)
                if pipe.head_slot(c):
                    collected[m] = pipe.head_fn(pipe.prm, h1, m).to(
                        torch.float32)
            stash[ef.unit % cap] = h_in
        if (table.fwd[t] is not None and t + 1 < ticks
                and table.fwd[t + 1] is not None and pipe.p > 1):
            nxt = live(table.fwd, t + 1)
            pend_f = pipe.hop(
                h1 if ef is not None and not pipe.head_slot(ef.chunk)
                else None, nxt is not None and not pipe.enters(nxt.chunk))
        recv_b = pend_b.wait()[0] if pend_b is not None else None
        pend_b = None
        eb, dh = live(table.bwd, t), None
        if eb is not None:
            c, m = eb.chunk, eb.microbatch
            h_saved = stash[eb.unit % cap]
            stash[eb.unit % cap] = None
            with torch.enable_grad():
                h_in = (None if h_saved is None
                        else h_saved.detach().requires_grad_(True))
                h_out, _ = pipe.slot(h_in, c, m)
                if pipe.head_slot(c):
                    vals = pipe.head_fn(pipe.prm, h_out, m).to(torch.float32)
                    lc = loss_of(vals, m)
                    grads = torch.autograd.grad(lc, pipe.inputs(h_in, c),
                                                allow_unused=True)
                    loss_sum = loss_sum + lc.detach()
                else:
                    grads = torch.autograd.grad(h_out, pipe.inputs(h_in, c),
                                                recv_b, allow_unused=True)
            dh = pipe.accumulate(acc, grads, h_in, c)
        if (table.bwd[t] is not None and t + 1 < ticks
                and table.bwd[t + 1] is not None and pipe.p > 1):
            nxt = live(table.bwd, t + 1)
            pend_b = pipe.hop(dh, nxt is not None
                              and not pipe.head_slot(nxt.chunk),
                              reverse=True)
    stats = stage_psum(collected, pipe.axis).reshape(
        pipe.m_cnt * pipe.mb, pipe.head_width)
    loss = stage_psum(loss_sum, pipe.axis)
    return (loss, stats), pipe.grads_out(acc, params)


def init_decode_cache(spec: TransformerSpec, batch: int,
                      heads: Optional[int] = None,
                      device: DeviceLike = None) -> Params:
    """Per-block contiguous KV cache ``{k{i}/v{i}: [B, S, H, Dh]}`` in
    the compute dtype, preallocated at the full sequence length."""
    dev = resolve_device(device)
    shape = (batch, spec.seq_len, heads or spec.n_heads, spec.d_head)
    cache: Params = {}
    for i in range(spec.num_blocks):
        cache[f"k{i}"] = torch.zeros(shape, dtype=spec.compute_dtype,
                                     device=dev)
        cache[f"v{i}"] = torch.zeros(shape, dtype=spec.compute_dtype,
                                     device=dev)
    return cache


class _DenseKV:
    """KV adapter for the contiguous ``[B, S, H, Dh]`` cache at one
    scalar decode position: writes row ``pos`` in place and returns
    the whole cache as the attention operands."""

    def __init__(self, spec: TransformerSpec, cache: Params, pos: int):
        self.cache = cache
        self.pos = int(pos)
        dev = cache["k0"].device
        self.valid = (torch.arange(spec.seq_len, device=dev)
                      <= self.pos)[None, None]

    def update(self, i: int, kk, vv):
        ck, cv = self.cache[f"k{i}"], self.cache[f"v{i}"]
        ck[:, self.pos] = kk
        cv[:, self.pos] = vv
        return ck, cv, self.valid


def _decode_forward(spec: TransformerSpec, params: Params, token, pos, kv,
                    model_axis=None):
    """The one KV-cached decode forward, shared by the contiguous
    ``decode_step`` and the paged ``serving.kv_cache.paged_decode_step``.
    ``token`` [B] long; ``pos`` an int (contiguous) or [B] (paged);
    ``kv.update(i, k, v) -> (keys, values, mask)``.  Returns f32
    logits [B, V].  A MoE spec decodes by exact dense dispatch whatever
    ``spec.moe_dispatch`` says, as in the JAX package: training's
    capacity pool spans the whole [B, S] token population, which a
    step at one position per sequence cannot reproduce.  Under
    ``model_axis`` (TP decode) each rank attends with its heads over
    its cache and sums after ``Wo`` and ``W2``."""
    if spec.objective != "lm":
        raise ValueError("decode serves the lm objective only")
    if spec.moe_dispatch != "dense":
        spec = dataclasses.replace(spec, moe_dispatch="dense")
    cdt = spec.compute_dtype
    b = token.shape[0]
    dh = spec.d_head
    h = _f32(params["W_emb"])[token] + _f32(params["pos"])[pos]   # [B, D]
    act = _ACTIVATIONS[spec.activation]
    sqrt_dh = torch.sqrt(torch.tensor(float(dh), dtype=torch.float32,
                                      device=h.device))
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=h.device)
    for i in range(spec.num_blocks):
        bp = _block_params(params, i)
        hn = bp["Wqkv"].shape[-1] // dh
        a = _ln(spec, h, bp["ln1_g"], bp["ln1_b"])
        qkv = torch.einsum("bd,dte->bte", _f32(a.to(cdt)),
                           _f32(bp["Wqkv"].to(cdt))) + _f32(bp["bqkv"])
        q, kk, vv = (qkv[:, t].to(cdt).reshape(b, hn, dh)
                     for t in range(3))
        ck, cv, valid = kv.update(i, kk, vv)
        # the score product in the cache dtype, cast after, divided by
        # sqrt(dh) in f32 (the decode path divides where the dense
        # attention multiplies by 1/sqrt(d): both kept as in JAX)
        scores = torch.einsum("bhe,bshe->bhs", q, ck).to(torch.float32) \
            / sqrt_dh
        scores = torch.where(valid, scores, neg)
        probs = softmax(scores, dim=-1)
        att = torch.einsum("bhs,bshe->bhe", probs.to(cv.dtype),
                           cv).reshape(b, hn * dh)
        h = h + _row_psum(att.to(cdt), bp["Wo"], bp["bo"], cdt, model_axis)
        h = _ffn_block(spec, bp, h[:, None], act, cdt,
                       model_axis=model_axis)[0][:, 0]
    hf = _ln(spec, h, params["lnf_g"], params["lnf_b"])
    return _f32(_mm(params, hf, "W_head", "b_head", cdt))


@torch.no_grad()
def decode_step(spec: TransformerSpec, params: Params, cache: Params,
                token: torch.Tensor, pos: int, model_axis=None):
    """One KV-cached decode step at scalar position ``pos``: returns
    (logits [B, V], cache).  The cache is updated in place (the JAX
    version returns an updated copy unless its buffers are donated).
    ``model_axis``: TP decode over this rank's heads and cache."""
    kv = _DenseKV(spec, cache, pos)
    return (_decode_forward(spec, params, token.long(), pos, kv,
                            model_axis=model_axis), kv.cache)


@torch.no_grad()
def generate(spec: TransformerSpec, params: Params, prompt: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             temperature: float = 1.0, model_axis=None) -> torch.Tensor:
    """Complete ``prompt`` [B, P] int tokens to the full ``seq_len``
    with KV-cached decoding (prompt positions teacher-forced).
    ``generator=None`` or ``temperature <= 0`` decodes greedily;
    otherwise samples at ``temperature`` (Gumbel-max with noise from
    ``generator``).  Returns [B, seq_len] tokens on the prompt's
    device.  ``model_axis``: TP decode (see ``generate_sharded``)."""
    b, p = prompt.shape
    s = spec.seq_len
    dev = prompt.device
    cache = init_decode_cache(spec, b, heads=params["L0_Wqkv"].shape[-1]
                              // spec.d_head, device=dev)
    tokens = torch.zeros((b, s), dtype=torch.long, device=dev)
    tokens[:, :p] = prompt.long()
    greedy = generator is None or temperature <= 0
    for pos in range(s - 1):
        logits, cache = decode_step(spec, params, cache, tokens[:, pos], pos,
                                    model_axis=model_axis)
        if greedy:
            nxt = torch.argmax(logits, dim=-1)
        else:
            nxt = _gumbel_argmax(logits / float(temperature), generator)
        if pos + 1 >= p:
            tokens[:, pos + 1] = nxt
    return tokens


def generate_sharded(spec: TransformerSpec, params: Params,
                     prompt: torch.Tensor, model_axis,
                     generator: Optional[torch.Generator] = None,
                     temperature: float = 1.0) -> torch.Tensor:
    """``generate`` tensor-parallel over the model group ``model_axis``
    (JAX's ``generate_sharded``): ``params`` stay this rank's Megatron
    shards, each rank decodes its heads with its own KV cache, and the
    row-split sums make the logits identical on every rank; every rank
    draws with a generator seeded alike, so the returned [B, seq_len]
    tokens are identical everywhere."""
    return generate(spec, params, prompt, generator=generator,
                    temperature=temperature, model_axis=model_axis)


def generate_dp(spec: TransformerSpec, params: Params,
                prompts: torch.Tensor, mesh, model_axis=None,
                generator_seed: Optional[int] = None,
                temperature: float = 1.0) -> tuple:
    """``generate`` sharded over the data axis of ``mesh``
    (``parallel/mesh.Mesh``; JAX's ``generate_dp``): the ``n`` prompts
    are padded with copies of row 0 up to a multiple of ``mesh.dp``, and
    this rank decodes the rows of its data index, so the ranks that
    share a data index (its stage, seq, expert and model ranks) decode
    the same rows, as JAX's devices along those axes hold the same
    ``P('data')`` shard.  ``params`` are whole (callers gather FSDP's
    shards, the stages and the experts first); with ``model_axis`` they
    are this rank's Megatron shards and each data shard decodes
    tensor-parallel (``generate_sharded``).  Greedy unless
    ``generator_seed`` is given and ``temperature`` > 0; then each data
    index draws from a ``torch.Generator`` seeded by the seed folded
    with its index (``parallel/step._fold``, the port's form of JAX's
    ``fold_in(key, axis_index('data'))``; other bits).

    Returns ``(tokens, n)``: where JAX returns the padded, data-sharded
    global array, this returns this rank's ``[n_pad / dp, seq_len]``
    rows of it; ``dp_samples_host`` gathers them and drops the pad."""
    from ..parallel.step import _fold

    n = int(prompts.shape[0])
    pad = (-n) % mesh.dp
    if pad:
        prompts = torch.cat([prompts, prompts[:1].expand(pad, -1)])
    rows = prompts.shape[0] // mesh.dp
    index = mesh.data_index
    gen = None
    if generator_seed is not None and temperature > 0:
        gen = torch.Generator(device=prompts.device).manual_seed(
            _fold(generator_seed, index))
    return generate(spec, params, prompts[index * rows:(index + 1) * rows],
                    generator=gen, temperature=temperature,
                    model_axis=model_axis), n


# bytes dp_samples_host posted (the gathered int32 rows, n_pad *
# seq_len * 4 a call at dp > 1), read and zeroed by the code that
# measures a run
DP_SAMPLE_BYTES = {"all_gather": 0}


def dp_samples_host(tokens: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """The first ``n`` rows of ``generate_dp``'s padded batch on every
    rank (JAX's ``dp_samples_host``): one all-gather of this rank's
    int32 rows over the data group, in data-index order, then ``[:n]``;
    at dp 1 no collective."""
    from .. import cluster

    tokens = tokens.to(torch.int32).contiguous()
    if mesh.dp > 1:
        out = tokens.new_empty((mesh.dp * tokens.shape[0],
                                tokens.shape[1]))
        cluster.all_gather_flat(out.view(-1), tokens.view(-1),
                                group=mesh.data_group)
        DP_SAMPLE_BYTES["all_gather"] += out.numel() * out.element_size()
        tokens = out
    return tokens[:int(n)]


def _gumbel_argmax(logits: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """A categorical draw per row by the Gumbel-max trick (the method
    ``jax.random.categorical`` uses; the bits differ)."""
    u = torch.rand(logits.shape, generator=generator,
                   device=logits.device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


__all__ = ["TransformerSpec", "param_shapes", "check_tp", "param_pspecs",
           "init", "tokenize", "apply", "num_params", "flops_per_step",
           "pipeline_stack_params", "pipeline_unstack_params",
           "pipeline_train_state", "pipeline_param_shapes",
           "pipeline_param_pspecs", "pipeline_expert_leaves",
           "apply_pipeline", "pipeline_value_and_grad_1f1b",
           "init_decode_cache", "decode_step", "generate",
           "generate_sharded", "generate_dp", "dp_samples_host",
           "DP_SAMPLE_BYTES"]

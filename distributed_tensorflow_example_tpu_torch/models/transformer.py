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
``_DenseKV``, ``_decode_forward``, ``decode_step``, ``generate``).

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
grouped FFN on ``[El, ep * C, d]`` and sends the rows back.  Not ported
yet (ROADMAP.md): pipeline parallelism.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..ops.ring_attention import NEG_INF, attention, softmax
from ..parallel.mesh import (expert_all_to_all, expert_copy, expert_psum,
                             model_copy, model_psum, pmean_seq,
                             pmean_tokens)
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
    the reference otherwise."""
    if spec.fused_ln:
        from ..ops.fused import fused_layer_norm

        return fused_layer_norm(x, g, b)
    return _layer_norm(x, g, b)


def _ln_residual(spec: TransformerSpec, h, branch, g, b):
    """``s = h + branch; return (LN(s), s)`` — one kernel pass under
    ``spec.fused_ln``."""
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
             expert_axis=None):
    """Top-k MoE FFN by dense dispatch: every expert on every token, the
    gate-weighted one-hot selection combines them (exact: no capacity,
    nothing dropped).  ``a`` [B, S, d] -> ``(out f32, aux)``.  Under
    ``expert_axis`` the rank runs its ``El`` experts only, on the
    selection's columns ``[index * El, (index + 1) * El)``, and the
    partial outputs are summed over the axis; ``a`` and the selection
    enter its experts through ``expert_copy`` (each rank's gradient
    covers its experts only), the balance loss reads ``probs`` beside
    it."""
    e = spec.num_experts
    probs = softmax(_cast_mm(a, bp["Wr"], cdt), dim=-1)     # [B, S, E]
    gates, idx = _route_topk(spec, probs)                   # [B, S, k]
    sel = torch.sum(torch.nn.functional.one_hot(idx, e).to(torch.float32)
                    * gates[..., None], dim=-2)             # [B, S, E]
    el = bp["We1"].shape[0]
    if expert_axis is not None:
        off = expert_axis.index * el
        sel = expert_copy(sel, expert_axis)[..., off:off + el]
        a = expert_copy(a, expert_axis)
    b, s, _ = a.shape
    h1 = _cast_mm(a, bp["We1"].permute(1, 0, 2), cdt) \
        + _f32(bp["be1"])                                   # [B, S, El, ff]
    h1 = act(h1).to(cdt)
    h2 = dot_f32(h1.reshape(b * s, el, -1).transpose(0, 1), bp["We2"], cdt)
    h2 = h2.transpose(0, 1).reshape(b, s, el, -1) + _f32(bp["be2"])
    out = expert_psum(torch.einsum("bsed,bse->bsd", h2, sel), expert_axis)
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
                    aux_axes=None, expert_axis=None):
    """Capacity-limited top-k MoE FFN (Switch/GShard): ``_sparse_route``
    -> ``_grouped_expert_ffn`` -> ``_sparse_combine``; dropped units add
    nothing and the residual carries their tokens.  ``a`` [B, S, d] ->
    ``(out f32, aux)``; with ``capacity_factor >= E`` nothing drops and
    it equals ``_moe_ffn`` up to the order of f32 sums.  Under
    ``expert_axis`` (with ``El < E`` experts here) the f32 buffers go to
    their experts' ranks and back (``expert_all_to_all``), and the
    grouped FFN runs on ``[El, ep * C, d]``; the capacity ``C`` is this
    shard's."""
    b, s, d = a.shape
    buf, slot, gates, keep, probs, idx = _sparse_route(
        spec, a.reshape(b * s, d), bp["Wr"], cdt)
    exchange = (expert_axis is not None
                and bp["We1"].shape[0] != spec.num_experts)
    if exchange:
        buf = expert_all_to_all(buf, expert_axis)
    h2 = _grouped_expert_ffn(spec, buf, bp["We1"], bp["be1"], bp["We2"],
                             bp["be2"], act, cdt)
    if exchange:
        h2 = expert_all_to_all(h2, expert_axis, reverse=True)
    out = _sparse_combine(h2, slot, gates, keep)
    return out.reshape(b, s, d), _load_balance_loss(spec, probs, idx[:, 0],
                                                    aux_axes)


def _block_forward(spec: TransformerSpec, bp: Params, h, act, cdt,
                   kv_out: Optional[list] = None, dropout_rng=None,
                   block: int = 0, model_axis=None, seq_axis=None,
                   aux_axes=None, expert_axis=None):
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
    loss, ``expert_axis`` the MoE FFN."""
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
                      expert_axis=expert_axis)


def _ffn_block(spec: TransformerSpec, bp: Params, h, act, cdt, a=None,
               dropout_rng=None, block: int = 0, model_axis=None,
               aux_axes=None, expert_axis=None):
    """The LN2 + FFN residual half of a block (dense, fp8 or MoE),
    shared by the training forward, the prefill and the decode step.
    ``h`` [B, S, D] -> ``(h, aux)``; ``a`` is the ln2 output when the
    caller already has it.  Under ``model_axis`` the dense FFN is
    column-split (``W1``) then row-split (``W2``, psummed); the MoE
    FFN's experts are not split over it (over ``expert_axis`` under
    expert parallelism); fp8 raises (JAX's guard)."""
    if a is None:
        a = _ln(spec, h, bp["ln2_g"], bp["ln2_b"])
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if spec.num_experts:
        if spec.moe_dispatch == "alltoall":
            moe = _moe_ffn_sparse
        elif spec.moe_dispatch == "dense":
            moe = _moe_ffn
        else:
            raise ValueError(
                f"unknown moe_dispatch {spec.moe_dispatch!r}: expected "
                f"'dense' or 'alltoall'")
        ffn, aux = moe(spec, bp, a, act, cdt, aux_axes, expert_axis)
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
    h = _ln(spec, h, params["lnf_g"], params["lnf_b"])
    head = params
    if spec.objective != "lm":
        h = torch.mean(h, dim=1)                 # [B, D]
        if seq_axis is not None:
            # the global token mean (backward: JAX's transpose, g / n);
            # the head then runs on a value replicated over the axis,
            # where JAX sums its gradient over 'data' only: the step
            # sums every gradient over data x seq, so its local
            # gradient counts 1 / n
            h = pmean_seq(h, seq_axis)
            head = {k: _ScaleGrad.apply(params[k], 1.0 / seq_axis.size)
                    for k in ("W_head", "b_head")}
    logits = _f32(_mm(head, h, "W_head", "b_head", cdt))
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
           "init_decode_cache", "decode_step", "generate",
           "generate_sharded"]

"""ZeRO-3 / FSDP: params and optimizer slots sharded 1/dp over the data
axis (the JAX package's ``parallel/fsdp.py``), composed with tensor
parallelism.

Layout: every float leaf of the train state with at least one dimension
(params and optimizer slots) is flattened, zero-padded to a multiple of
``dp`` and viewed as ``[dp, chunk]``; the rank at data index d holds
row d, a ``[chunk]`` tensor.  Integer leaves (the step, Adam's count)
stay replicated.

The step, on this rank's rows of the global batch:

1. all-gather the param shards into the full params (transient);
2. the local forward and backward (either family: the MLP, with B1
   under ``--pallas``, or ``models/transformer.apply``, flash included);
3. reduce-scatter the gradients: this rank gets its summed ``[chunk]``;
4. the optimizer on this rank's shard only.

The per-step collective bytes equal sync DP's one all-reduce (an
all-reduce is a reduce-scatter and an all-gather).  The optimizers are
elementwise, so each shard's update is the full update restricted to
it; the zero padding stays zero.  ``build_gather_params`` rebuilds the
full params for eval, sampling and checkpoints.

FSDP x TP (``model_parallel`` > 1, JAX's 2-D recipe): each leaf is
first Megatron-split over the model axis (``parallel/mesh.param_pspecs``),
then each model shard is flattened to ``[dp, chunk]``: the global layout
is ``[mp, dp, chunk]`` and the rank at (data d, model m) holds row
``[m, d]``.  The leaves replicated over the model axis are stored once
a model shard (duplicated content), as JAX stores them.  The step's
data-group all-gather rebuilds the TP-local params, the forward runs the
Megatron sums over the model group, the gradients are reduce-scattered
over the data group, and no gradient collective runs over the model
axis: a split leaf's gradient is local by construction, and a
replicated leaf sees replicated activations, so every model rank
computes the same one.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .. import cluster
from ..config import EP_COMPOSES_ONLY, SP_COMPOSES_ONLY
from ..train.state import TrainState
from ..utils.checkpoint import map_state
from . import mesh as mesh_lib
from . import step as step_lib


def is_sharded_leaf(a) -> bool:
    """Float leaves with a dimension are sharded; integer counters and
    scalars stay replicated."""
    return (isinstance(a, torch.Tensor) and a.dim() >= 1
            and a.dtype.is_floating_point)


def _flat_chunks(a: torch.Tensor, dp: int) -> torch.Tensor:
    flat = a.reshape(-1)
    chunk = -(-flat.numel() // dp)
    pad = chunk * dp - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(dp, chunk)


def shard_state_host(state: TrainState, dp: int, mp: int = 1,
                     tp_dims=None) -> TrainState:
    """Every sharded leaf flattened, zero-padded and viewed as
    ``[dp, chunk]`` (JAX's global layout), or under FSDP x TP split into
    its ``mp`` model shards along ``tp_dims(key)`` (the leaves it
    returns None for duplicated) and stacked ``[mp, dp, chunk]``; other
    leaves unchanged."""
    def conv(key, a):
        if not is_sharded_leaf(a):
            return a
        if mp <= 1:
            return _flat_chunks(a, dp)
        d = tp_dims(key)
        shards = a.chunk(mp, dim=d) if d is not None else [a] * mp
        return torch.stack([_flat_chunks(t, dp) for t in shards])

    return map_state(conv, state)


def unshard_state_host(state: TrainState, template: TrainState,
                       mp: int = 1, tp_dims=None) -> TrainState:
    """The inverse of ``shard_state_host`` (``[dp, chunk]`` or ``[mp, dp,
    chunk]`` leaves back to ``template``'s shapes; the checkpoints'
    portable layout)."""
    from ..utils.checkpoint import flatten_state

    shapes = flatten_state(template)

    def conv(key, s):
        t = shapes[key]
        if not is_sharded_leaf(t):
            return s
        return unshard_leaf(s, t, mp, tp_dims(key) if mp > 1 else None)

    return map_state(conv, state)


def unshard_leaf(s: torch.Tensor, t, mp: int = 1,
                 dim: Optional[int] = None) -> torch.Tensor:
    """One leaf's ``[dp, chunk]`` (or ``[mp, dp, chunk]``) global layout
    back to the full shape of ``t``; ``dim`` the dim its model shards
    split (None: replicated over the model axis, shard 0 read)."""
    if mp <= 1:
        return s.reshape(-1)[:t.numel()].reshape(t.shape)
    if dim is None:
        return s[0].reshape(-1)[:t.numel()].reshape(t.shape)
    shard = list(t.shape)
    shard[dim] //= mp
    size = math.prod(shard)
    return torch.cat([s[i].reshape(-1)[:size].reshape(shard)
                      for i in range(mp)], dim=dim)


def local_rows(state: TrainState, rank: int, model_index: int = 0,
               mp: int = 1) -> TrainState:
    """The block of every sharded leaf this rank holds: row ``rank``
    (its data index) of ``[dp, chunk]``, or row ``[model_index, rank]``
    of ``[mp, dp, chunk]``."""
    def row(a):
        if not is_sharded_leaf(a):
            return a
        return (a[model_index, rank] if mp > 1 else a[rank]).clone()

    return map_state(lambda _k, a: row(a), state)


def _gather_full(shard: torch.Tensor, shape, group=None,
                 n: int = 1) -> torch.Tensor:
    """This rank's ``[chunk]`` -> the (TP-local) leaf, one all-gather
    over the data ``group`` of ``n`` ranks (none without a group)."""
    if group is not None:
        flat = shard.new_empty(n * shard.numel())
        cluster.all_gather_flat(flat, shard, group=group)
    else:
        flat = shard
    return flat[:math.prod(shape)].reshape(shape)


def _scatter_grad(g: torch.Tensor, chunk: int, dp: int,
                  group=None) -> torch.Tensor:
    """The full gradient -> this rank's summed ``[chunk]``, one
    reduce-scatter over the data ``group``."""
    flat = g.reshape(-1)
    pad = chunk * dp - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    if group is None:
        return flat
    out = flat.new_empty(chunk)
    cluster.reduce_scatter_flat(out, flat.contiguous(), group=group)
    return out


def shape_template(state: TrainState) -> TrainState:
    """``state``'s shapes and dtypes as meta tensors (no storage): the
    full template the sharded state is gathered and unsharded into."""
    def meta(a):
        if isinstance(a, torch.Tensor):
            return torch.empty(a.shape, dtype=a.dtype, device="meta")
        return a

    return map_state(lambda _k, a: meta(a), state)


def full_shapes(full_template: TrainState) -> dict:
    return {k: tuple(v.shape) for k, v in full_template.params.items()}


def tp_local_shapes(full_template: TrainState, param_dims: dict,
                    mp: int) -> dict:
    """``{param: its TP-local shape}``: the full shape with the dim
    split over the model axis divided by ``mp``."""
    out = {}
    for k, shape in full_shapes(full_template).items():
        shape = list(shape)
        if mp > 1 and param_dims.get(k) is not None:
            shape[param_dims[k]] //= mp
        out[k] = tuple(shape)
    return out


def make_fsdp_step_body(cfg, spec, dp: int, optimizer,
                        full_template: TrainState, mp: int = 1,
                        mesh=None, with_anomaly: bool = False) -> Callable:
    """``(state, x, y, step_index=None) -> (state, cost, acc)`` on this
    rank's shard state and rows: the body the host path and the
    device-resident epoch share.  Under ``mp`` > 1 the gathered params
    are the TP-local shards and the forward runs over the ``mesh``'s
    model group.  Capturable in a CUDA graph (it reads nothing back from
    the card).  ``with_anomaly`` (``--debug_nans``) appends the
    synchronous step's ``{"flag", "counts"}``: the non-finite elements
    of this rank's gradient shards summed over the data group (and the
    model group for the leaves split over it), in ``leaf_names`` order,
    and the flag over them and every rank's loss, the same on every
    rank."""
    mesh = mesh if mesh is not None else mesh_lib.build_mesh(-1)
    if mesh.sp > 1:
        raise ValueError(SP_COMPOSES_ONLY)
    if mesh.ep > 1:
        raise ValueError(EP_COMPOSES_ONLY)
    param_dims = mesh_lib.param_pspecs(spec, mp)
    shapes = tp_local_shapes(full_template, param_dims, mp)
    names = sorted(shapes)
    styles = mesh_lib.layer_styles(spec, mp)
    model_axis = mesh_lib.model_axis(mesh)
    sharded = step_lib.tp_sharded_names(spec, mesh)
    step_rng = step_lib.make_step_rng(cfg, spec, mesh.data_index)
    remat = getattr(cfg, "remat", False)
    group = mesh.data_group

    def body(state: TrainState, x, y, step_index: Optional[int] = None):
        leaves = {k: _gather_full(state.params[k], shapes[k], group, dp)
                  .detach().requires_grad_(True) for k in names}
        objective, (cost, acc) = step_lib._loss_and_acc(
            spec, leaves, x, y, cfg.naive_ce, cfg.pallas,
            cfg.label_smoothing, remat, step_rng(state, step_index),
            styles, model_axis)
        grads_full = torch.autograd.grad(objective,
                                         [leaves[k] for k in names])
        grads = {k: _scatter_grad(g, state.params[k].shape[-1], dp, group)
                 for k, g in zip(names, grads_full)}
        if with_anomaly:
            loss_bad = (~torch.isfinite(cost.detach())).to(torch.int32)
            mesh_lib.world_all_reduce(loss_bad)
            counts = step_lib._leaf_nonfinite(grads, names, sharded, mesh)
            mesh_lib.data_all_reduce(counts, mesh)
            flag = torch.any(counts > 0) | (loss_bad > 0)
        if cfg.grad_reduce == "mean" and dp > 1:
            grads = {k: g / dp for k, g in grads.items()}
        if cfg.grad_clip > 0:
            grads = step_lib.clip_sharded(grads, cfg.grad_clip, sharded,
                                          mesh, over_data=True)
        new_p, new_o = optimizer.update(grads, state.opt_state, state.params)
        cost, acc = step_lib.mean_over_ranks(cost.detach(), acc, mesh)
        out = (TrainState(state.step + 1, new_p, new_o), cost, acc)
        if with_anomaly:
            out += ({"flag": flag, "counts": counts},)
        return out

    return body


def build_gather_params(full_template: TrainState, mesh=None,
                        spec=None) -> Callable:
    """``state -> full params``: one all-gather a leaf over the data
    group, then under FSDP x TP one over the model group along each
    split leaf's dim (eval, sampling, checkpoints)."""
    mesh = mesh if mesh is not None else mesh_lib.build_mesh(-1)
    param_dims = (mesh_lib.param_pspecs(spec, mesh.mp) if mesh.mp > 1
                  else {})
    local = tp_local_shapes(full_template, param_dims, mesh.mp)

    def gather(state: TrainState) -> dict:
        return {k: mesh_lib.gather_leaf(
            _gather_full(v, local[k], mesh.data_group, mesh.dp),
            param_dims.get(k), mesh.model_group, mesh.mp)
            for k, v in state.params.items()}

    return gather


__all__ = ["is_sharded_leaf", "shard_state_host", "unshard_state_host",
           "unshard_leaf", "local_rows", "make_fsdp_step_body",
           "build_gather_params", "shape_template", "full_shapes",
           "tp_local_shapes"]

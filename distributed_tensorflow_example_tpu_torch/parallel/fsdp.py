"""ZeRO-3 / FSDP: params and optimizer slots sharded 1/dp over the data
axis (the JAX package's ``parallel/fsdp.py`` at ``model_parallel`` 1).

Layout: every float leaf of the train state with at least one dimension
(params and optimizer slots) is flattened, zero-padded to a multiple of
``dp`` and viewed as ``[dp, chunk]``; rank r holds row r, a ``[chunk]``
tensor.  Integer leaves (the step, Adam's count) stay replicated.

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

FSDP x TP (``model_parallel`` > 1) is not ported (ROADMAP.md Queue A).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .. import cluster
from ..config import Unported
from ..train.optim import tree_map
from ..train.state import TrainState
from . import step as step_lib


def is_sharded_leaf(a) -> bool:
    """Float leaves with a dimension are sharded; integer counters and
    scalars stay replicated."""
    return (isinstance(a, torch.Tensor) and a.dim() >= 1
            and a.dtype.is_floating_point)


def _check_mp(mp: int) -> None:
    if mp != 1:
        raise Unported(f"--fsdp with model_parallel={mp}: FSDP x TP is not "
                       f"ported to the PyTorch trainer yet (see ROADMAP.md "
                       f"Queue A)")


def _flat_chunks(a: torch.Tensor, dp: int) -> torch.Tensor:
    flat = a.reshape(-1)
    chunk = -(-flat.numel() // dp)
    pad = chunk * dp - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(dp, chunk)


def shard_state_host(state: TrainState, dp: int, mp: int = 1) -> TrainState:
    """Every sharded leaf flattened, zero-padded and viewed as
    ``[dp, chunk]`` (JAX's global layout); other leaves unchanged."""
    _check_mp(mp)

    def conv(a):
        return _flat_chunks(a, dp) if is_sharded_leaf(a) else a

    return TrainState(state.step, tree_map(conv, state.params),
                      tree_map(conv, state.opt_state))


def unshard_state_host(state: TrainState, template: TrainState,
                       mp: int = 1) -> TrainState:
    """The inverse of ``shard_state_host`` (``[dp, chunk]`` leaves back to
    ``template``'s shapes; the checkpoints' portable layout)."""
    _check_mp(mp)

    def conv(s, t):
        if not is_sharded_leaf(t):
            return s
        return s.reshape(-1)[:t.numel()].reshape(t.shape)

    return TrainState(state.step, tree_map(conv, state.params,
                                           template.params),
                      tree_map(conv, state.opt_state, template.opt_state))


def local_rows(state: TrainState, rank: int) -> TrainState:
    """Row ``rank`` of every ``[dp, chunk]`` leaf: the state this rank
    holds."""
    def row(a):
        return a[rank].clone() if is_sharded_leaf(a) else a

    return TrainState(state.step, tree_map(row, state.params),
                      tree_map(row, state.opt_state))


def _gather_full(shard: torch.Tensor, shape) -> torch.Tensor:
    """This rank's ``[chunk]`` -> the full leaf, one all-gather (none
    without a process group: then dp is 1)."""
    if cluster.collectives():
        flat = shard.new_empty(cluster.process_count() * shard.numel())
        cluster.all_gather_flat(flat, shard)
    else:
        flat = shard
    return flat[:math.prod(shape)].reshape(shape)


def _scatter_grad(g: torch.Tensor, chunk: int, dp: int) -> torch.Tensor:
    """The full gradient -> this rank's summed ``[chunk]``, one
    reduce-scatter."""
    flat = g.reshape(-1)
    pad = chunk * dp - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    if not cluster.collectives():
        return flat
    out = flat.new_empty(chunk)
    cluster.reduce_scatter_flat(out, flat.contiguous())
    return out


def shape_template(state: TrainState) -> TrainState:
    """``state``'s shapes and dtypes as meta tensors (no storage): the
    full template the sharded state is gathered and unsharded into."""
    def meta(a):
        if isinstance(a, torch.Tensor):
            return torch.empty(a.shape, dtype=a.dtype, device="meta")
        return a

    return TrainState(meta(state.step), tree_map(meta, state.params),
                      tree_map(meta, state.opt_state))


def full_shapes(full_template: TrainState) -> dict:
    return {k: tuple(v.shape) for k, v in full_template.params.items()}


def make_fsdp_step_body(cfg, spec, dp: int, optimizer,
                        full_template: TrainState, mp: int = 1) -> Callable:
    """``(state, x, y, step_index=None) -> (state, cost, acc)`` on this
    rank's shard state and rows: the body the host path and the
    device-resident epoch share.  Capturable in a CUDA graph (it reads
    nothing back from the card)."""
    _check_mp(mp)
    shapes = full_shapes(full_template)
    names = sorted(shapes)
    step_rng = step_lib.make_step_rng(cfg, spec)
    remat = getattr(cfg, "remat", False)

    def body(state: TrainState, x, y, step_index: Optional[int] = None):
        leaves = {k: _gather_full(state.params[k], shapes[k]).detach()
                  .requires_grad_(True) for k in names}
        objective, (cost, acc) = step_lib._loss_and_acc(
            spec, leaves, x, y, cfg.naive_ce, cfg.pallas,
            cfg.label_smoothing, remat, step_rng(state, step_index))
        grads_full = torch.autograd.grad(objective,
                                         [leaves[k] for k in names])
        grads = {k: _scatter_grad(g, state.params[k].shape[-1], dp)
                 for k, g in zip(names, grads_full)}
        if cfg.grad_reduce == "mean" and dp > 1:
            grads = {k: g / dp for k, g in grads.items()}
        if cfg.grad_clip > 0:
            grads = _clip_sharded(grads, cfg.grad_clip)
        new_p, new_o = optimizer.update(grads, state.opt_state, state.params)
        cost, acc = step_lib.mean_over_ranks(cost.detach(), acc)
        return TrainState(state.step + 1, new_p, new_o), cost, acc

    return body


def _clip_sharded(grads: dict, max_norm: float) -> dict:
    """The global-norm clip over 1/dp gradient shards: each rank's
    square-sum, summed over the ranks, is the full tree's."""
    sq = sum(torch.sum(torch.square(g.to(torch.float32)))
             for g in grads.values())
    if cluster.collectives():
        torch.distributed.all_reduce(sq)
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}


def build_gather_params(full_template: TrainState) -> Callable:
    """``state -> full params``: one all-gather a leaf (eval, sampling,
    checkpoints)."""
    shapes = full_shapes(full_template)

    def gather(state: TrainState) -> dict:
        return {k: _gather_full(v, shapes[k])
                for k, v in state.params.items()}

    return gather


__all__ = ["is_sharded_leaf", "shard_state_host", "unshard_state_host",
           "local_rows", "make_fsdp_step_body", "build_gather_params",
           "shape_template", "full_shapes"]

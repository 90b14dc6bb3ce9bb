"""The synchronous data-parallel train step and the eval step (the data-
parallel subset of the JAX package's ``parallel/step.py``).

One process per device.  Each process runs forward and backward on its
slice of the global batch; the gradients are summed over the processes
with ``torch.distributed.all_reduce`` and, under ``grad_reduce='mean'``,
divided by the process count, so an N-process step at global batch B
computes the one-process batch-B gradient (the JAX package's
psum-equivalence guarantee; the sums run in another order, so equal to
float rounding).  The reported cost and accuracy are averaged over the
processes the same way.

``--pallas`` routes the MLP forward through the fused kernel
(``ops.fused.mlp_forward``) for the activations whose backward it
carries (sigmoid, tanh, relu); any other activation runs the plain
``models.mlp.apply``, as in the JAX package.  Tensor, sequence, expert
and pipeline parallelism, FSDP/ZeRO, local SGD, ``--on_anomaly`` and the
``--histograms`` norms are not ported (ROADMAP.md Queue A).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

from .. import cluster
from ..models import mlp
from ..ops import fused, losses, metrics
from ..train.optim import clip_by_global_norm
from ..train.state import TrainState


def forward_local(spec: mlp.MLPSpec, params, x, use_pallas: bool = False):
    """Logits of the MLP: the fused kernel under ``--pallas`` for the
    activations it supports, else the plain forward."""
    if use_pallas and spec.activation in fused.SUPPORTED_MLP_ACTIVATIONS:
        return fused.mlp_forward(spec, params, x)
    return mlp.apply(spec, params, x)


def _loss_and_acc(spec, params, x, y, naive: bool, use_pallas: bool,
                  label_smoothing: float = 0.0):
    """``(cost, accuracy)`` of the classify objective on one batch."""
    logits = forward_local(spec, params, x, use_pallas)
    cost = losses.cross_entropy(logits, y, naive=naive,
                                label_smoothing=label_smoothing)
    return cost, metrics.accuracy(logits, y)


def make_sync_step_body(cfg, spec: mlp.MLPSpec, optimizer) -> Callable:
    """``(state, x, y) -> (state, cost, acc)`` over this process's slice
    ``x``/``y`` of the global batch: ``grad_accum`` microbatches (the
    mean of their gradients), the all-reduce across processes,
    ``grad_clip``, the optimizer update, ``step + 1``."""
    names = sorted(mlp.param_shapes(spec))

    def grad_of(params, x, y):
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        cost, acc = _loss_and_acc(spec, leaves, x, y, cfg.naive_ce,
                                  cfg.pallas, cfg.label_smoothing)
        grads = torch.autograd.grad(cost, [leaves[k] for k in names])
        return cost.detach(), acc, dict(zip(names, grads))

    def body(state: TrainState, x, y) -> Tuple[TrainState, torch.Tensor,
                                               torch.Tensor]:
        n = cfg.grad_accum
        if n > 1:
            if x.shape[0] % n:
                raise ValueError(
                    f"per-process batch {x.shape[0]} must divide into "
                    f"grad_accum={n} microbatches")
            xs, ys = x.chunk(n), y.chunk(n)
            cost, acc, grads = grad_of(state.params, xs[0], ys[0])
            for xc, yc in zip(xs[1:], ys[1:]):
                c, a, g = grad_of(state.params, xc, yc)
                grads = {k: grads[k] + g[k] for k in names}
                cost, acc = cost + c, acc + a
            grads = {k: g / n for k, g in grads.items()}
            cost, acc = cost / n, acc / n
        else:
            cost, acc, grads = grad_of(state.params, x, y)
        world = cluster.process_count()
        if world > 1:
            for g in grads.values():
                dist.all_reduce(g)
            stats = torch.stack([cost, acc])
            dist.all_reduce(stats)
            cost, acc = stats[0] / world, stats[1] / world
            if cfg.grad_reduce == "mean":
                grads = {k: g / world for k, g in grads.items()}
        if cfg.grad_clip > 0:
            grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
        new_params, new_opt = optimizer.update(grads, state.opt_state,
                                               state.params)
        return TrainState(state.step + 1, new_params, new_opt), cost, acc

    return body


def build_eval_step(cfg, spec: mlp.MLPSpec) -> Callable:
    """``(params, x, y, mask) -> correct-prediction count`` (an f32
    scalar tensor) over one chunk; ``mask`` zeroes the padding rows.
    Every process evaluates the whole set it is given, so no collective
    runs."""

    @torch.no_grad()
    def eval_step(params, x, y, mask):
        logits = forward_local(spec, params, x, cfg.pallas)
        correct = (torch.argmax(logits, -1)
                   == torch.argmax(y, -1)).to(torch.float32)
        return torch.sum(correct * mask)

    return eval_step

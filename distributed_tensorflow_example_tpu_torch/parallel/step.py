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

Two model families: the MLP, whose ``--pallas`` routes the forward
through the fused kernel (``ops.fused.mlp_forward``) for the activations
whose backward it carries (sigmoid, tanh, relu; any other activation
runs the plain ``models.mlp.apply``, as in the JAX package), and the
transformer (``models.transformer.apply``: its kernels are chosen on the
spec, flash attention, the fused LayerNorms and the grouped expert FFN),
with the classify or the lm (next-token) objective, the MoE balance loss
in the objective (``--moe_aux_weight``), per-step dropout masks and
``--remat``.

The step (``make_sync_step_body``) reads nothing back from the card
when it is given the host's step index, so the device-resident epoch
(``parallel/epoch.py``) captures the MLP's in a CUDA graph and runs the
transformer's without a per-step host sync.
Tensor, sequence, expert and pipeline parallelism, FSDP/ZeRO, local SGD,
``--on_anomaly`` and the ``--histograms`` norms are not ported
(ROADMAP.md Queue A).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from .. import cluster
from ..models import mlp
from ..models import transformer as tfm
from ..ops import fused, losses, metrics
from ..train.optim import clip_by_global_norm
from ..train.state import TrainState


def param_shapes(spec) -> dict:
    """``{name: shape}`` of either family's params."""
    if isinstance(spec, tfm.TransformerSpec):
        return tfm.param_shapes(spec)
    return mlp.param_shapes(spec)


def forward_local(spec, params, x, use_pallas: bool = False,
                  dropout_rng: Optional[int] = None, with_aux: bool = False):
    """Logits: the transformer's ``apply`` (its kernels chosen on the
    spec), or the MLP's fused kernel under ``--pallas`` for the
    activations it supports, else the plain MLP forward.  ``with_aux``
    (transformer only) returns ``(logits, the MoE balance loss)``."""
    if isinstance(spec, tfm.TransformerSpec):
        return tfm.apply(spec, params, x, with_aux=with_aux,
                         dropout_rng=dropout_rng)
    if use_pallas and spec.activation in fused.SUPPORTED_MLP_ACTIVATIONS:
        return fused.mlp_forward(spec, params, x)
    return mlp.apply(spec, params, x)


def _lm_stats(spec, logits, tokens):
    """Per-example next-token sums from per-position vocab logits:
    ``(nll_sum [B], correct_sum [B], count [B])`` over the S-1 valid
    positions (position t predicts token t+1; the last position has no
    target)."""
    b = logits.shape[0]
    logp = torch.log_softmax(logits, dim=-1)
    targets = tokens[:, 1:]
    nll = -torch.gather(logp[:, :-1], -1, targets[..., None])[..., 0]
    correct = (torch.argmax(logits[:, :-1], dim=-1) == targets)
    count = torch.full((b,), float(nll.shape[1]), dtype=torch.float32,
                       device=logits.device)
    return (torch.sum(nll, dim=1), torch.sum(correct, dim=1).to(
        torch.float32), count)


def _loss_and_acc(spec, params, x, y, naive: bool, use_pallas: bool,
                  label_smoothing: float = 0.0, remat: bool = False,
                  dropout_rng: Optional[int] = None):
    """``(objective, (cost, accuracy))`` on one batch.  The cost is the
    classify objective's cross entropy, or for the lm objective the mean
    next-token cross entropy (``y`` unused); the objective, which the
    gradients flow from, adds ``aux_loss_weight`` x the MoE balance loss
    to it (the reported cost stays plain CE), as in the JAX package.
    ``remat`` recomputes the whole forward in the backward
    (``torch.utils.checkpoint``, the JAX ``jax.checkpoint`` around the
    forward)."""
    is_tfm = isinstance(spec, tfm.TransformerSpec)
    aux_w = spec.aux_loss_weight if is_tfm else 0.0

    def fwd(p, xx):
        if is_tfm:
            return forward_local(spec, p, xx, use_pallas, dropout_rng,
                                 with_aux=True)
        return forward_local(spec, p, xx, use_pallas, dropout_rng), 0.0

    if remat:
        logits, aux = checkpoint(fwd, params, x, use_reentrant=False)
    else:
        logits, aux = fwd(params, x)
    if getattr(spec, "objective", "classify") == "lm":
        nll, correct, count = _lm_stats(spec, logits, tfm.tokenize(spec, x))
        total = torch.sum(count)
        cost = torch.sum(nll) / total
        return cost + aux_w * aux, (cost, torch.sum(correct) / total)
    cost = losses.cross_entropy(logits, y, naive=naive,
                                label_smoothing=label_smoothing)
    return cost + aux_w * aux, (cost, metrics.accuracy(logits, y))


def make_step_rng(cfg, spec) -> Callable:
    """``(state, step_index) -> the step's dropout seed`` (an int; None
    when the spec does not drop): seed x step, and the process index, so
    every data shard draws its own masks — the counterpart of the JAX
    ``make_step_rng`` (the same stream after a resume; other bits).  The
    step is ``step_index`` when the caller knows it on the host (the
    device-resident epoch does), else ``int(state.step)``, which reads
    the card."""
    dropping = getattr(spec, "dropout_rate", 0.0) > 0

    def step_rng(state: TrainState,
                 step_index: Optional[int] = None) -> Optional[int]:
        if not dropping:
            return None
        step = int(state.step) if step_index is None else step_index
        return (((cfg.seed ^ 0xD0C0) << 40) + (step << 8)
                + cluster.process_index())

    return step_rng


def make_sync_step_body(cfg, spec, optimizer) -> Callable:
    """``(state, x, y, step_index=None) -> (state, cost, acc)`` over this
    process's slice ``x``/``y`` of the global batch: ``grad_accum``
    microbatches (the mean of their gradients), the all-reduce across
    processes, ``grad_clip``, the optimizer update, ``step + 1``.

    The step is capturable in a CUDA graph: it reads nothing back from
    the card, as long as the caller passes ``step_index`` (the value of
    ``state.step``, known on the host) where the spec drops — otherwise
    the dropout seed reads ``state.step`` (``make_step_rng``).  The
    results are the same either way."""
    names = sorted(param_shapes(spec))
    step_rng = make_step_rng(cfg, spec)
    remat = getattr(cfg, "remat", False)

    def grad_of(params, x, y, rng):
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        objective, (cost, acc) = _loss_and_acc(
            spec, leaves, x, y, cfg.naive_ce, cfg.pallas,
            cfg.label_smoothing, remat, rng)
        grads = torch.autograd.grad(objective, [leaves[k] for k in names])
        return cost.detach(), acc, dict(zip(names, grads))

    def body(state: TrainState, x, y, step_index: Optional[int] = None
             ) -> Tuple[TrainState, torch.Tensor, torch.Tensor]:
        rng = step_rng(state, step_index)
        n = cfg.grad_accum
        if n > 1:
            if x.shape[0] % n:
                raise ValueError(
                    f"per-process batch {x.shape[0]} must divide into "
                    f"grad_accum={n} microbatches")
            xs, ys = x.chunk(n), y.chunk(n)
            cost, acc, grads = grad_of(state.params, xs[0], ys[0], rng)
            for xc, yc in zip(xs[1:], ys[1:]):
                c, a, g = grad_of(state.params, xc, yc, rng)
                grads = {k: grads[k] + g[k] for k in names}
                cost, acc = cost + c, acc + a
            grads = {k: g / n for k, g in grads.items()}
            cost, acc = cost / n, acc / n
        else:
            cost, acc, grads = grad_of(state.params, x, y, rng)
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


def eval_chunk_cap(spec, eval_batch_size: int) -> int:
    """Examples per eval chunk: the caller's batch size, capped for
    transformers so one chunk's forward stays within a ~2 GB activation
    budget (the JAX package's estimate, unchanged: per example ~8 f32
    [S, H, max(Dh, 128)] tensors plus the two FFN hiddens, the
    [S, vocab] logits for lm, and the [H, S, S] scores for dense
    attention)."""
    cap = eval_batch_size
    if isinstance(spec, tfm.TransformerSpec):
        budget = 2 * 1024 ** 3
        dh_pad = max(spec.d_head, 128)
        per_example = 4 * spec.seq_len * (
            8 * spec.n_heads * dh_pad + 2 * spec.d_ff)
        if spec.objective == "lm":
            per_example += 4 * spec.seq_len * spec.vocab_size
        if spec.attention == "dense":
            per_example += 8 * spec.n_heads * spec.seq_len ** 2
        cap = min(cap, max(1, budget // per_example))
    return cap


def _eval_correct(spec, logits, x, y):
    """Per-example 'correct' value for eval: the 0/1 classification hit,
    or — lm objective — the example's mean next-token accuracy."""
    if getattr(spec, "objective", "classify") == "lm":
        _nll, c, cnt = _lm_stats(spec, logits, tfm.tokenize(spec, x))
        return c / cnt
    return (torch.argmax(logits, -1)
            == torch.argmax(y, -1)).to(torch.float32)


def build_eval_step(cfg, spec) -> Callable:
    """``(params, x, y, mask) -> correct-prediction count`` (an f32
    scalar tensor) over one chunk; ``mask`` zeroes the padding rows.
    Every process evaluates the whole set it is given, so no collective
    runs.  Eval never drops."""

    @torch.no_grad()
    def eval_step(params, x, y, mask):
        logits = forward_local(spec, params, x, cfg.pallas)
        return torch.sum(_eval_correct(spec, logits, x, y) * mask)

    return eval_step

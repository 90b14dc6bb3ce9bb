"""The synchronous train step and the eval step over the ``('data',
'model')`` mesh (the data- and tensor-parallel subset of the JAX
package's ``parallel/step.py``).

One process per device, rank r playing device r of JAX's mesh
(``parallel/mesh.py``).  Each rank runs forward and backward on its data
index's slice of the global batch; under ``--model_parallel`` its params
are its Megatron shards and the forward's activation sums run over the
model group (``models/mlp.apply`` with ``styles``, ``models/transformer``
with ``model_axis``).  The gradients are summed over the data group with
``torch.distributed.all_reduce`` and, under ``grad_reduce='mean'``,
divided by dp, so a dp x mp step at global batch B computes the
one-device batch-B gradient (the JAX package's psum-equivalence
guarantee; the sums run in another order, so equal to float rounding).
The reported cost and accuracy are averaged over the data group the same
way.  A leaf split over the model axis has its squared norm and its
non-finite count summed over the model group (``--grad_clip``,
``--histograms``, ``--on_anomaly``), a replicated leaf's counted once,
as JAX's ``_clip_sharded`` and ``_leaf_reduce`` do; the anomaly flag is
summed over the world.

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
transformer's without a per-step host sync.  The telemetry it can
return stays on the card too: the ``--histograms`` per-leaf gradient and
parameter norms, the ``--on_anomaly`` non-finite counts and flag, and
under ``--on_anomaly=skip`` the update masked on that flag with
``torch.where``, so the masked step is captured like any other.
Every collective runs whenever a process group exists, at any world
size (a one-rank NCCL group on one card runs them too), and rank r
plays device r of JAX's one-process mesh (``parallel/mesh.py``).  With
``zero_dp`` the update is ZeRO-1's (``parallel/zero.py``).  The async
analog, local SGD (``--sync_period K``), is ``make_local_step_body``,
``param_sync`` and ``consensus_params``: each rank keeps its own replica
and applies its own gradients, and every K steps the replicas' float
leaves are averaged (at ``model_parallel`` 1 only, as in JAX).  FSDP's
step is ``parallel/fsdp.py``'s; a multi-site round
(``parallel/local_sgd.py``) runs ``make_sync_step_body`` as its inner
step over its site's data group.  Under ``--grad_accum`` each
microbatch draws its own dropout masks (``microbatch_rng``, JAX's
``fold_in`` of the microbatch index).

Sequence parallelism (``mesh.sp`` > 1, JAX's ``('data', 'seq'[,
'model'])`` mesh): each rank takes its data index's rows and its seq
index's token columns (JAX's ``P('data', 'seq')``), the forward runs
``apply(seq_axis=...)``, the lm statistics take the next block's first
token and sum over the seq group (``_lm_stats``), and the gradients
are summed over the token group (data x seq at one model index: the
transpose of the params' ``pvary`` over both axes), then divided by
dp.  The MoE balance loss averages its statistics over the token group
at any dp (JAX's ``aux_axes``).

Expert parallelism (``mesh.ep`` > 1, JAX's ``('data', 'expert'[,
'model'])`` mesh): the forward runs ``apply(expert_axis=...)`` on this
rank's experts.  Under sparse dispatch each rank takes shard
``data_index * ep + expert_index`` of the batch (``mesh.ep_tokens``),
the balance loss and the cost average over data x expert and the
dropout masks differ per expert index; under dense dispatch the expert
ranks of a data index share its rows and masks.  The gradients are
summed by leaf: the expert leaves (``mesh_lib.expert_sharded``) over the
data group, which holds the same experts, every other leaf over the
token group; all are then divided by the batch shards (dp x ep sparse,
dp dense).  The expert leaves' squared norms and non-finite counts are
summed over the expert group, beside the model group's sum of the TP
leaves.

Pipeline parallelism (``mesh.pp`` > 1, JAX's ``('data', 'stage'[, 'seq'
| 'expert'][, 'model'])`` mesh): the params are the stacked layout
(``blk_*`` this stage's slice of the blocks), the forward is
``transformer.apply_pipeline`` (GPipe or interleaved, its backward the
reverse-tick schedule; under ``--remat`` per-slot remat) or, under
``--pp_schedule=1f1b``, the fused ``pipeline_value_and_grad_1f1b``; the
lm head reduces each microbatch's logits to ``(nll_sum, correct_sum)``
on the last stage.  The gradients of the non-``blk_*`` leaves (each
stage holds them whole and adds its share: the embedding on stage 0,
the head on the last) are summed over the stage group first, then every
leaf over its batch group as above; a ``blk_*`` leaf's squared norm and
non-finite count are summed over the stage group too.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from .. import cluster
from ..config import LOCAL_SGD_TP_REFUSED
from ..models import mlp
from ..models import transformer as tfm
from ..ops import fused, losses, metrics
from ..train.optim import clip_by_global_norm
from ..train.state import TrainState
from . import mesh as mesh_lib
from . import zero as zero_lib


def param_shapes(spec, pipeline: bool = False) -> dict:
    """``{name: shape}`` of either family's params (the transformer's
    stacked layout under ``pipeline``)."""
    if isinstance(spec, tfm.TransformerSpec):
        if pipeline:
            return tfm.pipeline_param_shapes(spec)
        return tfm.param_shapes(spec)
    return mlp.param_shapes(spec)


def _lm_head(spec, x, microbatches: int, seq_axis=None):
    """The pipeline's lm head (JAX's ``lm_head``): microbatch m's final
    LayerNorm and vocab logits reduced on the last stage to its
    per-example ``[mb, 2]`` ``(nll_sum, correct_sum)`` (``_lm_stats``,
    global over the seq axis), so two numbers an example cross the stage
    group instead of the ``[mb, S, V]`` logits."""
    micro_t = tfm.tokenize(spec, x).reshape(
        microbatches, x.shape[0] // microbatches, -1)

    def head(prm, h, m):
        hl = tfm._ln(spec, h, prm["lnf_g"], prm["lnf_b"])
        logits = tfm._f32(tfm._mm(prm, hl, "W_head", "b_head",
                                  spec.compute_dtype))
        nll, correct, _cnt = _lm_stats(spec, logits, micro_t[m], seq_axis)
        return torch.stack([nll, correct], dim=-1)

    return head


def forward_local(spec, params, x, use_pallas: bool = False,
                  dropout_rng: Optional[int] = None, with_aux: bool = False,
                  styles=None, model_axis=None, seq_axis=None,
                  aux_axes=None, expert_axis=None, pipeline=None,
                  slot_remat: bool = False):
    """Logits: the transformer's ``apply`` (its kernels chosen on the
    spec; Megatron TP over ``model_axis``, sequence parallelism over
    ``seq_axis``, expert parallelism over ``expert_axis``), or the MLP's
    fused kernel under ``--pallas`` for the activations it supports when
    every layer is replicated (JAX's gate: under TP the MLP's products
    are plain), else the MLP forward with ``styles``.  ``with_aux``
    (transformer only) returns ``(logits, the MoE balance loss)``, its
    statistics averaged over ``aux_axes``.  ``pipeline`` = ``(stage
    axis, stages, microbatches, virtual)``: ``transformer.
    apply_pipeline`` (``slot_remat``: per-slot remat), whose lm output
    is the ``[B, 2]`` ``(nll_sum, correct_sum)`` of ``_lm_head``."""
    if isinstance(spec, tfm.TransformerSpec):
        if pipeline is not None:
            stage, n_stages, microbatches, virtual = pipeline
            head = ((_lm_head(spec, x, microbatches, seq_axis), 2)
                    if spec.objective == "lm" else (None, None))
            return tfm.apply_pipeline(
                spec, params, x, stage, n_stages, microbatches,
                model_axis=model_axis, virtual=virtual, head_fn=head[0],
                head_width=head[1], seq_axis=seq_axis,
                expert_axis=expert_axis, with_aux=with_aux,
                aux_axes=aux_axes, dropout_rng=dropout_rng,
                slot_remat=slot_remat)
        return tfm.apply(spec, params, x, with_aux=with_aux,
                         dropout_rng=dropout_rng, model_axis=model_axis,
                         seq_axis=seq_axis, aux_axes=aux_axes,
                         expert_axis=expert_axis)
    replicated = not styles or all(st == "rep" for st in styles)
    if (use_pallas and replicated
            and spec.activation in fused.SUPPORTED_MLP_ACTIVATIONS):
        return fused.mlp_forward(spec, params, x)
    return mlp.apply(spec, params, x, styles=styles, model_axis=model_axis)


def _lm_stats(spec, logits, tokens, seq_axis=None):
    """Per-example next-token sums from per-position vocab logits:
    ``(nll_sum [B], correct_sum [B], count [B])`` over the S-1 valid
    positions (position t predicts token t+1; the last position has no
    target).  Under ``seq_axis`` each rank holds a token block: its last
    position's target is the next block's first token (one rotation
    backwards, no gradient), the global last position is masked, and
    the sums are taken over the seq group (``psum_seq``), so every rank
    returns the global statistics."""
    b = logits.shape[0]
    logp = torch.log_softmax(logits, dim=-1)
    if seq_axis is None:
        targets = tokens[:, 1:]
        nll = -torch.gather(logp[:, :-1], -1, targets[..., None])[..., 0]
        correct = (torch.argmax(logits[:, :-1], dim=-1) == targets)
        count = torch.full((b,), float(nll.shape[1]), dtype=torch.float32,
                           device=logits.device)
        return (torch.sum(nll, dim=1), torch.sum(correct, dim=1).to(
            torch.float32), count)
    nxt = mesh_lib.rotate_start([tokens[:, 0]], seq_axis, -1).wait()[0]
    targets = torch.cat([tokens[:, 1:], nxt[:, None]], dim=1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    correct = (torch.argmax(logits, dim=-1) == targets).to(torch.float32)
    mask = torch.ones(nll.shape, dtype=torch.float32, device=logits.device)
    if seq_axis.index == seq_axis.size - 1:
        mask[:, -1] = 0.0
    return (mesh_lib.psum_seq(torch.sum(nll * mask, dim=1), seq_axis),
            mesh_lib.psum_seq(torch.sum(correct * mask, dim=1), seq_axis),
            mesh_lib.psum_seq(torch.sum(mask, dim=1), seq_axis))


def _loss_and_acc(spec, params, x, y, naive: bool, use_pallas: bool,
                  label_smoothing: float = 0.0, remat: bool = False,
                  dropout_rng: Optional[int] = None, styles=None,
                  model_axis=None, seq_axis=None, aux_axes=None,
                  expert_axis=None, pipeline=None):
    """``(objective, (cost, accuracy))`` on one batch.  The cost is the
    classify objective's cross entropy, or for the lm objective the mean
    next-token cross entropy (``y`` unused); the objective, which the
    gradients flow from, adds ``aux_loss_weight`` x the MoE balance loss
    to it (the reported cost stays plain CE), as in the JAX package.
    ``remat`` recomputes the whole forward in the backward
    (``torch.utils.checkpoint``, the JAX ``jax.checkpoint`` around the
    forward).  ``seq_axis``: sequence parallelism (the lm statistics
    over the seq group); ``aux_axes``: the token-sharding ranks the
    balance loss averages over (only when it weighs in);
    ``expert_axis``: expert parallelism; ``pipeline``: pipeline
    parallelism (``forward_local``), where ``remat`` is per-slot remat
    inside the tick loop (JAX's: the backward keeps each slot's input
    alone) and the lm objective's statistics come from the last stage."""
    is_tfm = isinstance(spec, tfm.TransformerSpec)
    aux_w = spec.aux_loss_weight if is_tfm else 0.0
    aux_axes = aux_axes if aux_w > 0 else None

    def fwd(p, xx):
        if is_tfm:
            return forward_local(spec, p, xx, use_pallas, dropout_rng,
                                 with_aux=True, model_axis=model_axis,
                                 seq_axis=seq_axis, aux_axes=aux_axes,
                                 expert_axis=expert_axis, pipeline=pipeline,
                                 slot_remat=remat)
        return forward_local(spec, p, xx, use_pallas, dropout_rng,
                             styles=styles, model_axis=model_axis), 0.0

    if remat and pipeline is None:
        logits, aux = checkpoint(fwd, params, x, use_reentrant=False)
    else:
        logits, aux = fwd(params, x)
    if pipeline is not None and spec.objective == "lm":
        # the last stage's per-example (nll_sum, correct_sum); every
        # example counts its S - 1 targets
        count = float(x.shape[0] * (spec.seq_len - 1))
        cost = torch.sum(logits[:, 0]) / count
        return cost + aux_w * aux, (cost,
                                    torch.sum(logits[:, 1].detach()) / count)
    if getattr(spec, "objective", "classify") == "lm":
        nll, correct, count = _lm_stats(spec, logits, tfm.tokenize(spec, x),
                                        seq_axis)
        total = torch.sum(count)
        cost = torch.sum(nll) / total
        return cost + aux_w * aux, (cost, torch.sum(correct) / total)
    cost = losses.cross_entropy(logits, y, naive=naive,
                                label_smoothing=label_smoothing)
    return cost + aux_w * aux, (cost, metrics.accuracy(logits, y))


_M64 = (1 << 64) - 1


def _fold(h: int, v: int) -> int:
    """``v`` folded into the state ``h``: a 63-bit seed in which every bit
    of both depends (splitmix64's finalizer after a multiply-add), so no
    field is lost to the 63-bit seeds the dropout sites take or to the
    low 32 bits the CPU generator reads."""
    z = (int(h) * 0xBF58476D1CE4E5B9 + 0x94D049BB133111EB * (int(v) + 1)
         ) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


def make_step_rng(cfg, spec, data_index: Optional[int] = None,
                  seq_index: int = 0) -> Callable:
    """``(state, step_index) -> the step's dropout seed`` (an int; None
    when the spec does not drop): seed x step, the data index (default:
    the process index) and the seq index (``Mesh.token_index``: the
    expert index under sparse expert dispatch), so every token shard
    (each data and seq or expert index) draws its own masks while the
    model ranks of one shard, and the dense dispatch's expert ranks of a
    data index, whose activations are replicated, draw the same — the
    counterpart of the JAX ``make_step_rng``, which folds in every
    token-sharding axis (the same stream after a resume; other bits).
    The seed, the step, the data index and the seq index are folded in
    one after another (``_fold``), so every field reaches the masks:
    runs of other seeds, and steps of one run, draw other masks.  The
    step is ``step_index`` when the caller knows it on the host (the
    device-resident epoch does), else ``int(state.step)``, which reads
    the card."""
    dropping = getattr(spec, "dropout_rate", 0.0) > 0
    index = cluster.process_index() if data_index is None else data_index

    def step_rng(state: TrainState,
                 step_index: Optional[int] = None) -> Optional[int]:
        if not dropping:
            return None
        step = int(state.step) if step_index is None else step_index
        return _fold(_fold(_fold(_fold(0xD0C0, cfg.seed), step), index),
                     seq_index)

    return step_rng


def microbatch_rng(rng: Optional[int], i: int) -> Optional[int]:
    """Microbatch ``i``'s dropout seed under ``--grad_accum`` > 1 (the
    JAX ``fold_in(rng0, i)``; other bits): ``rng`` mixed with ``i``,
    so each microbatch draws its own masks and a step's microbatch
    seeds do not collide with another step's.  None stays None."""
    if rng is None:
        return None
    return _fold(rng, i)


def leaf_names(spec, pipeline: bool = False) -> list:
    """The params' leaf names in the order of the step's telemetry
    vectors, spelled as the JAX package's pytree key paths (``['W1']``):
    both packages walk the param dict in sorted key order, so the norms
    and the non-finite counts line up leaf for leaf, and an anomaly's
    blame names the same leaves in either package (the stacked layout's
    under ``pipeline``)."""
    return [f"[{k!r}]" for k in sorted(param_shapes(spec, pipeline))]


def _shard_sum(v: torch.Tensor, names, sharded, mesh,
               expert=(), stage=()) -> torch.Tensor:
    """``v`` [n_leaves] with the entries of the leaves split over the
    model axis (``sharded``) summed over the model group, those split
    over the expert axis (``expert``) over the expert group and those
    split over the stage axis (``stage``: the ``blk_*`` leaves) over the
    stage group, one all-reduce each; the replicated leaves' entries as
    they are (JAX's ``_leaf_reduce``: each leaf psummed over the axes its
    spec names)."""
    if mesh is None:
        return v
    for split, group in ((sharded, mesh.model_group),
                         (expert, mesh.expert_group),
                         (stage, mesh.stage_group)):
        if not split or group is None:
            continue
        mask = torch.tensor([k in split for k in names], device=v.device)
        part = torch.where(mask, v, torch.zeros_like(v))
        dist.all_reduce(part, group=group)
        v = torch.where(mask, part, v)
    return v


def _leaf_norms(tree: dict, names, sharded=(), mesh=None,
                expert=(), stage=()) -> torch.Tensor:
    """Per-leaf L2 norms as one [n_leaves] f32 vector, in ``names``
    order, of the full leaves under TP, EP and PP (``_shard_sum``)."""
    sq = torch.stack([torch.sum(torch.square(tree[k].to(torch.float32)))
                      for k in names])
    return torch.sqrt(_shard_sum(sq, names, sharded, mesh, expert, stage))


def _leaf_nonfinite(tree: dict, names, sharded=(), mesh=None,
                    expert=(), stage=()) -> torch.Tensor:
    """Per-leaf non-finite element counts as one [n_leaves] int32
    vector, in ``names`` order, of the full leaves under TP, EP and PP.
    ``g - g`` is 0 exactly where ``g`` is finite and NaN where it is an
    inf or a NaN: two elementwise passes where ``~isfinite`` takes five
    on the card."""
    return _shard_sum(torch.stack(
        [torch.sum(torch.isnan(tree[k] - tree[k]), dtype=torch.int32)
         for k in names]), names, sharded, mesh, expert, stage)


def clip_sharded(grads: dict, max_norm: float, sharded, mesh,
                 over_data: bool = False, expert=(), stage=()) -> dict:
    """The global-norm clip (JAX's ``_clip_sharded``): the square-sums of
    the leaves split over the model axis (``sharded``) summed over the
    model group, those split over the expert axis (``expert``) over the
    expert group, those split over the stage axis (``stage``) over the
    stage group too, the replicated leaves' counted once, so every rank
    computes the same norm and the replicated leaves stay equal;
    ``over_data`` (FSDP's 1/dp gradient shards) sums the total over the
    data group too.  With nothing split and nothing to sum it is
    ``train/optim.clip_by_global_norm``, bit for bit (the same sum in
    the same sorted-key order)."""
    def axes(k):
        return (k in sharded, k in expert, k in stage)

    rep = sum(torch.sum(torch.square(g.to(torch.float32)))
              for k, g in grads.items() if not any(axes(k)))
    # each set of axes one partial sum, in a fixed order on every rank
    for key in sorted({axes(k) for k in grads} - {(False,) * 3},
                      reverse=True):
        part = sum(torch.sum(torch.square(g.to(torch.float32)))
                   for k, g in grads.items() if axes(k) == key)
        for on, group in zip(key, (mesh.model_group if mesh.mp > 1
                                   else None, mesh.expert_group,
                                   mesh.stage_group)):
            if on and group is not None:
                dist.all_reduce(part, group=group)
        rep = rep + part
    if over_data:
        mesh_lib.data_all_reduce(rep, mesh)
    norm = torch.sqrt(rep)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}


def tp_sharded_names(spec, mesh) -> set:
    """The param names split over the model axis (empty at mp 1; the
    stacked layout's under pipeline parallelism)."""
    if mesh is None or mesh.mp == 1:
        return set()
    return {k for k, d in mesh_lib.param_pspecs(
        spec, mesh.mp, pipeline=mesh.pp > 1).items() if d is not None}


def stage_sharded_names(spec, mesh) -> set:
    """The param names split over the stage axis: the ``blk_*`` leaves
    under pipeline parallelism, none otherwise."""
    if mesh is None or mesh.pp == 1:
        return set()
    return {k for k in param_shapes(spec, True) if k.startswith("blk_")}


def _pipeline(cfg, mesh):
    """``(stage axis, stages, microbatches, virtual)`` under pipeline
    parallelism, else None."""
    if mesh.pp == 1:
        return None
    return (mesh_lib.stage_axis(mesh), mesh.pp, cfg.microbatches,
            getattr(cfg, "virtual_stages", 1))


def _keep_where(flag: torch.Tensor, new, old):
    """``new`` with every tensor leaf replaced by ``old``'s where
    ``flag`` (a 0-d bool tensor) is set; SGD's empty slots pass
    through."""
    if isinstance(new, dict):
        return {k: _keep_where(flag, new[k], old[k]) for k in new}
    if isinstance(new, torch.Tensor):
        return torch.where(flag, old, new)
    return new


def mean_over_ranks(cost: torch.Tensor, acc: torch.Tensor, mesh=None):
    """``(cost, acc)`` averaged over the batch shards (JAX's ``pmean``
    over the batch axes: the data axis, and the expert axis under sparse
    dispatch; the world without a ``mesh``): one all-reduce of both,
    whenever a group exists."""
    if not cluster.collectives():
        return cost, acc
    stats = torch.stack([cost, acc.to(cost.dtype)])
    if mesh is None:
        dist.all_reduce(stats)
        n = cluster.process_count()
    else:
        if mesh.batch_group is not None:
            dist.all_reduce(stats, group=mesh.batch_group)
        n = mesh.shards
    return stats[0] / n, stats[1] / n


def make_sync_step_body(cfg, spec, optimizer, with_norms: bool = False,
                        with_anomaly: bool = False,
                        zero_dp: int = 0, mesh=None) -> Callable:
    """``(state, x, y, step_index=None) -> (state, cost, acc)`` over this
    process's slice ``x``/``y`` of the global batch: ``grad_accum``
    microbatches (the mean of their gradients), the all-reduce across
    processes, ``grad_clip``, the optimizer update, ``step + 1``.

    ``with_norms`` (``--histograms``) appends ``{"grad": [n_leaves],
    "param": [n_leaves]}``: the per-leaf L2 norms of the gradients
    before the clip and of the updated params, f32.  ``with_anomaly``
    (``--on_anomaly``) appends a last ``{"flag": bool, "counts":
    [n_leaves] int32}``: "this step's loss or a gradient is not finite",
    and the per-leaf non-finite counts of the gradients before the clip
    (the blame vector).  Both are in ``leaf_names`` order.  Under
    ``cfg.on_anomaly == "skip"`` the update is masked on the flag (here
    and in the device-resident epoch, which runs this body): a flagged
    step keeps the old params and optimizer slots, and ``step`` still
    advances.

    ``zero_dp`` > 0 applies ZeRO-1's chunked update
    (``parallel/zero.zero_update``): the optimizer slots arrive as this
    rank's ``[chunk]`` rows and the updated params are all-gathered
    over the data group.

    ``mesh`` (default: the data axis over the process group) places the
    step: under ``model_parallel`` > 1 the params and slots are this
    rank's Megatron shards, the gradients are summed over the data group
    only, and the clip, the norms and the counts read the full leaves;
    under ``expert_parallel`` > 1 the expert leaves are this rank's
    experts (``for_spec`` reads the dispatch from ``spec``).

    The step is capturable in a CUDA graph, all-reduce included: it
    reads nothing back from the card, as long as the caller passes
    ``step_index`` (the value of ``state.step``, known on the host)
    where the spec drops — otherwise the dropout seed reads
    ``state.step`` (``make_step_rng``).  The results are the same either
    way."""
    mesh = mesh_lib.for_spec(
        mesh if mesh is not None else mesh_lib.build_mesh(-1), spec)
    pipeline = _pipeline(cfg, mesh)
    names = sorted(param_shapes(spec, pipeline is not None))
    styles = mesh_lib.layer_styles(spec, mesh.mp)
    model_axis = mesh_lib.model_axis(mesh)
    seq_axis = mesh_lib.seq_axis(mesh)
    expert_axis = mesh_lib.expert_axis(mesh)
    aux_axes = mesh_lib.token_axes(mesh)
    sharded = tp_sharded_names(spec, mesh)
    expert = mesh_lib.expert_sharded(spec, mesh.ep, pipeline is not None)
    stage = stage_sharded_names(spec, mesh)
    step_rng = make_step_rng(cfg, spec, mesh.data_index, mesh.token_index)
    remat = getattr(cfg, "remat", False)
    skip = getattr(cfg, "on_anomaly", "") == "skip"
    detect = with_anomaly or skip
    use_1f1b = (pipeline is not None
                and getattr(cfg, "pp_schedule", "gpipe") == "1f1b")

    def grad_of(params, x, y, rng):
        leaves = {k: params[k].detach().requires_grad_(True) for k in names}
        objective, (cost, acc) = _loss_and_acc(
            spec, leaves, x, y, cfg.naive_ce, cfg.pallas,
            cfg.label_smoothing, remat, rng, styles, model_axis, seq_axis,
            aux_axes, expert_axis, pipeline)
        grads = torch.autograd.grad(objective, [leaves[k] for k in names])
        return cost.detach(), acc, dict(zip(names, grads))

    def grad_1f1b(params, x, y, rng):
        """``(cost, acc, grads)`` by the fused 1F1B family
        (``transformer.pipeline_value_and_grad_1f1b``), the objective's
        plumbing as JAX's ``grad_1f1b``: each microbatch's share of the
        loss on the last stage, the cost from the collected values."""
        stage_ax, n_stages, microbatches, virtual = pipeline
        mbs = x.shape[0] // microbatches
        if spec.objective == "lm":
            count = float(x.shape[0] * (spec.seq_len - 1))
            (_loss, stats), grads = tfm.pipeline_value_and_grad_1f1b(
                spec, params, x, stage_ax, n_stages, microbatches,
                lambda vals, m: torch.sum(vals[:, 0]) / count,
                head_fn=_lm_head(spec, x, microbatches), head_width=2,
                model_axis=model_axis, dropout_rng=rng, virtual=virtual)
            return (torch.sum(stats[:, 0]) / count,
                    torch.sum(stats[:, 1]) / count, grads)
        ys = y.reshape(microbatches, mbs, *y.shape[1:])

        def loss_of(vals, m):
            return losses.cross_entropy(
                vals, ys[m], naive=cfg.naive_ce,
                label_smoothing=cfg.label_smoothing) / microbatches

        (_loss, stats), grads = tfm.pipeline_value_and_grad_1f1b(
            spec, params, x, stage_ax, n_stages, microbatches, loss_of,
            model_axis=model_axis, dropout_rng=rng, virtual=virtual)
        cost = losses.cross_entropy(stats, y, naive=cfg.naive_ce,
                                    label_smoothing=cfg.label_smoothing)
        return cost, metrics.accuracy(stats, y), grads

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
            cost, acc, grads = grad_of(state.params, xs[0], ys[0],
                                       microbatch_rng(rng, 0))
            for i, (xc, yc) in enumerate(zip(xs[1:], ys[1:]), start=1):
                c, a, g = grad_of(state.params, xc, yc,
                                  microbatch_rng(rng, i))
                grads = {k: grads[k] + g[k] for k in names}
                cost, acc = cost + c, acc + a
            grads = {k: g / n for k, g in grads.items()}
            cost, acc = cost / n, acc / n
        elif use_1f1b:
            cost, acc, grads = grad_1f1b(state.params, x, y, rng)
        else:
            cost, acc, grads = grad_of(state.params, x, y, rng)
        for k in grads:
            # each stage's share of a leaf every stage holds whole
            if pipeline is not None and k not in stage:
                mesh_lib.stage_all_reduce(grads[k], mesh)
        if detect:
            # this rank's loss, summed over every axis (JAX's all_axes),
            # so every rank keeps or applies together
            loss_bad = (~torch.isfinite(cost)).to(torch.int32)
            mesh_lib.world_all_reduce(loss_bad)
        if mesh.token_group is not None:
            # summed over data x seq (the data axis at sp 1), or data x
            # expert under sparse dispatch; the expert leaves over the
            # data group, whose ranks hold the same experts
            for k, g in grads.items():
                group = mesh.data_group if k in expert else mesh.token_group
                if group is not None:
                    dist.all_reduce(g, group=group)
            cost, acc = mean_over_ranks(cost, acc, mesh)
            if cfg.grad_reduce == "mean":
                grads = {k: g / mesh.shards for k, g in grads.items()}
        # the telemetry reads the raw gradients, before the clip
        grad_norms = (_leaf_norms(grads, names, sharded, mesh, expert,
                                  stage) if with_norms else None)
        if detect:
            counts = _leaf_nonfinite(grads, names, sharded, mesh, expert,
                                     stage)
            flag = torch.any(counts > 0) | (loss_bad > 0)
        if cfg.grad_clip > 0:
            grads = clip_sharded(grads, cfg.grad_clip, sharded, mesh,
                                 expert=expert, stage=stage)
        if zero_dp:
            new_params, new_opt = zero_lib.zero_update(
                optimizer, grads, state.opt_state, state.params, zero_dp,
                mesh.data_index, mesh.data_group)
        else:
            new_params, new_opt = optimizer.update(grads, state.opt_state,
                                                   state.params)
        if skip:
            # a flagged step keeps the old params and slots, on the card
            new_params = _keep_where(flag, new_params, state.params)
            new_opt = _keep_where(flag, new_opt, state.opt_state)
        out = (TrainState(state.step + 1, new_params, new_opt), cost, acc)
        if with_norms:
            out += ({"grad": grad_norms,
                     "param": _leaf_norms(new_params, names, sharded,
                                          mesh, expert, stage)},)
        if with_anomaly:
            out += ({"flag": flag, "counts": counts},)
        return out

    return body


def make_local_step_body(cfg, spec, optimizer, host: bool = True
                         ) -> Callable:
    """The async analog's step (local SGD): ``(state, x, y,
    step_index=None) -> (state, cost, acc)`` on this rank's own replica
    and rows, with no collective on the params: each rank applies its
    own gradients.  The reported cost and accuracy are averaged over
    the ranks.  The host path's step (JAX ``build_local_train_step``)
    applies ``--grad_clip`` and ``--label_smoothing``; the
    device-resident epoch's (``host=False``, JAX's whole-run local
    program) applies neither, as JAX's does.  No dropout: the config
    refuses ``--dropout_rate`` with ``--sync_period`` > 1, and tensor
    parallelism, with JAX's message."""
    if getattr(cfg, "model_parallel", 1) != 1:
        raise ValueError(LOCAL_SGD_TP_REFUSED)
    names = sorted(param_shapes(spec))
    remat = getattr(cfg, "remat", False)
    smoothing = cfg.label_smoothing if host else 0.0

    def body(state: TrainState, x, y, step_index: Optional[int] = None):
        leaves = {k: state.params[k].detach().requires_grad_(True)
                  for k in names}
        objective, (cost, acc) = _loss_and_acc(
            spec, leaves, x, y, cfg.naive_ce, cfg.pallas, smoothing, remat)
        grads = dict(zip(names, torch.autograd.grad(
            objective, [leaves[k] for k in names])))
        if host and cfg.grad_clip > 0:
            grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
        new_params, new_opt = optimizer.update(grads, state.opt_state,
                                               state.params)
        cost, acc = mean_over_ranks(cost.detach(), acc)
        return TrainState(state.step + 1, new_params, new_opt), cost, acc

    return body


def _average(tree, world: int):
    """Float leaves averaged over the ranks (all-reduce, then / world, as
    JAX's ``pmean``); integer leaves pass through (equal on every rank
    by construction)."""
    if isinstance(tree, dict):
        return {k: _average(v, world) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dtype.is_floating_point:
        out = tree.clone()
        dist.all_reduce(out)
        return out / world
    return tree


def param_sync(state: TrainState) -> TrainState:
    """Local SGD's reconciliation (JAX ``build_param_sync``): every
    float leaf of the params and the optimizer slots averaged over the
    ranks; integer leaves (Adam's count) pass through."""
    if not cluster.collectives():
        return state
    world = cluster.process_count()
    return TrainState(state.step, _average(state.params, world),
                      _average(state.opt_state, world))


def consensus_params(state: TrainState) -> dict:
    """The replicas' mean params (JAX ``build_unstack_params``): what
    eval, sampling and the checkpoints' consensus read in async mode."""
    if not cluster.collectives():
        return state.params
    return _average(state.params, cluster.process_count())


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


def _eval_correct(spec, logits, x, y, seq_axis=None):
    """Per-example 'correct' value for eval: the 0/1 classification hit,
    or — lm objective — the example's mean next-token accuracy (over
    the whole sequence under ``seq_axis``)."""
    if getattr(spec, "objective", "classify") == "lm":
        _nll, c, cnt = _lm_stats(spec, logits, tfm.tokenize(spec, x),
                                 seq_axis)
        return c / cnt
    return (torch.argmax(logits, -1)
            == torch.argmax(y, -1)).to(torch.float32)


def build_eval_step(cfg, spec, reduce: bool = True, mesh=None) -> Callable:
    """``(params, x, y, mask) -> correct-prediction count`` (an f32
    scalar tensor) over this rank's rows of one chunk; ``mask`` zeroes
    the padding rows.  ``params`` are this rank's shards under the
    ``mesh``'s tensor parallelism.  With ``reduce`` the count is summed
    over the data group (JAX's ``psum`` over the data axis; the model
    ranks of a data index count the same rows) whenever a process group
    exists; the fast eval sums its chunks first and reduces once.  Under
    sequence parallelism ``x`` is this rank's token columns and the
    count (replicated over the seq group) is summed over the data group
    alone; under expert parallelism the MoE blocks run on this rank's
    experts, and the count is summed over the batch axes (data x expert
    under sparse dispatch, whose rows differ by expert index); under
    pipeline parallelism the pipelined forward (every stage returns the
    same values).  Eval never drops."""
    mesh = mesh_lib.for_spec(
        mesh if mesh is not None else mesh_lib.build_mesh(-1), spec)
    styles = mesh_lib.layer_styles(spec, mesh.mp)
    model_axis = mesh_lib.model_axis(mesh)
    seq_axis = mesh_lib.seq_axis(mesh)
    expert_axis = mesh_lib.expert_axis(mesh)
    pipeline = _pipeline(cfg, mesh)

    @torch.no_grad()
    def eval_step(params, x, y, mask):
        logits = forward_local(spec, params, x, cfg.pallas, styles=styles,
                               model_axis=model_axis, seq_axis=seq_axis,
                               expert_axis=expert_axis, pipeline=pipeline)
        if pipeline is not None and spec.objective == "lm":
            # the example's mean next-token accuracy over its S - 1
            # targets, from the last stage's (nll_sum, correct_sum)
            correct = logits[:, 1] / float(spec.seq_len - 1)
        else:
            correct = _eval_correct(spec, logits, x, y, seq_axis)
        count = torch.sum(correct * mask)
        if reduce and mesh.batch_group is not None:
            dist.all_reduce(count, group=mesh.batch_group)
        return count

    return eval_step

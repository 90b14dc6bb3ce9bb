"""The ``('data', 'model')`` mesh over the process group, its
``('data', 'seq'[, 'model'])`` and ``('site', 'data')`` forms (the part
of the JAX package's ``parallel/mesh.py`` with no expert or pipeline
axis).

JAX lays the devices of one process out as ``np.array(devices)
.reshape(dp, mp)``: device r sits at data index ``r // mp`` and model
index ``r % mp``.  Under ``--data_parallel`` the batch splits over the
data axis and gradients are summed over it by ``psum``; under
``--model_parallel`` each layer's weights are Megatron-split over the
model axis and the row-split products are summed over it.  The port
runs one process per device, and **rank r plays device r**: the ranks
that share a data index form the **model group**, the ranks that share
a model index the **data group**, and every collective names its group
(``Mesh.data_group``, ``Mesh.model_group``; the anomaly flag alone
spans the world).  Every rank creates every sub-group, in the same
order (``dist.new_group`` is collective over the world).

``--data_parallel -1`` takes ``world / model_parallel``, and any other
value must make ``dp x mp`` the world size: JAX leaves devices past
``dp x mp`` idle, but a rank cannot sit out the collectives of the
others.

Tensor parallelism: ``layer_styles`` (the MLP's ``col``/``row``/``rep``
alternation), ``param_pspecs`` (each leaf's dim split over the model
axis, or None: JAX's ``PartitionSpec`` reduced to what a one-axis split
needs), ``shard_leaf``/``gather_leaf``, and the two Megatron operators:
``model_psum`` (all-reduce in the forward, identity in the backward:
the transpose of JAX's ``psum``, after each row-split product) and
``model_copy`` (identity in the forward, all-reduce in the backward:
the transpose of the implicit ``pvary``, on the replicated input of
each column-split product).

Multi-site training (``build_site_mesh``, JAX's ``('site', 'data')``
mesh with 'site' outermost): rank r sits at site ``r // dp`` and data
index ``r % dp``.  Its **data group** is its site's ``dp`` consecutive
ranks (the per-step gradient all-reduce), its **site group** the ranks
of its data index across the sites (stride ``dp``; the outer
pseudo-gradient mean), and the batch splits over ``sites x dp`` shards,
rank r taking shard r.

Sequence parallelism (``build_seq_mesh``, JAX's ``('data', 'seq'[,
'model'])`` mesh): rank r sits at data index ``r // (sp * mp)``, seq
index ``(r // mp) % sp`` and model index ``r % mp``, where JAX's
``np.array(devices).reshape(dp, sp, mp)`` puts device r.  Each example's
tokens split over the seq axis in contiguous blocks.  The **seq group**
is the ranks of one data and model index (the ring's rotations,
Ulysses' exchange, the pooled mean and the lm sums), the **data group**
the ranks of one seq and model index (the cost mean, ZeRO-1's chunks),
the model group the ranks of one data and seq index, and the **token
group** the ranks of one model index across data and seq: the tokens
of the global batch, whose gradients are summed there (the transpose
of the params' implicit ``pvary`` over both axes) and over which the
MoE balance loss averages its statistics (``token_axes``, JAX's
``aux_axes``).  ``seq_rotate`` and ``seq_all_to_all`` are the ring's
``ppermute`` and Ulysses' ``all_to_all``, each with its transpose as
its backward; ``psum_tokens``/``pmean_seq``/``pmean_tokens`` the sums
and means whose backward is JAX's transpose.

Expert parallelism (``build_expert_mesh``, JAX's ``('data', 'expert'[,
'model'])`` mesh): rank r sits at data index ``r // (ep * mp)``, expert
index ``(r // mp) % ep`` and model index ``r % mp``.  Every MoE block's
expert leaves (``We1``/``be1``/``We2``/``be2``) split dim 0 over the
expert axis (``expert_sharded``; the router stays replicated, and under
TP the experts are not split over 'model').  The **expert group** is
the ranks of one data and model index.  Under sparse dispatch
(``moe_dispatch='alltoall'``, ``sparse_ep_mode``) the tokens shard over
data x expert too (``for_spec`` sets ``Mesh.ep_tokens``): a rank's rows
are shard ``data_index * ep + expert_index`` of ``dp * ep``, and the
token group is the ranks of one model index across data x expert, as
for the seq axis.  Under dense dispatch the expert ranks of a data index
share its rows and the token group is the data group.  The exchanges are
``expert_all_to_all`` (JAX's tiled ``all_to_all``, its transpose as its
backward), ``expert_copy`` and ``expert_psum`` (the dense dispatch's
replicated input and partial-output sum), each tallied in ``EP_BYTES``
where it moves a buffer.

Pipeline parallelism (``build_stage_mesh``, JAX's ``('data', 'stage'[,
'seq' | 'expert'][, 'model'])`` mesh): with ``x`` the seq or expert
degree (1 when absent), rank r sits at data index ``r // (pp * x *
mp)``, stage index ``(r // (x * mp)) % pp``, seq or expert index ``(r //
mp) % x`` and model index ``r % mp``, where JAX's ``np.array(devices)
.reshape(dp, pp[, x][, mp])`` puts device r.  The **stage group** is the
ranks of one data, seq-or-expert and model index across the stages; the
other groups are those of the layout without the stage axis, within one
stage.  The stage hop (``stage_hop_start``, JAX's ``_hop_start`` /
``_hop_join``: a ``ppermute`` over the stage axis) moves one microbatch's
activations to the next stage, or its gradient back, by the seq ring's
two routes (``batch_isend_irecv``, or a zero-split ``all_to_all_single``
over the stage group for gloo on CUDA tensors), each tallied in
``PP_BYTES``; ``stage_psum`` is the sum over the stage group whose
backward passes the gradient as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from .. import cluster

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
STAGE_AXIS = "stage"
SITE_AXIS = "site"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``(sites x) dp x (pp x) (sp | ep) x mp`` ranks, this process at
    ``rank``; its groups (None without a process group): ``data_group``
    the ranks of its model and seq (or expert) index (within its site
    under ``sites`` > 1; the world at ``mp`` 1, ``sp`` and ``ep`` 1 and
    one site, None when ``dp`` is 1 under sites), ``model_group`` those
    of its data and seq (or expert) index (None at ``mp`` 1: no model
    axis to reduce over), ``site_group`` those of its data index across
    the sites (None at one site), ``seq_group`` those of its data and
    model index (None at ``sp`` 1), ``expert_group`` likewise on the
    expert axis (None at ``ep`` 1), ``mid_token_group`` those of its
    model index across data and the seq or expert axis (within its
    stage), and ``stage_group`` those of its data, seq-or-expert and
    model index across the stages (None at ``pp`` 1).
    ``ep_tokens``: the tokens shard over the expert axis too (sparse
    dispatch; ``for_spec`` sets it)."""
    dp: int
    rank: int
    mp: int = 1
    data_group: object = dataclasses.field(default=None, compare=False,
                                           repr=False)
    model_group: object = dataclasses.field(default=None, compare=False,
                                            repr=False)
    sites: int = 1
    site_group: object = dataclasses.field(default=None, compare=False,
                                           repr=False)
    sp: int = 1
    seq_group: object = dataclasses.field(default=None, compare=False,
                                          repr=False)
    mid_token_group: object = dataclasses.field(default=None, compare=False,
                                                repr=False)
    ep: int = 1
    expert_group: object = dataclasses.field(default=None, compare=False,
                                             repr=False)
    ep_tokens: bool = False
    pp: int = 1
    stage_group: object = dataclasses.field(default=None, compare=False,
                                            repr=False)

    @property
    def _inner(self) -> int:
        """Ranks a data index spans: the stage axis x the seq or expert
        axis x model."""
        return self.pp * self.sp * self.ep * self.mp

    @property
    def stage_index(self) -> int:
        return (self.rank // (self.sp * self.ep * self.mp)) % self.pp

    @property
    def data_index(self) -> int:
        return (self.rank % (self.dp * self._inner)) // self._inner

    @property
    def seq_index(self) -> int:
        return (self.rank // self.mp) % self.sp

    @property
    def expert_index(self) -> int:
        return (self.rank // self.mp) % self.ep

    @property
    def model_index(self) -> int:
        return self.rank % self.mp

    @property
    def site_index(self) -> int:
        return self.rank // (self.dp * self._inner)

    @property
    def devices(self) -> int:
        return self.sites * self.dp * self._inner

    @property
    def shards(self) -> int:
        """The batch shards within a site: dp, x ep under sparse
        dispatch (JAX's ``batch_layout`` count; not the seq axis, which
        splits tokens, not rows)."""
        return self.dp * (self.ep if self.ep_tokens else 1)

    @property
    def shard_index(self) -> int:
        """This rank's batch shard within its site."""
        if self.ep_tokens:
            return self.data_index * self.ep + self.expert_index
        return self.data_index

    @property
    def token_index(self) -> int:
        """This rank's index on the axis besides 'data' its tokens
        shard over: the seq index, the expert index under sparse
        dispatch, else 0."""
        return self.seq_index if self.sp > 1 else (
            self.expert_index if self.ep_tokens else 0)

    @property
    def token_group(self):
        """The group the gradients of the replicated leaves are summed
        over: the ranks of this model index across the data axis and
        the seq axis (or the expert axis under sparse dispatch)."""
        if self.sp > 1 or self.ep_tokens:
            return self.mid_token_group
        return self.data_group

    @property
    def batch_group(self):
        """The group a per-shard cost and an eval count are summed
        over: the ranks holding distinct rows (JAX's batch axes; a seq
        shard's cost is the whole sequence's already)."""
        return self.mid_token_group if self.ep_tokens else self.data_group


# the sub-groups of each (world group, dp, mp), beside the world group
# they belong to (held, so a later world group cannot reuse its id): a
# run builds its mesh once, but a process may run several, and every
# new_group is a collective over the world
_GROUPS: dict = {}


def _sub_groups(dp: int, mp: int, rank: int):
    """``(data_group, model_group)`` of ``rank``: every model group
    (consecutive ranks) and then every data group (stride ``mp``),
    created in the same order on every rank."""
    if mp == 1:
        return dist.group.WORLD, None
    world = dist.group.WORLD
    key = (id(world), dp, mp)
    if key not in _GROUPS:
        model = [dist.new_group(list(range(i * mp, (i + 1) * mp)))
                 for i in range(dp)]
        data = [dist.new_group(list(range(m, dp * mp, mp)))
                for m in range(mp)]
        _GROUPS[key] = (world, data, model)
    _world, data, model = _GROUPS[key]
    return data[rank % mp], model[rank // mp]


def build_mesh(data_parallel: int = -1, model_parallel: int = 1,
               world: int | None = None, rank: int | None = None) -> Mesh:
    """The ('data', 'model') layout over ``world`` ranks (default: the
    process group's, 1 without one), with JAX's rules and messages:
    ``model_parallel`` must divide the world, ``data_parallel`` -1 is
    ``world / model_parallel``, a mesh larger than the world raises;
    one smaller raises the port's own message (every rank must take
    part).  The groups are made when a process group is up and
    ``world`` is not given."""
    n = cluster.process_count() if world is None else world
    r = cluster.process_index() if rank is None else rank
    mp = model_parallel
    if mp < 1 or n % mp:
        raise ValueError(f"model_parallel={mp} must divide device count {n}")
    dp = n // mp if data_parallel == -1 else data_parallel
    if dp < 1:
        raise ValueError(f"data_parallel={dp} must be >= 1 (or -1)")
    if dp * mp > n:
        raise ValueError(f"mesh {dp}x{mp} needs {dp * mp} devices, have {n}")
    if dp * mp < n:
        over = f" over model_parallel={mp}" if mp > 1 else ""
        raise ValueError(
            f"data_parallel={dp} leaves {n - dp * mp} of {n} ranks off the "
            f"mesh: in the PyTorch port every rank plays one device of the "
            f"mesh, so --data_parallel must be -1 or the world size {n}"
            f"{over}")
    groups = (None, None)
    if world is None and cluster.collectives():
        groups = _sub_groups(dp, mp, r)
    return Mesh(dp=dp, rank=r, mp=mp, data_group=groups[0],
                model_group=groups[1])


def _site_groups(sites: int, dp: int, rank: int):
    """``(data_group, site_group)`` of ``rank`` on the ('site', 'data')
    layout: every site's data group (consecutive ranks) and then every
    data index's site group (stride ``dp``), created in the same order
    on every rank.  A one-rank data group is None (its all-reduce is the
    identity), and at ``dp`` 1 the site group is the world."""
    if dp == 1:
        return None, dist.group.WORLD
    world = dist.group.WORLD
    key = ("site", id(world), sites, dp)
    if key not in _GROUPS:
        data = [dist.new_group(list(range(s * dp, (s + 1) * dp)))
                for s in range(sites)]
        site = [dist.new_group(list(range(d, sites * dp, dp)))
                for d in range(dp)]
        _GROUPS[key] = (world, data, site)
    _world, data, site = _GROUPS[key]
    return data[rank // dp], site[rank % dp]


def _mid_groups(axis: str, dp: int, sp: int, mp: int, rank: int):
    """``(data, model, mid, token)`` groups of ``rank`` on the ('data',
    ``axis``, 'model') layout (``axis`` 'seq' or 'expert', of size
    ``sp``), every family created in the same order on every rank: the
    model groups (consecutive ranks; None at mp 1), the data groups (one
    a middle and model index), the middle axis's groups (one a data and
    model index), the token groups (one a model index; the world at mp
    1)."""
    world = dist.group.WORLD
    key = (axis, id(world), dp, sp, mp)
    n = dp * sp * mp

    def at(d, s, m):
        return (d * sp + s) * mp + m

    if key not in _GROUPS:
        model = ([dist.new_group([at(d, s, m) for m in range(mp)])
                  for d in range(dp) for s in range(sp)] if mp > 1 else None)
        data = [dist.new_group([at(d, s, m) for d in range(dp)])
                for s in range(sp) for m in range(mp)]
        seq = [dist.new_group([at(d, s, m) for s in range(sp)])
               for d in range(dp) for m in range(mp)]
        token = ([dist.new_group(list(range(m, n, mp))) for m in range(mp)]
                 if mp > 1 else None)
        _GROUPS[key] = (world, model, data, seq, token)
    _world, model, data, seq, token = _GROUPS[key]
    d, s, m = rank // (sp * mp), (rank // mp) % sp, rank % mp
    return (data[s * mp + m], model[d * sp + s] if model else None,
            seq[d * mp + m], token[m] if token else world)


def build_seq_mesh(data_parallel: int, sequence_parallel: int,
                   world: int | None = None, rank: int | None = None,
                   model_parallel: int = 1) -> Mesh:
    """The ('data', 'seq'[, 'model']) layout over ``world`` ranks
    (default: the process group's) for sequence-parallel transformer
    training: rank r at data index ``r // (sp * mp)``, seq index
    ``(r // mp) % sp``, model index ``r % mp``, as JAX's
    ``build_seq_mesh`` places device r.  ``data_parallel`` -1 is
    ``world / (sp * mp)`` (JAX's trainer rule); JAX's messages for a
    bad degree or a mesh larger than the world, the port's own for one
    that leaves ranks off.  The groups are made when a process group is
    up and ``world`` is not given."""
    n = cluster.process_count() if world is None else world
    r = cluster.process_index() if rank is None else rank
    sp, mp = sequence_parallel, model_parallel
    dp = (max(n // (sp * mp), 1) if data_parallel == -1
          else data_parallel)
    axes = {DATA_AXIS: dp, SEQ_AXIS: sp}
    if mp > 1:
        axes[MODEL_AXIS] = mp
    if any(v < 1 for v in axes.values()):
        raise ValueError(f"mesh axes must be >= 1, got {axes}")
    need = dp * sp * mp
    if need > n:
        raise ValueError(
            f"mesh {'x'.join(map(str, axes.values()))} over "
            f"{tuple(axes)} needs {need} devices, have {n}")
    if need < n:
        raise ValueError(
            f"data_parallel={dp} x sequence_parallel={sp} x "
            f"model_parallel={mp} leaves {n - need} of {n} ranks off the "
            f"mesh: in the PyTorch port every rank plays one device of "
            f"the mesh, so their product must be the world size {n}")
    groups = (None, None, None, None)
    if world is None and cluster.collectives():
        groups = _mid_groups(SEQ_AXIS, dp, sp, mp, r)
    return Mesh(dp=dp, rank=r, mp=mp, data_group=groups[0],
                model_group=groups[1], sp=sp, seq_group=groups[2],
                mid_token_group=groups[3])


def build_expert_mesh(data_parallel: int, expert_parallel: int,
                      world: int | None = None, rank: int | None = None,
                      model_parallel: int = 1) -> Mesh:
    """The ('data', 'expert'[, 'model']) layout over ``world`` ranks
    (default: the process group's) for expert-parallel MoE training:
    rank r at data index ``r // (ep * mp)``, expert index ``(r // mp) %
    ep``, model index ``r % mp``, as JAX's ``build_expert_mesh`` places
    device r.  ``data_parallel`` -1 is ``world / (ep * mp)`` (JAX's
    trainer rule); JAX's messages for a bad degree or a mesh larger than
    the world, the port's own for one that leaves ranks off.  The groups
    are made when a process group is up and ``world`` is not given.
    The tokens shard over the data axis alone until ``for_spec`` sees a
    sparse-dispatch MoE."""
    n = cluster.process_count() if world is None else world
    r = cluster.process_index() if rank is None else rank
    ep, mp = expert_parallel, model_parallel
    dp = (max(n // (ep * mp), 1) if data_parallel == -1
          else data_parallel)
    axes = {DATA_AXIS: dp, EXPERT_AXIS: ep}
    if mp > 1:
        axes[MODEL_AXIS] = mp
    if any(v < 1 for v in axes.values()):
        raise ValueError(f"mesh axes must be >= 1, got {axes}")
    need = dp * ep * mp
    if need > n:
        raise ValueError(
            f"mesh {'x'.join(map(str, axes.values()))} over "
            f"{tuple(axes)} needs {need} devices, have {n}")
    if need < n:
        raise ValueError(
            f"data_parallel={dp} x expert_parallel={ep} x "
            f"model_parallel={mp} leaves {n - need} of {n} ranks off the "
            f"mesh: in the PyTorch port every rank plays one device of "
            f"the mesh, so their product must be the world size {n}")
    groups = (None, None, None, None)
    if world is None and cluster.collectives():
        groups = _mid_groups(EXPERT_AXIS, dp, ep, mp, r)
    return Mesh(dp=dp, rank=r, mp=mp, data_group=groups[0],
                model_group=groups[1], ep=ep, expert_group=groups[2],
                mid_token_group=groups[3])


def _stage_groups(dp: int, pp: int, x: int, mp: int, rank: int):
    """``(data, model, mid, token, stage)`` groups of ``rank`` on the
    ('data', 'stage', mid, 'model') layout (``x`` the middle axis's
    size), every family created in the same order on every rank: the
    model groups (one a data, stage and middle index; None at mp 1), the
    data groups (one a stage, middle and model index), the middle axis's
    groups (one a data, stage and model index; None at x 1), the token
    groups (one a stage and model index, across data and the middle
    axis; None at x 1) and the stage groups (one a data, middle and
    model index)."""
    world = dist.group.WORLD
    key = ("stage", id(world), dp, pp, x, mp)

    def at(d, s, i, m):
        return ((d * pp + s) * x + i) * mp + m

    if key not in _GROUPS:
        model = ([dist.new_group([at(d, s, i, m) for m in range(mp)])
                  for d in range(dp) for s in range(pp) for i in range(x)]
                 if mp > 1 else None)
        data = [dist.new_group([at(d, s, i, m) for d in range(dp)])
                for s in range(pp) for i in range(x) for m in range(mp)]
        mid = ([dist.new_group([at(d, s, i, m) for i in range(x)])
                for d in range(dp) for s in range(pp) for m in range(mp)]
               if x > 1 else None)
        token = ([dist.new_group([at(d, s, i, m) for d in range(dp)
                                  for i in range(x)])
                  for s in range(pp) for m in range(mp)] if x > 1 else None)
        stage = [dist.new_group([at(d, s, i, m) for s in range(pp)])
                 for d in range(dp) for i in range(x) for m in range(mp)]
        _GROUPS[key] = (world, model, data, mid, token, stage)
    _world, model, data, mid, token, stage = _GROUPS[key]
    d, s = rank // (pp * x * mp), (rank // (x * mp)) % pp
    i, m = (rank // mp) % x, rank % mp
    return (data[(s * x + i) * mp + m],
            model[(d * pp + s) * x + i] if model else None,
            mid[(d * pp + s) * mp + m] if mid else None,
            token[s * mp + m] if token else None,
            stage[(d * x + i) * mp + m])


def build_stage_mesh(data_parallel: int, pipeline_parallel: int,
                     world: int | None = None, rank: int | None = None,
                     model_parallel: int = 1, sequence_parallel: int = 1,
                     expert_parallel: int = 1) -> Mesh:
    """The ('data', 'stage'[, 'seq' | 'expert'][, 'model']) layout over
    ``world`` ranks (default: the process group's) for pipeline-parallel
    transformer training: with ``x`` the seq or expert degree, rank r at
    data index ``r // (pp * x * mp)``, stage index ``(r // (x * mp)) %
    pp``, seq or expert index ``(r // mp) % x`` and model index ``r %
    mp``, as JAX's ``build_stage_mesh`` places device r.
    ``data_parallel`` -1 is ``world / (pp * x * mp)`` (JAX's trainer
    rule); JAX's messages for the seq and expert axes together, a bad
    degree or a mesh larger than the world, the port's own for one that
    leaves ranks off.  The groups are made when a process group is up
    and ``world`` is not given.  The tokens shard over the expert axis
    too only once ``for_spec`` sees a sparse-dispatch MoE."""
    n = cluster.process_count() if world is None else world
    r = cluster.process_index() if rank is None else rank
    pp, sp, ep, mp = (pipeline_parallel, sequence_parallel,
                      expert_parallel, model_parallel)
    if sp > 1 and ep > 1:
        raise ValueError(
            "pipeline parallelism composes with EITHER sequence_parallel "
            "OR expert_parallel (token-sharded expert capacity pools "
            "are not defined), not both")
    x = max(sp, ep)
    dp = (max(n // (pp * x * mp), 1) if data_parallel == -1
          else data_parallel)
    axes = {DATA_AXIS: dp, STAGE_AXIS: pp}
    if sp > 1:
        axes[SEQ_AXIS] = sp
    if ep > 1:
        axes[EXPERT_AXIS] = ep
    if mp > 1:
        axes[MODEL_AXIS] = mp
    if any(v < 1 for v in (dp, pp, sp, ep, mp)):
        raise ValueError(f"mesh axes must be >= 1, got {axes}")
    need = dp * pp * x * mp
    if need > n:
        raise ValueError(
            f"mesh {'x'.join(map(str, axes.values()))} over "
            f"{tuple(axes)} needs {need} devices, have {n}")
    if need < n:
        degrees = [f"data_parallel={dp}", f"pipeline_parallel={pp}"] + [
            f"{k}={v}" for k, v in (("sequence_parallel", sp),
                                    ("expert_parallel", ep),
                                    ("model_parallel", mp)) if v > 1]
        raise ValueError(
            f"{' x '.join(degrees)} leaves {n - need} of {n} ranks off "
            f"the mesh: in the PyTorch port every rank plays one device "
            f"of the mesh, so their product must be the world size {n}")
    groups = (None,) * 5
    if world is None and cluster.collectives():
        groups = _stage_groups(dp, pp, x, mp, r)
    return Mesh(dp=dp, rank=r, mp=mp, data_group=groups[0],
                model_group=groups[1], sp=sp, ep=ep,
                seq_group=groups[2] if sp > 1 else None,
                expert_group=groups[2] if ep > 1 else None,
                mid_token_group=groups[3], pp=pp, stage_group=groups[4])


def sparse_ep_mode(mesh: Mesh, spec) -> bool:
    """Whether the tokens shard over the expert axis too (JAX's
    ``sparse_ep_mode``): an expert axis and a sparse-dispatch MoE
    transformer, the GShard layout whose exchange carries distinct
    tokens; dense dispatch replicates the batch over the axis."""
    from ..models.transformer import TransformerSpec

    return (mesh.ep > 1 and isinstance(spec, TransformerSpec)
            and spec.num_experts > 0 and spec.moe_dispatch == "alltoall")


def for_spec(mesh: Mesh, spec) -> Mesh:
    """``mesh`` with ``ep_tokens`` set as ``spec``'s dispatch asks
    (``sparse_ep_mode``)."""
    sparse = sparse_ep_mode(mesh, spec)
    return mesh if mesh.ep_tokens == sparse else dataclasses.replace(
        mesh, ep_tokens=sparse)


def build_site_mesh(sites: int, data_parallel: int = -1,
                    world: int | None = None,
                    rank: int | None = None) -> Mesh:
    """The ('site', 'data') layout over ``world`` ranks (default: the
    process group's) for multi-site local SGD (``parallel/local_sgd``):
    ``sites`` sync-DP groups of ``data_parallel`` ranks each (-1: world
    / sites), rank r at site ``r // dp`` and data index ``r % dp``, as
    JAX's ``build_nd_mesh({'site': sites, 'data': dp})`` places device
    r.  JAX's messages for a bad degree; a layout that leaves ranks
    off raises the port's own, as ``build_mesh`` does."""
    if sites < 1:
        raise ValueError(f"sites={sites} must be >= 1")
    n = cluster.process_count() if world is None else world
    r = cluster.process_index() if rank is None else rank
    dp = max(n // sites, 1) if data_parallel == -1 else data_parallel
    if dp < 1:
        raise ValueError(f"mesh axes must be >= 1, got "
                         f"{{'site': {sites}, 'data': {dp}}}")
    if sites * dp > n:
        raise ValueError(f"mesh {sites}x{dp} over ('site', 'data') needs "
                         f"{sites * dp} devices, have {n}")
    if sites * dp < n:
        raise ValueError(
            f"sites={sites} x data_parallel={dp} leaves "
            f"{n - sites * dp} of {n} ranks off the mesh: in the PyTorch "
            f"port every rank plays one device of the mesh, so --sites x "
            f"--data_parallel must be the world size {n}")
    groups = (None, None)
    if world is None and cluster.collectives():
        groups = _site_groups(sites, dp, r)
    return Mesh(dp=dp, rank=r, mp=1, data_group=groups[0], sites=sites,
                site_group=groups[1])


def model_axis(mesh: Mesh):
    """The model group the Megatron operators reduce over (None without
    tensor parallelism)."""
    return mesh.model_group if mesh.mp > 1 else None


def data_all_reduce(t: torch.Tensor, mesh: Mesh) -> None:
    """Sum ``t`` in place over the data axis (whenever a group exists)."""
    if mesh.data_group is not None:
        dist.all_reduce(t, group=mesh.data_group)


def model_all_reduce(t: torch.Tensor, mesh: Mesh) -> None:
    """Sum ``t`` in place over the model axis (only under TP)."""
    if mesh.mp > 1 and mesh.model_group is not None:
        dist.all_reduce(t, group=mesh.model_group)


def site_mean(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` averaged over the site axis (JAX's ``pmean`` over 'site':
    the sum over the site group, then / sites), a new tensor."""
    out = t.clone()
    if mesh.site_group is not None:
        dist.all_reduce(out, group=mesh.site_group)
    return out / mesh.sites


def world_all_reduce(t: torch.Tensor) -> None:
    """Sum ``t`` in place over every rank (JAX's psum over all axes)."""
    if cluster.collectives():
        dist.all_reduce(t)  # dtx: noqa[axis-consistency] the anomaly flags are JAX's psum over every mesh axis, and the mesh spans the world


def groups(mesh: Mesh) -> list:
    """The distinct groups the mesh's collectives run over."""
    return [g for g in (mesh.data_group, mesh.model_group, mesh.site_group,
                        mesh.seq_group, mesh.mid_token_group,
                        mesh.expert_group, mesh.stage_group)
            if g is not None]


def uses_gloo(mesh: Mesh) -> bool:
    """Whether a collective of the mesh runs over gloo."""
    return any(dist.get_backend(g) == "gloo" for g in groups(mesh))


def _group_sum(t: torch.Tensor, group, tally: Optional[str]
               ) -> torch.Tensor:
    """``t`` summed over ``group`` (a new tensor), its bytes added to
    ``EP_BYTES[tally]`` when ``tally`` names an entry."""
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    if tally is not None:
        EP_BYTES[tally] += out.numel() * out.element_size()
    return out


class _GroupPsum(torch.autograd.Function):
    """All-reduce over a group (the model group, or the expert group) in
    the forward, identity in the backward (the transpose of JAX's
    ``psum`` of a varying value)."""

    @staticmethod
    def forward(ctx, x, group, tally=None):
        return _group_sum(x, group, tally)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GroupCopy(torch.autograd.Function):
    """Identity in the forward, all-reduce over a group in the backward
    (the transpose of JAX's implicit ``pvary``: what ``shard_map``'s
    transpose sums for a replicated value feeding each rank's own
    shard of the work)."""

    @staticmethod
    def forward(ctx, x, group, tally=None):
        ctx.group, ctx.tally = group, tally
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _group_sum(g, ctx.group, ctx.tally), None, None


def _check_group(group) -> None:
    if isinstance(group, str):
        raise TypeError(
            f"model_axis={group!r}: the PyTorch port reduces over the "
            f"model group of parallel/mesh.build_mesh (a process group), "
            f"not over a JAX mesh axis name")


def model_psum(x: torch.Tensor, group) -> torch.Tensor:
    """The row-split product's partial sums added over ``group`` (the
    model group; None: ``x`` as it is)."""
    _check_group(group)
    return x if group is None else _GroupPsum.apply(x, group)


def model_copy(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated activation entering a column-split product: its
    gradient is summed over ``group`` (None: ``x`` as it is)."""
    _check_group(group)
    return x if group is None else _GroupCopy.apply(x, group)


def tp_axis(spec, model_parallel: int) -> str | None:
    """MODEL_AXIS when the transformer family runs Megatron TP (the
    MLP's TP goes through layer_styles instead)."""
    from ..models.transformer import TransformerSpec

    return (MODEL_AXIS if model_parallel > 1
            and isinstance(spec, TransformerSpec) else None)


def layer_styles(spec, model_parallel: int = 1) -> list:
    """Per-layer TP style (JAX's): 'col' (column-split), 'row'
    (row-split + psum) or 'rep' (replicated).  Layers alternate col/row
    so activations need one psum a pair; the final layer stays
    replicated when the alternation would leave the logits split.  The
    transformer's TP goes through ``param_pspecs``: its degree is
    validated (``check_tp``) and one "rep" returned."""
    from ..models import transformer

    if isinstance(spec, transformer.TransformerSpec):
        transformer.check_tp(spec, model_parallel)
        return ["rep"]
    styles = []
    for i in range(1, spec.num_layers + 1):
        if model_parallel == 1:
            styles.append("rep")
        elif i % 2 == 1:
            styles.append("rep" if i == spec.num_layers else "col")
        else:
            styles.append("row")
    sizes = spec.layer_sizes
    for i, st in enumerate(styles, start=1):
        if st == "col" and sizes[i] % model_parallel:
            raise ValueError(
                f"layer {i} output dim {sizes[i]} not divisible by "
                f"model_parallel={model_parallel}")
        if st == "row" and sizes[i - 1] % model_parallel:
            raise ValueError(
                f"layer {i} input dim {sizes[i - 1]} not divisible by "
                f"model_parallel={model_parallel}")
    return styles


def param_pspecs(spec, model_parallel: int = 1,
                 pipeline: bool = False) -> Dict[str, Optional[int]]:
    """``{param name: the dim split over the model axis, or None}``, with
    JAX's leaf names and placements: the MLP's col layer splits ``W``'s
    dim 1 and ``b``, its row layer ``W``'s dim 0; the transformer's
    blocks split ``Wqkv``/``bqkv`` on their last dim (whole heads),
    ``Wo`` and ``W2`` on dim 0, ``W1``/``b1`` on the hidden dim.  With
    ``pipeline`` the names are the stacked layout's
    (``transformer.pipeline_param_pspecs``: each dim one further in)."""
    from ..models import transformer

    if isinstance(spec, transformer.TransformerSpec):
        layer_styles(spec, model_parallel)
        axis = tp_axis(spec, model_parallel)
        if pipeline:
            return transformer.pipeline_param_pspecs(spec, model_axis=axis)
        return transformer.param_pspecs(spec, model_axis=axis)
    out: Dict[str, Optional[int]] = {}
    for i, st in enumerate(layer_styles(spec, model_parallel), start=1):
        out[f"W{i}"] = {"col": 1, "row": 0}.get(st)
        out[f"b{i}"] = 0 if st == "col" else None
    return out


def expert_sharded(spec, expert_parallel: int,
                   pipeline: bool = False) -> frozenset:
    """The param names split on dim 0 over the expert axis (JAX's
    ``param_pspecs(expert_axis=...)``): every MoE block's ``We1``,
    ``be1``, ``We2`` and ``be2`` at ``expert_parallel`` > 1, none
    otherwise.  They are not split over the model axis
    (``param_pspecs`` gives them None).  With ``pipeline`` the stacked
    ``blk_*`` expert leaves, split on dim 1."""
    from ..models import transformer

    if expert_parallel <= 1 or not isinstance(
            spec, transformer.TransformerSpec):
        return frozenset()
    if pipeline:
        return frozenset(transformer.pipeline_expert_leaves(spec))
    return frozenset(transformer.expert_leaves(spec))


def state_pspecs(param_dims: Dict[str, Optional[int]]):
    """``key -> split dim or None`` over a train state's flattened keys
    (``utils/checkpoint.flatten_state``): a param and each of its
    optimizer slots (``.opt_state/.../W1``, the param's shape) split
    alike; the step and the counters are replicated."""
    def dim_of(key: str) -> Optional[int]:
        if not key.startswith((".params/", ".opt_state/")):
            return None
        return param_dims.get(key.rsplit("/", 1)[-1])

    return dim_of


# ---------------------------------------------------------------------------
# the seq axis's collectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SeqAxis:
    """The seq axis as the attention and the step see it (JAX's
    ``seq_axis`` name inside ``shard_map``): its group (None: no
    process group, every collective the identity), its size, this
    rank's index on it and the global ranks of the group in seq
    order."""
    group: object
    size: int
    index: int
    ranks: tuple


def seq_axis(mesh: Mesh) -> Optional[SeqAxis]:
    """The mesh's seq axis, or None at ``sp`` 1."""
    if mesh.sp == 1:
        return None
    base = mesh.rank - mesh.seq_index * mesh.mp
    return SeqAxis(mesh.seq_group, mesh.sp, mesh.seq_index,
                   tuple(base + s * mesh.mp for s in range(mesh.sp)))


def _live(axis: Optional[SeqAxis]) -> bool:
    return axis is not None and axis.size > 1 and axis.group is not None


# bytes this process posted to the seq axis's rotations and exchanges
# (the tensors handed to the collectives, not what the transport moved),
# read and zeroed by the code that measures a run
SEQ_BYTES = {"rotate": 0, "all_to_all": 0}


def _transport(axis: SeqAxis, t: torch.Tensor) -> str:
    """How a rotation travels: ``"p2p"`` (``batch_isend_irecv``: NCCL,
    and gloo on host tensors) or ``"a2a"`` (an ``all_to_all_single``
    whose splits are 0 but the neighbours': gloo on CUDA tensors,
    whose point-to-point ops take the tensor's raw pointer as host
    memory; ``scripts/torch_gloo_cuda_probe.py``, PERF.md section 7)."""
    if t.is_cuda and dist.get_backend(axis.group) == "gloo":
        return "a2a"
    return "p2p"


class _Pending:
    """Rotations posted and not yet waited for: ``wait()`` returns the
    received tensors."""

    def __init__(self, works, outs):
        self.works, self.outs = works, outs

    def wait(self) -> list:
        for w in self.works:
            w.wait()
        return self.outs


def rotate_start(tensors, axis: Optional[SeqAxis], shift: int = 1,
                 transport: Optional[str] = None) -> _Pending:
    """Post one rotation of each of ``tensors`` along the seq axis:
    every rank sends to seq index ``+shift`` and receives from
    ``-shift`` (JAX's ``ppermute`` with ``perm [(j, j + shift)]``); the
    receive buffers are new tensors.  Returns at once; ``wait()`` on the
    result gives the received tensors.  Without a live axis it gives
    the inputs back.  ``transport`` overrides ``_transport``'s choice
    (the CPU tests run the card's zero-split route on host tensors)."""
    tensors = [t.contiguous() for t in tensors]
    if not _live(axis):
        return _Pending([], tensors)
    n, i = axis.size, axis.index
    dst, src = (i + shift) % n, (i - shift) % n
    transport = transport or _transport(axis, tensors[0])
    outs = [torch.empty_like(t) for t in tensors]
    works = []
    if transport == "p2p":
        ops = []
        for t, o in zip(tensors, outs):
            ops.append(dist.P2POp(dist.isend, t, axis.ranks[dst],
                                  group=axis.group))
            ops.append(dist.P2POp(dist.irecv, o, axis.ranks[src],
                                  group=axis.group))
        works = dist.batch_isend_irecv(ops)
    else:
        for t, o in zip(tensors, outs):
            k = t.numel()
            send = [k if j == dst else 0 for j in range(n)]
            recv = [k if j == src else 0 for j in range(n)]
            works.append(dist.all_to_all_single(
                o.view(-1), t.view(-1), recv, send, group=axis.group,
                async_op=True))
    SEQ_BYTES["rotate"] += sum(t.numel() * t.element_size()
                               for t in tensors)
    return _Pending(works, outs)


class _SeqRotate(torch.autograd.Function):
    """One rotation by ``shift``; its backward rotates the gradient back
    by ``-shift`` (the transpose of ``ppermute``)."""

    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return rotate_start([x], axis, shift).wait()[0]

    @staticmethod
    def backward(ctx, g):
        return rotate_start([g], ctx.axis, -ctx.shift).wait()[0], None, None


def seq_rotate(x: torch.Tensor, axis: Optional[SeqAxis],
               shift: int = 1) -> torch.Tensor:
    """``x`` from seq index ``-shift`` (this rank's goes to ``+shift``),
    differentiable; ``x`` itself without a live axis."""
    if not _live(axis):
        return x
    return _SeqRotate.apply(x, axis, shift)


def _exchange(x: torch.Tensor, axis: SeqAxis) -> torch.Tensor:
    """``all_to_all_single`` of ``x``, whose dim 0 is the seq axis's
    size: chunk j goes to seq index j, and chunk j of the result came
    from seq index j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis.group)
    SEQ_BYTES["all_to_all"] += x.numel() * x.element_size() \
        * (axis.size - 1) // axis.size
    return out


class _SeqAllToAll(torch.autograd.Function):
    """The exchange; its backward is the same exchange of the gradient
    (chunk j back to where it came from: the transpose of
    ``all_to_all``)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _exchange(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.axis), None


def seq_all_to_all(x: torch.Tensor, axis: Optional[SeqAxis]
                   ) -> torch.Tensor:
    """``x`` [n, ...] laid out so that chunk j goes to seq index j ->
    [n, ...] whose chunk j came from seq index j, differentiable; ``x``
    itself without a live axis."""
    if not _live(axis):
        return x
    return _SeqAllToAll.apply(x, axis)


class _Psum(torch.autograd.Function):
    """All-reduce over ``group`` (then ``/ n``) in the forward; the
    backward scales the gradient by ``grad_scale`` and sums nothing."""

    @staticmethod
    def forward(ctx, x, group, n, grad_scale):
        ctx.grad_scale = grad_scale
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / n if n != 1 else out

    @staticmethod
    def backward(ctx, g):
        return g * ctx.grad_scale if ctx.grad_scale != 1 else g, \
            None, None, None


def psum_seq(x: torch.Tensor, axis: Optional[SeqAxis]) -> torch.Tensor:
    """``x`` summed over the seq axis (JAX's ``psum``): the backward
    passes the gradient as it is (the transpose of a ``psum`` whose
    result is replicated over the axis)."""
    if not _live(axis):
        return x
    return _Psum.apply(x, axis.group, 1, 1.0)


def pmean_seq(x: torch.Tensor, axis: Optional[SeqAxis]) -> torch.Tensor:
    """``x`` averaged over the seq axis (JAX's ``pmean``): the backward
    divides the gradient by the axis size (the transpose of ``psum``,
    then ``/ n``), as the classifier's pooled mean needs."""
    if not _live(axis):
        return x
    return _Psum.apply(x, axis.group, axis.size, 1.0 / axis.size)


@dataclasses.dataclass(frozen=True)
class TokenAxes:
    """The ranks a step's tokens shard over (JAX's ``aux_axes``: the
    data axis, and the seq axis under sequence parallelism): their
    group, how many, and the seq axis's size."""
    group: object
    size: int
    sp: int = 1


def token_axes(mesh: Mesh) -> Optional[TokenAxes]:
    """The mesh's token-sharding axes (None when one rank holds every
    token, or without a process group): data x seq, data x expert under
    sparse dispatch, else data."""
    n = mesh.shards * mesh.sp
    if n == 1 or mesh.token_group is None:
        return None
    return TokenAxes(mesh.token_group, n, mesh.sp)


def pmean_tokens(x: torch.Tensor, axes: Optional[TokenAxes],
                 grad: bool = True) -> torch.Tensor:
    """``x`` averaged over the token axes (JAX's ``pmean`` over
    ``aux_axes``).  ``grad=False`` is a plain mean (the balance loss's
    routing fractions, which carry no gradient).  With a gradient the
    backward is the transpose JAX's step takes: ``pmean`` transposes to
    ``g / (dp * sp)`` on each shard, and the implicit ``pvary`` that
    adds the replicated loss to the data-varying cost transposes to a
    sum over 'data' (x dp), so ``g / sp``; the step then sums the
    gradients over data x seq and divides by dp."""
    if axes is None:
        return x
    if not grad:
        out = x.detach().clone()
        dist.all_reduce(out, group=axes.group)
        return out / axes.size
    return _Psum.apply(x, axes.group, axes.size, 1.0 / axes.sp)


def shard_leaf(full: torch.Tensor, dim: Optional[int], mp: int,
               m: int) -> torch.Tensor:
    """Model shard ``m`` of ``mp`` of ``full`` along ``dim`` (a copy;
    ``full`` itself when ``dim`` is None)."""
    if dim is None or mp == 1:
        return full
    return full.chunk(mp, dim=dim)[m].clone()


def gather_leaf(local: torch.Tensor, dim: Optional[int], group,
                mp: int) -> torch.Tensor:
    """The full leaf from every model shard: one all-gather over the
    model group ``group``, concatenated on ``dim`` (``local`` itself
    when it is not split)."""
    if dim is None or mp == 1 or group is None:
        return local
    flat = local.detach().contiguous().reshape(-1)
    out = flat.new_empty(mp * flat.numel())
    cluster.all_gather_flat(out, flat, group=group)
    return torch.cat(list(out.view(mp, *local.shape)), dim=dim)


def seq_columns(mesh: Mesh, length: int) -> slice:
    """The token columns of a ``[B, length]`` batch this rank takes:
    the seq index's contiguous block (JAX's ``P('data', 'seq')``)."""
    if length % mesh.sp:
        raise ValueError(f"{length} columns do not split over "
                         f"sequence_parallel={mesh.sp}")
    w = length // mesh.sp
    return slice(mesh.seq_index * w, (mesh.seq_index + 1) * w)


def batch_layout(mesh: Mesh, global_batch: int) -> slice:
    """The rows of a global batch this rank takes: the batch splits over
    the data axis into dp equal blocks, and the rank at data index d
    takes block d (the model ranks of one data index share it, and the
    seq and the dense dispatch's expert ranks too), as JAX's
    ``P('data')`` gives device r its block; under ``sites`` it splits
    over ``sites x dp`` shards (``P(('site', 'data'))``), the rank at
    site s and data index d taking shard ``s * dp + d``; under sparse
    dispatch over ``dp x ep`` (``P(('data', 'expert'))``), the rank at
    data index d and expert index x taking shard ``d * ep + x``."""
    shards = mesh.sites * mesh.shards
    if global_batch % shards:
        over = (f"sites={mesh.sites} x " if mesh.sites > 1 else "")
        ep = (f" x expert_parallel={mesh.ep}" if mesh.ep_tokens else "")
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{over}data_parallel={mesh.dp}{ep}")
    b = global_batch // shards
    i = mesh.site_index * mesh.shards + mesh.shard_index
    return slice(i * b, (i + 1) * b)


# ---------------------------------------------------------------------------
# the expert axis's collectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExpertAxis:
    """The expert axis as the MoE blocks see it (JAX's ``expert_axis``
    name inside ``shard_map``): its group (None: no process group, every
    collective the identity), its size and this rank's index on it."""
    group: object
    size: int
    index: int


def expert_axis(mesh: Mesh) -> Optional[ExpertAxis]:
    """The mesh's expert axis, or None at ``ep`` 1."""
    if mesh.ep == 1:
        return None
    return ExpertAxis(mesh.expert_group, mesh.ep, mesh.expert_index)


# bytes this process posted to the expert axis's collectives (the
# tensors handed to them, not what the transport moved): "all_to_all"
# the sparse dispatch's exchanges, "psum"/"copy" the dense dispatch's
# all-reduces; read and zeroed by the code that measures a run
EP_BYTES = {"all_to_all": 0, "psum": 0, "copy": 0}


def expert_psum(x: torch.Tensor, axis: Optional[ExpertAxis]) -> torch.Tensor:
    """The local experts' partial outputs summed over the expert axis
    (``x`` itself without a live axis)."""
    if not _live(axis):
        return x
    return _GroupPsum.apply(x, axis.group, "psum")


def expert_copy(x: torch.Tensor, axis: Optional[ExpertAxis]) -> torch.Tensor:
    """A value replicated over the expert axis entering this rank's
    experts: its gradient is summed over the axis (``x`` itself without
    a live axis)."""
    if not _live(axis):
        return x
    return _GroupCopy.apply(x, axis.group, "copy")


def _exchange_experts(x: torch.Tensor, axis: ExpertAxis) -> torch.Tensor:
    """``all_to_all_single`` of ``x`` ``[ep, ...]``: chunk j goes to
    expert index j, and chunk j of the result came from expert index
    j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis.group)
    EP_BYTES["all_to_all"] += x.numel() * x.element_size()
    return out


def _dispatch(buf: torch.Tensor, axis: ExpertAxis) -> torch.Tensor:
    """``[E, C, d]`` -> ``[El, ep * C, d]``: expert group j (experts
    ``[j * El, (j + 1) * El)``) goes to expert index j; each rank gets
    its experts' rows from every shard, shard j's at ``[j * C, (j + 1)
    * C)`` of the capacity axis (JAX's ``all_to_all(split_axis=0,
    concat_axis=2, tiled=True)``)."""
    e, c, d = buf.shape
    ep = axis.size
    got = _exchange_experts(buf.reshape(ep, e // ep, c, d), axis)
    return got.transpose(0, 1).reshape(e // ep, ep * c, d)


def _combine(h: torch.Tensor, axis: ExpertAxis) -> torch.Tensor:
    """``[El, ep * C, d]`` -> ``[E, C, d]``: capacity block j goes back
    to expert index j, which gets its tokens' rows from every expert
    group in expert order (JAX's ``all_to_all(split_axis=1,
    concat_axis=0, tiled=True)``)."""
    el, n, d = h.shape
    ep = axis.size
    send = h.reshape(el, ep, n // ep, d).transpose(0, 1)
    return _exchange_experts(send, axis).reshape(ep * el, n // ep, d)


class _ExpertAllToAll(torch.autograd.Function):
    """The dispatch (``reverse`` False) or the combine; the backward of
    each is the other (the transpose of a tiled ``all_to_all`` is the
    ``all_to_all`` with the split and concat axes swapped)."""

    @staticmethod
    def forward(ctx, x, axis, reverse):
        ctx.axis, ctx.reverse = axis, reverse
        return (_combine if reverse else _dispatch)(x, axis)

    @staticmethod
    def backward(ctx, g):
        back = _dispatch if ctx.reverse else _combine
        return back(g, ctx.axis), None, None


def expert_all_to_all(x: torch.Tensor, axis: Optional[ExpertAxis],
                      reverse: bool = False) -> torch.Tensor:
    """The sparse dispatch's exchange over the expert axis,
    differentiable: ``[E, C, d]`` (this shard's capacity buffers) ->
    ``[El, ep * C, d]`` (this rank's experts' rows from every shard), or
    with ``reverse`` back; ``x`` itself without a live axis."""
    if not _live(axis):
        return x
    return _ExpertAllToAll.apply(x, axis, reverse)


# ---------------------------------------------------------------------------
# the stage axis's hops
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageAxis:
    """The stage axis as the pipeline schedules see it (JAX's
    ``stage_axis`` name inside ``shard_map``): its group (None: no
    process group), its size, this rank's stage index and the global
    ranks of the group in stage order."""
    group: object
    size: int
    index: int
    ranks: tuple


def stage_axis(mesh: Mesh) -> Optional[StageAxis]:
    """The mesh's stage axis, or None at ``pp`` 1."""
    if mesh.pp == 1:
        return None
    step = mesh.sp * mesh.ep * mesh.mp
    base = mesh.rank - mesh.stage_index * step
    return StageAxis(mesh.stage_group, mesh.pp, mesh.stage_index,
                     tuple(base + s * step for s in range(mesh.pp)))


# bytes this process posted to the stage hops ("fwd": activations to the
# next stage, "bwd": gradients to the previous one; the tensors handed to
# the transport), read and zeroed by the code that measures a run
PP_BYTES = {"fwd": 0, "bwd": 0}


def stage_hop_start(send: Optional[torch.Tensor], recv_like, axis: StageAxis,
                    reverse: bool = False, transport: str = "p2p",
                    device=None) -> _Pending:
    """Post one stage hop (JAX's ``_hop_start``: a ``ppermute`` over the
    stage axis; ``wait()`` on the result is ``_hop_join``): ``send`` (or
    None) goes to the next stage (the previous one under ``reverse``:
    the gradient hop), and a buffer shaped like ``recv_like`` (or None)
    is received from the previous (next) stage; the stage index wraps,
    so the interleaved schedule's chunk wrap ``p - 1 -> 0`` is one more
    hop.  Only the live pairs move data: the schedule tells every rank
    which stage sends, so each passes what it sends and receives.
    ``transport`` (``stage_hop_transport``): ``"p2p"``
    (``batch_isend_irecv``; nothing posted without a pair) or ``"a2a"``
    (an ``all_to_all_single`` on ``device`` whose splits are 0 but the
    neighbours', a collective over the stage group: every rank of the
    group posts every hop, in the same order, and a side with nothing to
    move sends or receives a one-element placeholder, so no rank hands
    gloo an empty buffer).  Returns at once; ``wait()`` gives ``[the
    received tensor or None]``.  ``PP_BYTES`` counts the payloads."""
    n, i = axis.size, axis.index
    shift = -1 if reverse else 1
    dst, src = (i + shift) % n, (i - shift) % n
    if send is not None:
        send = send.contiguous()
        PP_BYTES["bwd" if reverse else "fwd"] += (send.numel()
                                                  * send.element_size())
    out = (torch.empty(recv_like.shape, dtype=recv_like.dtype,
                       device=recv_like.device)
           if recv_like is not None else None)
    if transport == "p2p":
        ops = []
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send, axis.ranks[dst],
                                  group=axis.group))
        if out is not None:
            ops.append(dist.P2POp(dist.irecv, out, axis.ranks[src],
                                  group=axis.group))
        return _Pending(dist.batch_isend_irecv(ops) if ops else [], [out])
    like = send if send is not None else out
    dtype = like.dtype if like is not None else torch.float32
    s_buf = (send.view(-1) if send is not None
             else torch.zeros(1, dtype=dtype, device=device))
    r_buf = (out.view(-1) if out is not None
             else torch.empty(1, dtype=dtype, device=device))
    send_n = [s_buf.numel() if j == dst else 0 for j in range(n)]
    recv_n = [r_buf.numel() if j == src else 0 for j in range(n)]
    work = dist.all_to_all_single(r_buf, s_buf, recv_n, send_n,
                                  group=axis.group, async_op=True)
    return _Pending([work], [out])


def stage_hop_transport(axis: StageAxis, device) -> str:
    """The route every rank of the stage group takes for a hop of
    tensors on ``device``: the zero-split ``all_to_all_single`` for gloo
    on the card, where a rank with nothing to move still posts."""
    if torch.device(device).type == "cuda" \
            and dist.get_backend(axis.group) == "gloo":
        return "a2a"
    return "p2p"


def stage_psum(x: torch.Tensor, axis: Optional[StageAxis]) -> torch.Tensor:
    """``x`` summed over the stage axis (JAX's ``psum`` over 'stage'):
    the backward passes the gradient as it is (the transpose of a
    ``psum`` whose result is replicated over the axis)."""
    if axis is None or axis.group is None:
        return x
    return _Psum.apply(x, axis.group, 1, 1.0)


def stage_all_reduce(t: torch.Tensor, mesh: Mesh) -> None:
    """Sum ``t`` in place over the stage axis (under pipeline
    parallelism, whenever a group exists)."""
    if mesh.pp > 1 and mesh.stage_group is not None:
        dist.all_reduce(t, group=mesh.stage_group)


__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "EXPERT_AXIS",
           "STAGE_AXIS", "SITE_AXIS", "Mesh", "build_mesh", "build_site_mesh",
           "build_seq_mesh", "build_expert_mesh", "sparse_ep_mode",
           "for_spec", "expert_sharded", "ExpertAxis", "expert_axis",
           "expert_psum", "expert_copy", "expert_all_to_all", "EP_BYTES",
           "SeqAxis", "seq_axis",
           "rotate_start", "seq_rotate", "seq_all_to_all", "psum_seq",
           "pmean_seq", "TokenAxes", "token_axes", "pmean_tokens",
           "seq_columns", "SEQ_BYTES",
           "model_axis", "data_all_reduce", "model_all_reduce",
           "site_mean", "world_all_reduce", "build_stage_mesh",
           "StageAxis", "stage_axis", "stage_hop_start",
           "stage_hop_transport", "stage_psum", "stage_all_reduce",
           "PP_BYTES",
           "groups", "uses_gloo", "model_psum", "model_copy", "tp_axis",
           "layer_styles", "param_pspecs", "state_pspecs", "shard_leaf",
           "gather_leaf", "batch_layout"]

"""The training loop (the JAX package's ``train/loop.py``), for the
MLP and the transformer.

``run(cfg)`` loads the data, builds the seeded train state on the card
(``cfg.device``; the CPU only when asked for) and trains
``training_epochs`` epochs on one of two paths:

- **the fast path** (the default; ``fast_loop``, the JAX gate): the
  device-resident epoch of ``parallel/epoch.py``.  Each rank's shard of
  the split is staged on the device once, each epoch is shuffled there
  with the JAX fast path's permutation, bit for bit, and the per-step costs
  and accuracies come back once per run, or once per epoch when
  ``--checkpoint_every`` asks for host control between epochs.  The
  MLP's step replays as a CUDA graph on the card; the transformer's
  runs eagerly.  The prints and summaries are made from the returned
  arrays, ``AvgTime`` from the run's (or the epoch's) wall over its
  steps;
- **the host path** (``--no_fast_loop``, ``--zero_opt``,
  ``--ckpt_every`` or ``--resume=auto``): ``EpochIterator`` batches from
  one persistent producer thread (``data/prefetch.EpochPrefetcher``),
  each rank taking its rows of the global batch, one step per batch,
  under ``--device_prefetch`` committed ahead from pinned buffers on a
  copy stream; at most ``--dispatch_depth`` steps in flight before the
  host waits on the oldest, and the costs the summaries need fetched
  once per window.

Both print the reference's stdout byte for byte modulo the values:

    Variables initialized ...
    Step: N,  Epoch:  E,  Batch:   B of 550,  Cost: C,  AvgTime: T.TTms
    ...
    Test-Accuracy: A
    Total Time: S.SSs
    Final Cost: C
    done

write the ``cost``/``accuracy`` scalar summaries every step and the
graph record once (``--logs_path``; chief only unless
``--summaries_all_hosts``), evaluate the test split in chunks
(``step.eval_chunk_cap`` bounds a transformer's), for the lm objective
sample ``--sample_after`` sequences with the KV-cached decode into
``logs_path/samples.npz`` (routed as JAX's trainer routes them:
``generate_sharded`` on the Megatron shards under TP outside PP, FSDP
and local SGD, else ``generate_dp`` over the data axis and
``dp_samples_host``), save ``.npz`` checkpoints in the JAX
package's layouts (``--checkpoint_dir``, every ``--checkpoint_every``
steps, at epoch ends on the fast path, and at the end; one ``.npz``, or
``ckpt-N.shards/`` under ``--sharded_checkpoints``, written from a
background thread under ``--async_checkpoints``) and return the JAX
``run``'s result keys, ``"fast_loop"`` the path taken.

Data and tensor parallelism (``parallel/``): under a process group rank
r plays device r of the JAX package's one-process ``('data', 'model')``
mesh (``parallel/mesh.py``: data index ``r // mp``, model index ``r %
mp``), so dp x mp ranks train as JAX's ``--data_parallel=dp
--model_parallel=mp`` run; ``setup_strategy`` lays the state out for
the synchronous step (each rank its Megatron shards under
``--model_parallel``), ZeRO-1 (``--zero_opt``), FSDP (``--fsdp``, FSDP x
TP under both) or local SGD (``--sync_period K``, the async analog, at
``model_parallel`` 1), and the checkpoints keep JAX's layouts of each
(``utils/checkpoint.Layout``: the TP leaves and FSDP unsharded in one
file, the replicas stacked ``[dp, ...]``, ZeRO-1's slots ``[dp, chunk]``
or ``[mp, dp, chunk]``; under ``--sharded_checkpoints`` one rank a
distinct block writes it).  Multi-site local SGD (``--sites S
--inner_steps H``, ``parallel/local_sgd.py``) lays the ranks out as JAX's
``('site', 'data')`` mesh (site ``r // dp``, data index ``r % dp``) and
runs on the host path, one round a step: H inner steps of the
synchronous body over the site's data group, then the outer sync
across the sites (a ``round`` phase span a dispatch under
``--trace_spans``); the printed steps are rounds, and the checkpoints
stack the site copies ``[sites, ...]`` beside the outer state, with the
``sites``, ``outer_has_momentum`` and ``outer_quant_int8`` extras
resume checks, as JAX's do.  Sequence parallelism
(``--sequence_parallel N --sp_impl {ring,ulysses}``) lays the ranks out
as JAX's ``('data', 'seq'[, 'model'])`` mesh (data index ``r // (sp *
mp)``, seq index ``(r // mp) % sp``, model index ``r % mp``) and runs on
the host path, as JAX's gate sends it: each rank takes its data index's
rows and its seq index's token columns of every batch (train and
eval); the state is replicated over the seq axis, so the checkpoints
are those of the same run without it.  Expert parallelism
(``--expert_parallel N``, a MoE transformer) lays the ranks out as
JAX's ``('data', 'expert'[, 'model'])`` mesh (data index ``r // (ep *
mp)``, expert index ``(r // mp) % ep``, model index ``r % mp``) and runs
on the host path, as JAX's gate sends it: each rank holds its ``E / ep``
experts of every MoE block (and their optimizer slots; under
``--zero_opt`` its ``[chunk]`` rows of them), takes its data index's
rows of every batch (its ``data_index * ep + expert_index`` shard of
``dp * ep`` under sparse dispatch), and ``--sample_after`` gathers the
experts over the expert group before it decodes; the checkpoints hold
the whole expert leaves (ZeRO-1's slots of them ``[ep, dp, chunk]``),
as JAX's do.  Pipeline parallelism (``--pipeline_parallel P
--microbatches M [--virtual_stages V] [--pp_schedule {gpipe,1f1b}]``, the
transformer) lays the ranks out as JAX's ``('data', 'stage'[, 'seq' |
'expert'][, 'model'])`` mesh (``parallel/mesh.build_stage_mesh``) and
runs on the host path, as JAX's gate sends it: the state is the stacked
layout (``blk_*``, ``transformer.pipeline_train_state``), each rank its
stage's slice of the blocks (then its Megatron shards or its experts,
then ZeRO-1's rows), the checkpoints hold the global stacked leaves with
the ``pp_stages`` / ``pp_virtual`` extras (resume refuses another
``(stages, virtual)`` where the block order depends on it, with JAX's
message), the eval chunks split into ``batch shards x microbatches``,
and ``--sample_after`` gathers the blocks over the stage group and
unstacks them before it decodes.  ``preflight`` runs the flags' checks
and the layout's before any process group or data (the CLI exits 2 on
them).

Resilience (``resilience/``): ``--ckpt_every N`` hands the state to the
write-behind ``CheckpointWriter`` every N steps on the host path (on
the card the device-to-host copies go into pinned buffers without
waiting for the steps in flight; the writer waits on their event), and
installs the SIGTERM/SIGINT handler: at the next step's safe point the
loop lands one snapshot at the exact current step, drains the writer
and exits through ``Preempted`` (128 + signum).  ``--resume`` restores
the newest classic checkpoint (epoch granularity), falling forward to
the resilience store when there is none; ``--resume=auto`` restores the
newest valid snapshot and skips the batches of its epoch already done,
so the run continues bitwise as if never interrupted.  Preemptions,
snapshots and resumes land on ``<logs_path>/restarts.jsonl``, and under
``--trace_spans`` each checkpoint is a ``ckpt`` phase span.

Monitoring (``obs/``), as in the JAX trainer:

- ``--metrics``: ``<logs_path>/metrics.<proc>.jsonl``, one window row
  every ``--log_every`` steps on the host path (``WindowTimer``'s
  data_wait / h2d / dispatch / device_wait / ckpt / host split) and one
  an epoch on the fast path (``path: "fast"``, ``timing:
  "epoch_mean"``), with examples/s, tokens/s and MFU against the card's
  peak (``obs/flops``; null on the CPU), the ``compile`` event (the
  graph's warm-up and capture, kept out of the rows' step time), the
  chief's ``stragglers`` events over the heartbeats, and ``run_end``;
- ``--on_anomaly``: the step returns its non-finite flag and per-leaf
  counts; ``skip`` masks the update on the card (in the CUDA graph
  too), ``dump`` writes a flight dump and continues (both keep the
  fast path, judged post hoc over each epoch's costs), ``halt`` takes
  the host path, fetches the flags lazily and raises ``AnomalyError``;
- ``--flight``: the ring of the last ``--flight_steps`` steps, dumped to
  ``<logs_path>/flight/<proc>.json`` on a crash, a halt, an anomaly
  under ``dump`` or SIGUSR1, and the chief's ``flight/report.json``;
- ``--histograms``: per-leaf gradient and parameter norms and the
  learning rate as summaries every ``--log_every`` steps (host path);
- ``--profile`` / ``--profile_steps``: a ``torch.profiler`` capture
  written as a Chrome trace under ``<logs_path>/profile/``, the host
  phases as ``record_function`` and NVTX ranges; the chief dumps the
  first step's graph beside it (``utils/graph.py``, JAX's ``utils/hlo``
  dump): ``train_step.aten.txt``, and ``train_step.cudagraph.dot`` where
  the step is a captured CUDA graph;
- ``--status_port``: the status server over ``logs_path`` for the run's
  lifetime;
- ``--early_stop_patience``: the validation split after every epoch;
  ``--debug_nans``: the host path, ``FloatingPointError`` at the first
  non-finite loss or gradient, on every strategy (the synchronous,
  FSDP, local-SGD and site steps return the flag, reduced over every
  rank, so all ranks raise at one step).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import cluster
from ..config import (Config, validate_sequence_config,
                      validate_train_config)
from ..data import (CopyStreamCommit, DevicePrefetcher, EpochIterator,
                    EpochPrefetcher, load_datasets, pinned_batches, take)
from ..device import dtype_from_name, resolve_device
from ..models import transformer as tfm
from ..models.mlp import MLPSpec
from ..parallel import epoch as epoch_lib
from ..parallel import fsdp as fsdp_lib
from ..parallel import local_sgd as local_sgd_lib
from ..parallel import mesh as mesh_lib
from ..parallel import step as step_lib
from ..parallel import zero as zero_lib
from ..utils import checkpoint as ckpt_lib
from ..utils import graph as graph_lib
from ..utils import prng
from ..utils.sync import hard_sync
from ..utils.summary import (SummaryWriter, mlp_graph_nodes,
                             transformer_graph_nodes)
from .optim import make_optimizer
from .state import create_train_state


def make_spec(cfg: Config):
    """The model the flags describe (the JAX ``make_spec``): for the
    transformer, the lm objective tokenizes every input scalar
    (seq_len = input_size) and is causal, ``sigmoid`` (the reference
    default) runs as gelu, and ``--pallas`` selects flash attention."""
    if cfg.model == "transformer":
        lm = cfg.objective == "lm"
        return tfm.TransformerSpec(
            input_size=cfg.input_size,
            num_classes=cfg.num_classes,
            objective=cfg.objective,
            vocab_size=cfg.vocab_size,
            seq_len=cfg.input_size if lm else cfg.seq_len,
            d_model=cfg.d_model,
            n_heads=cfg.n_heads,
            num_blocks=cfg.num_blocks,
            d_ff=cfg.d_ff,
            activation=(cfg.activation if cfg.activation != "sigmoid"
                        else "gelu"),
            attention="flash" if cfg.pallas else cfg.attention,
            sp_impl=cfg.sp_impl,
            dropout_rate=cfg.dropout_rate,
            causal=True if lm else cfg.causal,
            num_experts=cfg.num_experts,
            moe_topk=cfg.moe_topk,
            moe_dispatch=cfg.moe_dispatch,
            capacity_factor=cfg.capacity_factor,
            aux_loss_weight=cfg.moe_aux_weight,
            fused_ln=cfg.fused_ln,
            grouped_moe=cfg.grouped_moe,
            fp8_ffn=cfg.fp8_ffn,
            param_dtype=dtype_from_name(cfg.param_dtype),
            compute_dtype=dtype_from_name(cfg.compute_dtype),
        )
    return MLPSpec(
        input_size=cfg.input_size,
        hidden_sizes=tuple(cfg.hidden_sizes),
        num_classes=cfg.num_classes,
        activation=cfg.activation,
        param_dtype=dtype_from_name(cfg.param_dtype),
        compute_dtype=dtype_from_name(cfg.compute_dtype),
    )


def _global_batch(cfg: Config, dp: int) -> int:
    """Round the global batch up to a multiple of the process count."""
    b = cfg.batch_size
    if b % dp:
        b = ((b + dp - 1) // dp) * dp
        print(f"NOTE: batch_size {cfg.batch_size} rounded up to {b} "
              f"(must divide data-parallel degree {dp})")
    return b


def _print_window(step: int, epoch: int, batch_i: int, batch_count: int,
                  cost: float, elapsed_time: float, frequency: int) -> None:
    """The reference's throughput print, byte for byte."""
    print("Step: %d," % (step + 1),
          " Epoch: %2d," % (epoch + 1),
          " Batch: %3d of %3d," % (batch_i + 1, batch_count),
          " Cost: %.4f," % cost,
          " AvgTime: %3.2fms" % float(elapsed_time * 1000 / frequency))


def _eval_accuracy(eval_step, params, images: np.ndarray,
                   labels: np.ndarray, chunk: int, device,
                   mesh: mesh_lib.Mesh, unit: Optional[int] = None) -> float:
    """Accuracy over a whole split, in chunks of ``chunk`` examples
    rounded down to a multiple of ``unit`` (default the batch shards: dp,
    dp x ep under sparse expert dispatch; under pipeline parallelism the
    shards x microbatches), at least one unit; the last chunk is
    zero-padded and masked, and each rank evaluates its rows of every
    chunk (the counts summed over the ranks), as in the JAX package;
    under sequence parallelism its token columns of them."""
    n = images.shape[0]
    unit = unit or mesh.shards
    chunk = max(unit, (min(chunk, n) // unit) * unit)
    rows = mesh_lib.batch_layout(mesh, chunk)
    images = images[:, mesh_lib.seq_columns(mesh, images.shape[1])]
    correct = 0.0
    for off in range(0, n, chunk):
        x = images[off: off + chunk]
        y = labels[off: off + chunk]
        valid = x.shape[0]
        if valid < chunk:
            pad = chunk - valid
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
            y = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
        mask = (np.arange(chunk) < valid).astype(np.float32)
        x, y, mask = x[rows], y[rows], mask[rows]
        correct += float(eval_step(params, torch.from_numpy(x).to(device),
                                   torch.from_numpy(y).to(device),
                                   torch.from_numpy(mask).to(device)))
    return correct / n


def _sample(cfg: Config, spec, params, images: np.ndarray, device,
            chief: bool, mesh: mesh_lib.Mesh, tp_decode: bool) -> None:
    """KV-cached decoding from the first test examples' opening
    ``seq_len // 8`` tokens (greedy at ``--sample_temperature`` 0), saved
    by the chief to ``logs_path/samples.npz`` as the JAX trainer saves
    them, routed as JAX's trainer routes them: under ``tp_decode``
    ``params`` are this rank's Megatron shards and every rank decodes
    the whole prompt set tensor-parallel (``generate_sharded``);
    otherwise ``params`` are whole and the prompts shard over the data
    axis (``generate_dp``), their rows gathered back on every rank
    (``dp_samples_host``)."""
    n_s = min(cfg.sample_after, images.shape[0])
    if not n_s:
        return
    prompt_len = max(1, spec.seq_len // 8)
    prompts = tfm.tokenize(spec, torch.from_numpy(images[:n_s]).to(
        device))[:, :prompt_len]
    sampled = cfg.sample_temperature > 0
    if tp_decode:
        gen = (torch.Generator(device=device).manual_seed(cfg.seed)
               if sampled else None)
        samples = tfm.generate_sharded(spec, params, prompts,
                                       mesh_lib.model_axis(mesh),
                                       generator=gen,
                                       temperature=cfg.sample_temperature)
    else:
        out, n = tfm.generate_dp(
            spec, params, prompts, mesh,
            generator_seed=cfg.seed if sampled else None,
            temperature=cfg.sample_temperature)
        samples = tfm.dp_samples_host(out, n, mesh)
    if chief:
        os.makedirs(cfg.logs_path, exist_ok=True)
        path = os.path.join(cfg.logs_path, "samples.npz")
        np.savez(path, samples=samples.cpu().numpy().astype(np.int32),
                 prompt_len=prompt_len, vocab_size=spec.vocab_size)
        print(f"Sampled {n_s} sequences -> {path}")


def tp_decode(cfg: Config, mesh: mesh_lib.Mesh) -> bool:
    """Whether ``--sample_after`` decodes tensor-parallel on the Megatron
    shards (``generate_sharded``), as JAX's trainer routes it: TP live
    and the run neither PP, FSDP nor local SGD (``--sites`` is not in
    the condition: it refuses TP); else ``generate_dp``."""
    return mesh.mp > 1 and not (mesh.pp > 1 or cfg.fsdp
                                or cfg.sync_period > 1)


def _gather_model(params: dict, spec, mesh: mesh_lib.Mesh,
                  pipeline: bool) -> dict:
    """``params`` with every leaf split over the model axis whole: this
    rank's Megatron shard all-gathered over the model group (the
    stacked layout's dims under ``pipeline``)."""
    dims = mesh_lib.param_pspecs(spec, mesh.mp, pipeline)
    return {k: mesh_lib.gather_leaf(v, dims.get(k), mesh.model_group,
                                    mesh.mp) for k, v in params.items()}


def _gather_stages(params: dict, spec, mesh: mesh_lib.Mesh,
                   virtual: int) -> dict:
    """The flat params from this rank's stacked ones: every ``blk_*``
    leaf all-gathered over the stage group (dim 0), then unstacked at
    the run's ``(stages, virtual)``."""
    full = {k: (mesh_lib.gather_leaf(v, 0, mesh.stage_group, mesh.pp)
                if k.startswith("blk_") else v) for k, v in params.items()}
    return tfm.pipeline_unstack_params(spec, full, mesh.pp, virtual)


def _gather_experts(params: dict, spec, mesh: mesh_lib.Mesh) -> dict:
    """``params`` with every expert leaf whole: this rank's experts
    all-gathered over the expert group (dim 0), the others as they
    are."""
    expert = mesh_lib.expert_sharded(spec, mesh.ep)
    return {k: (mesh_lib.gather_leaf(v, 0, mesh.expert_group, mesh.ep)
                if k in expert else v) for k, v in params.items()}


def _fetch(*tensors) -> list:
    """Device tensors to numpy with one device-to-host copy."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    host = flat.cpu().numpy()
    out, off = [], 0
    for t in tensors:
        out.append(host[off: off + t.numel()].reshape(t.shape))
        off += t.numel()
    return out


def _host_snapshot(state, dev) -> tuple:
    """``({key: CPU tensor}, ready)``: the state's leaves copied to the
    host for the snapshot writer.  On the card the copies go into pinned
    buffers with ``non_blocking`` copies on the compute stream, so the
    host does not wait for the steps in flight; ``ready`` is the CUDA
    event recorded after them, which the writer thread waits on.  The
    optimizer builds new tensors each step, so the leaves copied here
    are never written again.  On the CPU: plain copies, ``ready`` None."""
    leaves = ckpt_lib.flatten_state(state)
    if dev.type != "cuda":
        return {k: v.detach().clone() for k, v in leaves.items()}, None
    snap = {}
    for k, v in leaves.items():
        h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        h.copy_(v, non_blocking=True)
        snap[k] = h
    ready = torch.cuda.Event()
    ready.record()
    return snap, ready


def _reserve_host_buffers(state, dev, sets: int = 3) -> None:
    """Allocate and free ``sets`` sets of the pinned buffers
    ``_host_snapshot`` takes, so the caching host allocator holds them
    before the first snapshot: pinning 80 MB costs ~16 ms, which would
    otherwise land on the first snapshots' stall.  Three sets: the
    writer's pending and in-write snapshots and the one being filled."""
    if dev.type != "cuda":
        return
    held = [[torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
             for v in ckpt_lib.flatten_state(state).values()]
            for _ in range(sets)]
    del held


def _host_lr(cfg: Config, total_steps: int):
    """The host's mirror of ``make_optimizer``'s lr schedule: step
    (1-based) -> learning rate, for the ``--histograms`` summaries (the
    step on the card never exports its lr)."""
    from .optim import schedule_multiplier

    if cfg.lr_schedule == "constant" and not cfg.warmup_steps:
        return lambda step: float(cfg.learning_rate)
    mult = schedule_multiplier(cfg.lr_schedule, cfg.warmup_steps,
                               cfg.schedule_steps or total_steps,
                               cfg.lr_min_factor)
    return lambda step: float(cfg.learning_rate) * float(
        mult(torch.tensor(float(step), dtype=torch.float32)))


def _unshard_flat(data: dict, full_template, mp: int = 1,
                  tp_dims=None) -> dict:
    """FSDP's global ``[dp, chunk]`` (``[mp, dp, chunk]`` under TP,
    ``tp_dims`` naming each leaf's split dim) leaves of ``data`` back to
    the shapes of ``full_template`` (the others as they are)."""
    out = dict(data)
    for key, t in ckpt_lib.flatten_state(full_template).items():
        if fsdp_lib.is_sharded_leaf(t):
            out[key] = fsdp_lib.unshard_leaf(
                data[key], t, mp, tp_dims(key) if mp > 1 else None)
    return out


@dataclasses.dataclass
class Strategy:
    """A parallel strategy's layout of the train state on this rank and
    what runs it: ``body`` (the step; None = the synchronous one the
    fast path builds), ``get_params`` (the full params for eval and
    sampling; None = ``state.params``, this rank's shards under TP),
    ``layout`` (the blocks of the global checkpoint leaves this rank
    holds; None = every leaf whole), ``step_scale`` (printed steps per
    step: dp under local SGD, whose replicas each apply an update),
    ``sync_period`` (the runner's average every K steps; 0 = none),
    ``full_template`` (FSDP's full shapes) and ``tp_dims`` (flattened
    key -> the dim split over the model axis, under TP)."""
    state: Any
    body: Optional[Callable] = None
    get_params: Optional[Callable] = None
    layout: Optional[ckpt_lib.Layout] = None
    step_scale: int = 1
    sync_period: int = 0
    full_template: Any = None
    tp_dims: Optional[Callable] = None


def _tp_local(state, dims, mesh: mesh_lib.Mesh):
    """Each leaf's Megatron shard of this rank (``dims``: key -> split
    dim), from the full state every rank initialised alike."""
    return ckpt_lib.map_state(
        lambda k, a: mesh_lib.shard_leaf(a, dims(k), mesh.mp,
                                         mesh.model_index), state)


def setup_strategy(cfg: Config, spec, optimizer, state, mesh: mesh_lib.Mesh,
                   fast: bool, with_anomaly: bool = False) -> Strategy:
    """The strategy the flags name, from the full seeded ``state`` (the
    same on every rank): FSDP keeps this rank's ``[chunk]`` rows (of its
    model shard under TP), local SGD the rank's own replica, multi-site
    training its site's copy with the outer state beside it (one round
    a step), ZeRO-1 its ``[chunk]`` rows of the optimizer slots, the
    synchronous step the replicated state; under ``--model_parallel``
    every layout starts from this rank's Megatron shards, and under
    ``--expert_parallel`` from its experts of every expert leaf (dim 0
    of the param and each of its slots)."""
    dp, mp = mesh.dp, mesh.mp
    if mesh.sites > 1:
        outer = local_sgd_lib.outer_optimizer_from_config(cfg)
        return Strategy(
            state=local_sgd_lib.site_state(state, outer, cfg.outer_quant),
            body=local_sgd_lib.build_local_sgd_step(
                cfg, mesh, spec, optimizer, outer,
                with_anomaly=cfg.debug_nans),
            get_params=local_sgd_lib.build_site_unstack_params(mesh),
            layout=ckpt_lib.Layout(mesh, local_sgd_lib.site_block))
    d_idx, m_idx = mesh.data_index, mesh.model_index
    pipe = mesh.pp > 1
    dims = mesh_lib.state_pspecs(mesh_lib.param_pspecs(spec, mp, pipe))
    tp_dims = dims if mp > 1 else None
    if cfg.fsdp:
        full_template = fsdp_lib.shape_template(state)
        lead = ("model", "data") if mp > 1 else ("data",)
        return Strategy(
            state=fsdp_lib.local_rows(fsdp_lib.shard_state_host(
                state, dp, mp, tp_dims), d_idx, m_idx, mp),
            body=fsdp_lib.make_fsdp_step_body(
                cfg, spec, dp, optimizer, full_template, mp, mesh,
                with_anomaly=cfg.debug_nans),
            get_params=fsdp_lib.build_gather_params(full_template, mesh,
                                                    spec),
            layout=ckpt_lib.Layout(mesh, lambda k, a: (
                ckpt_lib.Block(lead) if fsdp_lib.is_sharded_leaf(a)
                else None)),
            full_template=full_template, tp_dims=tp_dims)
    if cfg.sync_period > 1:
        return Strategy(
            state=state,
            body=step_lib.make_local_step_body(
                cfg, spec, optimizer, host=not fast,
                with_anomaly=cfg.debug_nans),
            get_params=step_lib.consensus_params,
            layout=ckpt_lib.Layout(mesh, lambda k, a: (
                ckpt_lib.Block(("data",)) if k != ".step" else None)),
            step_scale=dp, sync_period=cfg.sync_period)
    # key -> 0 for a stacked blk_* leaf and its slots (split over the
    # stage axis), None otherwise
    sdims = mesh_lib.state_pspecs(
        {k: 0 for k in step_lib.stage_sharded_names(spec, mesh)})
    if pipe:
        state = tfm.pipeline_train_state(spec, optimizer, state, mesh.pp,
                                         cfg.virtual_stages)
        state = ckpt_lib.map_state(
            lambda k, a: mesh_lib.shard_leaf(a, sdims(k), mesh.pp,
                                             mesh.stage_index), state)
    if mp > 1:
        state = _tp_local(state, dims, mesh)
    # key -> the dim of an expert leaf and its slots split over the
    # expert axis (0; 1 in the stacked layout), None otherwise
    edims = mesh_lib.state_pspecs(
        {k: int(pipe) for k in mesh_lib.expert_sharded(spec, mesh.ep,
                                                        pipe)})
    if mesh.ep > 1:
        state = ckpt_lib.map_state(
            lambda k, a: mesh_lib.shard_leaf(a, edims(k), mesh.ep,
                                             mesh.expert_index), state)
    zero_dp = dp if cfg.zero_opt else 0
    if zero_dp:
        state.opt_state = zero_lib.zero_opt_state(optimizer, state.params,
                                                  dp)

    def block(key, leaf):
        stage = sdims(key)
        if zero_dp and key.startswith(".opt_state") \
                and fsdp_lib.is_sharded_leaf(leaf):
            # JAX's [|axis|, ..., dp, chunk] over the axes the param
            # splits on, in dim order
            lead = (("stage",) if stage is not None else ()) + (
                ("expert",) if edims(key) is not None
                else ("model",) if mp > 1 and dims(key) is not None
                else ())
            return ckpt_lib.Block(lead + ("data",))
        if edims(key) is not None:
            return ckpt_lib.Block(split=edims(key), axis="expert",
                                  stage_split=stage)
        if mp > 1 and dims(key) is not None:
            return ckpt_lib.Block(split=dims(key), stage_split=stage)
        if stage is not None:
            return ckpt_lib.Block(stage_split=stage)
        return None

    body = None if fast else step_lib.make_sync_step_body(
        cfg, spec, optimizer, with_norms=cfg.histograms,
        with_anomaly=with_anomaly, zero_dp=zero_dp, mesh=mesh)
    return Strategy(state=state, body=body,
                    layout=(ckpt_lib.Layout(mesh, block)
                            if zero_dp or mp > 1 or mesh.ep > 1 or pipe
                            else None),
                    tp_dims=tp_dims)


def train_mesh(cfg: Config, spec, world: Optional[int] = None,
               rank: Optional[int] = None) -> mesh_lib.Mesh:
    """The layout the flags name over ``world`` ranks (default: the
    process group's, with its groups), as JAX's trainer picks its mesh:
    ``('site', 'data')`` under ``--sites``, ``('data', 'stage'[,
    'seq' | 'expert'][, 'model'])`` under ``--pipeline_parallel``,
    ``('data', 'seq'[, 'model'])`` under ``--sequence_parallel``,
    ``('data', 'expert'[, 'model'])`` under ``--expert_parallel`` (its
    token sharding read from ``spec``'s dispatch), else ``('data',
    'model')``; the MLP's layer styles checked against its widths."""
    if cfg.sites > 1:
        mesh = mesh_lib.build_site_mesh(cfg.sites, cfg.data_parallel,
                                        world, rank)
    elif cfg.pipeline_parallel > 1:
        mesh = mesh_lib.build_stage_mesh(
            cfg.data_parallel, cfg.pipeline_parallel, world, rank,
            model_parallel=cfg.model_parallel,
            sequence_parallel=cfg.sequence_parallel,
            expert_parallel=cfg.expert_parallel)
    elif cfg.sequence_parallel > 1:
        mesh = mesh_lib.build_seq_mesh(
            cfg.data_parallel, cfg.sequence_parallel, world, rank,
            model_parallel=cfg.model_parallel)
    elif cfg.expert_parallel > 1:
        mesh = mesh_lib.build_expert_mesh(
            cfg.data_parallel, cfg.expert_parallel, world, rank,
            model_parallel=cfg.model_parallel)
    else:
        mesh = mesh_lib.build_mesh(cfg.data_parallel, cfg.model_parallel,
                                   world, rank)
    mesh_lib.layer_styles(spec, mesh.mp)
    return mesh_lib.for_spec(mesh, spec)


def preflight(cfg: Config):
    """The checks ``run`` makes before it joins a process group or
    loads data, JAX's messages (ValueError): the flags' values and
    combinations, TP's and SP's degrees against the model, and the
    layout against the world the flags describe (the process group's,
    else ``--num_processes`` under a coordinator, else one).  Returns
    the model spec."""
    validate_train_config(cfg)
    spec = make_spec(cfg)
    if cfg.model == "transformer" and cfg.model_parallel > 1:
        tfm.check_tp(spec, cfg.model_parallel)
    validate_sequence_config(cfg, getattr(spec, "seq_len", cfg.seq_len))
    if cluster.collectives():
        world, rank = cluster.process_count(), cluster.process_index()
    elif cfg.coordinator_address:
        world, rank = cfg.num_processes, cfg.task_index
    else:
        world, rank = 1, 0
    train_mesh(cfg, spec, world, rank)
    return spec


def run(cfg: Config) -> Dict[str, Any]:
    """Train per the config; returns the metrics the reference prints
    (the JAX ``run``'s result keys)."""
    spec = preflight(cfg)
    dev = resolve_device(cfg.device)
    owns_group = cluster.bootstrap(cfg)
    writer = None
    # handles bound before the try, so its except and finally can always
    # reach them
    ckpt_writer = None
    preempt_handler = None
    span_recorder = None
    status_server = None
    mlogger = None
    flight = None
    tracer = None
    try:
        proc_idx = cluster.process_index()
        proc_cnt = cluster.process_count()
        chief = proc_idx == 0
        # rank r plays device r of JAX's one-process mesh
        site_mode = cfg.sites > 1
        mesh = train_mesh(cfg, spec)
        dp = mesh.dp
        # the shards the global batch splits over: site x data (x expert
        # under sparse expert dispatch)
        batch_shards = mesh.sites * mesh.shards
        # eval reads the consensus params and splits its chunks over
        # every rank: under --sites a data axis over the world
        eval_mesh = mesh_lib.build_mesh(-1) if site_mode else mesh

        # run-start hygiene: a reused logs_path must not leak an older
        # run's heartbeats and flight dumps into this run's straggler
        # reports and post-mortems; a --resume relaunch continues the
        # same run and keeps the preempted attempt's (obs/heartbeat.py)
        if chief and (cfg.metrics or cfg.flight or cfg.on_anomaly
                      or cfg.status_port):
            from ..obs.heartbeat import clear_stale_signals

            clear_stale_signals(cfg.logs_path, resuming=bool(cfg.resume))
        # --status_port: /status, /metrics and /report over the files in
        # logs_path (obs/serve.py), a pure reader; closed in the finally
        if cfg.status_port and chief:
            from ..obs.serve import StatusServer

            status_server = StatusServer(cfg.logs_path,
                                         cache_ttl_s=cfg.status_cache_s)
            port = status_server.start(cfg.status_port)
            if port:
                print(f"Status server on port {port} "
                      f"(/status /metrics /report)")
        # the restart timeline (<logs_path>/restarts.jsonl): preemptions,
        # snapshots and resumes, whenever the resilience path is on
        restart_narrator = None
        if cfg.ckpt_every or cfg.resume == "auto":
            from ..resilience.restart import RestartNarrator

            restart_narrator = RestartNarrator(cfg.logs_path,
                                               process_index=proc_idx)
        # --trace_spans: a ckpt phase span per checkpoint on
        # spans.<proc>.jsonl, every row under one run-level trace id
        run_trace_id = None
        if cfg.trace_spans:
            from ..obs.spans import SpanRecorder, new_trace_id

            span_recorder = SpanRecorder(
                cfg.logs_path, process_index=proc_idx,
                rotate_bytes=int(cfg.span_rotate_mb * 1024 * 1024),
                keep=cfg.span_keep)
            run_trace_id = new_trace_id()

        def phase_span(name: str, t0: float, **fields) -> None:
            """One phase span: the host wall since ``t0`` under the
            run's trace id; a no-op without --trace_spans."""
            if span_recorder is not None:
                span_recorder.emit(
                    "phase", phase=name, trace_id=run_trace_id,
                    dur_ms=round((time.perf_counter() - t0) * 1e3, 3),
                    **fields)

        dataset = load_datasets(
            cfg.data_dir, cfg.dataset, seed=0,
            synthetic_train_size=cfg.synthetic_train_size,
            synthetic_test_size=cfg.synthetic_test_size,
            mirrors=cfg.mnist_mirrors, input_size=cfg.input_size)
        global_batch = _global_batch(cfg, batch_shards)
        total_steps = cfg.training_epochs * max(
            1, dataset.train.images.shape[0] // global_batch)
        optimizer = make_optimizer(cfg, total_steps)

        # the wall spent outside the per-window buckets, on the run_end
        # event, so obs/aggregate.py's decomposition sums to the wall
        phase_s = {"compile": 0.0, "eval": 0.0, "sample": 0.0}

        # --metrics: the per-process JSONL stream and heartbeat; MFU
        # from obs/flops against the card's own peak (null on the CPU)
        heartbeat = None
        metrics_row = None
        straggler_event = None
        if cfg.metrics:
            from ..obs import flops as flops_lib
            from ..obs import heartbeat as hb_lib
            from ..obs.metrics import MetricsLogger

            mlogger = MetricsLogger(cfg.logs_path, process_index=proc_idx,
                                    device=dev)
            heartbeat = hb_lib.Heartbeat(cfg.logs_path,
                                         process_index=proc_idx)
            telemetry_start = time.time()
            flops_step = flops_lib.model_flops_per_step(spec, global_batch)
            peak = flops_lib.chip_peak_flops(dev)
            toks = flops_lib.tokens_per_example(spec)

            def metrics_row(step: int, epoch: int, cost: float,
                            timing: Dict[str, Any]) -> None:
                """One window row: identity + timing + throughput/MFU."""
                row: Dict[str, Any] = dict(step=int(step), epoch=int(epoch),
                                           cost=cost, **timing)
                wall = timing.get("window_wall_s") or 0.0
                steps_n = timing.get("steps") or 0
                sps = steps_n / wall if wall > 0 and steps_n else None
                row["examples_per_sec"] = (round(sps * global_batch, 3)
                                           if sps else None)
                row["tokens_per_sec"] = (round(sps * global_batch * toks, 1)
                                         if sps and toks else None)
                row["model_flops_per_step"] = flops_step
                row["tflops_per_sec"] = (round(flops_step * sps / 1e12, 5)
                                         if sps else None)
                m = (flops_lib.mfu(flops_step, sps, peak, mesh.devices)
                     if sps else None)
                row["mfu"] = round(m, 6) if m is not None else None
                mlogger.log_window(**row)

            narrated_dead: set = set()

            def straggler_event(epoch: int) -> None:
                """The chief's straggler report over the heartbeats of
                this attempt; a peer newly silent past the threshold
                lands on the restart timeline once."""
                if not chief:
                    return
                mlogger.log_event(
                    "stragglers", epoch=int(epoch),
                    **hb_lib.straggler_report(cfg.logs_path,
                                              since=telemetry_start))
                if restart_narrator is not None and proc_cnt > 1:
                    from ..resilience.restart import dead_procs

                    dead = set(dead_procs(
                        hb_lib.read_heartbeats(cfg.logs_path),
                        since=telemetry_start)) - {proc_idx}
                    fresh = sorted(dead - narrated_dead)
                    narrated_dead.clear()
                    narrated_dead.update(dead)
                    if fresh:
                        restart_narrator.emit("dead_proc",
                                              epoch=int(epoch), dead=fresh)

        # failure forensics: the windowed profiler, the --on_anomaly
        # policy and the flight recorder; the except below dumps the
        # flight record on any failure, the finally stops the trace
        from ..obs import anomaly as anomaly_lib
        from ..obs import flight as flight_lib
        from ..obs import tracer as tracer_lib

        profile_window = tracer_lib.parse_profile_steps(cfg.profile_steps)
        tracer = tracer_lib.WindowedTracer(
            cfg.logs_path, window=profile_window, whole_run=cfg.profile,
            enabled=chief)
        if cfg.flight or cfg.on_anomaly:
            flight = flight_lib.FlightRecorder(
                cfg.logs_path, process_index=proc_idx,
                capacity=cfg.flight_steps, config=dataclasses.asdict(cfg))
            flight.install()
        policy = None
        if cfg.on_anomaly:
            policy = anomaly_lib.AnomalyPolicy(
                cfg.on_anomaly, leaf_names=step_lib.leaf_names(
                    spec, mesh.pp > 1),
                flight=flight, mlogger=mlogger,
                watchdog=anomaly_lib.LossWatchdog(
                    factor=cfg.anomaly_factor))

        if site_mode:
            # one step = one round: the rank's rows split into H
            # inner-step chunks (grad_accum splits each chunk further)
            per_shard = global_batch // batch_shards
            if per_shard % cfg.inner_steps:
                raise ValueError(
                    f"per-shard batch {per_shard} must divide into "
                    f"inner_steps={cfg.inner_steps} chunks (global "
                    f"batch {global_batch} over {batch_shards} "
                    f"site x data shards)")
            if (per_shard // cfg.inner_steps) % cfg.grad_accum:
                raise ValueError(
                    f"per-shard inner-step batch "
                    f"{per_shard // cfg.inner_steps} must divide into "
                    f"grad_accum={cfg.grad_accum} microbatches")
        pp_mode = mesh.pp > 1
        if pp_mode:
            # the schedule sees one grad-accum chunk at a time, split
            # into the microbatches (JAX's checks)
            per_shard = global_batch // batch_shards
            if per_shard % cfg.grad_accum:
                raise ValueError(
                    f"per-shard batch {per_shard} must divide into "
                    f"grad_accum={cfg.grad_accum}")
            if (per_shard // cfg.grad_accum) % cfg.microbatches:
                raise ValueError(
                    f"per-shard batch {per_shard // cfg.grad_accum} (after "
                    f"grad_accum={cfg.grad_accum}) must divide into "
                    f"microbatches={cfg.microbatches}")
        async_mode = cfg.sync_period > 1
        fsdp_mode = cfg.fsdp
        # the modes whose state needs get_params() before eval and
        # sampling (replicas, shards or site copies)
        unstack_mode = async_mode or fsdp_mode or site_mode
        # the JAX gate, each rank playing one device of the mesh: every
        # rank needs its own shard of the split (shard_data or dp == 1);
        # the resilience snapshots ride the host path's per-step safe
        # point, and --resume=auto's in-epoch skip needs the host feed;
        # --histograms fetches the step's norms a window, halt must stop
        # inside the epoch, and --debug_nans at the step; ZeRO-1's flat
        # slots are a host-path feature; the async run is one device
        # program, with no host control for periodic checkpoints or
        # early stopping (dump and skip compose with the fast path); a
        # multi-site round is one host-path step, and the seq axis's
        # token columns and the expert axis's sharded state are fed from
        # the host, as in JAX
        fast = (cfg.fast_loop and (cfg.shard_data or dp == 1)
                and not cfg.ckpt_every and cfg.resume != "auto"
                and not cfg.histograms and cfg.on_anomaly != "halt"
                and not cfg.debug_nans and not cfg.zero_opt
                and not site_mode and mesh.sp == 1 and mesh.ep == 1
                and not pp_mode
                and not (async_mode and (cfg.checkpoint_every
                                         or cfg.model_parallel > 1
                                         or cfg.early_stop_patience)))

        # the same seeded init on every rank: no broadcast needed
        state = create_train_state(spec, optimizer, seed=cfg.seed,
                                   device=dev)
        strat = setup_strategy(cfg, spec, optimizer, state, mesh, fast,
                               with_anomaly=(policy is not None
                                             or cfg.debug_nans))
        state, train_body = strat.state, strat.body
        full_template, layout = strat.full_template, strat.layout
        get_params, step_scale = strat.get_params, strat.step_scale
        print("Variables initialized ...")

        start_epoch = 0
        resume_skip = 0     # --resume=auto: batches of start_epoch done
        resumed_extras: dict = {}
        if cfg.resume and cfg.checkpoint_dir:
            from ..resilience import resume as resume_lib

            path, plan, flat = None, None, None
            if cfg.resume == "auto":
                # the resilience store's newest restorable snapshot; with
                # none, the classic formats
                found = resume_lib.auto_resume(cfg.checkpoint_dir)
                if found is not None:
                    plan, flat = found
                    path = plan.root_path
            if path is None:
                path = ckpt_lib.latest_checkpoint(cfg.checkpoint_dir)
            if path is None and cfg.resume != "auto" and not fsdp_mode:
                # a bare --resume over a store only --ckpt_every filled
                # must not start from scratch: fall forward to it
                found = resume_lib.auto_resume(cfg.checkpoint_dir)
                if found is not None:
                    if found[0].batches_done and fast:
                        raise ValueError(
                            f"checkpoint {found[0].root_path} resumes "
                            f"mid-epoch (+{found[0].batches_done} "
                            f"batches): use --resume=auto (the "
                            f"exact-step path) instead of bare "
                            f"--resume")
                    plan, flat = found
                    path = plan.root_path
            if path:
                resumed_extras = (dict(plan.extras) if plan is not None
                                  else ckpt_lib.load_extras(path))
                if pp_mode:
                    # the stacked block order is pinned to (stages,
                    # virtual) once virtual > 1; the shapes match across
                    # layouts, so a mismatch is refused (JAX's check)
                    sv = int(resumed_extras.get("pp_virtual", 1))
                    sp = int(resumed_extras.get("pp_stages",
                                                cfg.pipeline_parallel))
                    if (sv != cfg.virtual_stages
                            or (sv > 1 and sp != cfg.pipeline_parallel)):
                        raise ValueError(
                            f"checkpoint {path} was written with pipeline "
                            f"layout (stages={sp}, virtual={sv}): resuming "
                            f"needs the same --virtual_stages (and the "
                            f"same --pipeline_parallel when virtual > 1) — "
                            f"the stacked block order is pinned to that "
                            f"layout")
                if site_mode or "sites" in resumed_extras:
                    # the [sites] axis and the outer-state tree are
                    # pinned: a mismatch is refused with the flag to
                    # change, as in JAX
                    saved_sites = int(resumed_extras.get("sites", 0))
                    saved_m = int(resumed_extras.get(
                        "outer_has_momentum", 0))
                    want_m = int(site_mode
                                 and cfg.outer_optimizer == "nesterov"
                                 and cfg.outer_momentum > 0)
                    saved_q = int(resumed_extras.get(
                        "outer_quant_int8", 0))
                    want_q = int(site_mode and cfg.outer_quant == "int8")
                    if (saved_sites != (cfg.sites if site_mode else 0)
                            or saved_m != want_m or saved_q != want_q):
                        raise ValueError(
                            f"checkpoint {path} was written with "
                            f"sites={saved_sites}, outer momentum "
                            f"state={'yes' if saved_m else 'no'}, "
                            f"outer_quant="
                            f"{'int8' if saved_q else 'off'}: "
                            f"resume needs the same --sites, a "
                            f"momentum-compatible --outer_optimizer/"
                            f"--outer_momentum and the same "
                            f"--outer_quant (the error-feedback "
                            f"residual is part of the state tree; "
                            f"this run: sites="
                            f"{cfg.sites if site_mode else 0}, "
                            f"momentum state="
                            f"{'yes' if want_m else 'no'}, "
                            f"outer_quant="
                            f"{'int8' if want_q else 'off'})")
                saved_zdp = int(resumed_extras.get("zero_dp", 0))
                if saved_zdp != (dp if cfg.zero_opt else 0):
                    raise ValueError(
                        f"checkpoint {path} was written with "
                        f"zero_dp={saved_zdp} (ZeRO-1 flat slots are "
                        f"dp-shaped): resume needs the same --zero_opt "
                        f"setting and data-parallel degree (this run: "
                        f"{dp if cfg.zero_opt else 0})")
                if plan is not None:
                    state = ckpt_lib.rebuild_tree_validated(
                        ckpt_lib.take_local(flat, state, layout),
                        state, ckpt_path=path)
                    start_epoch, resume_skip = plan.epoch, plan.batches_done
                    print(f"Resumed from {path} at epoch {start_epoch} "
                          f"step {plan.step} (+{resume_skip} in-epoch "
                          f"batches)")
                    if restart_narrator is not None and chief:
                        restart_narrator.emit(
                            "resumed", step=int(plan.step),
                            epoch=int(start_epoch),
                            batches_done=int(resume_skip))
                else:
                    data, _, start_epoch = ckpt_lib.restore_arrays(path)
                    if fsdp_mode:
                        # a sharded FSDP checkpoint holds the saved run's
                        # flat [(mp_old,) dp_old, chunk] leaves, a single
                        # file the full ones: unshard at the saved degree,
                        # then re-shard for this (dp, mp)
                        if os.path.isdir(path):
                            mp_old = int(resumed_extras.get("fsdp_mp", 1))
                            data = _unshard_flat(
                                data, full_template, mp_old,
                                mesh_lib.state_pspecs(mesh_lib.param_pspecs(
                                    spec, mp_old)))
                        full = ckpt_lib.rebuild_tree_validated(
                            data, full_template, ckpt_path=path)
                        data = ckpt_lib.flatten_state(fsdp_lib.local_rows(
                            fsdp_lib.shard_state_host(
                                full, dp, mesh.mp, strat.tp_dims),
                            mesh.data_index, mesh.model_index, mesh.mp))
                    else:
                        data = ckpt_lib.take_local(data, state, layout)
                    state = ckpt_lib.rebuild_tree_validated(data, state,
                                                            ckpt_path=path)
                    print(f"Resumed from {path} at epoch {start_epoch}")

        if cfg.summaries and (chief or cfg.summaries_all_hosts):
            writer = SummaryWriter(cfg.logs_path)
            if cfg.model == "transformer":
                writer.add_graph(transformer_graph_nodes(cfg.num_blocks))
            else:
                writer.add_graph(mlp_graph_nodes(
                    cfg.input_size, tuple(cfg.hidden_sizes),
                    cfg.num_classes, cfg.activation,
                    optimizer=cfg.optimizer))

        # whole-run --profile starts here; --profile_steps windows open
        # at their step.  Either way the finally stops the capture
        tracer.begin_run()
        # and the chief dumps the first step's graph beside the trace
        # (utils/graph.py, JAX's utils/hlo dump): the fast path's first
        # step (its capture on the MLP's graph path), or the host path's
        graph_dump = (graph_lib.GraphDump(cfg.logs_path)
                      if chief and (cfg.profile or profile_window is not None)
                      else None)

        # --early_stop_patience: the validation split after every epoch;
        # best_val and val_wait ride the checkpoints' extras, so a
        # resumed run replays the same early-stop trajectory
        early = cfg.early_stop_patience > 0
        best_val = float(resumed_extras.get("best_val", -1.0))
        val_wait = int(resumed_extras.get("val_wait", 0))
        eval_step = None            # the host path's, built once

        def host_eval_accuracy(params, images, labels) -> float:
            nonlocal eval_step
            if eval_step is None:
                eval_step = step_lib.build_eval_step(cfg, spec,
                                                     mesh=eval_mesh)
            t0 = time.perf_counter()
            try:
                with tracer.annotate("eval"):
                    unit = (batch_shards * cfg.microbatches if pp_mode
                            else batch_shards)
                    return _eval_accuracy(
                        eval_step, params, images, labels,
                        max(step_lib.eval_chunk_cap(
                            spec, cfg.eval_batch_size), unit),
                        dev, eval_mesh, unit=unit)
            finally:
                phase_s["eval"] += time.perf_counter() - t0

        def note_validation(val_acc: float) -> bool:
            """Track the per-epoch validation accuracy; True = stop."""
            nonlocal best_val, val_wait
            if chief or cfg.eval_all_hosts:
                print("Validation-Accuracy: %2.2f" % val_acc)
            if val_acc > best_val + 1e-12:
                best_val, val_wait = val_acc, 0
                return False
            val_wait += 1
            return val_wait >= cfg.early_stop_patience

        def ckpt_extras() -> dict | None:
            extras = ({"best_val": best_val, "val_wait": val_wait}
                      if early else {})
            if cfg.zero_opt:
                # the flat slot chunking is dp-shaped; resume checks it
                extras["zero_dp"] = dp
            if pp_mode:
                # the stacked block order's layout (resume checks it)
                extras.update(pp_stages=cfg.pipeline_parallel,
                              pp_virtual=cfg.virtual_stages)
            if fsdp_mode and cfg.sharded_checkpoints:
                # a sharded FSDP checkpoint stores the flat [(mp,) dp,
                # chunk] layout; resume reads the degree it was written at
                extras["fsdp_mp"] = mesh.mp
            if site_mode:
                # the [sites] axis and the outer-state tree (momentum
                # state exists iff momentum > 0; the residual iff int8)
                extras.update(sites=cfg.sites,
                              outer_has_momentum=int(
                                  cfg.outer_optimizer == "nesterov"
                                  and cfg.outer_momentum > 0),
                              outer_quant_int8=int(
                                  cfg.outer_quant == "int8"))
            return extras or None

        def save_state(step: int, resume_epoch: int) -> None:
            """A classic checkpoint in JAX's layouts: every process writes
            its shard file (the blocks it is the first to hold; FSDP's
            flat layout as it is) and the chief the manifest under
            --sharded_checkpoints (the files from a background thread
            under --async_checkpoints, the prune once they landed); else
            every rank joins the gathers and the chief writes one .npz
            (the TP leaves and FSDP unsharded, local SGD's replicas
            stacked [dp, ...], ZeRO-1's slots [(mp,) dp, chunk])."""
            prune = ((lambda: ckpt_lib.prune_checkpoints(
                cfg.checkpoint_dir, cfg.keep_checkpoints))
                if chief and cfg.keep_checkpoints else None)
            if cfg.sharded_checkpoints:
                ckpt_lib.save_checkpoint_sharded(
                    cfg.checkpoint_dir, state, step, resume_epoch,
                    ckpt_extras(), async_=cfg.async_checkpoints,
                    on_complete=prune, layout=layout)
                return
            to_save = state
            if layout is not None:
                to_save = ckpt_lib.gather_global(state, layout)
                if fsdp_mode:
                    to_save = _unshard_flat(to_save, full_template, mesh.mp,
                                            strat.tp_dims)
            if chief:
                ckpt_lib.save_checkpoint(cfg.checkpoint_dir, to_save, step,
                                         resume_epoch, ckpt_extras())
                if prune is not None:
                    prune()

        ckpt_enabled = bool(cfg.checkpoint_dir and cfg.checkpoint_every)
        last_ckpt_step = 0

        def maybe_checkpoint(step: int, resume_epoch: int) -> None:
            """Save when a ``checkpoint_every`` boundary was crossed
            since the last save."""
            nonlocal last_ckpt_step
            every = cfg.checkpoint_every
            if ckpt_enabled and step // every > last_ckpt_step // every:
                t_ck = time.perf_counter()
                with tracer.annotate("checkpoint"):
                    save_state(step, resume_epoch)
                phase_span("ckpt", t_ck, step=step)
                last_ckpt_step = step

        # the resilience store: write-behind snapshots and the SIGTERM
        # handler (the host path only: the fast path was gated off)
        ckpt_stall_s: list = []
        if cfg.ckpt_every:
            from ..resilience import signals as signals_lib
            from ..resilience.writer import CheckpointWriter

            def _on_snapshot_written(snap_step, wstats):
                # writer thread: every persisted snapshot lands on the
                # restart timeline with its incremental reuse counts
                restart_narrator.emit(
                    "snapshot", step=int(snap_step),
                    objects_written=int(wstats["objects_written"]),
                    objects_reused=int(wstats["objects_reused"]),
                    bytes_written=int(wstats["bytes_written"]))

            ckpt_writer = CheckpointWriter(
                cfg.checkpoint_dir, process_index=proc_idx,
                process_count=proc_cnt, keep=cfg.ckpt_keep,
                on_written=_on_snapshot_written if chief else None)

            def _on_preempt_signal(signum):
                restart_narrator.emit("preempt", signal=int(signum))

            preempt_handler = signals_lib.PreemptionHandler(
                writer=ckpt_writer, on_signal=_on_preempt_signal)
            preempt_handler.install()
            _reserve_host_buffers(state, dev)

        def snapshot_state(step: int, epoch: int,
                           batches_done: int) -> None:
            """Hand the current state to the write-behind writer: the
            device-to-host copies are enqueued here (``_host_snapshot``),
            everything else runs on the writer thread.  With several
            processes the chief hands over every replicated leaf and
            each rank the blocks it is the first to hold (the TP shards,
            ZeRO-1's slots, local SGD's replicas), with their global
            shapes, so the snapshot holds the global layout."""
            snap, ready, meta = {}, None, None
            if chief or layout is not None:
                snap, ready = _host_snapshot(state, dev)
                snap, meta = ckpt_lib.local_shards(snap, layout)
            ckpt_writer.submit(
                int(step), int(epoch), snap, extras=ckpt_extras(),
                data_state={"epoch": int(epoch),
                            "batches_done": int(batches_done),
                            "steps_done": int(step)},
                leaf_meta=meta or None, ready=ready)

        # the fast path stages the splits on the device now: the data
        # load, which the reference also does before its timer starts
        if fast:
            img_d, lbl_d, batch_count = epoch_lib.shard_dataset(
                dataset.train.images, dataset.train.labels, global_batch,
                dev, dp, mesh.data_index)
            fast_eval = epoch_lib.build_fast_eval(
                cfg, spec, dataset.test.images, dataset.test.labels, dev,
                dp, mesh.data_index, mesh=mesh)
            fast_val = (epoch_lib.build_fast_eval(
                cfg, spec, dataset.validation.images,
                dataset.validation.labels, dev, dp, mesh.data_index,
                mesh=mesh) if early else None)
            # the upload lands before the timed window opens
            hard_sync((img_d, lbl_d, fast_eval.staged)
                      + ((fast_val.staged,) if fast_val else ()))

        def full_params():
            """The params sampling reads: the replicas' mean or the
            gathered shards (a collective) under the strategies, this
            rank's Megatron shards under plain TP."""
            return get_params(state) if unstack_mode else state.params

        def eval_params():
            """The params eval reads: ``full_params``, under FSDP x TP
            this rank's Megatron shards of them (JAX's eval of FSDP's
            gathered params runs on the TP layout too)."""
            params = full_params()
            if fsdp_mode and mesh.mp > 1:
                dims = mesh_lib.param_pspecs(spec, mesh.mp)
                params = {k: mesh_lib.shard_leaf(v, dims[k], mesh.mp,
                                                 mesh.model_index)
                          for k, v in params.items()}
            return params

        epochs_done = start_epoch
        begin_time = time.time()
        frequency = cfg.frequency
        cost = float("nan")
        examples_seen = 0
        steps_done = 0
        test_acc = None
        if fast:
            shuffle_key = prng.PRNGKey(cfg.seed + epoch_lib.SHUFFLE_SALT)

            def emit_epoch(epoch: int, costs: np.ndarray, accs: np.ndarray,
                           avg_step_s: float,
                           metrics_step_s: float | None = None) -> float:
                """The epoch's summaries, prints and telemetry from its
                per-step arrays; returns the last printed cost.
                ``metrics_step_s`` leaves the graph's warm-up and
                capture out of the metrics row (the print's AvgTime
                keeps them, as JAX's keeps its compile)."""
                nonlocal examples_seen
                examples_seen += batch_count * global_batch
                base_step = epoch * batch_count
                if writer is not None:
                    for i in range(batch_count):
                        writer.add_scalars(
                            (base_step + i + 1) * step_scale, {
                                "cost": float(costs[i]),
                                "accuracy": float(accs[i])})
                count = 0
                last = float("nan")
                for i in range(batch_count):
                    count += 1
                    if count % frequency == 0 or i + 1 == batch_count:
                        last = float(costs[i])
                        _print_window((base_step + i + 1) * step_scale,
                                      epoch, i, batch_count, last,
                                      count * avg_step_s, frequency)
                        count = 0
                if mlogger is not None:
                    # one row an epoch from the returned arrays: no
                    # per-step host timing, so the percentiles are the
                    # epoch mean (timing "epoch_mean"), all device time
                    m_s = (metrics_step_s if metrics_step_s is not None
                           else avg_step_s)
                    ms = round(m_s * 1e3, 4)
                    wall = round(m_s * batch_count, 6)
                    metrics_row(
                        (epoch + 1) * batch_count * step_scale, epoch, last,
                        {"path": "fast", "timing": "epoch_mean",
                         "steps": batch_count, "window_wall_s": wall,
                         "step_time_p50_ms": ms, "step_time_p95_ms": ms,
                         "step_time_max_ms": ms, "data_wait_s": 0.0,
                         "h2d_s": 0.0, "dispatch_s": 0.0,
                         "device_wait_s": wall, "ckpt_s": 0.0,
                         "host_s": 0.0})
                    heartbeat.touch((epoch + 1) * batch_count)
                    straggler_event(epoch)
                if flight is not None:
                    # one enriched record an epoch: its cost and how
                    # many of its per-step costs were not finite
                    flight.record_window(
                        (epoch + 1) * batch_count, epoch=epoch,
                        path="fast", cost=float(last),
                        nonfinite_steps=int(np.sum(~np.isfinite(costs))),
                        step_wall_ms=round(avg_step_s * 1e3, 4))
                if policy is not None:
                    # post hoc over the returned costs; under skip the
                    # step already masked the flagged updates on the card
                    policy.on_epoch(epoch, costs, base_step=base_step)
                return last

            def log_compile(what: str, compile_s: float) -> None:
                phase_s["compile"] += compile_s
                if mlogger is not None:
                    mlogger.log_event("compile", what=what,
                                      dispatch_wall_s=round(compile_s, 3))

            n_ep = cfg.training_epochs - start_epoch
            steps_done = start_epoch * batch_count
            if cfg.checkpoint_every == 0 and n_ep > 0 and not early:
                # the whole run on the device, one fetch at its end
                runner = epoch_lib.build_run_to_completion(
                    cfg, spec, optimizer, batch_count, n_ep, dev,
                    body=train_body, sync_period=strat.sync_period,
                    mesh=mesh)
                runner.dump = graph_dump
                tracer.on_range(start_epoch * batch_count,
                                (start_epoch + n_ep) * batch_count)
                if flight is not None:
                    flight.record_step(start_epoch * batch_count,
                                       epoch=start_epoch, path="fast",
                                       note="run_to_completion dispatched")
                t0 = time.time()
                with tracer.step_annotation(start_epoch * batch_count):
                    state, costs2d, accs2d = runner(state, img_d, lbl_d,
                                                    shuffle_key, start_epoch)
                log_compile("run_to_completion", runner.compile_s)
                with tracer.annotate("eval"):
                    correct = fast_eval.dispatch(eval_params())
                costs2d, accs2d, correct = _fetch(costs2d, accs2d, correct)
                test_acc = float(correct) / fast_eval.n
                total_wall = time.time() - t0
                avg_step_s = total_wall / (n_ep * batch_count)
                metrics_step_s = max(0.0, total_wall - runner.compile_s) / (
                    n_ep * batch_count)
                for e in range(n_ep):
                    cost = emit_epoch(start_epoch + e, costs2d[e],
                                      accs2d[e], avg_step_s, metrics_step_s)
                epochs_done = cfg.training_epochs
                steps_done = epochs_done * batch_count
            else:
                # one epoch a call, for host control between epochs
                # (periodic checkpoints, validation)
                epoch_runner = epoch_lib.build_epoch_runner(
                    cfg, spec, optimizer, batch_count, dev, body=train_body,
                    mesh=mesh)
                epoch_runner.run1.dump = graph_dump
                for epoch in range(start_epoch, cfg.training_epochs):
                    tracer.on_range(epoch * batch_count,
                                    (epoch + 1) * batch_count)
                    t0 = time.time()
                    with tracer.step_annotation(epoch * batch_count):
                        state, costs, accs = epoch_runner(
                            state, img_d, lbl_d, shuffle_key, epoch)
                    compile_s = (epoch_runner.run1.compile_s
                                 if epoch == start_epoch else 0.0)
                    if epoch == start_epoch:
                        log_compile("epoch_runner", compile_s)
                    costs, accs = _fetch(costs, accs)
                    total_wall = time.time() - t0
                    cost = emit_epoch(
                        epoch, costs, accs, total_wall / batch_count,
                        max(0.0, total_wall - compile_s) / batch_count)
                    epochs_done = epoch + 1
                    steps_done = epochs_done * batch_count
                    # validation before the checkpoint, so the saved
                    # best_val/val_wait include this epoch
                    stop_now = False
                    if early:
                        t_ev = time.perf_counter()
                        with tracer.annotate("eval"):
                            stop_now = note_validation(
                                fast_val(eval_params()))
                        phase_s["eval"] += time.perf_counter() - t_ev
                    maybe_checkpoint(steps_done, epochs_done)
                    if stop_now:
                        break
        else:
            # the sync step returns its non-finite flag and counts; the
            # FSDP, local-SGD and site steps only under --debug_nans, and
            # there the policy reads the loss at the print fetch, as in
            # JAX
            want_anomaly = ((policy is not None and not unstack_mode)
                            or cfg.debug_nans)
            # every rank draws the global batch JAX's one-process loader
            # draws and takes its rows of it, as device r does (and its
            # token columns under sequence parallelism: a view of the
            # split, gathered by rows as it is)
            iterator = EpochIterator(
                dataset.train, batch_size=global_batch, seed=cfg.seed,
                shard=cfg.shard_data)
            rows = mesh_lib.batch_layout(mesh, global_batch)
            train_split = dataset.train
            if mesh.sp > 1:
                train_split = dataclasses.replace(
                    dataset.train, images=dataset.train.images[
                        :, mesh_lib.seq_columns(
                            mesh, dataset.train.images.shape[1])])
            on_card = dev.type == "cuda"
            # the JAX defaults for the device: deep on the card, one on
            # the CPU, where the "device" is the host's own cores
            window = cfg.dispatch_depth or (32 if on_card else 1)
            prefetch_depth = cfg.prefetch_depth or (8 if on_card else 1)
            pinned = cfg.device_prefetch and on_card
            from ..resilience.resume import skip_batches

            # --metrics/--histograms: the window timer charges the
            # loop's existing host-side waits into named buckets; it
            # adds no fetch of its own
            wtimer = None
            if mlogger is not None or cfg.histograms:
                from ..obs.metrics import WindowTimer

                wtimer = WindowTimer()

            def charge(bucket: str, t0: float) -> None:
                if wtimer is not None:
                    wtimer.charge(bucket, time.perf_counter() - t0)

            h2d_wall = [0.0]    # the commits' wall, kept out of data_wait

            def commit_timed(commit):
                """``commit``, charged into the h2d bucket and range."""
                def timed(*args):
                    t0 = time.perf_counter()
                    with tracer.annotate("h2d"):
                        out = commit(*args)
                    h2d_wall[0] += time.perf_counter() - t0
                    charge("h2d", t0)
                    return out
                return timed

            def to_device(bx, by):
                return (torch.from_numpy(bx).to(dev),
                        torch.from_numpy(by).to(dev))

            # ONE producer thread spans every epoch; under
            # --device_prefetch ONE DevicePrefetcher keeps up to
            # prefetch_depth batches committed ahead across the run, the
            # producer gathering them into pinned memory on the card.
            # An exact-step resume starts the producer at the first batch
            # not yet done: the epoch's permutation is drawn whole, its
            # head is never gathered (skip_batches raises when the epoch
            # is shorter than the snapshot's position)
            def epoch_batches(e):
                idx = [b[rows] for b in iterator.batch_indices(e)]
                if e == start_epoch:
                    idx = list(skip_batches(idx, resume_skip))
                if pinned:
                    return pinned_batches(train_split, idx)
                return ((train_split.images[i], train_split.labels[i])
                        for i in idx)

            def timed_batches(batches, start=0):
                """enumerate(batches, start), charging the blocking
                next() into data_wait, less the commits inside it."""
                it = iter(batches)
                i = start
                while True:
                    t0 = time.perf_counter()
                    h0 = h2d_wall[0]
                    try:
                        with tracer.annotate("data_wait"):
                            item = next(it)
                    except StopIteration:
                        return
                    if wtimer is not None:
                        wtimer.charge("data_wait", max(
                            0.0, time.perf_counter() - t0
                            - (h2d_wall[0] - h0)))
                    yield i, item
                    i += 1

            prefetcher = EpochPrefetcher(
                epoch_batches, range(start_epoch, cfg.training_epochs))
            dev_feed = (DevicePrefetcher(commit_timed(CopyStreamCommit(dev)),
                                         depth=prefetch_depth)
                        if cfg.device_prefetch else None)
            take_timed = commit_timed(take)
            to_device_timed = commit_timed(to_device)
            inflight: list = []     # events of the steps on the card
            pending: list = []      # (step, cost, acc) not yet written
            norms_dev = None        # --histograms: the newest step's
            lr_host = _host_lr(cfg, total_steps) if cfg.histograms else None
            # --on_anomaly: the flags are fetched lazily, no faster than
            # the dispatch window, and no later than the flight ring
            # still holds the step's record (to attach its loss)
            anom_pending: list = []     # (step, cost, anomaly outputs)
            anom_depth = (min(window, max(1, flight.capacity - 1))
                          if flight is not None else window)
            compile_logged = False

            def wait_device(what) -> None:
                """Block on ``what`` (an event), charged as device_wait."""
                t0 = time.perf_counter()
                with tracer.annotate("device_wait"):
                    what.synchronize()
                charge("device_wait", t0)

            def drain_anomaly(entry) -> None:
                """One queued step's flag (and its cost) in one fetch,
                the counts only when flagged, then the policy."""
                sid, c_dev, a_dev = entry
                t0 = time.perf_counter()
                with tracer.annotate("device_wait"):
                    flagged_h, c = _fetch(a_dev["flag"], c_dev)
                    flagged, c = bool(flagged_h), float(c)
                    counts = (a_dev["counts"].cpu().numpy() if flagged
                              else None)
                charge("device_wait", t0)
                if flight is not None:
                    flight.attach_loss(sid, c)
                policy.on_step(sid, loss=c, flagged=flagged, counts=counts)

            def write_pending() -> None:
                """The summaries of the pending steps, from one fetch."""
                if not pending:
                    return
                t0 = time.perf_counter()
                with tracer.annotate("device_wait"):
                    vals = _fetch(*(t for _s, c, a in pending
                                    for t in (c, a)))
                charge("device_wait", t0)
                for k, (step, _c, _a) in enumerate(pending):
                    writer.add_scalars(step, {
                        "cost": float(vals[2 * k]),
                        "accuracy": float(vals[2 * k + 1])})
                pending.clear()

            def close_window(epoch: int, cost_dev) -> None:
                """Window boundary: the queued anomaly flags, then ONE
                fetch (the cost and the newest norm vectors), the
                metrics row, the flight window record, the heartbeat and
                the histogram and lr summaries."""
                while anom_pending:
                    drain_anomaly(anom_pending.pop(0))
                t0 = time.perf_counter()
                with tracer.annotate("device_wait"):
                    if norms_dev is not None:
                        cost_h, g_h, p_h = _fetch(cost_dev, norms_dev["grad"],
                                                  norms_dev["param"])
                        norms_host = {"grad": g_h, "param": p_h}
                    else:
                        (cost_h,), norms_host = _fetch(cost_dev), None
                charge("device_wait", t0)
                cost_w = float(cost_h)
                timing = wtimer.window_row()
                timing["path"] = "host"
                if mlogger is not None:
                    metrics_row(steps_done * step_scale, epoch, cost_w,
                                timing)
                if flight is not None:
                    flight.record_window(
                        steps_done, epoch=epoch, cost=cost_w, timing=timing,
                        grad_norms=(norms_host["grad"].tolist()
                                    if norms_host is not None else None))
                if heartbeat is not None:
                    heartbeat.touch(steps_done)
                if norms_host is not None and writer is not None:
                    writer.add_histograms(steps_done, {
                        "grad_norm": norms_host["grad"],
                        "param_norm": norms_host["param"]})
                    writer.add_scalars(
                        steps_done, {"learning_rate": lr_host(steps_done)})
                wtimer.reset()

            steps_done = start_epoch * iterator.batches_per_epoch \
                + resume_skip
            start_time = time.time()
            try:
                for epoch in range(start_epoch, cfg.training_epochs):
                    batch_count = iterator.batches_per_epoch
                    # an exact-step resume picks the print cadence up
                    # where the uninterrupted run would be
                    skip = resume_skip if epoch == start_epoch else 0
                    count = skip % frequency
                    feed = prefetcher.epoch(epoch)
                    if dev_feed is not None:
                        feed = dev_feed.rewind(feed)
                    if wtimer is not None:
                        # inter-epoch host work (validation, checkpoint)
                        # stays out of the next window's wall
                        wtimer.reset()
                    for i, item in timed_batches(feed, start=skip):
                        if preempt_handler is not None \
                                and preempt_handler.requested:
                            # the per-step safe point: one snapshot at the
                            # exact current position, drain, exit 128+sig
                            t_ck = time.perf_counter()
                            with tracer.annotate("checkpoint"):
                                snapshot_state(steps_done, epoch, i)
                                ckpt_writer.drain()
                            phase_span("ckpt", t_ck, step=steps_done,
                                       preempt=True)
                            print(f"Preempted "
                                  f"({preempt_handler.signal_name()}): "
                                  f"final snapshot at step {steps_done}",
                                  flush=True)
                            preempt_handler.check()   # raises Preempted
                        if dev_feed is not None:
                            x, y = take_timed(*item)
                        else:
                            x, y = to_device_timed(*item)
                        # the capture window opens and closes on exact
                        # step ids; at its edges the steps in flight
                        # must finish first
                        if on_card and tracer.boundary(steps_done):
                            t_edge = time.perf_counter()
                            with tracer.annotate("device_wait"):
                                torch.cuda.synchronize(dev)
                            charge("device_wait", t_edge)
                        tracer.on_step(steps_done)
                        t_disp = time.perf_counter()
                        with tracer.step_annotation(steps_done), \
                                tracer.annotate("dispatch"):
                            if graph_dump is not None:
                                state, cost_dev, acc_dev, *extra = \
                                    graph_dump.record(train_body, state, x, y)
                            else:
                                state, cost_dev, acc_dev, *extra = \
                                    train_body(state, x, y)
                        if site_mode:
                            # one step = one round (H inner steps and
                            # the outer sync): its host dispatch wall
                            phase_span("round", t_disp, step=steps_done + 1)
                        if wtimer is not None:
                            t_disp = time.perf_counter() - t_disp
                            wtimer.charge("dispatch", t_disp)
                            if not compile_logged:
                                # the first step's launches (the kernels'
                                # first use) are the compile event, kept
                                # out of the first window's throughput
                                compile_logged = True
                                phase_s["compile"] += t_disp
                                if mlogger is not None:
                                    mlogger.log_event(
                                        "compile", what="train_step",
                                        dispatch_wall_s=round(t_disp, 3))
                                wtimer.reset()
                        if cfg.histograms:
                            norms_dev = extra[0]
                        steps_done += 1
                        if async_mode and steps_done % cfg.sync_period == 0:
                            t_sync = time.perf_counter()
                            state = step_lib.param_sync(state)
                            phase_span("outer_sync", t_sync,
                                       step=steps_done)
                        examples_seen += global_batch
                        if flight is not None:
                            flight.record_step(steps_done, epoch=epoch,
                                               batch_index=i)
                        if cfg.debug_nans and want_anomaly \
                                and bool(extra[-1]["flag"]):  # dtx: noqa[host-sync] --debug_nans stops at the first non-finite step, so it reads every step's flag (JAX's jax_debug_nans syncs every op)
                            counts = extra[-1]["counts"].cpu().tolist()  # dtx: noqa[host-sync] read once, on the flagged step the run then raises on
                            blame = {n: c for n, c in zip(
                                step_lib.leaf_names(spec, pp_mode),
                                counts) if c}
                            raise FloatingPointError(
                                f"--debug_nans: step {steps_done} produced "
                                f"a non-finite loss or gradient (non-finite "
                                f"gradient elements by leaf: {blame})")
                        if policy is not None and want_anomaly:
                            anom_pending.append((steps_done, cost_dev,
                                                 extra[-1]))
                            if len(anom_pending) > anom_depth:
                                drain_anomaly(anom_pending.pop(0))
                        if on_card:
                            # at most `window` steps in flight: wait on
                            # the oldest
                            done = torch.cuda.Event()
                            done.record()
                            inflight.append(done)
                            if len(inflight) > window:
                                wait_device(inflight.pop(0))
                        if writer is not None:
                            # the reference writes cost and accuracy
                            # every step; fetched once per window
                            pending.append((steps_done * step_scale,
                                            cost_dev, acc_dev))
                            if len(pending) >= window:
                                write_pending()
                        count += 1
                        if count % frequency == 0 or i + 1 == batch_count:
                            t_fetch = time.perf_counter()
                            with tracer.annotate("device_wait"):
                                cost = float(cost_dev)
                            charge("device_wait", t_fetch)
                            elapsed_time = time.time() - start_time
                            start_time = time.time()
                            if policy is not None and not want_anomaly:
                                # FSDP and local SGD: no step flags, the
                                # loss watchdog rides the print fetch
                                policy.on_step(steps_done, loss=cost)
                            _print_window(steps_done * step_scale, epoch, i,
                                          batch_count, cost, elapsed_time,
                                          frequency)
                            count = 0
                        if (ckpt_writer is not None
                                and steps_done % cfg.ckpt_every == 0):
                            # write-behind snapshot; an epoch-final one
                            # records the next epoch's start.  Charged
                            # before the window may close, so the stall
                            # lands in the window of the step it follows
                            t_ck = time.perf_counter()
                            ck_ep, ck_done = ((epoch, i + 1)
                                              if i + 1 < batch_count
                                              else (epoch + 1, 0))
                            with tracer.annotate("checkpoint"):
                                snapshot_state(steps_done, ck_ep, ck_done)
                            ckpt_stall_s.append(time.perf_counter() - t_ck)
                            charge("ckpt", t_ck)
                            phase_span("ckpt", t_ck, step=steps_done)
                        if wtimer is not None:
                            wtimer.step_done()
                            if (wtimer.steps >= cfg.log_every
                                    or i + 1 == batch_count):
                                close_window(epoch, cost_dev)
                        maybe_checkpoint(steps_done, epoch)
                    # no queued anomaly crosses into the next epoch
                    while anom_pending:
                        drain_anomaly(anom_pending.pop(0))
                    epochs_done = epoch + 1
                    if mlogger is not None:
                        straggler_event(epoch)
                    if early and note_validation(host_eval_accuracy(
                            eval_params(), dataset.validation.images,
                            dataset.validation.labels)):
                        break
                if writer is not None:
                    write_pending()
            finally:
                if dev_feed is not None:
                    dev_feed.close()
                prefetcher.close()

        # a window still open when training ends closes here, after the
        # steps in flight: the capture holds the requested steps, not the
        # eval and shutdown (whole-run --profile keeps tracing)
        if not tracer.whole_run:
            if tracer.active and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            tracer.stop()

        final_params = None
        if test_acc is None:        # the whole-run path fetched it
            final_params = eval_params()
            if fast:
                t_ev = time.perf_counter()
                with tracer.annotate("eval"):
                    test_acc = fast_eval(final_params)
                phase_s["eval"] += time.perf_counter() - t_ev
            else:
                test_acc = host_eval_accuracy(
                    final_params, dataset.test.images, dataset.test.labels)
        total_time = time.time() - begin_time
        cost = float(cost)
        if chief or cfg.eval_all_hosts:
            print("Test-Accuracy: %2.2f" % test_acc)
        if chief:
            print("Total Time: %3.2fs" % float(total_time))
            print("Final Cost: %.4f" % cost)
        t_sample = time.perf_counter()
        if cfg.sample_after > 0 and cfg.model == "transformer" \
                and cfg.objective == "lm":
            # outside TP decode (tp_decode) whole params: FSDP's
            # gathered, the stages (and a PP run's Megatron shards) and
            # the experts gathered first
            params = (final_params
                      if final_params is not None and not fsdp_mode
                      else full_params())
            if pp_mode:
                if mesh.mp > 1:
                    params = _gather_model(params, spec, mesh, True)
                params = _gather_stages(params, spec, mesh,
                                        cfg.virtual_stages)
            if mesh.ep > 1:
                params = _gather_experts(params, spec, mesh)
            _sample(cfg, spec, params, dataset.test.images, dev, chief,
                    mesh, tp_decode(cfg, mesh))
        phase_s["sample"] += time.perf_counter() - t_sample
        ckpt_stats = None
        if cfg.checkpoint_dir:
            with tracer.annotate("checkpoint"):
                if ckpt_writer is not None:
                    # the resilience store's exit snapshot supersedes
                    # the classic exit save (nearly free after a
                    # periodic one: unchanged leaves are reused)
                    snapshot_state(steps_done, cfg.training_epochs, 0)
                    ckpt_writer.drain()
                    ckpt_stats = dict(ckpt_writer.stats(),
                                      ckpt_stall_ms=[round(t * 1e3, 6)
                                                     for t in ckpt_stall_s])
                if ckpt_writer is None or ckpt_enabled:
                    # the classic exit save still runs when the classic
                    # periodic format is in play beside the store
                    save_state(steps_done, cfg.training_epochs)
                # a background classic writer must land before the exit
                ckpt_lib.wait_for_pending_saves()
        if mlogger is not None:
            mlogger.log_event(
                "run_end", steps=int(steps_done),
                total_time_s=round(total_time, 3),
                test_accuracy=float(test_acc),
                examples_per_sec=(round(examples_seen / total_time, 3)
                                  if total_time > 0 else None),
                compile_s=round(phase_s["compile"], 6),
                eval_s=round(phase_s["eval"], 6),
                sample_s=round(phase_s["sample"], 6),
                **(policy.summary() if policy is not None else {}))
            mlogger.close()
        if chief:
            print("done")
        # a capture still open (whole-run --profile) closes before the
        # result reads its count
        tracer.stop()
    except BaseException as e:
        # the crash path: persist the flight record before propagating
        # (callers that catch never reach the excepthook) and collate
        # what the processes dumped into the chief's post-mortem
        if flight is not None:
            from ..resilience.signals import Preempted

            # "sigterm" (a handled preemption, its final snapshot
            # already durable) is the dump a --resume relaunch keeps
            reason = ("anomaly_halt"
                      if isinstance(e, anomaly_lib.AnomalyError)
                      else "sigterm" if isinstance(e, Preempted)
                      else "crash")
            flight.dump(reason, exc=e)
            if chief:
                flight_lib.collate(cfg.logs_path)
        raise
    finally:
        if tracer is not None:
            tracer.stop()
        if writer is not None:
            writer.close()
        if preempt_handler is not None:
            preempt_handler.uninstall()
        if ckpt_writer is not None:
            # flush the newest captured snapshot on the crash path too; a
            # writer error here must not mask the original exception
            try:
                ckpt_writer.close(drain=True, timeout=60.0)
            except Exception as ck_err:
                print(f"NOTE: checkpoint writer close failed: {ck_err}")
        if flight is not None:
            flight.uninstall()
        if mlogger is not None:
            mlogger.close()
        if span_recorder is not None:
            span_recorder.close()
        if status_server is not None:
            status_server.close()
        if owns_group:
            cluster.shutdown()
    result = {
        "test_accuracy": test_acc,
        "total_time_s": total_time,
        "final_cost": cost,
        # a multi-site round is inner_steps optimizer steps: JAX's count
        # reads the state's step
        "steps": int(state.step) if site_mode else steps_done,
        "examples_seen": examples_seen,
        "examples_per_sec": (examples_seen / total_time
                             if total_time > 0 else 0.0),
        "dataset_source": dataset.source,
        "devices": mesh.devices,
        "global_batch": global_batch,
        "fast_loop": fast,
        "epochs_completed": epochs_done,
        "stopped_early": bool(early
                              and val_wait >= cfg.early_stop_patience),
        "anomalies": policy.anomalies if policy is not None else 0,
        "skipped_steps": policy.skipped_steps if policy is not None else 0,
        "profile_windows": tracer.windows_captured,
    }
    if ckpt_stats is not None:
        # the port's own, under --ckpt_every: the resilience writer's
        # stats() and the loop's stall of each periodic snapshot
        result["checkpoint_stats"] = ckpt_stats
    return result

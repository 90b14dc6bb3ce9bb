"""The training loop (the JAX package's ``train/loop.py``), for the
MLP and the transformer.

``run(cfg)`` loads the data, builds the seeded train state on the card
(``cfg.device``; the CPU only when asked for) and trains
``training_epochs`` epochs on one of two paths:

- **the fast path** (the default; ``fast_loop`` with one process, the
  JAX gate): the device-resident epoch of ``parallel/epoch.py``.  The
  split is staged on the device once, each epoch is shuffled there with
  the JAX fast path's permutation, bit for bit, and the per-step costs
  and accuracies come back once per run, or once per epoch when
  ``--checkpoint_every`` asks for host control between epochs.  The
  MLP's step replays as a CUDA graph on the card; the transformer's
  runs eagerly.  The prints and summaries are made from the returned
  arrays, ``AvgTime`` from the run's (or the epoch's) wall over its
  steps;
- **the host path** (``--no_fast_loop``, several processes,
  ``--ckpt_every`` or ``--resume=auto``): ``EpochIterator`` batches from
  one persistent producer thread (``data/prefetch.EpochPrefetcher``),
  one synchronous data-parallel step per batch (``parallel/step.py``),
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
sample ``--sample_after`` sequences with the KV-cached ``generate``
into ``logs_path/samples.npz``, save ``.npz`` checkpoints in the JAX
package's layouts (``--checkpoint_dir``, every ``--checkpoint_every``
steps, at epoch ends on the fast path, and at the end; one ``.npz``, or
``ckpt-N.shards/`` under ``--sharded_checkpoints``, written from a
background thread under ``--async_checkpoints``) and return the JAX
``run``'s result keys, ``"fast_loop"`` the path taken.

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
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict

import numpy as np
import torch

from .. import cluster
from ..config import Config, Unported, validate_train_config
from ..data import (CopyStreamCommit, DevicePrefetcher, EpochIterator,
                    EpochPrefetcher, load_datasets, pinned_batches, take)
from ..device import dtype_from_name, resolve_device
from ..models import transformer as tfm
from ..models.mlp import MLPSpec
from ..parallel import epoch as epoch_lib
from ..parallel import step as step_lib
from ..utils import checkpoint as ckpt_lib
from ..utils import prng
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
                   labels: np.ndarray, chunk: int, device) -> float:
    """Accuracy over a whole split, in chunks of ``chunk`` examples; the
    last chunk is zero-padded and masked, as in the JAX package."""
    n = images.shape[0]
    chunk = max(1, min(chunk, n))
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
        correct += float(eval_step(params, torch.from_numpy(x).to(device),
                                   torch.from_numpy(y).to(device),
                                   torch.from_numpy(mask).to(device)))
    return correct / n


def _sample(cfg: Config, spec, params, images: np.ndarray, device,
            chief: bool) -> None:
    """KV-cached decoding from the first test examples' opening
    ``seq_len // 8`` tokens (greedy at ``--sample_temperature`` 0), saved
    by the chief to ``logs_path/samples.npz`` as the JAX trainer saves
    them."""
    n_s = min(cfg.sample_after, images.shape[0])
    if not n_s:
        return
    prompt_len = max(1, spec.seq_len // 8)
    prompts = tfm.tokenize(spec, torch.from_numpy(images[:n_s]).to(
        device))[:, :prompt_len]
    gen = (torch.Generator(device=device).manual_seed(cfg.seed)
           if cfg.sample_temperature > 0 else None)
    samples = tfm.generate(spec, params, prompts, generator=gen,
                           temperature=cfg.sample_temperature)
    if chief:
        os.makedirs(cfg.logs_path, exist_ok=True)
        path = os.path.join(cfg.logs_path, "samples.npz")
        np.savez(path, samples=samples.cpu().numpy().astype(np.int32),
                 prompt_len=prompt_len, vocab_size=spec.vocab_size)
        print(f"Sampled {n_s} sequences -> {path}")


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


# the JAX trainer's checkpoint extras of layouts the port does not have:
# their states would not restore into the port's template
_FOREIGN_LAYOUTS = ("zero_dp", "sites", "fsdp_mp", "pp_stages",
                    "pp_virtual")


def run(cfg: Config) -> Dict[str, Any]:
    """Train per the config; returns the metrics the reference prints
    (the JAX ``run``'s result keys)."""
    validate_train_config(cfg)
    dev = resolve_device(cfg.device)
    spec = make_spec(cfg)
    cluster.bootstrap(cfg)
    writer = None
    # resilience handles, bound before the try so its finally can always
    # reach them
    ckpt_writer = None
    preempt_handler = None
    span_recorder = None
    try:
        proc_idx = cluster.process_index()
        proc_cnt = cluster.process_count()
        chief = proc_idx == 0

        if chief and cfg.resume:
            # a relaunch continues the same run: a reused logs_path keeps
            # the preempted attempt's heartbeats and preemption dumps,
            # and loses older crash leftovers
            from ..obs.heartbeat import clear_stale_signals

            clear_stale_signals(cfg.logs_path, resuming=True)
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
            input_size=cfg.input_size)
        global_batch = _global_batch(cfg, proc_cnt)
        total_steps = cfg.training_epochs * max(
            1, dataset.train.images.shape[0] // global_batch)
        optimizer = make_optimizer(cfg, total_steps)
        state = create_train_state(spec, optimizer, seed=cfg.seed,
                                   device=dev)
        # the JAX gate (fast_loop, one process, shard_data or dp == 1) as
        # far as the port has its flags; with one process dp is 1.  The
        # resilience snapshots ride the host path's per-step safe point,
        # and --resume=auto's in-epoch skip needs the host feed
        fast = (cfg.fast_loop and proc_cnt == 1 and not cfg.ckpt_every
                and cfg.resume != "auto")
        print("Variables initialized ...")

        start_epoch = 0
        resume_skip = 0     # --resume=auto: batches of start_epoch done
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
            if path is None and cfg.resume != "auto":
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
                extras = (dict(plan.extras) if plan is not None
                          else ckpt_lib.load_extras(path))
                foreign = {k: extras[k] for k in _FOREIGN_LAYOUTS
                           if k in extras}
                if foreign:
                    raise Unported(
                        f"checkpoint {path} was written with {foreign}: "
                        f"ZeRO-1, multi-site, FSDP and pipeline layouts "
                        f"are not ported to the PyTorch trainer yet "
                        f"(see ROADMAP.md Queue A)")
                if plan is not None:
                    state = ckpt_lib.rebuild_tree_validated(
                        flat, state, ckpt_path=path)
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
                    state, _, start_epoch = ckpt_lib.restore_checkpoint(
                        path, state)
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

        def save_state(step: int, resume_epoch: int) -> None:
            """A classic checkpoint: every process writes its shard file
            and the chief the manifest under --sharded_checkpoints (the
            files from a background thread under --async_checkpoints,
            the prune once they landed); else the chief's one .npz."""
            prune = ((lambda: ckpt_lib.prune_checkpoints(
                cfg.checkpoint_dir, cfg.keep_checkpoints))
                if chief and cfg.keep_checkpoints else None)
            if cfg.sharded_checkpoints:
                ckpt_lib.save_checkpoint_sharded(
                    cfg.checkpoint_dir, state, step, resume_epoch,
                    async_=cfg.async_checkpoints, on_complete=prune)
            elif chief:
                ckpt_lib.save_checkpoint(cfg.checkpoint_dir, state, step,
                                         resume_epoch)
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
            processes the state is replicated: the chief hands over
            every leaf, the others an empty part."""
            snap, ready = ({}, None)
            if chief:
                snap, ready = _host_snapshot(state, dev)
            ckpt_writer.submit(
                int(step), int(epoch), snap,
                data_state={"epoch": int(epoch),
                            "batches_done": int(batches_done),
                            "steps_done": int(step)},
                ready=ready)

        # the fast path stages the splits on the device now: the data
        # load, which the reference also does before its timer starts
        if fast:
            img_d, lbl_d, batch_count = epoch_lib.shard_dataset(
                dataset.train.images, dataset.train.labels, global_batch,
                dev)
            fast_eval = epoch_lib.build_fast_eval(
                cfg, spec, dataset.test.images, dataset.test.labels, dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

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
                           avg_step_s: float) -> float:
                """The epoch's summaries and prints from its per-step
                arrays; returns the last printed cost."""
                nonlocal examples_seen
                examples_seen += batch_count * global_batch
                base_step = epoch * batch_count
                if writer is not None:
                    for i in range(batch_count):
                        writer.add_scalars(base_step + i + 1, {
                            "cost": float(costs[i]),
                            "accuracy": float(accs[i])})
                count = 0
                last = float("nan")
                for i in range(batch_count):
                    count += 1
                    if count % frequency == 0 or i + 1 == batch_count:
                        last = float(costs[i])
                        _print_window(base_step + i + 1, epoch, i,
                                      batch_count, last, count * avg_step_s,
                                      frequency)
                        count = 0
                return last

            n_ep = cfg.training_epochs - start_epoch
            steps_done = start_epoch * batch_count
            if cfg.checkpoint_every == 0 and n_ep > 0:
                # the whole run on the device, one fetch at its end
                runner = epoch_lib.build_run_to_completion(
                    cfg, spec, optimizer, batch_count, n_ep, dev)
                t0 = time.time()
                state, costs2d, accs2d = runner(state, img_d, lbl_d,
                                                shuffle_key, start_epoch)
                correct = fast_eval.dispatch(state.params)
                costs2d, accs2d, correct = _fetch(costs2d, accs2d, correct)
                test_acc = float(correct) / fast_eval.n
                avg_step_s = (time.time() - t0) / (n_ep * batch_count)
                for e in range(n_ep):
                    cost = emit_epoch(start_epoch + e, costs2d[e],
                                      accs2d[e], avg_step_s)
                epochs_done = cfg.training_epochs
                steps_done = epochs_done * batch_count
            else:
                # one epoch a call, for checkpoints between epochs
                epoch_runner = epoch_lib.build_epoch_runner(
                    cfg, spec, optimizer, batch_count, dev)
                for epoch in range(start_epoch, cfg.training_epochs):
                    t0 = time.time()
                    state, costs, accs = epoch_runner(state, img_d, lbl_d,
                                                      shuffle_key, epoch)
                    costs, accs = _fetch(costs, accs)
                    cost = emit_epoch(epoch, costs, accs,
                                      (time.time() - t0) / batch_count)
                    epochs_done = epoch + 1
                    steps_done = epochs_done * batch_count
                    maybe_checkpoint(steps_done, epochs_done)
        else:
            train_step = step_lib.make_sync_step_body(cfg, spec, optimizer)
            iterator = EpochIterator(
                dataset.train, batch_size=global_batch // proc_cnt,
                seed=cfg.seed, shard=cfg.shard_data,
                process_index=proc_idx, process_count=proc_cnt)
            on_card = dev.type == "cuda"
            # the JAX defaults for the device: deep on the card, one on
            # the CPU, where the "device" is the host's own cores
            window = cfg.dispatch_depth or (32 if on_card else 1)
            prefetch_depth = cfg.prefetch_depth or (8 if on_card else 1)
            pinned = cfg.device_prefetch and on_card
            from ..resilience.resume import skip_batches

            # ONE producer thread spans every epoch; under
            # --device_prefetch ONE DevicePrefetcher keeps up to
            # prefetch_depth batches committed ahead across the run, the
            # producer gathering them into pinned memory on the card.
            # An exact-step resume starts the producer at the first batch
            # not yet done: the epoch's permutation is drawn whole, its
            # head is never gathered (skip_batches raises when the epoch
            # is shorter than the snapshot's position)
            def epoch_batches(e):
                idx = iterator.batch_indices(e)
                if e == start_epoch:
                    idx = list(skip_batches(idx, resume_skip))
                if pinned:
                    return pinned_batches(dataset.train, idx)
                return ((dataset.train.images[i], dataset.train.labels[i])
                        for i in idx)

            prefetcher = EpochPrefetcher(
                epoch_batches, range(start_epoch, cfg.training_epochs))
            dev_feed = (DevicePrefetcher(CopyStreamCommit(dev),
                                         depth=prefetch_depth)
                        if cfg.device_prefetch else None)
            inflight: list = []     # events of the steps on the card
            pending: list = []      # (step, cost, acc) not yet written

            def write_pending() -> None:
                """The summaries of the pending steps, from one fetch."""
                if not pending:
                    return
                vals = _fetch(*(t for _s, c, a in pending for t in (c, a)))
                for k, (step, _c, _a) in enumerate(pending):
                    writer.add_scalars(step, {
                        "cost": float(vals[2 * k]),
                        "accuracy": float(vals[2 * k + 1])})
                pending.clear()

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
                    for i, item in enumerate(feed, start=skip):
                        if preempt_handler is not None \
                                and preempt_handler.requested:
                            # the per-step safe point: one snapshot at the
                            # exact current position, drain, exit 128+sig
                            t_ck = time.perf_counter()
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
                            x, y = take(*item)
                        else:
                            x = torch.from_numpy(item[0]).to(dev)
                            y = torch.from_numpy(item[1]).to(dev)
                        state, cost_dev, acc_dev = train_step(state, x, y)
                        steps_done += 1
                        examples_seen += global_batch
                        if on_card:
                            # at most `window` steps in flight: wait on
                            # the oldest
                            done = torch.cuda.Event()
                            done.record()
                            inflight.append(done)
                            if len(inflight) > window:
                                inflight.pop(0).synchronize()
                        if writer is not None:
                            # the reference writes cost and accuracy
                            # every step; fetched once per window
                            pending.append((steps_done, cost_dev, acc_dev))
                            if len(pending) >= window:
                                write_pending()
                        count += 1
                        if count % frequency == 0 or i + 1 == batch_count:
                            cost = float(cost_dev)
                            elapsed_time = time.time() - start_time
                            start_time = time.time()
                            _print_window(steps_done, epoch, i, batch_count,
                                          cost, elapsed_time, frequency)
                            count = 0
                        if (ckpt_writer is not None
                                and steps_done % cfg.ckpt_every == 0):
                            # write-behind snapshot; an epoch-final one
                            # records the next epoch's start
                            t_ck = time.perf_counter()
                            ck_ep, ck_done = ((epoch, i + 1)
                                              if i + 1 < batch_count
                                              else (epoch + 1, 0))
                            snapshot_state(steps_done, ck_ep, ck_done)
                            ckpt_stall_s.append(time.perf_counter() - t_ck)
                            phase_span("ckpt", t_ck, step=steps_done)
                        maybe_checkpoint(steps_done, epoch)
                    epochs_done = epoch + 1
                if writer is not None:
                    write_pending()
            finally:
                if dev_feed is not None:
                    dev_feed.close()
                prefetcher.close()

        if test_acc is None:        # the whole-run path fetched it
            test_acc = (fast_eval(state.params) if fast else _eval_accuracy(
                step_lib.build_eval_step(cfg, spec), state.params,
                dataset.test.images, dataset.test.labels,
                step_lib.eval_chunk_cap(spec, cfg.eval_batch_size), dev))
        total_time = time.time() - begin_time
        cost = float(cost)
        if chief or cfg.eval_all_hosts:
            print("Test-Accuracy: %2.2f" % test_acc)
        if chief:
            print("Total Time: %3.2fs" % float(total_time))
            print("Final Cost: %.4f" % cost)
        if cfg.sample_after > 0 and cfg.model == "transformer" \
                and cfg.objective == "lm":
            _sample(cfg, spec, state.params, dataset.test.images, dev,
                    chief)
        ckpt_stats = None
        if cfg.checkpoint_dir:
            if ckpt_writer is not None:
                # the resilience store's exit snapshot supersedes the
                # classic exit save (nearly free after a periodic one:
                # unchanged leaves are reused)
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
        if chief:
            print("done")
    finally:
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
        if span_recorder is not None:
            span_recorder.close()
        cluster.shutdown()
    result = {
        "test_accuracy": test_acc,
        "total_time_s": total_time,
        "final_cost": cost,
        "steps": steps_done,
        "examples_seen": examples_seen,
        "examples_per_sec": (examples_seen / total_time
                             if total_time > 0 else 0.0),
        "dataset_source": dataset.source,
        "devices": proc_cnt,
        "global_batch": global_batch,
        "fast_loop": fast,
        "epochs_completed": epochs_done,
        "stopped_early": False,
        "anomalies": 0,
        "skipped_steps": 0,
        "profile_windows": 0,
    }
    if ckpt_stats is not None:
        # the port's own, under --ckpt_every: the resilience writer's
        # stats() and the loop's stall of each periodic snapshot
        result["checkpoint_stats"] = ckpt_stats
    return result
